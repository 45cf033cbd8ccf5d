// Flash attention (K10), the decode kernels for Hopper (sm_90a): a few query
// rows per kv head against a long cache, bf16 inputs on the tensor cores
// and float32 inputs on the CUDA cores.
//
// Replaces the TPU kernel
//   src/repro/kernels/attention/flash.py::flash_attention_pallas
//   (_flash_kernel at the decode geometry: offset, kv_len)
// for inputs whose Sq * group is at most 64
// (kernels/attention/flash.py::variant): every serve step, Sq = 1.
//
// Function: that of flash_prefill.cu (s = (q . k) / sqrt(D) in float32,
// masks at the finite -1e30, p rounded to bf16 for the product with v and
// summed unrounded into l, acc / max(l, 1e-30)), with exp(x) computed as
// exp2(x * log2(e)); for float32 inputs that of flash_attention.cu (p
// unrounded, exp as expf, the products explicit fmaf: TF32 would miss the
// float32 tolerance of 1e-5).
//
// What bounds them on this card: bytes.  A step reads the first kv_len rows
// of K and V once: at the serve shape (B = 4, Hkv = 3, D = 64, kv_len
// 256) 786 KB in bf16, 0.00024 ms at 3.35 TB/s, against 0.2 MFLOP; in
// float32 at kv_len 4096 25.2 MB, 0.0075 ms.
//
// Design (bf16): one block of four warps per (batch, kv head) holds all
// the group * Sq query rows of that kv head (row r: query r / group of head
// hk * group + r % group), so each K and V row is read once for the whole
// GQA group.  64-row K and V tiles go through a two-stage cp.async ring in
// shared memory (16-byte copies, rows padded by 16 bytes so that the
// fragment reads hit 32 banks); only the rows below the block's last
// valid column are read.  With up to 16 rows the four warps split each
// tile's kv rows four ways (16 each); with up to 32 or 64 rows they split
// the rows into 16-row tiles and the kv rows two ways or not at all.  Each
// warp computes S = Q K^T and O += P V for its 16 rows and 16 kv rows at a
// time with mma.sync m16n8k16 (bf16 in, float32 accumulation; Q's
// fragments stay in registers, V's come by ldmatrix.trans) and keeps its
// own online softmax; at the end the warps' (m, l, acc) are merged in
// shared memory with their log-sum-exp weights.  Where (batch, kv head)
// blocks are too few to fill the card and the cache is long, the wrapper
// also splits the kv tiles over blocks (grid y); each block then writes
// its merged (m, l, acc) to a float32 scratch and a second small kernel
// merges the splits the same way.
//
// Design (float32, flash_decode_f32_kernel): the same blocks, ring, kv
// splits, scratch and merge kernel, with the group's rows staged once in
// shared memory and each tile's scores, softmax and P V shared out over
// the block's threads (see the kernel).
//
// Head sizes 16, 64, 112 (zamba2-7b's) and 128 each have their own
// instantiation of both kernels: 112 is 7 k-steps of 16 and 14 n-tiles of
// 8, and its rows (224 or 448 bytes, padded by 16) keep the 16-byte
// copies aligned and the fragment reads on distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;              // kv rows per tile
constexpr int THREADS = 128;        // four warps
constexpr int MAX_ROWS = 64;        // Sq * group

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows first .. first + 63 of a [rows, D] view of T (bf16 or float) into a
// [64][D + 16 bytes] tile; rows at and past n_valid are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* base,
                                          long long rs, int first,
                                          int n_valid) {
  constexpr int VPC = 16 / (int)sizeof(T);   // values per 16-byte chunk
  constexpr int CPR = D / VPC, DS = D + VPC;
#pragma unroll
  for (int idx = threadIdx.x; idx < BK * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool in = first + r < n_valid;
    const T* src = base + (long long)(in ? first + r : 0) * rs + c * VPC;
    cp_async16(smem_u32(dst + r * DS + c * VPC), src, in);
  }
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename OutT, int D>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const bf16* __restrict__ q, long long qsb, long long qsh, long long qss,
    const bf16* __restrict__ k, long long ksb, long long ksh, long long kss,
    const bf16* __restrict__ v, long long vsb, long long vsh, long long vss,
    OutT* __restrict__ o, long long osb, long long osh, long long oss,
    float* __restrict__ part, int Hkv, int group, int Sq, int kv_len,
    int offset, int causal, float scale, int tiles_per_split) {
  constexpr int DS = D + 8;         // padded row of a shared tile
  constexpr int KS = D / 16;        // k-steps of Q K^T
  constexpr int NT = D / 8;         // n-tiles of P V
  extern __shared__ uint4 smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);          // [2][BK][DS]
  bf16* Vs = Ks + 2 * BK * DS;                        // [2][BK][DS]

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int R = Sq * group;
  const int MT = (R + 15) / 16;
  const int MTP = MT <= 1 ? 1 : (MT <= 2 ? 2 : 4);   // row tiles, padded
  const int NKG = 4 / MTP;                            // kv groups per tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % MTP, kg = warp / MTP;
  const bool active = mt < MT;
  const int kv_end = causal ? min(kv_len, Sq + offset) : kv_len;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  const bf16* kp = k + b * ksb + hk * ksh;
  const bf16* vp = v + b * vsb + hk * vsh;

  // Q fragments (A of m16n8k16) of rows rA = mt*16 + g and rB = rA + 8
  const int rA = mt * 16 + g, rB = rA + 8;
  const int qiA = rA / group, qiB = rB / group;
  uint32_t qa[KS][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rB : rA;
    const bf16* qr = q + b * qsb + (long long)(hk * group + r % group) * qsh +
                     (long long)(r / group) * qss;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][half] = r < R ? ld32(qr + ks * 16 + 2 * t) : 0u;
      qa[ks][2 + half] = r < R ? ld32(qr + ks * 16 + 8 + 2 * t) : 0u;
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (t0 < t1) {
    load_tile<D>(Ks, kp, kss, t0 * BK, kv_end);
    load_tile<D>(Vs, vp, vss, t0 * BK, kv_end);
  }
  cp_async_commit();
  for (int j = t0; j < t1; ++j) {
    const int st = (j - t0) & 1;
    if (j + 1 < t1) {
      load_tile<D>(Ks + (st ^ 1) * BK * DS, kp, kss, (j + 1) * BK, kv_end);
      load_tile<D>(Vs + (st ^ 1) * BK * DS, vp, vss, (j + 1) * BK, kv_end);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bf16* Kt = Ks + st * BK * DS;
    const bf16* Vt = Vs + st * BK * DS;
    for (int c = kg; active && c < BK / 16; c += NKG) {
      const int kv0 = j * BK + c * 16;
      if (kv0 >= kv_end) break;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* kr = Kt + (c * 16 + nt * 8 + g) * DS + ks * 16 + 2 * t;
          mma16816(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
        }
      // s[nt][e]: row (e < 2 ? rA : rB), column kv0 + nt*8 + 2t + (e & 1)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nt * 8 + 2 * t + (e & 1);
          const int qi = e < 2 ? qiA : qiB;
          const bool ok = col < kv_len && (!causal || col <= qi + offset);
          s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
        m[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f((s[nt][e] - m[e >> 1]) * LOG2E);
          psum[e >> 1] += p;
          s[nt][e] = p;
        }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + psum[r];
      // V rows kv0..kv0+15: matrices (rows 0-7 | 8-15) x (n-tile np | np+1)
      const int mi = lane >> 3;
      const uint32_t vaddr = smem_u32(Vt + (c * 16 + (mi & 1) * 8 +
                                            (lane & 7)) * DS + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < NT; np += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vaddr + np * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[np][e] *= alpha[e >> 1];
          acc[np + 1][e] *= alpha[e >> 1];
        }
        mma16816(acc[np], pa, bv[0], bv[1]);
        mma16816(acc[np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                       // stage st is free again
  }

  // Merge the warps' (m, l, acc) in shared memory (the ring is free).
  float* Ms = reinterpret_cast<float*>(smem);         // [4 warps][16]
  float* Ls = Ms + 64;                                 // [4 warps][16]
  float* As = Ls + 64;                                 // [4 warps][16][D]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t == 0) {
    Ms[warp * 16 + g] = m[0];
    Ms[warp * 16 + g + 8] = m[1];
    Ls[warp * 16 + g] = l[0];
    Ls[warp * 16 + g + 8] = l[1];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      As[(warp * 16 + g + (e >> 1) * 8) * D + nt * 8 + 2 * t + (e & 1)] =
          acc[nt][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int w0 = r / 16, rr = r % 16;    // warps w0 + kg * MTP hold row r
    float M = NEG_INF;
    for (int x = 0; x < NKG; ++x) M = fmaxf(M, Ms[(w0 + x * MTP) * 16 + rr]);
    float L = 0.f, A = 0.f;
    for (int x = 0; x < NKG; ++x) {
      const int w = w0 + x * MTP;
      const float wt = exp2f((Ms[w * 16 + rr] - M) * LOG2E);
      L += Ls[w * 16 + rr] * wt;
      A += As[(w * 16 + rr) * D + d] * wt;
    }
    if (nsplit == 1) {
      o[b * osb + (long long)(hk * group + r % group) * osh +
        (long long)(r / group) * oss + d] = from_f<OutT>(A / fmaxf(L, 1e-30f));
    } else {
      float* pp = part + ((long long)(blockIdx.x * nsplit + split) * R + r) *
                             (D + 2);
      pp[d] = A;
      if (d == 0) {
        pp[D] = M;
        pp[D + 1] = L;
      }
    }
  }
}

// The splits' (acc, m, l) of one (batch, kv head) into the output.
template <typename OutT, int D>
__global__ void __launch_bounds__(THREADS) flash_decode_merge_kernel(
    const float* __restrict__ part, OutT* __restrict__ o, long long osb,
    long long osh, long long oss, int Hkv, int group, int Sq, int nsplit) {
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int R = Sq * group;
  const float* pb = part + (long long)blockIdx.x * nsplit * R * (D + 2);
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s)
      M = fmaxf(M, pb[((long long)s * R + r) * (D + 2) + D]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* pp = pb + ((long long)s * R + r) * (D + 2);
      const float wt = exp2f((pp[D] - M) * LOG2E);
      L += pp[D + 1] * wt;
      A += pp[d] * wt;
    }
    o[b * osb + (long long)(hk * group + r % group) * osh +
      (long long)(r / group) * oss + d] = from_f<OutT>(A / fmaxf(L, 1e-30f));
  }
}

// The float32 decode kernel, on the CUDA cores.  One block of four warps
// per (batch, kv head, kv split) holds the group's R = Sq * group query
// rows in shared memory; the K and V tiles come through the same ring as
// the bf16 kernel's, rows padded by 16 bytes.  Per tile, three steps
// between barriers:
//   scores  thread t takes kv column t % 64 and the rows t / 64, + 2, ...,
//           RB rows at a time: q read by broadcast, the column's K row
//           as float4 (conflict-free on the padded rows), explicit fmaf;
//           masked scores are -1e30;
//   softmax a warp per row: the row max and sum by shuffles, p = exp(s -
//           m_new) once per score, the running (m, l) and this tile's
//           rescale alpha kept in shared memory;
//   P V     thread t owns dims 4 (t % (D/4)) .. + 3 of the rows t / (D/4),
//           + 128 / (D/4), ...: acc *= alpha, then acc += p v over the
//           tile's columns below kv_end, p as float4 from shared memory
//           (at D = 112, 128 threads are 4 rows of 28 float4 and 16 more,
//           which own no row).
// SMALL (R <= 4: a serve step of a GQA group of up to 4, smollm-135m's 3
// among them) scores two rows at a time and gives a thread at most one row
// of acc, so that no thread issues predicated-off products for rows it
// lacks; the other instantiation takes up to 64 rows.
constexpr int PS = BK + 4;          // padded row of the score / p tile
constexpr int SMALL_ROWS = 4;       // R of the SMALL instantiation, at most

template <int D, bool SMALL>
__global__ void __launch_bounds__(THREADS) flash_decode_f32_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qss,
    const float* __restrict__ k, long long ksb, long long ksh, long long kss,
    const float* __restrict__ v, long long vsb, long long vsh, long long vss,
    float* __restrict__ o, long long osb, long long osh, long long oss,
    float* __restrict__ part, int Hkv, int group, int Sq, int kv_len,
    int offset, int causal, float scale, int tiles_per_split) {
  constexpr int DS = D + 4;         // padded row of a shared tile
  constexpr int D4 = D / 4;         // float4 chunks of a row
  constexpr int RPH = THREADS / D4; // row phases of the P V step
  const bool owner = threadIdx.x < RPH * D4;   // owns rows of acc
  constexpr int RB = SMALL ? 2 : 4;  // query rows a thread scores at once
  constexpr int NJ = SMALL ? 1 : (MAX_ROWS + RPH - 1) / RPH;  // acc rows
  extern __shared__ uint4 smem[];
  float* Ks = reinterpret_cast<float*>(smem);        // [2][BK][DS]
  float* Vs = Ks + 2 * BK * DS;                       // [2][BK][DS]
  const int R = Sq * group;
  float* Qs = Vs + 2 * BK * DS;                       // [R][D]
  float* SP = Qs + R * D;                             // [R][PS]
  float* Ms = SP + R * PS;                            // [R] running max
  float* Ls = Ms + MAX_ROWS;                          // [R] running sum
  float* As = Ls + MAX_ROWS;                          // [R] tile rescale

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int kv_end = causal ? min(kv_len, Sq + offset) : kv_len;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  const float* kp = k + b * ksb + hk * ksh;
  const float* vp = v + b * vsb + hk * vsh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = threadIdx.x % BK, rp = threadIdx.x / BK;
  const int d4 = threadIdx.x % D4, rph = threadIdx.x / D4;

  // Q rows (row r: query r / group of head hk * group + r % group), once,
  // in the first tile's copy group
  for (int idx = threadIdx.x; idx < R * D4; idx += THREADS) {
    const int r = idx / D4, x = idx % D4;
    const float* src = q + b * qsb + (long long)(hk * group + r % group) *
                       qsh + (long long)(r / group) * qss + x * 4;
    cp_async16(smem_u32(Qs + r * D + x * 4), src, true);
  }
  for (int r = threadIdx.x; r < R; r += THREADS) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.f;
  }
  if (t0 < t1) {
    load_tile<D>(Ks, kp, kss, t0 * BK, kv_end);
    load_tile<D>(Vs, vp, vss, t0 * BK, kv_end);
  }
  cp_async_commit();

  float4 acc[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j = t0; j < t1; ++j) {
    const int st = (j - t0) & 1;
    if (j + 1 < t1) {
      load_tile<D>(Ks + (st ^ 1) * BK * DS, kp, kss, (j + 1) * BK, kv_end);
      load_tile<D>(Vs + (st ^ 1) * BK * DS, vp, vss, (j + 1) * BK, kv_end);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* Kt = Ks + st * BK * DS;
    const float* Vt = Vs + st * BK * DS;

    // scores of column col against rows rp, rp + 2, ...
    const int col = j * BK + c;
    const float4* kr = reinterpret_cast<const float4*>(Kt + c * DS);
    for (int r0 = rp; r0 < R; r0 += 2 * RB) {
      const float4* qr[RB];
      float s[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        qr[i] = reinterpret_cast<const float4*>(Qs + min(r0 + 2 * i, R - 1) *
                                                         D);
        s[i] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < D4; ++x) {
        const float4 kk = kr[x];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float4 qq = qr[i][x];
          s[i] = fmaf(qq.x, kk.x, s[i]);
          s[i] = fmaf(qq.y, kk.y, s[i]);
          s[i] = fmaf(qq.z, kk.z, s[i]);
          s[i] = fmaf(qq.w, kk.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = r0 + 2 * i;
        if (r < R) {
          const bool ok =
              col < kv_len && (!causal || col <= r / group + offset);
          SP[r * PS + c] = ok ? s[i] * scale : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax, a warp per row
    for (int r = warp; r < R; r += THREADS / 32) {
      float* sr = SP + r * PS;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[r] = alpha;
        Ls[r] = alpha * Ls[r] + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p v over the columns below kv_end (p is 0 past
    // them, or V's zero-filled rows are)
    const int nc4 = (min(BK, kv_end - j * BK) + 3) / 4;
    const float4* vt = reinterpret_cast<const float4*>(Vt) + d4;
    if (owner && (!SMALL || rph < R)) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int r = rph + RPH * jj;
        if (SMALL || r < R) {
          const float a = As[r];
          acc[jj].x *= a;
          acc[jj].y *= a;
          acc[jj].z *= a;
          acc[jj].w *= a;
        }
      }
#pragma unroll 4
      for (int c4 = 0; c4 < nc4; ++c4) {
        const float4 v0 = vt[(4 * c4 + 0) * (DS / 4)];
        const float4 v1 = vt[(4 * c4 + 1) * (DS / 4)];
        const float4 v2 = vt[(4 * c4 + 2) * (DS / 4)];
        const float4 v3 = vt[(4 * c4 + 3) * (DS / 4)];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int r = rph + RPH * jj;
          if (SMALL || r < R) {
            const float4 p =
                *reinterpret_cast<const float4*>(SP + r * PS + 4 * c4);
            float4& a = acc[jj];
            a.x = fmaf(p.x, v0.x, a.x);
            a.y = fmaf(p.x, v0.y, a.y);
            a.z = fmaf(p.x, v0.z, a.z);
            a.w = fmaf(p.x, v0.w, a.w);
            a.x = fmaf(p.y, v1.x, a.x);
            a.y = fmaf(p.y, v1.y, a.y);
            a.z = fmaf(p.y, v1.z, a.z);
            a.w = fmaf(p.y, v1.w, a.w);
            a.x = fmaf(p.z, v2.x, a.x);
            a.y = fmaf(p.z, v2.y, a.y);
            a.z = fmaf(p.z, v2.z, a.z);
            a.w = fmaf(p.z, v2.w, a.w);
            a.x = fmaf(p.w, v3.x, a.x);
            a.y = fmaf(p.w, v3.y, a.y);
            a.z = fmaf(p.w, v3.z, a.z);
            a.w = fmaf(p.w, v3.w, a.w);
          }
        }
      }
    }
    __syncthreads();                       // stage st and SP are free again
  }
  __syncthreads();                         // (m, l) of a block with no tile

#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int r = rph + RPH * jj;
    if (!owner || r >= R) continue;
    const float4 a = acc[jj];
    if (nsplit == 1) {
      const float den = fmaxf(Ls[r], 1e-30f);
      *reinterpret_cast<float4*>(
          o + b * osb + (long long)(hk * group + r % group) * osh +
          (long long)(r / group) * oss + 4 * d4) =
          make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
    } else {
      float* pp = part + ((long long)(blockIdx.x * nsplit + split) * R + r) *
                             (D + 2);
      pp[4 * d4 + 0] = a.x;
      pp[4 * d4 + 1] = a.y;
      pp[4 * d4 + 2] = a.z;
      pp[4 * d4 + 3] = a.w;
      if (d4 == 0) {
        pp[D] = Ms[r];
        pp[D + 1] = Ls[r];
      }
    }
  }
}

template <typename OutT, int D>
int launch(const void* q, long long qsb, long long qsh, long long qss,
           const void* k, long long ksb, long long ksh, long long kss,
           const void* v, long long vsb, long long vsh, long long vss,
           void* o, long long osb, long long osh, long long oss, void* part,
           int B, int H, int Hkv, int Sq, int kv_len, int offset, int causal,
           int splits, int tiles_per_split, cudaStream_t stream) {
  const int smem = 2 * 2 * BK * (D + 8) * (int)sizeof(bf16);
  auto kernel = flash_decode_kernel<OutT, D>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int group = H / Hkv;
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<dim3(B * Hkv, splits), THREADS, smem, stream>>>(
      (const bf16*)q, qsb, qsh, qss, (const bf16*)k, ksb, ksh, kss,
      (const bf16*)v, vsb, vsh, vss, (OutT*)o, osb, osh, oss, (float*)part,
      Hkv, group, Sq, kv_len, offset, causal, scale, tiles_per_split);
  if (splits > 1)
    flash_decode_merge_kernel<OutT, D><<<B * Hkv, THREADS, 0, stream>>>(
        (const float*)part, (OutT*)o, osb, osh, oss, Hkv, group, Sq, splits);
  return (int)cudaGetLastError();
}

template <int D, bool SMALL>
int launch_f32_rows(const float* q, long long qsb, long long qsh,
                    long long qss, const float* k, long long ksb,
                    long long ksh, long long kss, const float* v,
                    long long vsb, long long vsh, long long vss, float* o,
                    long long osb, long long osh, long long oss, float* part,
                    int B, int Hkv, int group, int Sq, int kv_len, int offset,
                    int causal, int splits, int tiles_per_split,
                    cudaStream_t stream) {
  // K and V rings, Q and the score tile of R rows, three row statistics
  const auto bytes = [](int rows) {
    return (4 * BK * (D + 4) + rows * (D + PS) + 3 * MAX_ROWS) *
           (int)sizeof(float);
  };
  auto kernel = flash_decode_f32_kernel<D, SMALL>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes(SMALL ? SMALL_ROWS : MAX_ROWS));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<dim3(B * Hkv, splits), THREADS, bytes(Sq * group), stream>>>(
      q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, osb, osh, oss,
      part, Hkv, group, Sq, kv_len, offset, causal, scale, tiles_per_split);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, long long qsb, long long qsh, long long qss,
               const void* k, long long ksb, long long ksh, long long kss,
               const void* v, long long vsb, long long vsh, long long vss,
               void* o, long long osb, long long osh, long long oss,
               void* part, int B, int H, int Hkv, int Sq, int kv_len,
               int offset, int causal, int splits, int tiles_per_split,
               cudaStream_t stream) {
  const int group = H / Hkv;
#define FD_ROWS_ARGS (const float*)q, qsb, qsh, qss, (const float*)k, ksb,  \
                     ksh, kss, (const float*)v, vsb, vsh, vss, (float*)o,   \
                     osb, osh, oss, (float*)part, B, Hkv, group, Sq,        \
                     kv_len, offset, causal, splits, tiles_per_split, stream
  const int err = Sq * group <= SMALL_ROWS
                      ? launch_f32_rows<D, true>(FD_ROWS_ARGS)
                      : launch_f32_rows<D, false>(FD_ROWS_ARGS);
#undef FD_ROWS_ARGS
  if (err != 0) return err;
  if (splits > 1)
    flash_decode_merge_kernel<float, D><<<B * Hkv, THREADS, 0, stream>>>(
        (const float*)part, (float*)o, osb, osh, oss, Hkv, group, Sq, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 inputs; out_code 0 float32, 1 bfloat16.  Strides are in
// elements; the head dimension is contiguous and every row 16-byte
// aligned (the wrapper checks both).  With splits > 1, part is a float32
// scratch of B * Hkv * splits * Sq * (H / Hkv) * (D + 2) elements and
// tiles_per_split * splits covers the block's kv tiles.
extern "C" int flash_decode_launch(
    const void* q, long long qsb, long long qsh, long long qss,
    const void* k, long long ksb, long long ksh, long long kss,
    const void* v, long long vsb, long long vsh, long long vss,
    void* o, long long osb, long long osh, long long oss, void* part, int B,
    int H, int Hkv, int Sq, int Skv, int D, int kv_len, int offset,
    int causal, int splits, int tiles_per_split, int out_code,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      Sq * (H / Hkv) > MAX_ROWS || kv_len < 1 || kv_len > Skv ||
      splits < 1 || tiles_per_split < 1 || (splits > 1 && part == nullptr) ||
      (out_code != 0 && out_code != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FD_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, osb, \
                osh, oss, part, B, H, Hkv, Sq, kv_len, offset, causal,       \
                splits, tiles_per_split, st
#define FD_CALL(DD)                                                          \
  (out_code == 0 ? launch<float, DD>(FD_ARGS)                                \
                 : launch<__nv_bfloat16, DD>(FD_ARGS))
  switch (D) {
    case 16: return FD_CALL(16);
    case 64: return FD_CALL(64);
    case 112: return FD_CALL(112);
    case 128: return FD_CALL(128);
  }
#undef FD_CALL
#undef FD_ARGS
  return (int)cudaErrorInvalidValue;
}

// float32 inputs and output (out_code 0), the arguments of
// flash_decode_launch; every row 16-byte aligned (the wrapper checks it).
extern "C" int flash_decode_f32_launch(
    const void* q, long long qsb, long long qsh, long long qss,
    const void* k, long long ksb, long long ksh, long long kss,
    const void* v, long long vsb, long long vsh, long long vss,
    void* o, long long osb, long long osh, long long oss, void* part, int B,
    int H, int Hkv, int Sq, int Skv, int D, int kv_len, int offset,
    int causal, int splits, int tiles_per_split, int out_code,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      Sq * (H / Hkv) > MAX_ROWS || kv_len < 1 || kv_len > Skv ||
      splits < 1 || tiles_per_split < 1 || (splits > 1 && part == nullptr) ||
      out_code != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FD_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, osb, \
                osh, oss, part, B, H, Hkv, Sq, kv_len, offset, causal,       \
                splits, tiles_per_split, st
  switch (D) {
    case 16: return launch_f32<16>(FD_ARGS);
    case 64: return launch_f32<64>(FD_ARGS);
    case 112: return launch_f32<112>(FD_ARGS);
    case 128: return launch_f32<128>(FD_ARGS);
  }
#undef FD_ARGS
  return (int)cudaErrorInvalidValue;
}
