// Flash attention (K10), the prefill and bidirectional kernel for Hopper
// (sm_90a): bf16 inputs, QK^T and PV on the tensor cores with wgmma.
//
// Replaces the TPU kernel
//   src/repro/kernels/attention/flash.py::flash_attention_pallas
//   (_flash_kernel, and the padding wrapper kernels/attention/ops.py)
// for bfloat16 inputs whose Sq * group is above the decode kernel's 64 rows
// (kernels/attention/flash.py::variant); float32 inputs run the CUDA-core
// kernel of flash_attention.cu, a decode step flash_decode.cu.
//
// Function (that of the Pallas kernel): query head h reads kv head
// h / (H / Hkv); s = (q . k) * (1/sqrt(D)) in float32; masked entries
// (causal: col > row + offset; always: col >= kv_len) take the finite
// -1e30; a running (acc, m, l) per row in float32, with p = exp(s - m_new)
// summed into l unrounded and rounded to bf16 for the product with v; the
// output acc / max(l, 1e-30) in float32 or bf16.  bf16 products are exact
// in float32, so against the CUDA-core kernel only the order of the
// float32 sums changes, and exp(x) is computed as exp2(x * log2(e)).
//
// What bounds it on this card: operations.  At the serve path's prefill
// (B = 4, S = 2048, H = 9, Hkv = 3, D = 64, causal) the work is
// 2 * B * H * S^2 * D = 1.9e10 FLOPs, 0.020 ms at the 989 TFLOP/s of bf16
// on the tensor cores, against 35 MB of inputs and output.
//
// Design: one warpgroup (128 threads) per (batch * head, tile of 64 query
// rows), the tiles of the longest causal rows issued first.  The Q tile
// and a two-stage ring of 64-row K and V tiles live in shared memory as
// bf16, in the 128-byte-swizzled layout that wgmma reads (rows of 64
// values; D = 128 takes two such column blocks, D = 16 fills a quarter of
// one).  The tiles are filled by cp.async with zero fill past Sq and past
// the block's last kv column, so the copy of tile j + 1 runs under the
// products of tile j.  S = Q K^T is a chain of m64n64k16 wgmma with both
// operands in shared memory (K-major); the masked online softmax runs on
// S in registers (each thread holds two rows' quarter); P goes to the PV
// product straight from registers as the bf16 A operand, against V read
// MN-major (transposed) from shared memory.  Every tensor is read through
// its strides (16-byte aligned rows), so the model's [B, S, H, D] views go
// in without a copy.  The kv loop stops at min(kv_len, the causal limit of
// the block's last row); tiles wholly above the diagonal are never read.
// Head sizes 16, 64 and 128 have their own instantiations; 112 (zamba2-7b's)
// runs the 128 body: K, Q and V zero-filled past column 112 (cp.async with
// a source size of 0, so nothing past it is read), seven k-steps of Q K^T,
// the scale 1/sqrt(112), and only the 112 columns stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;              // query rows per block, 16 per warp
constexpr int BK = 64;              // kv rows per tile
constexpr int THREADS = 128;        // one warpgroup
constexpr int BLOCK = 64 * 128;     // bytes of a [64 rows][64 bf16] block

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 values) of row r in a 64-row tile kept
// as [c / 8][64 rows][128 bytes] with the 128-byte swizzle (chunk ^ row%8).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)((c >> 3) * BLOCK + r * 128 + (((c & 7) ^ (r & 7)) << 4));
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

// Rows first .. first + 63 of a [rows, DV] view (row stride rs elements)
// into a swizzled tile of D columns; rows at and past n_valid, and columns
// at and past DV, are zero-filled.
template <int D, int DV>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long long rs, int first,
                                          int n_valid) {
  constexpr int CPR = D / 8;        // 16-byte chunks per row
#pragma unroll
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool in = first + r < n_valid && c * 8 < DV;
    const bf16* src =
        base + (long long)(in ? first + r : 0) * rs + (in ? c * 8 : 0);
    cp_async16(dst + sw128(r, c), src, in);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.  Both byte offsets are
// the 1024 bytes between groups of 8 rows: the K-major operands never span
// two swizzle atoms along k (16 values = 32 bytes), and each product below
// spans one 64-column atom along N, so neither reads a second offset.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define WG_D32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define WG_OUT32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, m64n64k16: A [64 x 16] and B [16 x 64] both K-major in
// shared memory; d is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_OUT32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16: A from registers (the accumulator layout of S, as
// bf16 pairs), B [16 x 64] MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_OUT32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// D: the tile's row of values (16, 64 or 128); DV <= D: the head size.
// A head size of 112 runs the D = 128 body: its last 16 columns are
// zero-filled on load, skipped by Q K^T, and never stored.
template <typename OutT, int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const bf16* __restrict__ q, long long qsb, long long qsh, long long qss,
    const bf16* __restrict__ k, long long ksb, long long ksh, long long kss,
    const bf16* __restrict__ v, long long vsb, long long vsh, long long vss,
    OutT* __restrict__ o, long long osb, long long osh, long long oss, int H,
    int group, int Sq, int kv_len, int offset, int causal, float scale) {
  constexpr int NB = D > 64 ? D / 64 : 1;    // 64-column blocks of a row
  constexpr int TILE = NB * BLOCK;           // bytes of one Q, K or V tile
  constexpr int KSTEPS = DV / 16;            // k-steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t sQ = base, sK = base + TILE, sV = base + 3 * TILE;

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rowA = q0 + warp * 16 + g, rowB = rowA + 8;
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(kv_len, last_row + offset + 1) : kv_len;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const bf16* kp = k + b * ksb + hk * ksh;
  const bf16* vp = v + b * vsb + hk * vsh;

  if (D < 64) {
    // V's unused columns feed only output columns that are not stored;
    // zero them so that they hold no NaN patterns.
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (base - raw) + 3 * TILE);
    for (int i = threadIdx.x; i < 2 * TILE / 16; i += THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  load_tile<D, DV>(sQ, q + b * qsb + h * qsh, qss, q0, Sq);
  load_tile<D, DV>(sK, kp, kss, 0, kv_end);
  load_tile<D, DV>(sV, vp, vss, 0, kv_end);
  cp_async_commit();

  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D, DV>(sK + (st ^ 1) * TILE, kp, kss, (j + 1) * BK, kv_end);
      load_tile<D, DV>(sV + (st ^ 1) * TILE, vp, vss, (j + 1) * BK, kv_end);
    }
    cp_async_commit();
    cp_async_wait1();                      // tile j (and Q) has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk >> 2) * BLOCK + (kk & 3) * 32;
      wgmma_ss(s, desc(sQ + off), desc(sK + st * TILE + off), kk);
    }
    wgmma_commit_wait();
    fence_regs(s);

    // s[4i + e]: row (e < 2 ? rowA : rowB), column j0 + 8i + 2t + (e & 1)
    const int j0 = j * BK;
    const bool full = j0 + BK <= kv_len && (!causal || j0 + BK - 1 <= q0 +
                                                            offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + 8 * i + 2 * t + (e & 1);
        const int row = e < 2 ? rowA : rowB;
        const bool ok = full || (col < kv_len && (!causal ||
                                                  col <= row + offset));
        s[4 * i + e] = ok ? s[4 * i + e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
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
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f((s[i] - m[(i >> 1) & 1]) * LOG2E);
      psum[(i >> 1) & 1] += p;
      s[i] = p;
    }
    // P as the A operand of m64n64k16, one k-step per 16 columns
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + psum[r];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] *= alpha[(i >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[nb], pa[kk],
                 desc(sV + st * TILE + nb * BLOCK + kk * 2048));
    wgmma_commit_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    __syncthreads();                       // stage st is free again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rowB : rowA;
    if (row >= Sq) continue;
    OutT* op = o + b * osb + h * osh + (long long)row * oss;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = nb * 64 + 8 * i + 2 * t;
        if (nb * 64 + 8 * i < DV)
          store2(op + col, acc[nb][4 * i + 2 * half] / den[half],
                 acc[nb][4 * i + 2 * half + 1] / den[half]);
      }
  }
}

template <typename OutT, int D, int DV = D>
int launch(const void* q, long long qsb, long long qsh, long long qss,
           const void* k, long long ksb, long long ksh, long long kss,
           const void* v, long long vsb, long long vsh, long long vss,
           void* o, long long osb, long long osh, long long oss, int B, int H,
           int Hkv, int Sq, int kv_len, int offset, int causal,
           cudaStream_t stream) {
  constexpr int NB = D > 64 ? D / 64 : 1;
  const int smem = 5 * NB * BLOCK + 1024;  // Q, 2 K and 2 V tiles, align
  auto kernel = flash_prefill_kernel<OutT, D, DV>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)DV));   // the head size's
  kernel<<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, qsb, qsh, qss, (const bf16*)k, ksb, ksh, kss,
      (const bf16*)v, vsb, vsh, vss, (OutT*)o, osb, osh, oss, H, H / Hkv, Sq,
      kv_len, offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 inputs; out_code 0 float32, 1 bfloat16.  Strides are in
// elements; the head dimension is contiguous and every row 16-byte
// aligned (the wrapper checks both).
extern "C" int flash_prefill_launch(
    const void* q, long long qsb, long long qsh, long long qss,
    const void* k, long long ksb, long long ksh, long long kss,
    const void* v, long long vsb, long long vsh, long long vss,
    void* o, long long osb, long long osh, long long oss, int B, int H,
    int Hkv, int Sq, int Skv, int D, int kv_len, int offset, int causal,
    int out_code, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      kv_len < 1 || kv_len > Skv || (out_code != 0 && out_code != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FP_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, osb, \
                osh, oss, B, H, Hkv, Sq, kv_len, offset, causal, st
#define FP_CALL(DD, DV)                                                      \
  (out_code == 0 ? launch<float, DD, DV>(FP_ARGS)                            \
                 : launch<__nv_bfloat16, DD, DV>(FP_ARGS))
  switch (D) {
    case 16: return FP_CALL(16, 16);
    case 64: return FP_CALL(64, 64);
    case 112: return FP_CALL(128, 112);
    case 128: return FP_CALL(128, 128);
  }
#undef FP_CALL
#undef FP_ARGS
  return (int)cudaErrorInvalidValue;
}
