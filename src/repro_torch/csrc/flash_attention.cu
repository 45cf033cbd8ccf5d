// Flash attention (K10) for Hopper (sm_90a), the float32 prefill kernel:
// causal or bidirectional GQA attention with an online softmax on the CUDA
// cores, register-tiled as an SGEMM is.
//
// Replaces the TPU kernel
//   src/repro/kernels/attention/flash.py::flash_attention_pallas
//   (_flash_kernel, and the padding wrapper kernels/attention/ops.py)
// for float32 inputs whose Sq * group is above 64
// (kernels/attention/flash.py::variant); float32 decode steps run
// flash_decode.cu's float32 kernel, bfloat16 inputs the tensor cores
// (flash_prefill.cu, flash_decode.cu).  TF32 products would not meet the
// float32 tolerance of 1e-5, so the products are explicit fmaf (the shared
// build flags forbid contraction).
//
// Function (that of the Pallas kernel): query head h reads kv head
// h / (H / Hkv); s = (q . k) * (1/sqrt(D)) in float32; masked entries
// (causal: col > row + offset; always: col >= kv_len) take the finite
// -1e30, not -inf; a running (acc, m, l) per row in float32, with
// p = exp(s - m_new) summed into l (p cast to v's dtype is a no-op in
// float32); the output acc / max(l, 1e-30).  A kv tile that is entirely
// masked for a row adds p = exp(-1e30 - m) = 0; the wrapper refuses a
// geometry that leaves a row no valid column at all.
//
// What bounds it on this card: operations.  At a prefill of B = 4,
// S = 2048, H = 9, D = 64 (causal) the work is 2 * B * H * S^2 * D = 1.9e10
// FLOPs, 0.29 ms at the 67 TFLOP/s of float32 on the CUDA cores, against
// 21 MB of inputs and output.
//
// Design: one block of 128 threads per (batch * head, 64 query rows), the
// blocks of the longest causal rows issued first.  Q is staged once in
// shared memory, transposed to [D][64]; 64-row K and V tiles come through
// a two-stage cp.async ring (16-byte copies, zero fill past the block's
// last kv column, rows padded by 16 bytes so that the reads below are free
// of bank conflicts).  Thread (ty, tx), ty < 8, tx < 16, owns query rows
// 8 ty .. 8 ty + 7:
//   S = Q K^T  an 8 x 4 micro-tile (kv columns tx + 16 n) as outer
//              products over d: per four d, four K float4 and eight Q
//              float4 feed 128 fmaf;
//   softmax    the mask only on diagonal and tail tiles; the row max by
//              four shuffles over the 16 threads of a row, once per tile;
//              exp once per element; each thread sums its own columns
//              into l, and the row's 16 partial sums are added once, at
//              the end (they share every rescale);
//   O += P V   P goes transposed to shared memory ([64][64 + 4]; a row's
//              16 threads are one half-warp, so a __syncwarp orders it);
//              the thread's acc is its 8 rows x D / 16 dims (dims 4 tx ..
//              4 tx + 3 in each 64, or tx at D = 16): per kv column two P
//              float4 and D / 64 V float4 feed 8 D / 16 fmaf.
// The kv loop stops at min(kv_len, the causal limit of the block's last
// row); the P V step stops at the tile's last column below it.  Every
// tensor is read through its strides, so the model's [B, S, H, D]
// activations and [B, S, Hkv, D] cache go in without a transposed copy,
// and ragged Sq and Skv are masked here rather than padded.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // kv rows per tile
constexpr int THREADS = 128;
constexpr int TM = 8;                  // query rows per thread
constexpr int TN = 4;                  // kv columns per thread in S
constexpr int TX = BK / TN;            // threads that share a row: 16
constexpr int PS = BQ + 4;             // padded row of the P^T tile

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

// Rows first .. first + 63 of a [rows, D] view into a [64][D + 4] tile;
// rows at and past n_valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long rs, int first,
                                          int n_valid) {
  constexpr int CPR = D / 4, DS = D + 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < BK * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool in = first + r < n_valid;
    const float* src = base + (long long)(in ? first + r : 0) * rs + c * 4;
    cp_async16(smem_u32(dst + r * DS + c * 4), src, in);
  }
}

__device__ __forceinline__ float component(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qss,
    const float* __restrict__ k, long long ksb, long long ksh, long long kss,
    const float* __restrict__ v, long long vsb, long long vsh, long long vss,
    float* __restrict__ o, long long osb, long long osh, long long oss,
    int H, int group, int Sq, int kv_len, int offset, int causal,
    float scale) {
  constexpr int DS = D + 4;            // padded row of a K or V tile
  constexpr int DN = D / TX;           // output dims per thread: 1, 4, 8
  extern __shared__ float4 smem[];
  float* Ks = reinterpret_cast<float*>(smem);        // [2][BK][DS]
  float* Vs = Ks + 2 * BK * DS;                       // [2][BK][DS]
  float* Qt = Vs + 2 * BK * DS;                       // [D][BQ]
  float* Pt = Qt + D * BQ;                            // [BK][PS]

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(kv_len, last_row + offset + 1) : kv_len;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const float* kp = k + b * ksb + hk * ksh;
  const float* vp = v + b * vsb + hk * vsh;

  load_tile<D>(Ks, kp, kss, 0, kv_end);
  load_tile<D>(Vs, vp, vss, 0, kv_end);
  cp_async_commit();
  // Q transposed, once: consecutive threads take consecutive rows
  const float* qp = q + b * qsb + h * qsh;
  for (int idx = threadIdx.x; idx < BQ * (D / 4); idx += THREADS) {
    const int r = idx % BQ, x = idx / BQ, row = q0 + r;
    const float4 qq =
        row < Sq ? *reinterpret_cast<const float4*>(qp + (long long)row * qss +
                                                    4 * x)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    Qt[(4 * x + 0) * BQ + r] = qq.x;
    Qt[(4 * x + 1) * BQ + r] = qq.y;
    Qt[(4 * x + 2) * BQ + r] = qq.z;
    Qt[(4 * x + 3) * BQ + r] = qq.w;
  }

  float acc[TM][DN], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DN; ++d) acc[i][d] = 0.f;
  }
  const float* qt = Qt + ty * TM;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, j0 = j * BK;
    if (j + 1 < n_tiles) {
      load_tile<D>(Ks + (st ^ 1) * BK * DS, kp, kss, j0 + BK, kv_end);
      load_tile<D>(Vs + (st ^ 1) * BK * DS, vp, vss, j0 + BK, kv_end);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* Kt = Ks + st * BK * DS;
    const float* Vt = Vs + st * BK * DS;

    // S = Q K^T: rows 8 ty + i, columns tx + 16 n
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) s[i][n] = 0.f;
#pragma unroll
    for (int x = 0; x < D / 4; ++x) {
      float4 kk[TN];
#pragma unroll
      for (int n = 0; n < TN; ++n)
        kk[n] = *reinterpret_cast<const float4*>(Kt + (tx + TX * n) * DS +
                                                 4 * x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 qa = *reinterpret_cast<const float4*>(qt + (4 * x + e) *
                                                                    BQ);
        const float4 qb = *reinterpret_cast<const float4*>(qt + (4 * x + e) *
                                                                    BQ + 4);
        const float qv[TM] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int n = 0; n < TN; ++n)
            s[i][n] = fmaf(qv[i], component(kk[n], e), s[i][n]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) s[i][n] *= scale;
    if (j0 + BK > kv_len || (causal && j0 + BK - 1 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const int col = j0 + tx + TX * n, row = q0 + ty * TM + i;
          if (col >= kv_len || (causal && col > row + offset))
            s[i][n] = NEG_INF;
        }
    }

    // online softmax: the row max over its 16 threads, exp once each
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int w = 1; w < TX; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        s[i][n] = expf(s[i][n] - m_new);
        ps += s[i][n];
      }
      l[i] = alpha * l[i] + ps;
#pragma unroll
      for (int d = 0; d < DN; ++d) acc[i][d] *= alpha;
    }
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      float* pc = Pt + (tx + TX * n) * PS + ty * TM;
      *reinterpret_cast<float4*>(pc) =
          make_float4(s[0][n], s[1][n], s[2][n], s[3][n]);
      *reinterpret_cast<float4*>(pc + 4) =
          make_float4(s[4][n], s[5][n], s[6][n], s[7][n]);
    }
    __syncwarp();                    // a row's P comes from its half-warp

    // O += P V over the tile's columns below kv_end
    const int nc = min(BK, kv_end - j0);
    const float* pt = Pt + ty * TM;
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * PS);
      const float4 pb = *reinterpret_cast<const float4*>(pt + c * PS + 4);
      const float pv[TM] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[DN];
      if constexpr (DN == 1) {
        vv[0] = Vt[c * DS + tx];
      } else {
#pragma unroll
        for (int g = 0; g < DN / 4; ++g) {
          const float4 x =
              *reinterpret_cast<const float4*>(Vt + c * DS + g * 64 + tx * 4);
          vv[4 * g + 0] = x.x;
          vv[4 * g + 1] = x.y;
          vv[4 * g + 2] = x.z;
          vv[4 * g + 3] = x.w;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int d = 0; d < DN; ++d) acc[i][d] = fmaf(pv[i], vv[d], acc[i][d]);
    }
    __syncthreads();                 // stage st and P^T are free again
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int w = 1; w < TX; w <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
    const int row = q0 + ty * TM + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* op = o + b * osb + h * osh + (long long)row * oss;
    if constexpr (DN == 1) {
      op[tx] = acc[i][0] / den;
    } else {
#pragma unroll
      for (int g = 0; g < DN / 4; ++g)
        *reinterpret_cast<float4*>(op + g * 64 + tx * 4) = make_float4(
            acc[i][4 * g] / den, acc[i][4 * g + 1] / den,
            acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den);
    }
  }
}

template <int D>
int launch(const void* q, long long qsb, long long qsh, long long qss,
           const void* k, long long ksb, long long ksh, long long kss,
           const void* v, long long vsb, long long vsh, long long vss,
           void* o, long long osb, long long osh, long long oss, int B, int H,
           int Hkv, int Sq, int kv_len, int offset, int causal,
           cudaStream_t stream) {
  // K and V rings, Q^T, P^T
  const int smem = (4 * BK * (D + 4) + D * BQ + BK * PS) * (int)sizeof(float);
  auto kernel = flash_attention_kernel<D>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)q, qsb, qsh, qss, (const float*)k, ksb, ksh, kss,
      (const float*)v, vsb, vsh, vss, (float*)o, osb, osh, oss, H, H / Hkv,
      Sq, kv_len, offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 inputs and output.  Strides are in elements; the head dimension
// of every tensor is contiguous and every row 16-byte aligned (the wrapper
// checks both).
extern "C" int flash_attention_launch(
    const void* q, long long qsb, long long qsh, long long qss,
    const void* k, long long ksb, long long ksh, long long kss,
    const void* v, long long vsb, long long vsh, long long vss,
    void* o, long long osb, long long osh, long long oss, int B, int H,
    int Hkv, int Sq, int Skv, int D, int kv_len, int offset, int causal,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      kv_len < 1 || kv_len > Skv)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FA_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, osb, \
                osh, oss, B, H, Hkv, Sq, kv_len, offset, causal, st
  switch (D) {
    case 16: return launch<16>(FA_ARGS);
    case 64: return launch<64>(FA_ARGS);
    case 128: return launch<128>(FA_ARGS);
  }
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}
