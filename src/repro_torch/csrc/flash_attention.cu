// Flash attention (K10) for Hopper (sm_90a), the float32 kernel: causal
// or bidirectional GQA attention with an online softmax on the CUDA cores.
//
// Replaces the TPU kernel
//   src/repro/kernels/attention/flash.py::flash_attention_pallas
//   (_flash_kernel, and the padding wrapper kernels/attention/ops.py)
// for float32 inputs.  bfloat16 inputs run on the tensor cores instead:
// flash_prefill.cu (wgmma) where Sq * group is above 64, flash_decode.cu
// (one block per GQA group, mma.sync) at and below it; the choice is
// kernels/attention/flash.py::variant.  TF32 products would not meet the
// float32 tolerance of 1e-5, so float32 stays on the CUDA cores.
//
// Function (that of the Pallas kernel): query head h reads kv head
// h / (H / Hkv); s = (q . k) * (1/sqrt(D)) in float32; masked entries
// (causal: col > row + offset; always: col >= kv_len) take the finite
// -1e30, not -inf; a running (acc, m, l) per row in float32, with
// p = exp(s - m_new) summed into l and cast to the inputs' type before
// the product with v; the output acc / max(l, 1e-30) in float32.  A kv
// tile that is entirely masked for a row adds p = exp(-1e30 - m) = 0; the
// wrapper refuses a geometry that leaves a row no valid column at all.
//
// What bounds it on this card: operations.  At a prefill of B = 4,
// S = 2048, H = 9, D = 64 (causal) the work is 2 * B * H * S^2 * D = 1.9e10
// FLOPs, 0.28 ms at the 67 TFLOP/s of float32 on the CUDA cores.
//
// Design: explicit fmaf (the shared build flags forbid contraction); one
// block of 256 threads per (batch * head, tile of 64 query rows), four
// threads per query row, each holding a quarter of the row's q and acc in
// registers (dims i*16 + lane*4 + c, so the four lanes of a row read 64
// consecutive bytes of a shared-memory row).  K and V tiles of 64 rows are
// staged in shared memory; a tile's 64 scores stay in registers, reduced
// over the four lanes with two shuffles.  Every tensor is read through its
// strides, so the model's [B, S, H, D] activations and [B, S, Hkv, D]
// cache go in without a transposed copy, and ragged Sq and Skv are masked
// here rather than padded.  The kv loop stops at min(kv_len, the causal
// limit of the block's last row).  The blocks of the longest causal rows
// are issued first.  The kernel is a template over the input and output
// types; only float32 -> float32 is instantiated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // kv rows per shared-memory tile
constexpr int LANES = 4;               // threads per query row
constexpr int THREADS = BQ * LANES;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, long long qsb, long long qsh, long long qss,
    const T* __restrict__ k, long long ksb, long long ksh, long long kss,
    const T* __restrict__ v, long long vsb, long long vsh, long long vss,
    OutT* __restrict__ o, long long osb, long long osh, long long oss,
    int H, int group, int Sq, int kv_len, int offset, int causal, float scale) {
  constexpr int NV = D / 16;           // float4 slices of a row per thread
  constexpr int DL = NV * 4;           // dims per thread
  extern __shared__ float4 smem[];
  float* Ks = reinterpret_cast<float*>(smem);        // [BK][D]
  float* Vs = Ks + BK * D;                           // [BK][D]

  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int r = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int row = q0 + r;
  const bool live = row < Sq;

  float qr[DL], acc[DL];
  const T* qp = q + b * qsb + h * qsh + (long long)(live ? row : 0) * qss;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      qr[i * 4 + c] = live ? to_f(qp[i * 16 + lane * 4 + c]) : 0.f;
      acc[i * 4 + c] = 0.f;
    }
  float m = NEG_INF, l = 0.f;

  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(kv_len, last_row + offset + 1) : kv_len;
  const T* kp = k + b * ksb + hk * ksh;
  const T* vp = v + b * vsb + hk * vsh;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();                                  // previous tile done
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int col = j0 + idx / D, d = idx % D;
      const bool in = col < kv_end;
      Ks[idx] = in ? to_f(kp[col * kss + d]) : 0.f;
      Vs[idx] = in ? to_f(vp[col * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * D) + lane;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = kr[i * 4];
        part = fmaf(qr[i * 4 + 0], kk.x, part);
        part = fmaf(qr[i * 4 + 1], kk.y, part);
        part = fmaf(qr[i * 4 + 2], kk.z, part);
        part = fmaf(qr[i * 4 + 3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int col = j0 + j;
      const bool ok = col < kv_len && (!causal || col <= row + offset);
      s[j] = ok ? part * scale : NEG_INF;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      const float pr = to_f(from_f<T>(p));            // p.astype(v.dtype)
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * D) + lane;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = vr[i * 4];
        acc[i * 4 + 0] = fmaf(pr, vv.x, acc[i * 4 + 0]);
        acc[i * 4 + 1] = fmaf(pr, vv.y, acc[i * 4 + 1]);
        acc[i * 4 + 2] = fmaf(pr, vv.z, acc[i * 4 + 2]);
        acc[i * 4 + 3] = fmaf(pr, vv.w, acc[i * 4 + 3]);
      }
    }
    l = alpha * l + psum;
    m = m_new;
  }

  if (live) {
    const float den = fmaxf(l, 1e-30f);
    OutT* op = o + b * osb + h * osh + (long long)row * oss;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        op[i * 16 + lane * 4 + c] = from_f<OutT>(acc[i * 4 + c] / den);
  }
}

template <typename T, typename OutT, int D>
int launch(const void* q, long long qsb, long long qsh, long long qss,
           const void* k, long long ksb, long long ksh, long long kss,
           const void* v, long long vsb, long long vsh, long long vss,
           void* o, long long osb, long long osh, long long oss, int B, int H,
           int Hkv, int Sq, int kv_len, int offset, int causal,
           cudaStream_t stream) {
  const int smem = 2 * BK * D * (int)sizeof(float);
  auto kernel = flash_attention_kernel<T, OutT, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, qsb, qsh, qss, (const T*)k, ksb, ksh, kss, (const T*)v,
      vsb, vsh, vss, (OutT*)o, osb, osh, oss, H, H / Hkv, Sq, kv_len, offset,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_types(int in_code, int out_code, const void* q, long long qsb,
                   long long qsh, long long qss, const void* k, long long ksb,
                   long long ksh, long long kss, const void* v, long long vsb,
                   long long vsh, long long vss, void* o, long long osb,
                   long long osh, long long oss, int B, int H, int Hkv, int Sq,
                   int kv_len, int offset, int causal, cudaStream_t stream) {
#define FA_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, osb, \
                osh, oss, B, H, Hkv, Sq, kv_len, offset, causal, stream
  if (in_code == 0 && out_code == 0) return launch<float, float, D>(FA_ARGS);
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32 (the only pair built: float32 in and out).  Strides
// are in elements; the head dimension of every tensor is contiguous.
extern "C" int flash_attention_launch(
    const void* q, long long qsb, long long qsh, long long qss,
    const void* k, long long ksb, long long ksh, long long kss,
    const void* v, long long vsb, long long vsh, long long vss,
    void* o, long long osb, long long osh, long long oss, int B, int H,
    int Hkv, int Sq, int Skv, int D, int kv_len, int offset, int causal,
    int in_code, int out_code, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      kv_len < 1 || kv_len > Skv)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FA_CALL(DD)                                                          \
  dispatch_types<DD>(in_code, out_code, q, qsb, qsh, qss, k, ksb, ksh, kss, \
                     v, vsb, vsh, vss, o, osb, osh, oss, B, H, Hkv, Sq,     \
                     kv_len, offset, causal, st)
  switch (D) {
    case 16: return FA_CALL(16);
    case 64: return FA_CALL(64);
    case 128: return FA_CALL(128);
  }
#undef FA_CALL
  return (int)cudaErrorInvalidValue;
}
