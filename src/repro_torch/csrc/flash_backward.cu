// The gradient of flash attention (K10) for Hopper (sm_90a): dq, dk and dv
// of causal or bidirectional GQA attention, on the CUDA cores, in two
// kernels and without atomics, so that a training step is deterministic.
//
// Replaces no TPU kernel.  The JAX package has no backward kernel: it
// trains by differentiating its jnp attention (src/repro/models/
// attention.py:22 chunked_causal_attention under jax.checkpoint, and :96
// bidirectional_attention).  The port's model attention is K10 on every
// call, launched through ctypes, which autograd cannot pass through; this
// is the backward of kernels/attention/ops.py::FlashAttentionFn.
//
// Function (that of kernels/attention/ref.py::flash_attention_bwd_ref):
// q [B,H,Sq,D], k and v [B,Hkv,Skv,D] (float32 or bfloat16, read through
// their strides and widened to float32), the forward's float32 output o
// and the float32 gradient dO of o.  Query head h reads kv head
// h / (H / Hkv); s = (q . k) * (1/sqrt(D)); the valid entries are col <
// Skv and, causal, col <= row + (Skv - Sq).  With lse = max + log(sum exp)
// of a row's valid s and D_i = sum_d dO_id o_id:
//   P = exp(s - lse) (0 where masked), dP = dO V^T, dS = P (dP - D_i),
//   dq = scale dS K,  dk = scale sum_{group heads} dS^T Q,
//   dv = sum_{group heads} P^T dO,
// all in float32, each written once in the inputs' dtype (round to
// nearest even).
//
// What bounds it on this card: operations.  Six 2 Sq Skv D products a
// (batch, head) over the valid share of the square: the row statistics'
// S, then S, dP, dq, dk and dv.  At smollm-135m's training shape (B 8,
// H 9, S 256, D 64, causal) that is about 1.8 GFLOP a layer, so a launch
// is latency-bound; at 4 x 2048 about 58 GFLOP, 0.06 ms at bf16's tensor-
// core rate and 0.9 ms at float32's 67 TFLOP/s on the CUDA cores.
//
// Design: a simple, correct first version, every product an explicit
// fmaf on the CUDA cores (the shared build flags forbid contraction).
// 256 threads a block; thread (ty, tx), ty, tx < 16, owns the rows
// ty + 16 a and the columns tx + 16 b (a, b < 4) of each 64 x 64 tile
// product, and the dims tx + 16 e (e < D / 16) of each 64 x D one.  Tiles
// are staged in shared memory as float32 rows padded to D + 1 (odd), so
// that a half-warp's 16 rows and a warp's 2 broadcast rows fall in
// distinct banks; a row's 16 threads are one half-warp, so row maxima
// and sums are four shuffles and a row's tile of P or dS is ordered by a
// __syncwarp.
//   flash_bwd_dq    one block per (64 query rows, head, batch).  Q and dO
//                   staged once; D_i from dO and o; one pass over the kv
//                   tiles below the causal limit for the row max and sum
//                   (each thread sums its own columns under the shared
//                   running max, the row's 16 partial sums added at the
//                   end), lse and D_i written to a [B,H,Sq] float32
//                   scratch; a second pass for S, P, dP and dS (to shared
//                   memory) and dq += dS K in registers.
//   flash_bwd_dkdv  one block per (64 kv rows, kv head, batch).  K and V
//                   staged once; for each of the group's heads in order,
//                   for each query tile that can see the kv tile in
//                   order: Q, dO, lse and D_i staged, S^T, dP^T, P^T and
//                   dS^T, then dv += P^T dO and dk += dS^T Q in
//                   registers.  The group's heads sum inside the block,
//                   in a fixed order: no atomics, the same bits on every
//                   run.
// Later steps (ROADMAP §2): lse written by the forward kernels, and the
// tensor cores (mma.sync / wgmma) for the bf16 products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int BT = 64;                 // rows of a query or kv tile
constexpr int THREADS = 256;
constexpr int TX = 16;                 // threads that share a row
constexpr int TR = BT / TX;            // rows (and columns) per thread: 4
constexpr int PS = BT + 1;             // padded row of a P or dS tile

__device__ __forceinline__ void widen(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen(const uint4& u, float* out,
                                      __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);          // the lower element
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows first .. first + 63 of a [rows, D] view of T (row stride rs, in
// elements) into a [64][D + 1] float32 tile, 16 bytes a load; rows at and
// past n_valid are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long rs, int first,
                                          int n_valid) {
  constexpr int E = 16 / sizeof(T), CPR = D / E, DS = D + 1;
  for (int idx = threadIdx.x; idx < BT * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    float x[E];
    if (first + r < n_valid) {
      widen(*reinterpret_cast<const uint4*>(base + (long long)(first + r) *
                                                       rs + c * E),
            x, T());
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) dst[r * DS + c * E + e] = x[e];
  }
}

// s[a][b] = sum_d A[ty + 16 a][d] * Bm[tx + 16 b][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[TR][TR], const float* A,
                                         const float* Bm, int ty, int tx) {
  constexpr int DS = D + 1;
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int b = 0; b < TR; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[TR], bv[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a) av[a] = A[(ty + TX * a) * DS + d];
#pragma unroll
    for (int b = 0; b < TR; ++b) bv[b] = Bm[(tx + TX * b) * DS + d];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < TR; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int w = 1; w < TX; w <<= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int w = 1; w < TX; w <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, long long qsb, long long qsh, long long qss,
    const T* __restrict__ k, long long ksb, long long ksh, long long kss,
    const T* __restrict__ v, long long vsb, long long vsh, long long vss,
    const float* __restrict__ o, long long osb, long long osh, long long oss,
    const float* __restrict__ dout, long long gsb, long long gsh,
    long long gss, T* __restrict__ dq, long long dsb, long long dsh,
    long long dss, float* __restrict__ lse_out, float* __restrict__ dsum_out,
    int H, int group, int Sq, int Skv, int offset, int causal, float scale) {
  constexpr int DS = D + 1, DN = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BT][DS]
  float* Gs = Qs + BT * DS;            // dO, [BT][DS]
  float* Ks = Gs + BT * DS;            // [BT][DS]
  float* Vs = Ks + BT * DS;            // [BT][DS]
  float* Ss = Vs + BT * DS;            // dS, [BT][PS]

  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int q0 = blockIdx.x * BT;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int last_row = min(q0 + BT, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + offset + 1) : Skv;
  const int n_tiles = (kv_end + BT - 1) / BT;
  const T* kp = k + b * ksb + hk * ksh;
  const T* vp = v + b * vsb + hk * vsh;
  const float* op = o + b * osb + h * osh;

  load_tile<D, T>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
  load_tile<D, float>(Gs, dout + b * gsb + h * gsh, gss, q0, Sq);
  __syncthreads();

  // D_i = sum_d dO_id o_id, and the row statistics over the kv tiles
  float dsum[TR], m[TR], l[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int r = ty + TX * a, row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
#pragma unroll
      for (int e = 0; e < DN; ++e)
        acc = fmaf(Gs[r * DS + tx + TX * e],
                   op[(long long)row * oss + tx + TX * e], acc);
    }
    dsum[a] = row_sum(acc);
    m[a] = NEG_INF;
    l[a] = 0.f;
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int j0 = j * BT;
    __syncthreads();                   // the last tile's reads are done
    load_tile<D, T>(Ks, kp, kss, j0, kv_end);
    __syncthreads();
    float s[TR][TR];
    tile_dot<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int row = q0 + ty + TX * a;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < TR; ++c) {
        const int col = j0 + tx + TX * c;
        const bool ok = col < kv_end && (!causal || col <= row + offset);
        s[a][c] = ok ? s[a][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < TR; ++c)
        if (s[a][c] > NEG_INF) ps += expf(s[a][c] - m_new);
      l[a] = l[a] * expf(m[a] - m_new) + ps;
      m[a] = m_new;
    }
  }
  float lse[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = q0 + ty + TX * a;
    lse[a] = m[a] + logf(row_sum(l[a]));
    if (tx == 0 && row < Sq) {
      const long long at = ((long long)blockIdx.z * H + h) * Sq + row;
      lse_out[at] = lse[a];
      dsum_out[at] = dsum[a];
    }
  }

  // dq = scale * sum_j dS_ij k_j
  float acc[TR][DN];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[a][e] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int j0 = j * BT;
    __syncthreads();
    load_tile<D, T>(Ks, kp, kss, j0, kv_end);
    load_tile<D, T>(Vs, vp, vss, j0, kv_end);
    __syncthreads();
    float s[TR][TR], dp[TR][TR];
    tile_dot<D>(s, Qs, Ks, ty, tx);
    tile_dot<D>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int r = ty + TX * a, row = q0 + r;
#pragma unroll
      for (int c = 0; c < TR; ++c) {
        const int col = j0 + tx + TX * c;
        const bool ok = col < kv_end && (!causal || col <= row + offset);
        const float p = ok ? expf(s[a][c] * scale - lse[a]) : 0.f;
        Ss[r * PS + tx + TX * c] = p * (dp[a][c] - dsum[a]);
      }
    }
    __syncwarp();                      // a row's dS comes from its half-warp
    const int nc = min(BT, kv_end - j0);
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      float sv[TR], kv[DN];
#pragma unroll
      for (int a = 0; a < TR; ++a) sv[a] = Ss[(ty + TX * a) * PS + c];
#pragma unroll
      for (int e = 0; e < DN; ++e) kv[e] = Ks[c * DS + tx + TX * e];
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int e = 0; e < DN; ++e) acc[a][e] = fmaf(sv[a], kv[e], acc[a][e]);
    }
  }
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = q0 + ty + TX * a;
    if (row >= Sq) continue;
    T* out = dq + b * dsb + h * dsh + (long long)row * dss;
#pragma unroll
    for (int e = 0; e < DN; ++e) store(out + tx + TX * e, acc[a][e] * scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, long long qsb, long long qsh, long long qss,
    const T* __restrict__ k, long long ksb, long long ksh, long long kss,
    const T* __restrict__ v, long long vsb, long long vsh, long long vss,
    const float* __restrict__ dout, long long gsb, long long gsh,
    long long gss, T* __restrict__ dk, long long dksb, long long dksh,
    long long dkss, T* __restrict__ dv, long long dvsb, long long dvsh,
    long long dvss, const float* __restrict__ lse,
    const float* __restrict__ dsum, int H, int group, int Sq, int Skv,
    int offset, int causal, float scale) {
  constexpr int DS = D + 1, DN = D / TX;
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BT][DS]
  float* Vs = Ks + BT * DS;            // [BT][DS]
  float* Qs = Vs + BT * DS;            // [BT][DS]
  float* Gs = Qs + BT * DS;            // dO, [BT][DS]
  float* Ps = Gs + BT * DS;            // P^T, [BT][PS]
  float* Ss = Ps + BT * PS;            // dS^T, [BT][PS]
  float* Ls = Ss + BT * PS;            // lse of the query tile, [BT]
  float* Ds = Ls + BT;                 // D_i of the query tile, [BT]

  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  load_tile<D, T>(Ks, k + b * ksb + hk * ksh, kss, k0, Skv);
  load_tile<D, T>(Vs, v + b * vsb + hk * vsh, vss, k0, Skv);

  float gk[TR][DN], gv[TR][DN];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int e = 0; e < DN; ++e) gk[a][e] = gv[a][e] = 0.f;
  // the query tiles whose rows can see kv row k0 (causal: row >= k0 - offset)
  const int t_first = causal ? max(0, k0 - offset) / BT : 0;
  const int n_qt = (Sq + BT - 1) / BT;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qp = q + b * qsb + h * qsh;
    const float* gp = dout + b * gsb + h * gsh;
    const long long st = ((long long)b * H + h) * Sq;
    for (int t = t_first; t < n_qt; ++t) {
      const int q0 = t * BT;
      __syncthreads();                 // the last tile's reads are done
      load_tile<D, T>(Qs, qp, qss, q0, Sq);
      load_tile<D, float>(Gs, gp, gss, q0, Sq);
      if (threadIdx.x < BT) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < Sq ? lse[st + row] : 0.f;
        Ds[threadIdx.x] = row < Sq ? dsum[st + row] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: kv rows ty + 16 a, query columns tx + 16 c
      float s[TR][TR], dp[TR][TR];
      tile_dot<D>(s, Ks, Qs, ty, tx);
      tile_dot<D>(dp, Vs, Gs, ty, tx);
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const int r = ty + TX * a, col = k0 + r;
#pragma unroll
        for (int c = 0; c < TR; ++c) {
          const int i = tx + TX * c, row = q0 + i;
          const bool ok = row < Sq && col < Skv &&
                          (!causal || col <= row + offset);
          const float p = ok ? expf(s[a][c] * scale - Ls[i]) : 0.f;
          Ps[r * PS + i] = p;
          Ss[r * PS + i] = p * (dp[a][c] - Ds[i]);
        }
      }
      __syncwarp();                    // a kv row's P^T and dS^T: its half-warp
      const int nr = min(BT, Sq - q0);
#pragma unroll 2
      for (int c = 0; c < nr; ++c) {
        float pv[TR], sv[TR], gq[DN], qq[DN];
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          pv[a] = Ps[(ty + TX * a) * PS + c];
          sv[a] = Ss[(ty + TX * a) * PS + c];
        }
#pragma unroll
        for (int e = 0; e < DN; ++e) {
          gq[e] = Gs[c * DS + tx + TX * e];
          qq[e] = Qs[c * DS + tx + TX * e];
        }
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int e = 0; e < DN; ++e) {
            gv[a][e] = fmaf(pv[a], gq[e], gv[a][e]);
            gk[a][e] = fmaf(sv[a], qq[e], gk[a][e]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = k0 + ty + TX * a;
    if (row >= Skv) continue;
    T* out_k = dk + b * dksb + hk * dksh + (long long)row * dkss;
    T* out_v = dv + b * dvsb + hk * dvsh + (long long)row * dvss;
#pragma unroll
    for (int e = 0; e < DN; ++e) {
      store(out_k + tx + TX * e, gk[a][e] * scale);
      store(out_v + tx + TX * e, gv[a][e]);
    }
  }
}

// Raise the dynamic shared-memory limit of a kernel once.
template <typename K>
int size_smem(K kernel, int smem, bool& sized) {
  if (sized) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sized = true;
  return 0;
}

template <int D, typename T>
int launch_dq(const void* q, long long qsb, long long qsh, long long qss,
              const void* k, long long ksb, long long ksh, long long kss,
              const void* v, long long vsb, long long vsh, long long vss,
              const void* o, long long osb, long long osh, long long oss,
              const void* g, long long gsb, long long gsh, long long gss,
              void* dq, long long dsb, long long dsh, long long dss,
              void* lse, void* dsum, int B, int H, int Hkv, int Sq, int Skv,
              int offset, int causal, cudaStream_t stream) {
  const int smem = (4 * BT * (D + 1) + BT * PS) * (int)sizeof(float);
  auto kernel = flash_bwd_dq_kernel<D, T>;
  static bool sized = false;
  const int err = size_smem(kernel, smem, sized);
  if (err) return err;
  const dim3 grid((Sq + BT - 1) / BT, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, qsb, qsh, qss, (const T*)k, ksb, ksh, kss, (const T*)v,
      vsb, vsh, vss, (const float*)o, osb, osh, oss, (const float*)g, gsb,
      gsh, gss, (T*)dq, dsb, dsh, dss, (float*)lse, (float*)dsum, H,
      H / Hkv, Sq, Skv, offset, causal, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkdv(const void* q, long long qsb, long long qsh, long long qss,
                const void* k, long long ksb, long long ksh, long long kss,
                const void* v, long long vsb, long long vsh, long long vss,
                const void* g, long long gsb, long long gsh, long long gss,
                void* dk, long long dksb, long long dksh, long long dkss,
                void* dv, long long dvsb, long long dvsh, long long dvss,
                const void* lse, const void* dsum, int B, int H, int Hkv,
                int Sq, int Skv, int offset, int causal,
                cudaStream_t stream) {
  const int smem =
      (4 * BT * (D + 1) + 2 * BT * PS + 2 * BT) * (int)sizeof(float);
  auto kernel = flash_bwd_dkdv_kernel<D, T>;
  static bool sized = false;
  const int err = size_smem(kernel, smem, sized);
  if (err) return err;
  const dim3 grid((Skv + BT - 1) / BT, Hkv, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, qsb, qsh, qss, (const T*)k, ksb, ksh, kss, (const T*)v,
      vsb, vsh, vss, (const float*)g, gsb, gsh, gss, (T*)dk, dksb, dksh,
      dkss, (T*)dv, dvsb, dvsh, dvss, (const float*)lse,
      (const float*)dsum, H, H / Hkv, Sq, Skv, offset, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int Sq, int Skv, int offset,
               int causal) {
  return B <= 0 || H <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 ||
         H % Hkv != 0 || H / Hkv > 8 || B > 65535 || H > 65535 ||
         (causal && (offset != Skv - Sq || offset < 0));
}

}  // namespace

// Strides are in elements; the head dimension of every tensor is
// contiguous and every row 16-byte aligned (the wrapper checks both).
// dtype 0: float32 q, k, v, dq, dk, dv; 1: bfloat16.  o and dO are
// float32.  lse and dsum: [B, H, Sq] float32, written by the first kernel
// and read by the second, on the same stream.
extern "C" int flash_bwd_dq_launch(
    const void* q, long long qsb, long long qsh, long long qss,
    const void* k, long long ksb, long long ksh, long long kss,
    const void* v, long long vsb, long long vsh, long long vss,
    const void* o, long long osb, long long osh, long long oss,
    const void* g, long long gsb, long long gsh, long long gss,
    void* dq, long long dsb, long long dsh, long long dss, void* lse,
    void* dsum, int B, int H, int Hkv, int Sq, int Skv, int D, int offset,
    int causal, int dtype, void* stream) {
  if (bad_shape(B, H, Hkv, Sq, Skv, offset, causal))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define DQ_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, osb, \
                osh, oss, g, gsb, gsh, gss, dq, dsb, dsh, dss, lse, dsum, B,  \
                H, Hkv, Sq, Skv, offset, causal, st
#define DQ_CASE(DD)                                                   \
  case DD:                                                            \
    return dtype ? launch_dq<DD, __nv_bfloat16>(DQ_ARGS)              \
                 : launch_dq<DD, float>(DQ_ARGS);
  switch (D) {
    DQ_CASE(16)
    DQ_CASE(64)
    DQ_CASE(112)
    DQ_CASE(128)
  }
#undef DQ_CASE
#undef DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkdv_launch(
    const void* q, long long qsb, long long qsh, long long qss,
    const void* k, long long ksb, long long ksh, long long kss,
    const void* v, long long vsb, long long vsh, long long vss,
    const void* g, long long gsb, long long gsh, long long gss,
    void* dk, long long dksb, long long dksh, long long dkss,
    void* dv, long long dvsb, long long dvsh, long long dvss,
    const void* lse, const void* dsum, int B, int H, int Hkv, int Sq,
    int Skv, int D, int offset, int causal, int dtype, void* stream) {
  if (bad_shape(B, H, Hkv, Sq, Skv, offset, causal))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define KV_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, g, gsb, \
                gsh, gss, dk, dksb, dksh, dkss, dv, dvsb, dvsh, dvss, lse,    \
                dsum, B, H, Hkv, Sq, Skv, offset, causal, st
#define KV_CASE(DD)                                                   \
  case DD:                                                            \
    return dtype ? launch_dkdv<DD, __nv_bfloat16>(KV_ARGS)            \
                 : launch_dkdv<DD, float>(KV_ARGS);
  switch (D) {
    KV_CASE(16)
    KV_CASE(64)
    KV_CASE(112)
    KV_CASE(128)
  }
#undef KV_CASE
#undef KV_ARGS
  return (int)cudaErrorInvalidValue;
}
