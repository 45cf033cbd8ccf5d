// Fused FAP dependency horizon + runnable score (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/event_wheel/event_wheel.py::horizon_score_pallas
// and the XLA gather in front of it
// (src/repro/kernels/event_wheel/ops.py::fused_horizon_select).
//
// For neuron i with K in-edges in the static by-post layout
// (pre_byk/delay_byk, column i):
//   hor[i]   = min(min_k(t_clock[pre_byk[k,i]] + delay_byk[k,i]), t_end,
//                  t_clock[i] + horizon_cap)
//   score[i] = t_clock[i] if t_clock[i] < hor[i] - eps else +inf
//
// What bounds it on the card: bytes.  Per neuron it reads K int32 ids,
// K doubles of delay and K gathered clocks (the clock table, 8N bytes,
// stays in L2) and writes two doubles; the arithmetic is K adds and
// compares.  At the main path's N = 16384, K = 16 that is 3.4 MB, about
// 1 us at the HBM rate, the same order as a launch; the rest is the
// latency of two dependent loads (the id, then the clock it names) and
// of 262,144 scattered 8-byte clock reads, so the design issues a
// neuron's loads before their uses.
//
// One thread per neuron, 256 threads a block (on the H100 128 took 17 %
// longer; 2 and 4 lanes per neuron with a shuffle min were no faster).  A
// thread issues its in-edges' id and delay loads first (neighbouring
// threads read neighbouring columns of the [K, N] layout: coalesced),
// then its clock gathers, then folds the candidates in k order.  K = 16,
// the main path's make_network(k_in=16), is a template parameter: its 16
// gathers in one group took 8 % less time than the generic body's two
// groups of 8 (both 32 registers).  Other K run the generic body, in
// unrolled groups of 8 and a remainder.  The fold keeps the sequential
// order, so NaN propagation (min_nan) and the choice between equal minima
// are those of the first port's loop.  Adds, mins and compares are exact,
// so the outputs are bitwise those of gather +
// repro_torch.kernels.event_wheel.ref, and the gather's [K, N] candidate
// matrix of the TPU version is never written to device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;            // one neuron a thread

__device__ __forceinline__ double min_nan(double a, double b) {
  // jnp.minimum / torch.minimum semantics: NaN propagates
  return (isnan(a) || a < b) ? a : b;
}

// m folded with the candidates of in-edges [k0, k0 + G) of neuron i, in
// k order: every id and delay load first, then every clock gather.
template <int G>
__device__ __forceinline__ double fold_edges(
    const double* __restrict__ t_clock, const int32_t* __restrict__ pre,
    const double* __restrict__ delay, long long N, long long i, int k0,
    double m) {
  int id[G];
  double c[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long e = (long long)(k0 + g) * N + i;
    id[g] = __ldg(pre + e);
    c[g] = __ldg(delay + e);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) c[g] = __ldg(t_clock + id[g]) + c[g];
#pragma unroll
  for (int g = 0; g < G; ++g) m = min_nan(c[g], m);
  return m;
}

// kK > 0: K = kK in-edges; kK == 0: any K.
template <int kK>
__global__ void __launch_bounds__(kThreads)
horizon_kernel(const double* __restrict__ t_clock,
               const int32_t* __restrict__ pre,
               const double* __restrict__ delay, int K, int N, double t_end,
               double horizon_cap, double eps, double* __restrict__ hor,
               double* __restrict__ score) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const double tc = t_clock[i];
  double m = INFINITY;
  if constexpr (kK > 0) {
    m = fold_edges<kK>(t_clock, pre, delay, N, i, 0, m);
  } else {
    int k = 0;
    for (; k + 8 <= K; k += 8)
      m = fold_edges<8>(t_clock, pre, delay, N, i, k, m);
    for (; k < K; ++k) m = fold_edges<1>(t_clock, pre, delay, N, i, k, m);
  }
  double h = min_nan(m, t_end);
  h = min_nan(h, tc + horizon_cap);
  hor[i] = h;
  score[i] = (tc < h - eps) ? tc : INFINITY;
}

}  // namespace

extern "C" int horizon_score_launch(const void* t_clock, const void* pre,
                                    const void* delay, int K, int N,
                                    double t_end, double horizon_cap,
                                    double eps, void* hor, void* score,
                                    void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int blocks = (N + kThreads - 1) / kThreads;
  const auto kernel = K == 16 ? horizon_kernel<16> : horizon_kernel<0>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)t_clock, (const int32_t*)pre, (const double*)delay, K, N,
      t_end, horizon_cap, eps, (double*)hor, (double*)score);
  return (int)cudaGetLastError();
}
