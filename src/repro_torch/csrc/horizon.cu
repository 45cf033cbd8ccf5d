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
// compares.  The design is one thread per neuron looping over its K
// in-edges: in the [K, N] layout neighbouring threads read neighbouring
// ids and delays (coalesced), and the gather moves inside the kernel, so
// the [K, N] candidate matrix of the TPU version is never written to
// device memory.  Adds, min and compare are exact, so the outputs are
// bitwise those of gather + repro_torch.kernels.event_wheel.ref.
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

namespace {

__device__ __forceinline__ double min_nan(double a, double b) {
  // jnp.minimum / torch.minimum semantics: NaN propagates
  return (isnan(a) || a < b) ? a : b;
}

__global__ void horizon_kernel(const double* __restrict__ t_clock,
                               const int32_t* __restrict__ pre,
                               const double* __restrict__ delay, int K, int N,
                               double t_end, double horizon_cap, double eps,
                               double* __restrict__ hor,
                               double* __restrict__ score) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  double m = INFINITY;
  for (int k = 0; k < K; ++k) {
    const long long e = (long long)k * N + i;
    const double cand = __ldg(t_clock + __ldg(pre + e)) + __ldg(delay + e);
    m = min_nan(cand, m);
  }
  const double tc = t_clock[i];
  double h = min_nan(m, t_end);
  h = min_nan(h, tc + horizon_cap);
  hor[i] = h;
  score[i] = (tc < h - eps) ? tc : INFINITY;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int horizon_score_launch(const void* t_clock, const void* pre,
                                    const void* delay, int K, int N,
                                    double t_end, double horizon_cap,
                                    double eps, void* hor, void* score,
                                    void* stream) {
  if (N > 0) {
    const int blocks = (N + kThreads - 1) / kThreads;
    horizon_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)t_clock, (const int32_t*)pre, (const double*)delay, K, N,
        t_end, horizon_cap, eps, (double*)hor, (double*)score);
  }
  return (int)cudaGetLastError();
}
