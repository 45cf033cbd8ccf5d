// Fused Hodgkin-Huxley right-hand side (K4) for Hopper (sm_90a), float64.
//
// Replaces the TPU kernel
//   src/repro/kernels/hh_rhs/hh_rhs.py::hh_rhs_pallas
//
// For every (neuron, compartment) it evaluates the six gating rates, the
// gate derivatives dm/dh/dn, the ionic current and the total ionic
// conductance in one pass: one read of v, m, h, n and one write of each
// output, instead of some hundred elementwise launches of the plain version.
//
// What bounds it on the card: bytes.  Each element costs four exp and two
// expm1 (some 35 fp64 operations each, below) plus some fifty arithmetic
// operations, about 280 in all, for 4 x 8 bytes in and 5 x 8 bytes out:
// about 4 operations a byte, under the H100's fp64 balance of about 10
// (34 TFLOP/s to 3.35 TB/s).
// The design is one thread per element with the inputs read through
// per-tensor strides, so the cell model passes its [N, C] views of the
// packed state without copies.
//
// Bit-exact with the plain version (repro_torch/core/mechanisms.py) on
// every device: exp and expm1 are the Cody-Waite + Taylor/Horner sequences
// of repro_torch/core/detmath.py operation for operation (not CUDA's
// libdevice, whose last bit differs from the CPU's), divisions by
// constants are multiplications by the reciprocal constant as there, the
// integer powers are the products lax.integer_pow evaluates (m*(m*m),
// (n*n)*(n*n)), exprel keeps the |x| < 1e-9 branch of
// repro/core/mechanisms.py, and the build uses -fmad=false so nvcc fuses
// no multiply-add the plain version rounds twice.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double GNABAR = 0.12, GKBAR = 0.036, GLBAR = 0.0003;
constexpr double ENA = 50.0, EK = -77.0, EL = -54.3;
constexpr double S_PER_CM2_TO_US_PER_UM2 = 1e-2;

// repro_torch/core/detmath.py constants
constexpr double LN2_HI = 0.6931471803691238;
constexpr double LN2_LO = 1.9082149292705877e-10;
constexpr double INV_LN2 = 1.4426950408889634;
constexpr double EXP_CLAMP = 708.0;
constexpr double EXPM1_SMALL = 0.5;
__constant__ double EXP_C[14] = {
    1.0, 1.0, 0.5, 0.16666666666666666, 0.041666666666666664,
    0.008333333333333333, 0.001388888888888889, 0.0001984126984126984,
    2.48015873015873e-05, 2.7557319223985893e-06, 2.755731922398589e-07,
    2.505210838544172e-08, 2.08767569878681e-09, 1.6059043836821613e-10};
__constant__ double EXPM1_C[17] = {
    1.0, 0.5, 0.16666666666666666, 0.041666666666666664,
    0.008333333333333333, 0.001388888888888889, 0.0001984126984126984,
    2.48015873015873e-05, 2.7557319223985893e-06, 2.755731922398589e-07,
    2.505210838544172e-08, 2.08767569878681e-09, 1.6059043836821613e-10,
    1.1470745597729725e-11, 7.647163731819816e-13, 4.779477332387385e-14,
    2.8114572543455206e-15};

__device__ __forceinline__ double det_exp(double x) {
  x = x < -EXP_CLAMP ? -EXP_CLAMP : (x > EXP_CLAMP ? EXP_CLAMP : x);
  const double k = rint(x * INV_LN2);
  const double r = (x - k * LN2_HI) - k * LN2_LO;
  double p = EXP_C[13];
#pragma unroll
  for (int i = 12; i >= 0; --i) p = p * r + EXP_C[i];
  return p * __longlong_as_double(((long long)k + 1023LL) << 52);
}

__device__ __forceinline__ double det_expm1(double x) {
  if (fabs(x) < EXPM1_SMALL) {
    double p = EXPM1_C[16];
#pragma unroll
    for (int i = 15; i >= 0; --i) p = p * x + EXPM1_C[i];
    return x * p;
  }
  return det_exp(x) - 1.0;
}

__device__ __forceinline__ double exprel(double x) {
  const bool small = fabs(x) < 1e-9;
  const double xs = small ? 1e-9 : x;
  const double out = xs / det_expm1(xs);
  return small ? 1.0 - x * 0.5 : out;
}

__global__ void hh_rhs_kernel(const double* __restrict__ area,
                              const double* __restrict__ v, long long v_sn,
                              const double* __restrict__ m, long long m_sn,
                              const double* __restrict__ h, long long h_sn,
                              const double* __restrict__ nn, long long n_sn,
                              long long sc,
                              double* __restrict__ dm, double* __restrict__ dh,
                              double* __restrict__ dn, double* __restrict__ i_ion,
                              double* __restrict__ g_tot, int C, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long n = idx / C;
  const int c = (int)(idx - n * C);
  const double vv = v[n * v_sn + c * sc];
  const double mm = m[n * m_sn + c * sc];
  const double hh = h[n * h_sn + c * sc];
  const double ng = nn[n * n_sn + c * sc];

  const double a_m = 1.0 * exprel(-(vv + 40.0) * (1.0 / 10.0));
  const double b_m = 4.0 * det_exp(-(vv + 65.0) * (1.0 / 18.0));
  const double a_h = 0.07 * det_exp(-(vv + 65.0) * (1.0 / 20.0));
  const double b_h = 1.0 / (1.0 + det_exp(-(vv + 35.0) * (1.0 / 10.0)));
  const double a_n = 0.1 * exprel(-(vv + 55.0) * (1.0 / 10.0));
  const double b_n = 0.125 * det_exp(-(vv + 65.0) * (1.0 / 80.0));

  const double f = __ldg(area + c) * S_PER_CM2_TO_US_PER_UM2;
  const double n2 = ng * ng;
  const double g_na = GNABAR * f * (mm * (mm * mm)) * hh;
  const double g_k = GKBAR * f * (n2 * n2);
  const double g_l = GLBAR * f * 1.0;

  dm[idx] = a_m * (1.0 - mm) - b_m * mm;
  dh[idx] = a_h * (1.0 - hh) - b_h * hh;
  dn[idx] = a_n * (1.0 - ng) - b_n * ng;
  i_ion[idx] = g_na * (vv - ENA) + g_k * (vv - EK) + g_l * (vv - EL);
  g_tot[idx] = g_na + g_k + g_l;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int hh_rhs_launch(const void* area, const void* v, long long v_sn,
                             const void* m, long long m_sn, const void* h,
                             long long h_sn, const void* n, long long n_sn,
                             long long sc, void* dm, void* dh, void* dn,
                             void* i_ion, void* g_tot, int N, int C,
                             void* stream) {
  const long long total = (long long)N * C;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    hh_rhs_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)area, (const double*)v, v_sn, (const double*)m, m_sn,
        (const double*)h, h_sn, (const double*)n, n_sn, sc, (double*)dm,
        (double*)dh, (double*)dn, (double*)i_ion, (double*)g_tot, C, total);
  }
  return (int)cudaGetLastError();
}
