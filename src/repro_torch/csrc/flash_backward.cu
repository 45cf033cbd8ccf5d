// The gradient of flash attention (K10) for Hopper (sm_90a): dq, dk and dv
// of causal or bidirectional GQA attention in two kernels, every sum in a
// fixed order, so that a training step is deterministic.  bf16 inputs run
// on the tensor cores (mma.sync) at float32 accuracy, float32 inputs on
// the CUDA cores.
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
// their strides), the forward's float32 output o and the float32 gradient
// dO of o.  Query head h reads kv head h / (H / Hkv); s = (q . k) *
// (1/sqrt(D)); the valid entries are col < Skv and, causal, col <= row +
// (Skv - Sq).  With lse = max + log(sum exp) of a row's valid s and D_i =
// sum_d dO_id o_id:
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
// Design, bf16 inputs (flash_bwd_dq_mma_kernel, flash_bwd_dkdv_mma_kernel):
// four warps a block, each owning 16 rows of a 64-row tile, 32 columns of
// the other side at a time; every product is mma.sync m16n8k16 (bf16 in,
// float32 accumulation) on fragments read by ldmatrix from shared-memory
// tiles that 16-byte cp.async copies fill through a two-stage ring.  A
// product of two bf16 operands (S = Q K^T)
// is exact in the float32 accumulator.  A float32 operand x (P, dS, dO) is
// split in registers into three bf16 pieces, hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid), which hold x to about 2**-24 of itself;
// each piece times a bf16 operand is exact, so the result differs from the
// float32 reference only in the order of its sums and the accumulator's
// rounding (within half the float32 limit even if every mma.sync
// truncated: tests/test_torch_flash_backward.py emulates it).  P^T dO has float32 on
// both sides: it keeps the six piece products down to 2**-16 (hi.hi,
// hi.mid, mid.hi, hi.lo, lo.hi, mid.mid) and drops those at float32's own
// rounding.  A piece that is zero over a whole 64-row tile of dO is not
// multiplied (x + 0 = x: no bit changes); in bf16 training dO arrives
// exactly bf16 (models/common.py::mm rounds o), so dP costs one product
// and dv three.  P and dS pass from the accumulator fragments of one
// product to the A fragments of the next in registers, 16 columns at a
// time; each piece multiplies every n-tile of D before the next piece, so
// that consecutive products go to distinct accumulators.
//   flash_bwd_dq_mma_kernel    a block per (64 query rows, head, batch).
//                   Splits its dO tile once into three bf16 planes in
//                   shared memory (and into a global scratch for the
//                   second kernel, with a flag per tile saying which of
//                   mid and lo are not all zero) and computes D_i; then
//                   one pass over the kv tiles below the causal limit, as
//                   the forward's: the row max m and sum l run online and
//                   dq accumulates exp(s - m) (dP - D_i) K, rescaled when
//                   m grows, divided by l at the end.  lse = m + log l and
//                   D_i go to a [B,H,Sq padded to 64] float32 scratch.
//   flash_bwd_dkdv_mma_kernel  a block per (query head of the group, 64 kv
//                   rows, kv head and batch), the group's blocks one
//                   thread-block cluster.  For each query tile that can
//                   see its kv rows: S^T = K Q^T, P^T, dv += P^T dO, dP^T
//                   = V dO^T, dS^T, dk += dS^T Q; the ring holds Q and
//                   dO's hi piece, mid and lo (when not all zero) take one
//                   stage, so that three blocks fit an SM at D 64.  Then each block puts its
//                   head's partial dk and dv in its shared memory and,
//                   after a cluster barrier, block r sums rows slice r of
//                   all the group's partials through distributed shared
//                   memory in head order 0..group-1 and writes that slice;
//                   a group of one writes straight from its registers.
// Warps skip the 16-column steps that the causal mask empties.
//
// Design, float32 inputs (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel):
// every product an explicit fmaf on the CUDA cores (the shared build flags
// forbid contraction).  256 threads a block; thread (ty, tx), ty, tx < 16,
// owns the rows ty + 16 a and the columns tx + 16 b (a, b < 4) of each
// 64 x 64 tile product, and the dims tx + 16 e (e < D / 16) of each 64 x
// D one.  Tiles are staged in shared memory as float32 rows padded to D +
// 1 (odd); a row's 16 threads are one half-warp, so row maxima and sums
// are four shuffles.  The dq kernel makes two passes over the kv tiles
// (the row statistics, then dq); the dkdv kernel has the bf16 one's
// grid, cluster and sum.
//
// Later steps (ROADMAP §2): lse written by the forward kernels, and wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int BT = 64;                 // rows of a query or kv tile
constexpr int THREADS = 256;           // float32 kernels
constexpr int TX = 16;                 // threads that share a row
constexpr int TR = BT / TX;            // rows (and columns) per thread: 4
constexpr int PS = BT + 1;             // padded row of a P or dS tile
constexpr int MMA_THREADS = 128;       // bf16 kernels: four warps

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------- helpers --

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
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

// Fragment addresses in a [rows][DS] bf16 tile (one lane's ldmatrix row):
//   a_at   the A fragment (16 x 16, row-major) at (row0, col0);
//   b_at   B fragments of two n-tiles from [n][k] rows at (n0, k0): r[0],
//          r[1] of n0 .. n0 + 7, r[2], r[3] of n0 + 8 .. n0 + 15;
//   bt_at  the same from [k][n] rows at (k0, n0), for ldsm_x4_trans.
template <int DS>
__device__ __forceinline__ uint32_t a_at(const bf16* t, int row0, int col0,
                                         int lane) {
  return smem_u32(t + (row0 + (lane & 15)) * DS + col0 + (lane >> 4) * 8);
}

template <int DS>
__device__ __forceinline__ uint32_t b_at(const bf16* t, int n0, int k0,
                                         int lane) {
  return smem_u32(t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * DS + k0 +
                  ((lane >> 3) & 1) * 8);
}

template <int DS>
__device__ __forceinline__ uint32_t bt_at(const bf16* t, int k0, int n0,
                                          int lane) {
  return smem_u32(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS + n0 +
                  (lane >> 4) * 8);
}

// x0 (the lower element) and x1 rounded to bf16 and packed, in one cvt.
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lower(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float upper(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// x0, x1 (the lower and the upper element of a pair) into three packed
// bf16 pieces: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid).
// Each subtraction is exact in float32.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack2(x0, x1);
  const float r0 = x0 - lower(hi), r1 = x1 - upper(hi);
  mid = pack2(r0, r1);
  lo = pack2(r0 - lower(mid), r1 - upper(mid));
}

// An accumulator fragment pair (n-tiles 2 kk, 2 kk + 1) as the three
// pieces' A fragments of the product over those 16 columns.
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&p)[3][4]) {
  split3(c0[0], c0[1], p[0][0], p[1][0], p[2][0]);
  split3(c0[2], c0[3], p[0][1], p[1][1], p[2][1]);
  split3(c1[0], c1[1], p[0][2], p[1][2], p[2][2]);
  split3(c1[2], c1[3], p[0][3], p[1][3], p[2][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Four floats at p in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ float4 ld_cluster_f4(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(remote) : "memory");
  return x;
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(bf16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(x.x, x.y), pack2(x.z, x.w));
}

// The group's partial dk and dv, [BT][D + 4] float32 each at Pk and Pv in
// every block of the cluster, summed in head order: block `rank` takes
// its slice of the kv rows and writes it (dk times scale).
template <int D, int NTHR, typename T>
__device__ __forceinline__ void cluster_sum_store(
    const float* Pk, const float* Pv, int rank, int group, int k0, int Skv,
    T* dk, long long dkss, T* dv, long long dvss, float scale) {
  constexpr int PD = D + 4, C4 = D / 4;
  cluster_sync();                      // every block's partials are written
  const int per = (BT + group - 1) / group;
  const int r0 = rank * per, r1 = min(BT, r0 + per);
  for (int idx = threadIdx.x; idx < (r1 - r0) * C4; idx += NTHR) {
    const int r = r0 + idx / C4, c = (idx % C4) * 4;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int src = 0; src < group; ++src) {
      const float4 a = ld_cluster_f4(Pk + r * PD + c, src);
      const float4 e = ld_cluster_f4(Pv + r * PD + c, src);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += e.x; sv.y += e.y; sv.z += e.z; sv.w += e.w;
    }
    if (k0 + r < Skv) {
      store4(dk + (long long)(k0 + r) * dkss + c,
             make_float4(sk.x * scale, sk.y * scale, sk.z * scale,
                         sk.w * scale));
      store4(dv + (long long)(k0 + r) * dvss + c, sv);
    }
  }
  cluster_sync();                      // no block leaves while read
}

// ---------------------------------------------------- bf16: tensor cores --

// Rows first .. first + 63 of a [rows, D] bf16 view (row stride rs) into
// a [64][D + 8] tile by 16-byte cp.async copies; rows at and past n_valid
// are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* base,
                                                long long rs, int first,
                                                int n_valid) {
  constexpr int CPR = D / 8, DS = D + 8;
  for (int idx = threadIdx.x; idx < BT * CPR; idx += MMA_THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool in = first + r < n_valid;
    const bf16* src = base + (long long)(in ? first + r : 0) * rs + c * 8;
    cp_async16(smem_u32(dst + r * DS + c * 8), src, in);
  }
}

// s += A B^T of a warp's 16 rows against 32 rows n0 .. n0 + 31 of a
// [n][D] tile, as n-tiles 0..3 (rows n0 + 16 u .. only where on[u]): A's
// fragments a[ks] in registers, B's from the tile.
template <int D>
__device__ __forceinline__ void mma_pair(float (&s)[4][4],
                                         const uint32_t (&a)[D / 16][4],
                                         const bf16* tile, int n0,
                                         const bool (&on)[2], int lane) {
  constexpr int DS = D + 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (on[u]) {
        uint32_t b[4];
        ldsm_x4(b, b_at<DS>(tile, n0 + 16 * u, ks * 16, lane));
        mma16816(s[2 * u], a[ks], b[0], b[1]);
        mma16816(s[2 * u + 1], a[ks], b[2], b[3]);
      }
}

// acc[n] += sum_{P0 <= p < P1} a[p] B over rows k0 .. k0 + 15 of a [k][n]
// tile, every n-tile of D: B's fragments by ldmatrix.trans, four n-tile
// pairs at a time, so that consecutive products go to distinct
// accumulators.
template <int D, int P0, int P1>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[3][4],
                                         const bf16* tile, int k0, int lane) {
  constexpr int DS = D + 8, NP = D / 16;
#pragma unroll
  for (int c = 0; c < NP; c += 4) {
    uint32_t b[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < NP)
        ldsm_x4_trans(b[j], bt_at<DS>(tile, k0, (c + j) * 16, lane));
#pragma unroll
    for (int p = P0; p < P1; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < NP) {
          mma16816(acc[2 * (c + j)], a[p], b[j][0], b[j][1]);
          mma16816(acc[2 * (c + j) + 1], a[p], b[j][2], b[j][3]);
        }
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, long long qsb, long long qsh, long long qss,
    const bf16* __restrict__ k, long long ksb, long long ksh, long long kss,
    const bf16* __restrict__ v, long long vsb, long long vsh, long long vss,
    const float* __restrict__ o, long long osb, long long osh, long long oss,
    const float* __restrict__ dout, long long gsb, long long gsh,
    long long gss, bf16* __restrict__ dq, long long dsb, long long dsh,
    long long dss, float* __restrict__ lse_out, float* __restrict__ dsum_out,
    bf16* __restrict__ split_out, int* __restrict__ flags_out, int H,
    int group, int Sq, int Skv, int offset, int causal, float scale) {
  constexpr int DS = D + 8, KS = D / 16, NT = D / 8, TILE = BT * DS;
  extern __shared__ uint4 smem_dq[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_dq);       // [BT][DS]
  bf16* Gs = Qs + TILE;                               // dO pieces, [3][BT][DS]
  bf16* Ks = Gs + 3 * TILE;                           // [2][BT][DS]
  bf16* Vs = Ks + 2 * TILE;                           // [2][BT][DS]
  __shared__ float Dsh[BT];

  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int qt = blockIdx.x, nqt = gridDim.x, Sqp = nqt * BT, q0 = qt * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int last_row = min(q0 + BT, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + offset + 1) : Skv;
  const int n_tiles = (kv_end + BT - 1) / BT;
  // the warp's rows q0 + 16 warp .. + 15 and the columns they can see
  const int w0 = q0 + 16 * warp, w_last = min(w0 + 15, Sq - 1);
  const int w_end = w_last < w0 ? 0
                    : (causal ? min(kv_end, w_last + offset + 1) : kv_end);
  const bf16* kp = k + b * ksb + hk * ksh;
  const bf16* vp = v + b * vsb + hk * vsh;
  const long long bh = (long long)b * H + h;

  load_tile_async<D>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
  if (n_tiles > 0) {
    load_tile_async<D>(Ks, kp, kss, 0, kv_end);
    load_tile_async<D>(Vs, vp, vss, 0, kv_end);
  }
  cp_async_commit();

  // dO into its three pieces (shared planes, and the global scratch
  // [3][B][H][Sqp][D]: hi always, mid and lo where not all zero), and each
  // 4-column chunk's share of D_i = sum_d dO_id o_id; a thread's loads
  // are in flight together, eight chunks at a time
  constexpr int C4 = D / 4, ITER = BT * C4 / MMA_THREADS, PC = C4 + 1;
  const float* gp = dout + b * gsb + h * gsh;
  const float* op = o + b * osb + h * osh;
  const long long plane = (long long)gridDim.z * H * Sqp * D;
  bf16* sp = split_out + (bh * Sqp + q0) * D;
  float* part = reinterpret_cast<float*>(Vs + TILE);  // [BT][PC], V stage 1
  bool nz_mid = false, nz_lo = false;
#pragma unroll
  for (int i0 = 0; i0 < ITER; i0 += 8) {
    float4 x[8], y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = threadIdx.x + (i0 + i) * MMA_THREADS;
      const int r = idx / C4, c = (idx % C4) * 4;
      x[i] = y[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + i < ITER && q0 + r < Sq) {
        x[i] = *reinterpret_cast<const float4*>(gp + (long long)(q0 + r) *
                                                         gss + c);
        y[i] = *reinterpret_cast<const float4*>(op + (long long)(q0 + r) *
                                                         oss + c);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i0 + i >= ITER) break;
      const int idx = threadIdx.x + (i0 + i) * MMA_THREADS;
      const int r = idx / C4, c = (idx % C4) * 4;
      uint2 hi, mid, lo;
      split3(x[i].x, x[i].y, hi.x, mid.x, lo.x);
      split3(x[i].z, x[i].w, hi.y, mid.y, lo.y);
      nz_mid |= ((mid.x | mid.y) & 0x7fff7fffu) != 0;
      nz_lo |= ((lo.x | lo.y) & 0x7fff7fffu) != 0;
      *reinterpret_cast<uint2*>(Gs + r * DS + c) = hi;
      *reinterpret_cast<uint2*>(Gs + TILE + r * DS + c) = mid;
      *reinterpret_cast<uint2*>(Gs + 2 * TILE + r * DS + c) = lo;
      *reinterpret_cast<uint2*>(sp + r * D + c) = hi;
      part[r * PC + c / 4] =
          fmaf(x[i].w, y[i].w,
               fmaf(x[i].z, y[i].z, fmaf(x[i].y, y[i].y, x[i].x * y[i].x)));
    }
  }
  const int fl = (__syncthreads_or(nz_mid) ? 1 : 0) |
                 (__syncthreads_or(nz_lo) ? 2 : 0);
  if (threadIdx.x == 0) flags_out[bh * nqt + qt] = fl;
#pragma unroll
  for (int p = 1; p < 3; ++p) {
    if (!(fl & p)) continue;
#pragma unroll
    for (int it = 0; it < D / 16; ++it) {
      const int idx = threadIdx.x + it * MMA_THREADS;
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(sp + p * plane + r * D + c) =
          *reinterpret_cast<const uint4*>(Gs + p * TILE + r * DS + c);
    }
  }
  if (threadIdx.x < BT) {              // the row's chunks in column order
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C4; ++c) acc += part[threadIdx.x * PC + c];
    Dsh[threadIdx.x] = acc;
  }
  cp_async_wait<0>();
  __syncthreads();

  // this lane's rows: w0 + g (e < 2) and w0 + g + 8 (e >= 2)
  const float dsum[2] = {Dsh[16 * warp + g], Dsh[16 * warp + g + 8]};
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qa[ks], a_at<DS>(Qs, 16 * warp, ks * 16, lane));

  // One pass over the kv tiles, as the forward's: the row max m and sum l
  // run online, and dq accumulates sum_j exp(s_ij - m) (dP_ij - D_i) k_j,
  // rescaled when m grows, so that dq = scale acc / l at the end (P =
  // exp(s - m) / l = exp(s - lse)).
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, j0 = j * BT;
    if (j + 1 < n_tiles) {
      load_tile_async<D>(Ks + (st ^ 1) * TILE, kp, kss, j0 + BT, kv_end);
      load_tile_async<D>(Vs + (st ^ 1) * TILE, vp, vss, j0 + BT, kv_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int nk = min(4, max(0, (w_end - j0 + 15) / 16));
    // a tile that no mask cuts for this warp's rows
    const bool full = j0 + BT <= kv_end &&
                      (!causal || j0 + BT - 1 <= w0 + offset);
    const bf16* Kt = Ks + st * TILE;
    const bf16* Vt = Vs + st * TILE;
    // 32 kv columns at a time: n-tile n covers j0 + 16 k2 + 8 n ..
#pragma unroll 1
    for (int k2 = 0; k2 < nk; k2 += 2) {
      const bool on[2] = {true, k2 + 1 < nk};
      float s[4][4] = {}, dp[4][4] = {};
      mma_pair<D>(s, qa, Kt, k2 * 16, on, lane);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + k2 * 16 + n * 8 + 2 * t + (e & 1);
          const int row = w0 + g + (e >> 1) * 8;
          const bool ok = full || (on[n >> 1] && col < kv_end &&
                                   (!causal || col <= row + offset));
          s[n][e] = ok ? s[n][e] * scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = s[n][e] > NEG_INF ? expf(s[n][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += s[n][e];
        }
      // dP = dO V^T over dO's non-zero pieces
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        if (p > 0 && !(fl & p)) continue;
        uint32_t ga[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(ga[ks], a_at<DS>(Gs + p * TILE, 16 * warp, ks * 16, lane));
        mma_pair<D>(dp, ga, Vt, k2 * 16, on, lane);
      }
      // exp(s - m) (dP - D_i), split into pieces 16 columns at a time, and
      // acc += that times K
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!on[u]) continue;
#pragma unroll
        for (int n = 2 * u; n < 2 * u + 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[n][e] = s[n][e] * (dp[n][e] - dsum[e >> 1]);
        uint32_t da[3][4];
        split_frag(dp[2 * u], dp[2 * u + 1], da);
        mma_rows<D, 0, 3>(acc, da, Kt, (k2 + u) * 16, lane);
      }
    }
    __syncthreads();                   // stage st is free again
  }
  float lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = quad_sum(l[r]);
    if (t == 0) {
      const long long at = bh * Sqp + w0 + g + 8 * r;
      lse_out[at] = m[r] + logf(lsum[r]);
      dsum_out[at] = dsum[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    bf16* out = dq + b * dsb + h * dsh + (long long)row * dss;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) =
          pack2(acc[n][2 * r] * scale / lsum[r],
                acc[n][2 * r + 1] * scale / lsum[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, long long qsb, long long qsh, long long qss,
    const bf16* __restrict__ k, long long ksb, long long ksh, long long kss,
    const bf16* __restrict__ v, long long vsb, long long vsh, long long vss,
    bf16* __restrict__ dk, long long dksb, long long dksh, long long dkss,
    bf16* __restrict__ dv, long long dvsb, long long dvsh, long long dvss,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const bf16* __restrict__ split, const int* __restrict__ flags, int H,
    int group, int Sq, int Skv, int offset, int causal, float scale) {
  constexpr int DS = D + 8, KS = D / 16, NT = D / 8, TILE = BT * DS;
  extern __shared__ uint4 smem_kv[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_kv);       // [BT][DS]
  bf16* Vs = Ks + TILE;                               // [BT][DS]
  bf16* Ring = Vs + TILE;              // [2][Q, dO hi][BT][DS]
  bf16* Extra = Ring + 4 * TILE;       // dO mid, lo: [2][BT][DS], one stage
  float* Stat = reinterpret_cast<float*>(Extra + 2 * TILE);  // [2][lse, D_i][BT]

  const int gi = blockIdx.x;          // the query head in the group = rank
  const int k0 = blockIdx.y * BT;
  const int Hkv = H / group;
  const int hk = blockIdx.z % Hkv, b = blockIdx.z / Hkv;
  const int h = hk * group + gi;
  const int nqt = (Sq + BT - 1) / BT, Sqp = nqt * BT;
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * group * Sqp * D;
  const bf16* sp = split + bh * Sqp * D;
  const bf16* qp = q + b * qsb + h * qsh;
  const int* fp = flags + bh * nqt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + 16 * warp;     // the warp's first kv row
  const int t_first = causal ? max(0, k0 - offset) / BT : 0;

  load_tile_async<D>(Ks, k + b * ksb + hk * ksh, kss, k0, Skv);
  load_tile_async<D>(Vs, v + b * vsb + hk * vsh, vss, k0, Skv);
  // the tile flags, read a tile ahead of their use
  int f_cur = fp[t_first], f_next = t_first + 1 < nqt ? fp[t_first + 1] : 0;
  // rows q0 .. q0 + 63 of dO's piece p into dst
  auto load_piece = [&](bf16* dst, int p, int q0) {
    const bf16* src = sp + p * plane + (long long)q0 * D;
    for (int idx = threadIdx.x; idx < BT * (D / 8); idx += MMA_THREADS) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      cp_async16(smem_u32(dst + r * DS + c), src + r * D + c, true);
    }
  };
  // Q, dO's hi piece, lse and D_i of query tile tt into ring stage st
  auto load_stage = [&](int st, int tt) {
    bf16* R = Ring + st * 2 * TILE;
    const int q0 = tt * BT;
    load_tile_async<D>(R, qp, qss, q0, Sq);
    load_piece(R + TILE, 0, q0);
    if (threadIdx.x < 32) {
      const int c = (threadIdx.x & 15) * 4, which = threadIdx.x >> 4;
      cp_async16(smem_u32(Stat + (st * 2 + which) * BT + c),
                 (which ? dsum : lse) + bh * Sqp + q0 + c, true);
    }
  };
  load_stage(0, t_first);
  cp_async_commit();

  float gk[NT][4], gv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

  for (int tt = t_first; tt < nqt; ++tt) {
    const int st = (tt - t_first) & 1, q0 = tt * BT;
    const int fl = f_cur;
    // the tile's mid and lo pieces where not all zero (one stage: their
    // copies wait here), then the next tile's Q, hi and statistics
#pragma unroll
    for (int p = 1; p < 3; ++p)
      if (fl & p) load_piece(Extra + (p - 1) * TILE, p, q0);
    cp_async_commit();
    if (tt + 1 < nqt) load_stage(st ^ 1, tt + 1);
    cp_async_commit();
    f_cur = f_next;
    f_next = tt + 2 < nqt ? fp[tt + 2] : 0;
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Ring + st * 2 * TILE;
    const bf16* Gp[3] = {Qt + TILE, Extra, Extra + TILE};   // dO's pieces
    const float* Lt = Stat + st * 2 * BT;
    const float* Dt = Lt + BT;
    // the query steps (16 columns) the warp's kv rows can see
    const int kk_hi = kr0 >= Skv ? 0 : min(4, (Sq - q0 + 15) / 16);
    const int kk_lo = causal ? min(kk_hi, max(0, kr0 - offset - q0) / 16) : 0;
    // a tile that no mask cuts for this warp's kv rows
    const bool full = q0 + BT <= Sq && kr0 + 16 <= Skv &&
                      (!causal || kr0 + 15 <= q0 + offset);
    // 32 query columns at a time: n-tile n covers q0 + 16 k2 + 8 n ..
#pragma unroll 1
    for (int k2 = kk_lo & ~1; k2 < kk_hi; k2 += 2) {
      const bool on[2] = {k2 >= kk_lo, k2 + 1 < kk_hi};
      // S^T = K Q^T: kv rows kr0 + g (+ 8)
      float s[4][4] = {}, dp[4][4] = {};
      {
        uint32_t ka[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(ka[ks], a_at<DS>(Ks, 16 * warp, ks * 16, lane));
        mma_pair<D>(s, ka, Qt, k2 * 16, on, lane);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = k2 * 16 + n * 8 + 2 * t + (e & 1), row = q0 + i;
          const int col = kr0 + g + (e >> 1) * 8;
          const bool ok = full || (on[n >> 1] && row < Sq && col < Skv &&
                                   (!causal || col <= row + offset));
          s[n][e] = ok ? expf(s[n][e] * scale - Lt[i]) : 0.f;
        }
      // dv += P^T dO: the six piece products, 16 query rows at a time
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!on[u]) continue;
        const int k0u = (k2 + u) * 16;
        uint32_t pa[3][4];
        split_frag(s[2 * u], s[2 * u + 1], pa);
        // hi.hi, mid.hi, lo.hi; hi.mid, mid.mid; hi.lo
        mma_rows<D, 0, 3>(gv, pa, Gp[0], k0u, lane);
        if (fl & 1) mma_rows<D, 0, 2>(gv, pa, Gp[1], k0u, lane);
        if (fl & 2) mma_rows<D, 0, 1>(gv, pa, Gp[2], k0u, lane);
      }
      // dP^T = V dO^T over dO's non-zero pieces
      {
        uint32_t va[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(va[ks], a_at<DS>(Vs, 16 * warp, ks * 16, lane));
#pragma unroll
        for (int p = 0; p < 3; ++p)
          if (p == 0 || (fl & p))
            mma_pair<D>(dp, va, Gp[p], k2 * 16, on, lane);
      }
      // dS^T = P^T (dP^T - D_i), split 16 query rows at a time, and
      // dk += dS^T Q
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!on[u]) continue;
#pragma unroll
        for (int n = 2 * u; n < 2 * u + 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[n][e] = s[n][e] *
                       (dp[n][e] - Dt[k2 * 16 + n * 8 + 2 * t + (e & 1)]);
        uint32_t da[3][4];
        split_frag(dp[2 * u], dp[2 * u + 1], da);
        mma_rows<D, 0, 3>(gk, da, Qt, (k2 + u) * 16, lane);
      }
    }
    __syncthreads();                   // stage st is free again
  }
  cp_async_wait<0>();

  bf16* dkp = dk + b * dksb + hk * dksh;
  bf16* dvp = dv + b * dvsb + hk * dvsh;
  if (group == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kr0 + g + 8 * r;
      if (row >= Skv) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dkp + (long long)row * dkss + c) =
            pack2(gk[n][2 * r] * scale, gk[n][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvp + (long long)row * dvss + c) =
            pack2(gv[n][2 * r], gv[n][2 * r + 1]);
      }
    }
    return;
  }
  constexpr int PD = D + 4;
  float* Pk = reinterpret_cast<float*>(smem_kv);     // [BT][PD]
  float* Pv = Pk + BT * PD;                           // [BT][PD]
  __syncthreads();                     // the tiles are no longer read
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(Pk + row * PD + c) =
          make_float2(gk[n][2 * r], gk[n][2 * r + 1]);
      *reinterpret_cast<float2*>(Pv + row * PD + c) =
          make_float2(gv[n][2 * r], gv[n][2 * r + 1]);
    }
  }
  cluster_sum_store<D, MMA_THREADS>(Pk, Pv, gi, group, k0, Skv, dkp, dkss,
                                    dvp, dvss, scale);
}

// ------------------------------------------------ float32: CUDA cores --

// Rows first .. first + 63 of a [rows, D] float32 view (row stride rs)
// into a [64][D + 1] tile, 16 bytes a load; rows at and past n_valid are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long rs, int first,
                                          int n_valid) {
  constexpr int CPR = D / 4, DS = D + 1;
  for (int idx = threadIdx.x; idx < BT * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < n_valid)
      x = *reinterpret_cast<const float4*>(base + (long long)(first + r) * rs +
                                           c * 4);
    float* d = dst + r * DS + c * 4;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
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

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qss,
    const float* __restrict__ k, long long ksb, long long ksh, long long kss,
    const float* __restrict__ v, long long vsb, long long vsh, long long vss,
    const float* __restrict__ o, long long osb, long long osh, long long oss,
    const float* __restrict__ dout, long long gsb, long long gsh,
    long long gss, float* __restrict__ dq, long long dsb, long long dsh,
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
  const int q0 = blockIdx.x * BT, Sqp = gridDim.x * BT;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int last_row = min(q0 + BT, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + offset + 1) : Skv;
  const int n_tiles = (kv_end + BT - 1) / BT;
  const float* kp = k + b * ksb + hk * ksh;
  const float* vp = v + b * vsb + hk * vsh;
  const float* op = o + b * osb + h * osh;

  load_tile<D>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
  load_tile<D>(Gs, dout + b * gsb + h * gsh, gss, q0, Sq);
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
    load_tile<D>(Ks, kp, kss, j0, kv_end);
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
      const long long at = ((long long)blockIdx.z * H + h) * Sqp + row;
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
    load_tile<D>(Ks, kp, kss, j0, kv_end);
    load_tile<D>(Vs, vp, vss, j0, kv_end);
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
    float* out = dq + b * dsb + h * dsh + (long long)row * dss;
#pragma unroll
    for (int e = 0; e < DN; ++e) out[tx + TX * e] = acc[a][e] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qss,
    const float* __restrict__ k, long long ksb, long long ksh, long long kss,
    const float* __restrict__ v, long long vsb, long long vsh, long long vss,
    const float* __restrict__ dout, long long gsb, long long gsh,
    long long gss, float* __restrict__ dk, long long dksb, long long dksh,
    long long dkss, float* __restrict__ dv, long long dvsb, long long dvsh,
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

  const int gi = blockIdx.x;          // the query head in the group = rank
  const int k0 = blockIdx.y * BT;
  const int Hkv = H / group;
  const int hk = blockIdx.z % Hkv, b = blockIdx.z / Hkv;
  const int h = hk * group + gi;
  const int nqt = (Sq + BT - 1) / BT, Sqp = nqt * BT;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  load_tile<D>(Ks, k + b * ksb + hk * ksh, kss, k0, Skv);
  load_tile<D>(Vs, v + b * vsb + hk * vsh, vss, k0, Skv);

  float gk[TR][DN], gv[TR][DN];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int e = 0; e < DN; ++e) gk[a][e] = gv[a][e] = 0.f;
  // the query tiles whose rows can see kv row k0 (causal: row >= k0 - offset)
  const int t_first = causal ? max(0, k0 - offset) / BT : 0;
  const float* qp = q + b * qsb + h * qsh;
  const float* gp = dout + b * gsb + h * gsh;
  const long long st = ((long long)b * H + h) * Sqp;
  for (int t = t_first; t < nqt; ++t) {
    const int q0 = t * BT;
    __syncthreads();                   // the last tile's reads are done
    load_tile<D>(Qs, qp, qss, q0, Sq);
    load_tile<D>(Gs, gp, gss, q0, Sq);
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
    __syncwarp();                      // a kv row's P^T and dS^T: its half-warp
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
  float* dkp = dk + b * dksb + hk * dksh;
  float* dvp = dv + b * dvsb + hk * dvsh;
  if (group == 1) {
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int row = k0 + ty + TX * a;
      if (row >= Skv) continue;
#pragma unroll
      for (int e = 0; e < DN; ++e) {
        dkp[(long long)row * dkss + tx + TX * e] = gk[a][e] * scale;
        dvp[(long long)row * dvss + tx + TX * e] = gv[a][e];
      }
    }
    return;
  }
  constexpr int PD = D + 4;
  float* Pk = smem;                    // [BT][PD]
  float* Pv = Pk + BT * PD;            // [BT][PD]
  __syncthreads();                     // the tiles are no longer read
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int e = 0; e < DN; ++e) {
      Pk[(ty + TX * a) * PD + tx + TX * e] = gk[a][e];
      Pv[(ty + TX * a) * PD + tx + TX * e] = gv[a][e];
    }
  cluster_sum_store<D, THREADS>(Pk, Pv, gi, group, k0, Skv, dkp, dkss, dvp,
                                dvss, scale);
}

// ------------------------------------------------------------ launchers --

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

template <int D>
constexpr int dq_smem(bool mma) {
  return mma ? 8 * BT * (D + 8) * 2
             : (4 * BT * (D + 1) + BT * PS) * (int)sizeof(float);
}

template <int D>
constexpr int dkdv_smem(bool mma) {
  return mma ? 8 * BT * (D + 8) * 2 + 4 * BT * (int)sizeof(float)
             : (4 * BT * (D + 1) + 2 * BT * PS + 2 * BT) * (int)sizeof(float);
}

// every block's partials (two [BT][D + 4] float32 tiles) fit its tiles
static_assert(dkdv_smem<16>(true) >= 2 * BT * 20 * 4 &&
              dkdv_smem<16>(false) >= 2 * BT * 20 * 4, "partials");

template <int D, typename T>
int launch_dq(const void* q, long long qsb, long long qsh, long long qss,
              const void* k, long long ksb, long long ksh, long long kss,
              const void* v, long long vsb, long long vsh, long long vss,
              const void* o, long long osb, long long osh, long long oss,
              const void* g, long long gsb, long long gsh, long long gss,
              void* dq, long long dsb, long long dsh, long long dss,
              void* lse, void* dsum, void* split, void* flags, int B, int H,
              int Hkv, int Sq, int Skv, int offset, int causal,
              cudaStream_t stream) {
  constexpr bool mma = sizeof(T) == 2;
  const int smem = dq_smem<D>(mma);
  const dim3 grid((Sq + BT - 1) / BT, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  static bool sized = false;
  if constexpr (mma) {
    auto kernel = flash_bwd_dq_mma_kernel<D>;
    const int err = size_smem(kernel, smem, sized);
    if (err) return err;
    kernel<<<grid, MMA_THREADS, smem, stream>>>(
        (const bf16*)q, qsb, qsh, qss, (const bf16*)k, ksb, ksh, kss,
        (const bf16*)v, vsb, vsh, vss, (const float*)o, osb, osh, oss,
        (const float*)g, gsb, gsh, gss, (bf16*)dq, dsb, dsh, dss,
        (float*)lse, (float*)dsum, (bf16*)split, (int*)flags, H, H / Hkv, Sq,
        Skv, offset, causal, scale);
  } else {
    auto kernel = flash_bwd_dq_kernel<D>;
    const int err = size_smem(kernel, smem, sized);
    if (err) return err;
    kernel<<<grid, THREADS, smem, stream>>>(
        (const float*)q, qsb, qsh, qss, (const float*)k, ksb, ksh, kss,
        (const float*)v, vsb, vsh, vss, (const float*)o, osb, osh, oss,
        (const float*)g, gsb, gsh, gss, (float*)dq, dsb, dsh, dss,
        (float*)lse, (float*)dsum, H, H / Hkv, Sq, Skv, offset, causal,
        scale);
  }
  return (int)cudaGetLastError();
}

// A launch of `kernel` on (group, kv tiles, Hkv * B) in clusters of the
// group's blocks (no cluster for a group of one).
template <typename K, typename... Args>
int launch_cluster(K kernel, int group, int Skv, int Hkv, int B, int threads,
                   int smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(group, (Skv + BT - 1) / BT, Hkv * B);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = group;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = group > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkdv(const void* q, long long qsb, long long qsh, long long qss,
                const void* k, long long ksb, long long ksh, long long kss,
                const void* v, long long vsb, long long vsh, long long vss,
                const void* g, long long gsb, long long gsh, long long gss,
                void* dk, long long dksb, long long dksh, long long dkss,
                void* dv, long long dvsb, long long dvsh, long long dvss,
                const void* lse, const void* dsum, const void* split,
                const void* flags, int B, int H, int Hkv, int Sq, int Skv,
                int offset, int causal, cudaStream_t stream) {
  constexpr bool mma = sizeof(T) == 2;
  const int smem = dkdv_smem<D>(mma);
  const int group = H / Hkv;
  const float scale = (float)(1.0 / sqrt((double)D));
  static bool sized = false;
  if constexpr (mma) {
    auto kernel = flash_bwd_dkdv_mma_kernel<D>;
    const int err = size_smem(kernel, smem, sized);
    if (err) return err;
    return launch_cluster(
        kernel, group, Skv, Hkv, B, MMA_THREADS, smem, stream,
        (const bf16*)q, qsb, qsh, qss, (const bf16*)k, ksb, ksh, kss,
        (const bf16*)v, vsb, vsh, vss, (bf16*)dk, dksb, dksh, dkss,
        (bf16*)dv, dvsb, dvsh, dvss, (const float*)lse, (const float*)dsum,
        (const bf16*)split, (const int*)flags, H, group, Sq, Skv, offset,
        causal, scale);
  } else {
    auto kernel = flash_bwd_dkdv_kernel<D>;
    const int err = size_smem(kernel, smem, sized);
    if (err) return err;
    return launch_cluster(
        kernel, group, Skv, Hkv, B, THREADS, smem, stream, (const float*)q,
        qsb, qsh, qss, (const float*)k, ksb, ksh, kss, (const float*)v, vsb,
        vsh, vss, (const float*)g, gsb, gsh, gss, (float*)dk, dksb, dksh,
        dkss, (float*)dv, dvsb, dvsh, dvss, (const float*)lse,
        (const float*)dsum, H, group, Sq, Skv, offset, causal, scale);
  }
}

bool bad_shape(int B, int H, int Hkv, int Sq, int Skv, int offset,
               int causal) {
  return B <= 0 || H <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 ||
         H % Hkv != 0 || H / Hkv > 8 || B > 65535 || H > 65535 ||
         (long long)Hkv * B > 65535 ||
         (causal && (offset != Skv - Sq || offset < 0));
}

}  // namespace

// Strides are in elements; the head dimension of every tensor is
// contiguous and every row 16-byte aligned (the wrapper checks both).
// dtype 0: float32 q, k, v, dq, dk, dv; 1: bfloat16.  o and dO are
// float32.  Scratch, written by the first kernel and read by the second,
// on the same stream, with Sqp = Sq rounded up to 64: lse and dsum,
// [B, H, Sqp] float32 each; for bf16, split, dO's three bf16 pieces [3,
// B, H, Sqp, D], and flags, [B, H, Sqp / 64] int32 (bit 1: the tile's mid
// piece is not all zero, bit 2: its lo piece); float32 ignores both.
extern "C" int flash_bwd_dq_launch(
    const void* q, long long qsb, long long qsh, long long qss,
    const void* k, long long ksb, long long ksh, long long kss,
    const void* v, long long vsb, long long vsh, long long vss,
    const void* o, long long osb, long long osh, long long oss,
    const void* g, long long gsb, long long gsh, long long gss,
    void* dq, long long dsb, long long dsh, long long dss, void* lse,
    void* dsum, void* split, void* flags, int B, int H, int Hkv, int Sq,
    int Skv, int D, int offset, int causal, int dtype, void* stream) {
  if (bad_shape(B, H, Hkv, Sq, Skv, offset, causal))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define DQ_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, o, osb, \
                osh, oss, g, gsb, gsh, gss, dq, dsb, dsh, dss, lse, dsum,     \
                split, flags, B, H, Hkv, Sq, Skv, offset, causal, st
#define DQ_CASE(DD)                                                   \
  case DD:                                                            \
    return dtype ? launch_dq<DD, bf16>(DQ_ARGS)                       \
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
    const void* lse, const void* dsum, const void* split, const void* flags,
    int B, int H, int Hkv, int Sq, int Skv, int D, int offset, int causal,
    int dtype, void* stream) {
  if (bad_shape(B, H, Hkv, Sq, Skv, offset, causal))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define KV_ARGS q, qsb, qsh, qss, k, ksb, ksh, kss, v, vsb, vsh, vss, g, gsb, \
                gsh, gss, dk, dksb, dksh, dkss, dv, dvsb, dvsh, dvss, lse,    \
                dsum, split, flags, B, H, Hkv, Sq, Skv, offset, causal, st
#define KV_CASE(DD)                                                   \
  case DD:                                                            \
    return dtype ? launch_dkdv<DD, bf16>(KV_ARGS)                     \
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
