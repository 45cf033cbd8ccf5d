// Gather-id compaction (K6), compaction + table-row gather (K7) and the
// row-wise spike-parcel compaction (K9) for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/event_wheel/event_wheel.py::compact_ids_pallas
//   src/repro/kernels/event_wheel/event_wheel.py::compact_gather_pallas
//   src/repro/kernels/event_wheel/event_wheel.py::compact_rows_pallas
//
// K6: ids[r] = index of the r-th set lane of mask[0..N) (index order) for
//     r < min(count, cap), the sentinel N for the other slots; count = the
//     number of set lanes (it may exceed cap).
// K7: K6, then rows[r, c] = table[ids[r], c] for filled slots and ``fill``
//     for empty ones (table is int32 [N, MO], row-major).
// K9: K6 on every row d of a [D, M] mask, with the values: idx[d, r] = the
//     column of the r-th kept element of row d (sentinel M), vals[d, r] =
//     values[d, idx[d, r]] (0 in empty slots), count[d] = kept in row d.
//     Mask and values are read through their strides, so the transport's
//     one spike-time row broadcast to D rows is never materialised.
//
// What bounds it on the card: neither bytes nor operations.  At the main
// path's shapes the kernels read N = 16384 mask bytes (K9: D x M = 4 x
// 4096 mask bytes and at most D x cap values; K7: at most cap rows of MO
// int32 table entries) and write cap ids: a few tens of KB, nanoseconds at
// the HBM rate.  The index order makes the compaction a scan, so the
// kernel's time is the latency of that scan.
//
// Design: the TPU version places lanes with a [cap, BN] one-hot reduction
// per grid step, carrying the running count between sequential steps (K9:
// one [cap, M] one-hot reduction per row).  On the GPU one block of 1024
// threads walks a mask row in 1024-lane chunks: each warp ranks its set
// lanes with __ballot_sync/__popc, warp 0 scans the 32 warp counts with
// shuffles, and a shared carry holds the running count between chunks.
// Each set lane below cap writes its own slot, so the output is
// deterministic and equals the cumsum + scatter of the plain version
// (repro_torch/kernels/event_wheel/ref.py) bit for bit; K9 copies the
// values and so stays bitwise too.  K7's row gather then runs in the same
// block, one thread per (slot, column) pair; K9 runs one block per row.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// The block scan: calls place(pos, i) for each lane i < N with is_set(i)
// whose rank pos (set lanes before it) is below cap; returns the number of
// set lanes, in every thread.
template <class IsSet, class Place>
__device__ int block_compact(int N, int cap, IsSet is_set, Place place) {
  __shared__ int warp_incl[kWarps];
  __shared__ int carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < N; base += kThreads) {
    const int i = base + tid;
    const bool set = i < N && is_set(i);
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    const int before = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_incl[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int v = warp_incl[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += y;
      }
      warp_incl[lane] = v;                      // inclusive scan of counts
    }
    __syncthreads();
    const int pos = carry + (warp ? warp_incl[warp - 1] : 0) + before;
    if (set && pos < cap) place(pos, i);
    __syncthreads();                            // carry and scan read
    if (tid == 0) carry += warp_incl[kWarps - 1];
    __syncthreads();
  }
  return carry;
}

__device__ void compact_block(const uint8_t* __restrict__ mask, int N,
                              int cap, int32_t* ids, int32_t* count) {
  const int total = block_compact(
      N, cap, [&](int i) { return mask[i] != 0; },
      [&](int pos, int i) { ids[pos] = i; });
  for (int r = min(total, cap) + threadIdx.x; r < cap; r += kThreads)
    ids[r] = N;
  if (threadIdx.x == 0) *count = total;
}

__global__ void __launch_bounds__(kThreads)
compact_ids_kernel(const uint8_t* __restrict__ mask, int N, int cap,
                   int32_t* ids, int32_t* count) {
  compact_block(mask, N, cap, ids, count);
}

__global__ void __launch_bounds__(kThreads)
compact_gather_kernel(const uint8_t* __restrict__ mask, int N,
                      const int32_t* __restrict__ table, int MO, int cap,
                      int fill, int32_t* ids, int32_t* __restrict__ rows,
                      int32_t* count) {
  compact_block(mask, N, cap, ids, count);
  __syncthreads();                              // ids visible to the block
  const long long total = (long long)cap * MO;
  for (long long e = threadIdx.x; e < total; e += kThreads) {
    const int id = ids[e / MO];
    rows[e] = id < N ? __ldg(table + (long long)id * MO + e % MO) : fill;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const uint8_t* __restrict__ mask, long long ms0,
                    long long ms1, const double* __restrict__ values,
                    long long vs0, long long vs1, int M, int cap,
                    int32_t* __restrict__ idx, double* __restrict__ vals,
                    int32_t* __restrict__ count) {
  const long long d = blockIdx.x;
  const uint8_t* mrow = mask + d * ms0;
  const double* vrow = values + d * vs0;
  int32_t* irow = idx + d * cap;
  double* orow = vals + d * cap;
  const int total = block_compact(
      M, cap, [&](int i) { return mrow[(long long)i * ms1] != 0; },
      [&](int pos, int i) {
        irow[pos] = i;
        orow[pos] = vrow[(long long)i * vs1];
      });
  for (int r = min(total, cap) + threadIdx.x; r < cap; r += kThreads) {
    irow[r] = M;
    orow[r] = 0.0;
  }
  if (threadIdx.x == 0) count[d] = total;
}

}  // namespace

extern "C" int compact_ids_launch(const void* mask, int N, int cap, void* ids,
                                  void* count, void* stream) {
  compact_ids_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, N, cap, (int32_t*)ids, (int32_t*)count);
  return (int)cudaGetLastError();
}

extern "C" int compact_gather_launch(const void* mask, int N,
                                     const void* table, int MO, int cap,
                                     int fill, void* ids, void* rows,
                                     void* count, void* stream) {
  compact_gather_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, N, (const int32_t*)table, MO, cap, fill,
      (int32_t*)ids, (int32_t*)rows, (int32_t*)count);
  return (int)cudaGetLastError();
}

extern "C" int compact_rows_launch(const void* mask, long long ms0,
                                   long long ms1, const void* values,
                                   long long vs0, long long vs1, int D, int M,
                                   int cap, void* idx, void* vals, void* count,
                                   void* stream) {
  compact_rows_kernel<<<D, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, ms0, ms1, (const double*)values, vs0, vs1, M, cap,
      (int32_t*)idx, (double*)vals, (int32_t*)count);
  return (int)cudaGetLastError();
}
