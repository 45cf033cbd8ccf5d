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
// What bounds them on the card: neither bytes nor operations.  At the main
// path's shapes the kernels read N = 16384 mask bytes (K9: D x M = 4 x
// 4096 mask bytes and at most D x cap values; K7: at most cap rows of MO
// int32 table entries) and write cap ids: a few tens of KB, nanoseconds at
// the HBM rate.  The index order makes the compaction a scan, so a
// kernel's time is the latency of that scan: its barriers and its
// dependent loads.
//
// K6's design keeps the scan short.  One block of 1024 threads covers
// 16,384 lanes in one pass: each thread reads its 16 consecutive mask
// bytes as one 16-byte load and turns them into a 16-bit set mask
// (__vcmpne4), whose __popc is its count.  Each warp sums its counts; one
// barrier publishes the 32 warp counts, and every warp scans them itself
// with shuffles, so a pass costs one barrier (the TPU version's sequential
// grid of one-hot reductions, and this kernel's first port, 16 chunks of
// four barriers each at N = 16384).  A warp then writes its 512 lanes' ids
// in 16 rounds of 32 lanes: each lane takes its bit from the owning
// thread's mask by a shuffle, and a ballot ranks the round's set lanes, so
// each round's ids are one contiguous, coalesced store.  Larger N loop
// over passes with a running carry.  A mask whose data is not 16-byte
// aligned, or whose N is no multiple of 16, is read as 16-byte groups of
// its aligned base: the groups at the head and the tail that hold bytes
// outside the mask are read byte by byte, only inside it.  The sentinel
// fill of slots [min(count, cap), cap) uses 16-byte stores.  Each set lane
// below cap has one slot and one writer, so the output is deterministic
// and equals the cumsum + scatter of the plain version
// (repro_torch/kernels/event_wheel/ref.py) bit for bit.
//
// K7 and K9 keep the first port's block scan (block_compact): one block of
// 1024 threads walks a row in 1024-lane chunks, each warp ranks its set
// lanes with __ballot_sync/__popc, warp 0 scans the 32 warp counts and a
// shared carry holds the running count between chunks.  K7's row gather
// then runs in the same block, one thread per (slot, column) pair; K9
// runs one block per row and copies the values, so both stay bitwise.
// Moving them onto K6's one-barrier pass is later work.
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

constexpr int kPassLanes = kThreads * 16;     // lanes of one K6 pass

// Bit j of the result: byte j of w is nonzero.
__device__ __forceinline__ unsigned nonzero_bits4(unsigned w) {
  return (((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24) & 0xfu;
}

__global__ void __launch_bounds__(kThreads)
compact_ids_kernel(const uint8_t* __restrict__ mask, int N, int cap,
                   int32_t* __restrict__ ids, int32_t* __restrict__ count) {
  __shared__ int warp_count[2][kWarps];         // by pass parity
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  // mask[i] is byte v = i + shift of the 16-byte aligned base
  const int shift = (int)(reinterpret_cast<uintptr_t>(mask) & 15);
  const uint8_t* base = mask - shift;
  const long long end = (long long)shift + N;
  int carry = 0;                                // set lanes of earlier passes
  for (long long v_pass = 0; N > 0 && v_pass < end; v_pass += kPassLanes) {
    const long long v0 = v_pass + 16LL * tid;
    unsigned bits = 0;                          // bit j: lane v0 + j is set
    if (v0 >= shift && v0 + 16 <= end) {
      const uint4 w = *reinterpret_cast<const uint4*>(base + v0);
      bits = nonzero_bits4(w.x) | nonzero_bits4(w.y) << 4 |
             nonzero_bits4(w.z) << 8 | nonzero_bits4(w.w) << 12;
    } else if (v0 < end) {                      // the head or the tail group
      for (int j = 0; j < 16; ++j) {
        const long long v = v0 + j;
        if (v >= shift && v < end && base[v] != 0) bits |= 1u << j;
      }
    }
    const int wsum = (int)__reduce_add_sync(0xffffffffu, __popc(bits));
    int* counts = warp_count[(v_pass / kPassLanes) & 1];
    if (lane == 0) counts[warp] = wsum;
    __syncthreads();
    int incl = counts[lane];                    // every warp scans the 32
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    int run = carry + __shfl_sync(0xffffffffu, incl, warp) - wsum;
    carry += __shfl_sync(0xffffffffu, incl, 31);
    // the warp's lanes v_pass + 512 warp + [0, 512), 32 per round
    const int i0 = (int)(v_pass - shift) + 512 * warp + lane;
    for (int r = 0; r < 16 && wsum > 0 && run < cap; ++r) {
      const unsigned m = __shfl_sync(0xffffffffu, bits, 2 * r + (lane >> 4));
      const bool set = (m >> (lane & 15)) & 1u;
      const unsigned ballot = __ballot_sync(0xffffffffu, set);
      const int pos = run + __popc(ballot & below);
      if (set && pos < cap) ids[pos] = i0 + 32 * r;
      run += __popc(ballot);
    }
  }
  // the sentinel N in slots [min(count, cap), cap): scalar up to a 16-byte
  // boundary, then 16-byte stores, then the scalar rest
  int32_t* rest = ids + min(carry, cap);
  const int n_rest = cap - min(carry, cap);
  const int head = min(
      n_rest, (int)((16 - (reinterpret_cast<uintptr_t>(rest) & 15)) & 15) / 4);
  const int body = (n_rest - head) / 4;
  if (tid < head) rest[tid] = N;
  int4* vec = reinterpret_cast<int4*>(rest + head);
  for (int q = tid; q < body; q += kThreads) vec[q] = make_int4(N, N, N, N);
  for (int q = head + 4 * body + tid; q < n_rest; q += kThreads) rest[q] = N;
  if (tid == 0) *count = carry;
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
