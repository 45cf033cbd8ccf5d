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
// K6 rows, K7 rows: K6 and K7 on each row t of a contiguous [T, N] mask
//     (the tenants of the simulation service's batched round), one launch
//     for all rows: ids[t, r], rows[t, r, c] (from the one [N, MO] table)
//     and count[t], what JAX's vmap makes of the Pallas kernels' grids.
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
// K9 runs the same pass, one block per row (compact_row, shared with K6),
// and reads the mask as the transport stores it.  The transport's [D, M]
// mask is the transpose of contiguous [M, D] bytes (strides (1, D)): at D
// = 4 and M = 4096, 16,384 contiguous bytes, one pass of 1024 threads x 16
// bytes.  Block d reads all of them, 16 bytes a thread (16 / D columns x D
// rows), and keeps row d's 16 / D bits (the first port read one byte a
// thread through the strides and walked each row in four chunks of four
// barriers).  The D blocks re-read the same 16 KB from L2, and in return
// each writes and sentinel-fills only its row, on its own SM.  Contiguous
// rows take K6's reading (per row, any offset); any other strides, D that
// does not divide 16, or a base off 16-byte alignment are read byte by byte
// through the strides.  A lane's values for its write rounds are loaded,
// coalesced, before the barrier, through the values' strides (the
// broadcast spike-time row is never made whole), so no load waits behind
// the scan.  The sentinel fills (M in idx, 0.0 in vals) use 16-byte stores.
// ref.compact_rows_packed_ref models the pass on the CPU.
//
// K7 runs K6's pass, then gathers the rows in the same kernel after one
// more barrier (the first port scanned in 16 chunks of four barriers).
// The entries are split over G = 32 blocks (kGatherBlocks; on the H100
// 12-14 % faster than one block at the main path's shape, 64 no faster);
// each block re-runs the pass (16 KB of
// mask from L2) and writes the same ids, then gathers its share of the
// n_e = kept * MO filled entries and fills its share of the rest.  A
// thread reads each slot's id back from global memory (its block's own
// writes; staging them in shared memory measured 0.0003-0.0004 ms
// slower), walks its entries e = e0 + tid, + 1024, ... with (slot,
// column) advanced by adds (one division by MO a thread, not two an
// entry), and issues the table loads of 8 entries before their 8 stores;
// loads and stores are coalesced along the rows.  The empty slots' fill
// values are written with 16-byte stores before the barrier, where they
// overlap the scan's tail.  Any cap is taken.  ref.compact_gather_sched_ref
// models the schedule.
//
// The rows forms are the same bodies (compact_ids_row, compact_gather_row)
// with a second grid axis over the rows: block (b, t) runs row t's pass
// from byte t * N of the mask (any alignment, as above) and writes row t's
// slices.  At the simulation service's shapes (T = 4 tenants, N = 16384,
// cap 4096; K7 at the spike cap, MO = 33) that is one launch a round in
// place of T, and T blocks (K7: 32 T) side by side on the SMs.  They are
// as bound as K6 and K7: a scan's latency, not bytes.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Bit j of the result: byte j of w is nonzero.
__device__ __forceinline__ unsigned nonzero_bits4(unsigned w) {
  return (((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24) & 0xfu;
}

// Bit j of the result: byte v0 + j of the 16-byte aligned base is nonzero,
// for the bytes v0 + j in [lo, hi).  A group wholly inside is one 16-byte
// load; a group that straddles lo or hi is read byte by byte inside.
__device__ __forceinline__ unsigned group_bits(const uint8_t* __restrict__ base,
                                               long long v0, long long lo,
                                               long long hi) {
  if (v0 >= lo && v0 + 16 <= hi) {
    const uint4 w = *reinterpret_cast<const uint4*>(base + v0);
    return nonzero_bits4(w.x) | nonzero_bits4(w.y) << 4 |
           nonzero_bits4(w.z) << 8 | nonzero_bits4(w.w) << 12;
  }
  unsigned bits = 0;
  for (int j = 0; j < 16; ++j) {
    const long long v = v0 + j;
    if (v >= lo && v < hi && base[v] != 0) bits |= 1u << j;
  }
  return bits;
}

// Bit k of the result: bit k * D + d of a 16-byte group's nonzero bits,
// i.e. row d of the group's 16 / D interleaved [*, D] columns.
template <int D>
__device__ __forceinline__ unsigned row_bits(unsigned nz, int d) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 16 / D; ++k) bits |= ((nz >> (k * D + d)) & 1u) << k;
  return bits;
}

// value in p[0, n): scalar up to a 16-byte boundary, then 16-byte stores,
// then the scalar rest.
template <class T>
__device__ void fill_slots(T* p, int n, T value) {
  constexpr int kPer = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int head = min(
      n, (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T)));
  if (tid < head) p[tid] = value;
  const int body = (n - head) / kPer;
  union { T t[kPer]; uint4 u; } w;
  for (int k = 0; k < kPer; ++k) w.t[k] = value;
  uint4* vec = reinterpret_cast<uint4*>(p + head);
  for (int q = tid; q < body; q += kThreads) vec[q] = w.u;
  for (int q = head + kPer * body + tid; q < n; q += kThreads) p[q] = value;
}

// The one-barrier pass of one row by one block (K6's design).  Lane i of
// the row is v = i + shift in pass coordinates; a pass covers kThreads *
// LPT lanes, LPT consecutive ones a thread, and bits_of(v0) gives their
// set mask (bit k: lane v0 + k).  Writes ids[pos] = i -- and with kVals
// vals[pos] = vrow[i * vs1] -- for each set lane whose rank pos is below
// cap; returns the number of set lanes, in every thread.  A warp writes
// its 32 * LPT lanes in LPT rounds of 32 (lane l of round r: lane 32 r + l
// of the warp, its bit taken from the owning thread by a shuffle); the
// values of a lane's rounds are loaded before the barrier, coalesced, so
// no load waits behind the scan.
template <int LPT, bool kVals, class BitsOf>
__device__ __forceinline__ int compact_row(BitsOf bits_of, int shift,
                                           long long N, int cap,
                                           int32_t* __restrict__ ids,
                                           const double* __restrict__ vrow,
                                           long long vs1,
                                           double* __restrict__ vals) {
  constexpr long long kPass = (long long)kThreads * LPT;
  __shared__ int warp_count[2][kWarps];         // by pass parity
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long end = shift + N;
  int carry = 0;                                // set lanes of earlier passes
  for (long long v_pass = 0; N > 0 && v_pass < end; v_pass += kPass) {
    const long long i0 = v_pass - shift + 32LL * LPT * warp + lane;
    double val[LPT];                            // round r: lane i0 + 32 r
    if constexpr (kVals) {
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        const long long i = i0 + 32 * r;
        val[r] = i >= 0 && i < N ? vrow[i * vs1] : 0.0;
      }
    }
    const long long v0 = v_pass + (long long)LPT * tid;
    const unsigned bits = v0 < end ? bits_of(v0) : 0u;
    const int wsum = (int)__reduce_add_sync(0xffffffffu, __popc(bits));
    int* counts = warp_count[(v_pass / kPass) & 1];
    if (lane == 0) counts[warp] = wsum;
    __syncthreads();
    int incl = counts[lane];                    // every warp scans the 32
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    int run = carry + __shfl_sync(0xffffffffu, incl, warp) - wsum;
    carry += __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int r = 0; r < LPT; ++r) {
      if (wsum == 0 || run >= cap) break;       // uniform in the warp
      const int l = 32 * r + lane;
      const unsigned m = __shfl_sync(0xffffffffu, bits, l / LPT);
      const bool set = (m >> (l % LPT)) & 1u;
      const unsigned ballot = __ballot_sync(0xffffffffu, set);
      const int pos = run + __popc(ballot & below);
      if (set && pos < cap) {
        ids[pos] = (int)(i0 + 32 * r);
        if constexpr (kVals) vals[pos] = val[r];
      }
      run += __popc(ballot);
    }
  }
  return carry;
}

// K6 on one row: mask[0..N) to ids[0..cap) and *count, one block.
__device__ __forceinline__ void compact_ids_row(
    const uint8_t* __restrict__ mask, int N, int cap,
    int32_t* __restrict__ ids, int32_t* __restrict__ count) {
  // mask[i] is byte i + shift of the 16-byte aligned base
  const int shift = (int)(reinterpret_cast<uintptr_t>(mask) & 15);
  const uint8_t* base = mask - shift;
  const long long end = (long long)shift + N;
  const int total = compact_row<16, false>(
      [&](long long v0) { return group_bits(base, v0, shift, end); }, shift,
      N, cap, ids, nullptr, 0, nullptr);
  fill_slots(ids + min(total, cap), cap - min(total, cap), N);
  if (threadIdx.x == 0) *count = total;
}

__global__ void __launch_bounds__(kThreads)
compact_ids_kernel(const uint8_t* __restrict__ mask, int N, int cap,
                   int32_t* __restrict__ ids, int32_t* __restrict__ count) {
  compact_ids_row(mask, N, cap, ids, count);
}

// K6's rows form: row t = blockIdx.y of a contiguous [T, N] mask (any
// offset of each row) to ids[t, 0..cap) and count[t].
__global__ void __launch_bounds__(kThreads)
compact_ids_rows_kernel(const uint8_t* __restrict__ mask, int N, int cap,
                        int32_t* __restrict__ ids,
                        int32_t* __restrict__ count) {
  const long long t = blockIdx.y;
  compact_ids_row(mask + t * N, N, cap, ids + t * cap, count + t);
}

constexpr int kGatherUnroll = 8;                // table loads before stores
constexpr int kGatherBlocks = 32;               // K7's G

// K7 on one row.  Block b of G = gridDim.x gathers entries [n_e b / G,
// n_e (b + 1) / G) of the n_e = kept * MO filled ones and fills its share
// of the rest alike.
__device__ __forceinline__ void compact_gather_row(
    const uint8_t* __restrict__ mask, int N,
    const int32_t* __restrict__ table, int MO, int cap, int fill,
    int32_t* ids, int32_t* __restrict__ rows, int32_t* __restrict__ count) {
  const int shift = (int)(reinterpret_cast<uintptr_t>(mask) & 15);
  const uint8_t* base = mask - shift;
  const long long end = (long long)shift + N;
  const int total = compact_row<16, false>(
      [&](long long v0) { return group_bits(base, v0, shift, end); }, shift,
      N, cap, ids, nullptr, 0, nullptr);
  const int kept = min(total, cap);
  const long long G = gridDim.x, b = blockIdx.x;
  const long long n_e = (long long)kept * MO;
  const long long n_fill = (long long)(cap - kept) * MO;
  if (b == 0) {
    fill_slots(ids + kept, cap - kept, N);
    if (threadIdx.x == 0) *count = total;
  }
  const long long f0 = n_fill * b / G, f1 = n_fill * (b + 1) / G;
  fill_slots(rows + n_e + f0, (int)(f1 - f0), fill);
  __syncthreads();                              // the ids, to the block
  const long long g1 = n_e * (b + 1) / G;
  long long e0 = n_e * b / G + threadIdx.x;
  if (e0 >= g1) return;
  // entry e is (slot r, column c); kThreads entries on is q slots and rm
  // columns on
  const int q = kThreads / MO, rm = kThreads % MO;
  int r = (int)(e0 / MO), c = (int)(e0 % MO);
  for (; e0 < g1; e0 += (long long)kGatherUnroll * kThreads) {
    int v[kGatherUnroll];
#pragma unroll
    for (int j = 0; j < kGatherUnroll; ++j) {
      if (e0 + (long long)j * kThreads < g1)
        v[j] = __ldg(table + (long long)ids[r] * MO + c);
      r += q;
      c += rm;
      if (c >= MO) {
        c -= MO;
        ++r;
      }
    }
#pragma unroll
    for (int j = 0; j < kGatherUnroll; ++j)
      if (e0 + (long long)j * kThreads < g1)
        rows[e0 + (long long)j * kThreads] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
compact_gather_kernel(const uint8_t* __restrict__ mask, int N,
                      const int32_t* __restrict__ table, int MO, int cap,
                      int fill, int32_t* ids, int32_t* __restrict__ rows,
                      int32_t* __restrict__ count) {
  compact_gather_row(mask, N, table, MO, cap, fill, ids, rows, count);
}

// K7's rows form: row t = blockIdx.y of a contiguous [T, N] mask, gathered
// from the one [N, MO] table by its G blocks into ids[t], rows[t] and
// count[t].
__global__ void __launch_bounds__(kThreads)
compact_gather_rows_kernel(const uint8_t* __restrict__ mask, int N,
                           const int32_t* __restrict__ table, int MO, int cap,
                           int fill, int32_t* ids, int32_t* __restrict__ rows,
                           int32_t* __restrict__ count) {
  const long long t = blockIdx.y;
  compact_gather_row(mask + t * N, N, table, MO, cap, fill, ids + t * cap,
                     rows + t * cap * MO, count + t);
}

// K9's three readings of the [D, M] mask: rows interleaved as the
// contiguous [M, D] bytes of a transposed view (strides (1, D), 16 % D ==
// 0, a 16-byte aligned base), contiguous rows (stride (*, 1)), and any
// other strides, byte by byte.
enum Layout { kPacked, kRows, kStrided };

template <Layout L, int kD>
__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const uint8_t* __restrict__ mask, long long ms0,
                    long long ms1, const double* __restrict__ values,
                    long long vs0, long long vs1, int M, int cap,
                    int32_t* __restrict__ idx, double* __restrict__ vals,
                    int32_t* __restrict__ count) {
  const int d = blockIdx.x;
  const uint8_t* mrow = mask + d * ms0;
  const double* vrow = values + d * vs0;
  int32_t* irow = idx + (long long)d * cap;
  double* orow = vals + (long long)d * cap;
  int total;
  if constexpr (L == kPacked) {
    // thread t of a pass reads 16-byte group t: 16 / kD columns x kD rows
    const long long bytes = (long long)kD * M;
    total = compact_row<16 / kD, true>(
        [=](long long v0) {
          return row_bits<kD>(group_bits(mask, v0 * kD, 0, bytes), d);
        },
        0, M, cap, irow, vrow, vs1, orow);
  } else if constexpr (L == kRows) {
    const int shift = (int)(reinterpret_cast<uintptr_t>(mrow) & 15);
    const uint8_t* base = mrow - shift;
    const long long end = (long long)shift + M;
    total = compact_row<16, true>(
        [&](long long v0) { return group_bits(base, v0, shift, end); }, shift,
        M, cap, irow, vrow, vs1, orow);
  } else {
    total = compact_row<16, true>(
        [&](long long v0) {
          unsigned bits = 0;
          for (int j = 0; j < 16; ++j)
            if (v0 + j < M && mrow[(v0 + j) * ms1] != 0) bits |= 1u << j;
          return bits;
        },
        0, M, cap, irow, vrow, vs1, orow);
  }
  const int kept = min(total, cap);
  fill_slots(irow + kept, cap - kept, M);
  fill_slots(orow + kept, cap - kept, 0.0);
  if (threadIdx.x == 0) count[d] = total;
}

template <Layout L, int kD = 1>
int launch_rows(int D, cudaStream_t stream, const void* mask, long long ms0,
                long long ms1, const void* values, long long vs0,
                long long vs1, int M, int cap, void* idx, void* vals,
                void* count) {
  compact_rows_kernel<L, kD><<<D, kThreads, 0, stream>>>(
      (const uint8_t*)mask, ms0, ms1, (const double*)values, vs0, vs1, M, cap,
      (int32_t*)idx, (double*)vals, (int32_t*)count);
  return (int)cudaGetLastError();
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
  compact_gather_kernel<<<kGatherBlocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, N, (const int32_t*)table, MO, cap, fill,
      (int32_t*)ids, (int32_t*)rows, (int32_t*)count);
  return (int)cudaGetLastError();
}

extern "C" int compact_ids_rows_launch(const void* mask, int T, int N,
                                       int cap, void* ids, void* count,
                                       void* stream) {
  if (T <= 0) return 0;
  compact_ids_rows_kernel<<<dim3(1, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, N, cap, (int32_t*)ids, (int32_t*)count);
  return (int)cudaGetLastError();
}

extern "C" int compact_gather_rows_launch(const void* mask, int T, int N,
                                          const void* table, int MO, int cap,
                                          int fill, void* ids, void* rows,
                                          void* count, void* stream) {
  if (T <= 0) return 0;
  compact_gather_rows_kernel<<<dim3(kGatherBlocks, T), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)mask, N, (const int32_t*)table, MO, cap, fill,
      (int32_t*)ids, (int32_t*)rows, (int32_t*)count);
  return (int)cudaGetLastError();
}

extern "C" int compact_rows_launch(const void* mask, long long ms0,
                                   long long ms1, const void* values,
                                   long long vs0, long long vs1, int D, int M,
                                   int cap, void* idx, void* vals, void* count,
                                   void* stream) {
  if (D <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool packed = ms0 == 1 && ms1 == D &&
                      (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const auto args = [&](auto launch) {
    return launch(D, s, mask, ms0, ms1, values, vs0, vs1, M, cap, idx, vals,
                  count);
  };
  if (packed && D == 2) return args(launch_rows<kPacked, 2>);
  if (packed && D == 4) return args(launch_rows<kPacked, 4>);
  if (packed && D == 8) return args(launch_rows<kPacked, 8>);
  if (packed && D == 16) return args(launch_rows<kPacked, 16>);
  if (ms1 == 1) return args(launch_rows<kRows>);
  return args(launch_rows<kStrided>);
}
