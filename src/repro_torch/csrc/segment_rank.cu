// Segment ranking (K8) for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/event_wheel/event_wheel.py::segment_rank_pallas
//
// rank[j] = |{i < j : key[i] == key[j]}|, clipped at max_rank.  The event
// wheel's batch insert uses it to give the events that hit one (neuron,
// bucket) distinct slots, in event-index order.
//
// What bounds it on the card: integer operations.  It reads and writes
// 4E bytes (E ~ 4e3 on the active path, tens of KB) but compares up to
// E^2/2 pairs.  The design keeps the TPU kernel's pairwise count, which
// needs no per-round key table, no atomics and no sort, and spreads each
// event's count over a warp, so the longest dependent chain is about
// E / 128 trips, not E compares:
//
// * One warp per event, 32 events per block of 1024 threads.  Event j
//   compares j keys, so the block's warps take 16 events from the front of
//   the batch and 16 from its back (block b: events 16b + w and
//   E - 1 - 16b - w): every block does about the same work, and E = 4224
//   is 132 blocks, one per SM.
// * The block stages the keys its events need, key[0, j_end), in shared
//   memory (16-byte loads where the keys are 16-byte aligned), behind one
//   barrier.  Batches over kChunk keys are staged in chunks of kChunk into
//   two buffers that alternate, one barrier per chunk.
// * Lane l counts the equal keys of the 16-byte groups l, l + 32, ... below
//   j (consecutive 16-byte words across the warp: no bank conflicts), in
//   unrolled blocks of kCheck = 8 trips, so eight loads are in flight;
//   after each block the warp sums its partial counts (__reduce_add_sync)
//   and stops once they reach max_rank (the wheel's invalid key N*B, shared
//   by every padding slot of the batch, reaches it within its first
//   block).  Lane 0 stores min(sum, max_rank).  On the active path's keys
//   the blocks of 8 measured faster than blocks of 4 or 16, than 8
//   unrolled trips without the stop, and than a check every fourth trip
//   of a rolled loop; reading the keys from global memory through L1
//   instead of staging them took twice as long (PERF.md, PR 19).
//
// Integer counts and min do not depend on the order in which pairs are
// counted, so the result equals the pairwise count of the plain version
// (repro_torch/kernels/event_wheel/ref.py) bit for bit;
// ref.segment_rank_split_ref models this schedule on the CPU.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = kWarps / 2;       // events from each end, per block
constexpr int kChunk = 28672;           // keys of one staged chunk: two
                                        // buffers take 224 of the 227 KB
constexpr int kCheck = 8;               // trips between early-stop checks

__global__ void __launch_bounds__(kThreads)
segment_rank_kernel(const int32_t* __restrict__ key, int E, int max_rank,
                    int chunk, int32_t* __restrict__ rank) {
  extern __shared__ int4 tiles[];       // one or two buffers of chunk keys
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int front = (E + 1) / 2;        // events [0, front) from the front
  const int t0 = kHalf * blockIdx.x;
  const int t = t0 + warp % kHalf;
  const int j = warp < kHalf ? (t < front ? t : -1)
                             : (t < E - front ? E - 1 - t : -1);
  // the block's events compare keys [0, j_end): its first back event's
  // j + 1, or with no back event its last front event's
  const int j_end = t0 < E - front ? E - t0 : min(front, t0 + kHalf);
  const int kj = j >= 0 ? key[j] : 0;
  const bool vec = (reinterpret_cast<uintptr_t>(key) & 15) == 0;
  int cnt = 0;
  bool done = j < 0 || max_rank <= 0;   // uniform in the warp
  for (int c0 = 0, buf = 0; c0 < j_end; c0 += chunk, buf ^= 1) {
    const int n = min(chunk, j_end - c0);
    int4* tile4 = tiles + buf * (chunk / 4);
    int32_t* tile = reinterpret_cast<int32_t*>(tile4);
    const int32_t* src = key + c0;
    if (vec) {
      const int4* src4 = reinterpret_cast<const int4*>(src);
      for (int q = tid; q < n / 4; q += kThreads) tile4[q] = src4[q];
      if (tid < n % 4) tile[n - n % 4 + tid] = src[n - n % 4 + tid];
    } else {
      for (int i = tid; i < n; i += kThreads) tile[i] = src[i];
    }
    __syncthreads();
    if (!done) {
      const int lim = min(j - c0, n);   // keys of the chunk before j
      const int trips = lim / 128;      // full trips: 32 lanes x 4 keys
      int k = 0;
      for (; k + kCheck <= trips; k += kCheck) {
#pragma unroll
        for (int u = 0; u < kCheck; ++u) {   // kCheck loads in flight
          const int4 v = tile4[32 * (k + u) + lane];
          cnt += (v.x == kj) + (v.y == kj) + (v.z == kj) + (v.w == kj);
        }
        if ((int)__reduce_add_sync(0xffffffffu, cnt) >= max_rank) {
          done = true;
          break;
        }
      }
      if (!done) {
        for (; k < trips; ++k) {
          const int4 v = tile4[32 * k + lane];
          cnt += (v.x == kj) + (v.y == kj) + (v.z == kj) + (v.w == kj);
        }
        const int i = 128 * trips + 4 * lane;   // the last, partial trip
        for (int e = 0; e < 4; ++e) cnt += i + e < lim && tile[i + e] == kj;
        done = j <= c0 + n ||
               (int)__reduce_add_sync(0xffffffffu, cnt) >= max_rank;
      }
    }
  }
  if (j >= 0) {
    const int total = (int)__reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) rank[j] = min(total, max_rank);
  }
}

}  // namespace

extern "C" int segment_rank_launch(const void* key, int E, int max_rank,
                                   void* rank, void* stream) {
  if (E <= 0) return 0;
  const int chunk = E < kChunk ? (E + 3) / 4 * 4 : kChunk;
  const size_t smem = (E > chunk ? 2 : 1) * (size_t)chunk * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (E + kWarps - 1) / kWarps;
  segment_rank_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)key, E, max_rank, chunk, (int32_t*)rank);
  return (int)cudaGetLastError();
}
