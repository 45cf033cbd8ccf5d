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
// 4E bytes (E ~ 1e4 on the main path, tens of KB) but compares up to
// E^2/2 pairs.  The design keeps the TPU kernel's pairwise count, which
// needs no per-round key table, no atomics and no sort: thread j holds its
// key in a register, the block stages 256-key tiles of the earlier events
// in shared memory (every thread reads the same word: a broadcast, no bank
// conflicts) and counts equal keys.  A thread's count can stop at
// max_rank, so the block leaves its tile loop as soon as all of its
// threads have reached max_rank (__syncthreads_and); the count of what is
// left is exactly the pairwise count of the plain version
// (repro_torch/kernels/event_wheel/ref.py), clipped alike.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_rank_kernel(const int32_t* __restrict__ key, int E, int max_rank,
                    int32_t* __restrict__ rank) {
  __shared__ int32_t tile[kThreads];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int kj = j < E ? key[j] : 0;
  const int j_end = min(E, (int)(blockIdx.x + 1) * kThreads);
  int cnt = 0;
  for (int i0 = 0; i0 < j_end; i0 += kThreads) {
    if (__syncthreads_and(j >= E || cnt >= max_rank)) break;
    const int i = i0 + threadIdx.x;
    tile[threadIdx.x] = i < E ? key[i] : 0;
    __syncthreads();
    const int lim = min(kThreads, j - i0);      // tile entries before j
    for (int t = 0; t < lim; ++t) cnt += tile[t] == kj;
  }
  if (j < E) rank[j] = min(cnt, max_rank);
}

}  // namespace

extern "C" int segment_rank_launch(const void* key, int E, int max_rank,
                                   void* rank, void* stream) {
  if (E > 0) {
    const int blocks = (E + kThreads - 1) / kThreads;
    segment_rank_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)key, E, max_rank, (int32_t*)rank);
  }
  return (int)cudaGetLastError();
}
