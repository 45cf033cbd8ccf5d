"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

One subpackage per kernel family, mirroring ``repro.kernels``:
  <name>.py  - the CUDA wrapper (checks, launch through ctypes, count)
  ops.py     - dispatch: plain version for CPU tensors, the kernel for
               CUDA tensors (or raise) -- never a silent fallback
  ref.py     - the plain PyTorch version

Kernels (sources in ``repro_torch/csrc``, built by ``kernels/build.py``):
  hines       - K1 tree factor, K2 factored solve,
                K3 fused solve                       (csrc/hines.cu)
  hh_rhs      - K4 fused HH rates + ionic current   (csrc/hh_rhs.cu)
  event_wheel - K5 fused horizon + runnable score   (csrc/horizon.cu)
                K6 gather-id compaction, K7 compaction
                + table-row gather                   (csrc/compact.cu)
                K8 segment ranking                   (csrc/segment_rank.cu)
                K9 row-wise parcel compaction        (csrc/compact.cu)
  attention   - K10 flash attention, causal/bidirectional
                GQA with a decode offset           (csrc/flash_attention.cu)
"""
