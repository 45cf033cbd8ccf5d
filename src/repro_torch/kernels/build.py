"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds plain ``extern "C"`` launchers.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``repro_torch/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``.  The library name carries a hash of the source and flags, so
an edited source is rebuilt and a stale library is never loaded.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into fused
multiply-adds: the neuron core is float64 and each kernel must keep the
float operation order of its plain PyTorch version.  Flash attention (K10)
is held to a tolerance instead and has four kernels in three sources,
chosen by ``kernels/attention/flash.py::variant`` from the dtype and
whether Sq * group is at most 64 (decode) or above it (prefill): float32
inputs run on the CUDA cores (fused multiply-adds written out as
``fmaf``), ``flash_decode.cu``'s float32 kernel (one block per GQA group)
and ``flash_attention.cu`` (register-tiled); bfloat16 inputs run
``flash_decode.cu`` (``mma.sync``, one block per GQA group) and
``flash_prefill.cu`` (``wgmma``).  All four fill their shared-memory tiles
with ``cp.async``; none uses TMA, so no source links the driver API.
K10's gradient, ``flash_backward.cu``, is two kernels (dq, then dk and
dv; ``mma.sync`` for bf16 inputs, the CUDA cores for float32 ones, the
dk/dv blocks of a GQA group one thread-block cluster) that a training
step's backward pass launches through
``kernels/attention/ops.py::FlashAttentionFn``.

Every launcher returns ``cudaGetLastError()``; :func:`check` raises when
it is not 0.  Each wrapper adds one to its launch counter (``count``)
where it launches its kernel, and nowhere else.  K1, K2 and K3 count every
launch under their names and a launch of their warp frame (the trees
whose tiles do not fit) also under ``hines_{factor,solve_factored,
solve}_warp``.  K10 counts each call under
``flash_attention`` and under the kernel that ran
(``flash_attention_{f32_decode,f32_prefill,decode,prefill}``); its
backward counts ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkdv``
once each a call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("hines", "hh_rhs", "horizon", "compact", "segment_rank",
           "flash_attention", "flash_prefill", "flash_decode",
           "flash_backward")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}
_LOGS: dict = {}
LAUNCHES = {"hines_factor": 0, "hines_solve_factored": 0, "hines_solve": 0,
            "hines_factor_warp": 0, "hines_solve_factored_warp": 0,
            "hines_solve_warp": 0,
            "hh_rhs": 0, "horizon_score": 0, "compact_ids": 0,
            "compact_gather": 0, "compact_ids_rows": 0,
            "compact_gather_rows": 0, "segment_rank": 0, "compact_rows": 0,
            "flash_attention": 0, "flash_attention_f32_decode": 0,
            "flash_attention_f32_prefill": 0, "flash_attention_prefill": 0,
            "flash_attention_decode": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkdv": 0}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        _LOGS[name] = proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names=SOURCES) -> dict:
    """Build every kernel source at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = dict(zip(names, pool.map(build, names)))
    return paths


def ptxas_log(name: str) -> str:
    """nvcc's ``-Xptxas -v`` report (registers, spills) of the last build."""
    return _LOGS.get(name, "")


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """The current stream of CUDA ``device``, read without making a
    ``torch.cuda.Stream`` object."""
    import torch
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict:
    return dict(LAUNCHES)
