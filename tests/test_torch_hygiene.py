"""Structural rules of the PyTorch port.

* Nothing under ``src/repro_torch/``, and nothing in ``chip_smoke.py``,
  imports ``jax`` or the JAX package ``repro``.
* Entry points default to ``device="cuda"`` and raise without a card
  rather than running on the CPU.
* A CUDA tensor handed to a kernel dispatcher launches the kernel or
  raises; it never falls back to the plain version, and no CUDA wrapper
  can reach one.  The kernel sources call no library kernel.
* The LM modules (``models/``, ``kernels/attention``) compute in bf16 and
  are held to tolerances, not to card == CPU bitwise equality, so the
  rounding rule below leaves them out.
* The neuron core and the SPMD round's step path (``distributed/
  {fap_spmd,exchange,group}.py``) round alike on the CPU and the card: no
  library transcendental or reduction whose last bit differs by device,
  and no division by a constant (``repro_torch/core/detmath.py``).
"""
import ast
import re
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import (calibrate, exec_bsp, exec_fap, fixed_step,
                              morphology, network)
from repro_torch.core.cell import CellModel
from repro_torch.distributed import fap_spmd, group
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.event_wheel import ops as ew_ops
from repro_torch.kernels.hh_rhs import ops as hh_ops
from repro_torch.kernels.hines import ops as hines_ops
from repro_torch.launch import serve
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
OPS_FILES = sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*/ops.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_never_imports_jax_or_reference(path):
    assert path.exists(), path
    bad = {r for r in _imported_roots(path) if r in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_dispatchers_have_no_fallback_path():
    assert len(OPS_FILES) == 4
    for path in OPS_FILES:
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


WRAPPER_FILES = sorted(p for p in (ROOT / "src" / "repro_torch" / "kernels")
                       .glob("*/*.py")
                       if p.stem not in ("__init__", "ops", "ref"))
SOURCE_FILES = sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"))


@pytest.mark.parametrize("path", WRAPPER_FILES, ids=lambda p: p.name)
def test_cuda_wrappers_never_reach_a_plain_version(path):
    """The CUDA wrappers (K10's three included) launch or raise: no
    ``try``, and no plain ``*_ref`` function in reach."""
    tree = ast.parse(path.read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | \
        {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)} | \
        {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
         for a in n.names}
    assert not [n for n in names if n.endswith("_ref")], path


@pytest.mark.parametrize("path", SOURCE_FILES, ids=lambda p: p.name)
def test_kernel_sources_use_no_library_kernels(path):
    """Every kernel is written here: no cuBLAS, cuDNN, CUTLASS device-level
    GEMM or PyTorch operator behind a launcher."""
    text = path.read_text()
    headers = {line.split()[1] for line in text.splitlines()
               if line.startswith("#include")}
    assert headers <= {"<cuda_bf16.h>", "<cuda_runtime.h>", "<math.h>",
                       "<stdint.h>", "<cstdint>"}, \
        f"{path.name} includes {headers}"
    for word in ("cublas", "cudnn", "cutlass", "scaled_dot_product"):
        assert word not in text.lower(), f"{path.name} mentions {word}"


@pytest.mark.parametrize("name,product", [("flash_prefill", "wgmma.mma_async"),
                                          ("flash_decode", "mma.sync"),
                                          ("flash_backward", "mma.sync")])
def test_k10_bf16_kernels_use_tensor_cores_and_async_copies(name, product):
    text = (ROOT / "src" / "repro_torch" / "csrc" / f"{name}.cu").read_text()
    assert product in text and "cp.async.cg.shared.global" in text
    assert "__nv_bfloat16" in text and "flash_attention_ref" not in text



def _code(text):
    """C++ source without its comments."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def test_k10_backward_is_deterministic_and_keeps_float32():
    """K10's backward sums in a fixed order (no atomic operation: a second
    call is bitwise the first), converts nothing to TF32, sums the GQA
    group in a thread-block cluster, and keeps the float32 kernels on the
    CUDA cores: explicit fmaf, no tensor-core product."""
    text = _code((ROOT / "src" / "repro_torch" / "csrc" /
                  "flash_backward.cu").read_text())
    for word in ("atomic", "tf32", "cvt.rna"):
        assert word not in text.lower(), word
    assert "cudaLaunchAttributeClusterDimension" in text
    assert "ld.shared::cluster" in text and "barrier.cluster" in text
    f32 = text[text.index("void __launch_bounds__(THREADS) "
                          "flash_bwd_dq_kernel("):text.index("int size_smem(")]
    assert "fmaf(" in f32 and "mma" not in f32 and "ldsm" not in f32

def _f32_kernel_sources():
    """The float32 K10 kernels' code: all of ``flash_attention.cu``, and
    ``flash_decode.cu``'s float32 kernel with its launcher plus the
    file's copy helpers (the bf16 kernel beside it uses mma.sync)."""
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    decode = (csrc / "flash_decode.cu").read_text()
    start = decode.index("flash_decode_f32_kernel(")
    body = decode[start:decode.index("}  // namespace", start)]
    helpers = decode[decode.index("__device__ __forceinline__ void "
                                  "cp_async16"):
                     decode.index("__device__ __forceinline__ void mma16816")]
    return {"f32_prefill": (csrc / "flash_attention.cu").read_text(),
            "f32_decode": helpers + body}


@pytest.mark.parametrize("kind", ["f32_prefill", "f32_decode"])
def test_k10_f32_kernels_use_cuda_cores_and_async_copies(kind):
    """Both float32 kernels fill their tiles with 16-byte cp.async copies
    and multiply with explicit fmaf on the CUDA cores: no tensor-core
    product (mma, wgmma) and no TF32 conversion, which would miss the
    float32 tolerance."""
    text = _f32_kernel_sources()[kind]
    assert "cp.async.cg.shared.global" in text and "fmaf(" in text
    assert re.search(r"load_tile<D(, DV)?>\(", text) and "expf(" in text
    assert "const float* __restrict__ q" in text
    for word in ("mma", "wgmma", "tf32", "cvt.rna"):
        assert word not in text, f"{kind} mentions {word}"


HOST_NUMPY = {"morphology.py", "topology.py", "network.py", "detmath.py"}
CORE_FILES = [p for p in sorted((ROOT / "src" / "repro_torch" / "core")
                                .glob("*.py")) if p.name not in HOST_NUMPY] \
    + sorted((ROOT / "src" / "repro_torch" / "sched").glob("*.py")) \
    + [p for p in sorted((ROOT / "src" / "repro_torch" / "kernels")
                         .glob("*/ref.py")) if p.parent.name != "attention"] \
    + [ROOT / "src" / "repro_torch" / "distributed" / f
       for f in ("fap_spmd.py", "exchange.py", "group.py")] \
    + sorted((ROOT / "src" / "repro_torch" / "serve").glob("*.py"))
DEVICE_DEPENDENT = {"exp", "expm1", "log", "pow", "sqrt", "mean", "sum"}


@pytest.mark.parametrize("path", CORE_FILES, ids=lambda p: p.name)
def test_core_rounds_alike_on_every_device(path):
    """Library transcendentals and reductions (``torch.exp(...)``,
    ``torch.sum(...)``) and ``x / 2.0`` round differently on the CPU and
    the card."""
    def constant(e):
        if isinstance(e, ast.UnaryOp):
            e = e.operand
        return isinstance(e, ast.Constant) or (
            isinstance(e, ast.Attribute) and e.attr.isupper())

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "torch":
            assert node.func.attr not in DEVICE_DEPENDENT, \
                f"{path.name}:{node.lineno} torch.{node.func.attr}"
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            assert constant(node.left) or not constant(node.right), \
                f"{path.name}:{node.lineno} division by a constant"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CellModel(morphology.soma_only())
    model = CellModel(morphology.soma_only(), device="cpu")
    net = network.make_network(8, k_in=2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exec_fap.make_fap_vardt_runner(model, net, 0.1, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exec_fap.run_fap_vardt(model, net, 0.1, 1.0, horizon_impl="fused")
    for make in (exec_bsp.make_bsp_fixed_runner,
                 exec_bsp.make_bsp_vardt_runner,
                 exec_fap.make_fap_fixed_runner):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(model, net, 0.1, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fixed_step.make_stepper(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fixed_step.run_fixed(model, model.init_state(), 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate.threshold_current(model, t_end=1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        group.launch(4, len)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fap_spmd.run_fap_spmd(model, net, 0.1, 1.0,
                              group.Group(0, 1, "gloo", "cuda"))


def test_robustness_and_service_entry_points_default_to_the_card(no_cuda):
    """The simulation service and ``--sim`` build their runner on the
    card unless told otherwise."""
    from repro_torch.serve import SimService
    model = CellModel(morphology.soma_only(), device="cpu")
    net = network.make_network(8, k_in=2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimService(model, net, t_end=1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--sim", "--tenants", "1", "--n", "8"])
    svc = SimService(model, net, t_end=1.0, lanes=1,
                     runner_kwargs={"device": "cpu"})
    assert svc._carry[0].t.device.type == "cpu"


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-moe-30b-a3b",
                                  "arctic-480b", "rwkv6-7b", "zamba2-7b",
                                  "whisper-base"])
def test_lm_entry_points_default_to_the_card(no_cuda, name):
    """Every family's entry points, whisper's ``frames`` included, and
    the serve CLI and example."""
    from repro_torch.examples import serve_decode
    cfg = get_config(name).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    state = lm.make_decode_state(cfg, 1, 8, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    batch = {"tokens": tok}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((1, cfg.enc_frames, cfg.d_model))
    for call in (lambda: lm.init_params(cfg, 0),
                 lambda: lm.make_decode_state(cfg, 1, 8),
                 lambda: lm.decode_step(cfg, params, tok, state, 0),
                 lambda: lm.forward_hidden(cfg, params, batch),
                 lambda: lm.prefill(cfg, params, batch),
                 lambda: serve.serve_requests(cfg, params, [], 1, 2, 8),
                 lambda: serve.main(["--arch", name, "--reduced",
                                     "--requests", "1"]),
                 lambda: serve_decode.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-moe-30b-a3b",
                                  "whisper-base"])
def test_training_entry_points_default_to_the_card(no_cuda, name, tmp_path):
    """``lm.loss_fn``, ``loss_and_grad``, ``train_step`` and
    ``init_train_state``, the data
    pipeline and the training launcher and example run on the card unless
    asked for the CPU."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataPipeline, make_batch
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    cfg = get_config(name).reduced()
    shape = ShapeConfig("t", 8, 1, "train")
    params, opt = lm.init_train_state(cfg, 0, device="cpu")
    batch = make_batch(cfg, shape, 0, 0, device="cpu")
    for call in (lambda: lm.init_train_state(cfg, 0),
                 lambda: lm.loss_fn(cfg, params, batch),
                 lambda: lm.loss_and_grad(cfg, params, batch),
                 lambda: lm.train_step(cfg, params, opt, batch, 1e-3),
                 lambda: make_batch(cfg, shape, 0, 0),
                 lambda: DataPipeline(cfg, shape).next_batch(),
                 lambda: train.main(["--arch", name, "--reduced", "--steps",
                                     "1", "--ckpt-dir", str(tmp_path)]),
                 lambda: train_lm.main(["--steps", "1", "--ckpt-dir",
                                        str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


class _CudaLike:
    """Stands in for a CUDA tensor on a machine without a card."""
    device = torch.device("cuda")
    shape = (3, 4)


def _boom(*_a, **_k):
    raise RuntimeError("kernel launch refused")


@pytest.mark.parametrize("mod,cuda_fn,call", [
    (hines_ops, "hines_factor_cuda",
     lambda x: hines_ops.hines_factor(None, None, x)),
    (hines_ops, "hines_solve_factored_cuda",
     lambda x: hines_ops.hines_solve_factored(None, None, x, x)),
    (hines_ops, "hines_solve_cuda",
     lambda x: hines_ops.hines_solve(None, None, x, x)),
    (hh_ops, "hh_rhs_cuda", lambda x: hh_ops.hh_rhs(None, x, x, x, x)),
    (ew_ops, "horizon_score_cuda",
     lambda x: ew_ops.horizon_score(x, None, None, t_end=1.0,
                                    horizon_cap=1.0)),
    (ew_ops, "compact_ids_cuda", lambda x: ew_ops.compact_ids(x, 4)),
    (ew_ops, "compact_gather_cuda",
     lambda x: ew_ops.compact_gather(x, None, 4, fill=0)),
    (ew_ops, "segment_rank_cuda", lambda x: ew_ops.segment_rank(x, 4)),
    (ew_ops, "compact_rows_cuda", lambda x: ew_ops.spike_compact(x, x, 4)),
    (attn_ops, "flash_attention_cuda",
     lambda x: attn_ops.flash_attention(x, x, x)),
    (attn_ops, "flash_attention_bwd_cuda",
     lambda x: attn_ops.flash_attention_bwd(x, x, x, x, x)),
])
def test_cuda_tensor_never_falls_back(monkeypatch, mod, cuda_fn, call):
    monkeypatch.setattr(mod, cuda_fn, _boom)
    with pytest.raises(RuntimeError, match="kernel launch refused"):
        call(_CudaLike())


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA wrappers themselves refuse host tensors before launching."""
    from repro_torch.kernels.event_wheel.event_wheel import (
        compact_gather_cuda, compact_ids_cuda, compact_rows_cuda,
        horizon_score_cuda, segment_rank_cuda)
    from repro_torch.kernels.hh_rhs.hh_rhs import hh_rhs_cuda
    from repro_torch.kernels.hines.hines import (hines_factor_cuda,
                                                 hines_solve_cuda)
    x = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        hines_factor_cuda(torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.float64), x)
    with pytest.raises(ValueError):
        hines_solve_cuda(torch.zeros(3, dtype=torch.int32),
                         torch.zeros(3, dtype=torch.float64), x, x)
    with pytest.raises(ValueError):
        hh_rhs_cuda(torch.zeros(4, dtype=torch.float64), x, x, x, x)
    with pytest.raises(ValueError):
        horizon_score_cuda(torch.zeros(4, dtype=torch.float64),
                           torch.zeros((2, 4), dtype=torch.int32),
                           torch.zeros((2, 4), dtype=torch.float64),
                           t_end=1.0, horizon_cap=1.0)
    mask = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        compact_ids_cuda(mask, 2)
    with pytest.raises(ValueError):
        compact_gather_cuda(mask, torch.zeros((4, 2), dtype=torch.int32), 2, 0)
    with pytest.raises(ValueError):
        segment_rank_cuda(torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        compact_rows_cuda(torch.zeros((2, 4), dtype=torch.bool),
                          torch.zeros((2, 4), dtype=torch.float64), 2)


def test_k10_takes_the_zoos_head_sizes():
    """16, 64, 128 and zamba2-7b's 112 in every kernel; 96 is refused."""
    from repro_torch.kernels.attention.flash import variant
    for D in (16, 64, 112, 128):
        assert variant(torch.float32, 1, 1, D) == "f32_decode"
        assert variant(torch.float32, 128, 1, D) == "f32_prefill"
        assert variant(torch.bfloat16, 1, 8, D) == "decode"
        assert variant(torch.bfloat16, 128, 1, D) == "prefill"
    with pytest.raises(ValueError, match="head_dim 96"):
        variant(torch.bfloat16, 1, 1, 96)


def test_flash_attention_wrapper_refuses_what_it_cannot_take():
    from repro_torch.kernels.attention.flash import flash_attention_cuda
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, q, q)
    # meta tensors are the dry run's: what a kernel would take gets an
    # empty output in the kernels' layout, the rest is refused as on a card
    m = torch.zeros((1, 2, 4, 16), device="meta")
    out = attn_ops.flash_attention(m, m, m)
    assert out.device.type == "meta" and out.shape == m.shape
    m96 = torch.zeros((1, 2, 4, 96), device="meta")
    with pytest.raises(ValueError, match="head_dim 96"):
        attn_ops.flash_attention(m96, m96, m96)
    with pytest.raises(ValueError, match="offset"):
        attn_ops.flash_attention(m, m, m, offset=-1)


def test_other_devices_are_refused():
    x = torch.zeros((2, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        hh_ops.hh_rhs(x[0], x, x, x, x)
    with pytest.raises(ValueError):
        hines_ops.hines_factor(None, None, x)
    with pytest.raises(ValueError):
        hines_ops.hines_solve(None, None, x, x)
    m = torch.zeros(3, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        ew_ops.compact_ids(m, 2)
    with pytest.raises(ValueError):
        ew_ops.segment_rank(m.to(torch.int32), 2)
    with pytest.raises(ValueError):
        ew_ops.spike_compact(m[None], m[None].to(torch.float64), 2)
