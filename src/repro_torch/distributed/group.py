"""The process group of the SPMD round: ranks, collectives, per-channel
byte counters and the launcher that starts the ranks.

Counterpart of the JAX ``mesh`` argument and of
``repro.distributed.exchange``'s ``shard_index`` / ``_gather_axes``.  Each
shard of the network is one process (a rank) that holds its neurons on its
own device; the ranks talk only through ``torch.distributed``
collectives.  ``Group`` wraps the three kinds the transports use -- a
tiled all-gather, a row-wise all-to-all and an all-reduce (sum, min,
max) -- and adds, at each call, the bytes that the collective delivers to
this rank and the host wall time spent in it to a counter under the
caller's channel tag (``exchange_notify``, ``exchange_parcel``,
``exchange_counts``, ``exchange_parcel_c<cap>``; ``other`` for telemetry
and the end-of-run gathers).  The counters take the place of the JAX
package's per-channel HLO attribution
(``repro.launch.hlo_analysis.collective_channel_bytes``); the dry run
reckons the same bytes of one round without running it
(``launch/comm_analysis.py::paper_round_bytes``).

``launch(world, fn, *args, backend=..., device=...)`` spawns ``world``
ranks, runs ``fn(group, *args)`` on each and returns rank 0's result; a
failure in any rank is raised in the caller.  The ranks meet through a
``FileStore`` in a fresh temporary directory, so concurrent launches never
collide.  With ``device="cuda"`` every rank uses the same card,
``cuda:0`` (the card's machine has one): NCCL refuses two ranks on one
card, so the ranks talk over gloo, which accepts CUDA tensors and stages
them through host memory itself.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from collections import defaultdict

import torch
import torch.distributed as dist

# ``all_gather_single`` is the newer name of ``all_gather_into_tensor``
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
       "max": dist.ReduceOp.MAX}


class Group:
    """One rank's view of the group: rank, world size, backend, device and
    the per-channel counters (``bytes``, ``seconds``, ``calls`` by tag)."""

    def __init__(self, rank: int, world: int, backend: str, device):
        self.rank, self.world, self.backend = rank, world, backend
        self.device = torch.device(device)
        self.reset_counters()

    def reset_counters(self) -> None:
        self.bytes = defaultdict(int)
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    def counters(self) -> dict:
        """{tag: {"bytes", "seconds", "calls"}} of this rank."""
        return {k: {"bytes": self.bytes[k], "seconds": self.seconds[k],
                    "calls": self.calls[k]} for k in sorted(self.calls)}

    def _timed(self, tag: str, nbytes: int, fn):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn()
        self.seconds[tag] += time.perf_counter() - t0
        self.bytes[tag] += int(nbytes)
        self.calls[tag] += 1

    def all_gather(self, x, tag: str):
        """Tiled all-gather along dim 0: [m, ...] -> [world * m, ...],
        rank r's block at rows [r * m, (r + 1) * m)."""
        x = x.contiguous()
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        self._timed(tag, out.numel() * out.element_size(),
                    lambda: _ALL_GATHER(out, x))
        return out

    def all_to_all(self, x, tag: str):
        """Row-wise all-to-all: x [world, ...], row d goes to rank d; row s
        of the result is the row that rank s sent here."""
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all needs {self.world} rows, got "
                             f"{tuple(x.shape)}")
        x = x.contiguous()
        out = torch.empty_like(x)
        self._timed(tag, out.numel() * out.element_size(),
                    lambda: dist.all_to_all_single(out, x))
        return out

    def all_reduce(self, x, op: str, tag: str):
        """Elementwise reduction over the ranks (``op`` in sum/min/max) of a
        copy of ``x``.  Integer sums are exact; a float sum would depend on
        the order of the ranks and is not used on the step path."""
        out = x.clone().contiguous()
        self._timed(tag, out.numel() * out.element_size(),
                    lambda: dist.all_reduce(out, op=OPS[op]))
        return out


def _rank_main(rank, world, store_path, backend, device, fn, args, outdir):
    def note_failure():
        # written at once, before the group is torn down, so that this
        # rank's error predates those it causes in the others
        path = os.path.join(outdir, f"error-{rank}.txt")
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(traceback.format_exc())

    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                              world),
                                rank=rank, world_size=world)
        try:
            result = fn(Group(rank, world, backend, dev), *args)
            if rank == 0:
                torch.save(result, os.path.join(outdir, "result.pt"))
        except BaseException:
            note_failure()
            raise
        finally:
            dist.destroy_process_group()
    except BaseException:
        note_failure()
        raise SystemExit(1)


def launch(world: int, fn, *args, backend: str = "gloo", device="cuda",
           timeout: float = 3600.0):
    """Run ``fn(group, *args)`` on ``world`` spawned ranks and return rank
    0's result (loaded onto the CPU).  ``fn`` and ``args`` must pickle.
    ``device``: "cuda" (default; raises without a card) or "cpu".
    Raises if a rank fails, naming its traceback; then stops the other
    ranks, which would otherwise wait in a collective."""
    import multiprocessing as mp

    from repro_torch import resolve_device
    device = resolve_device(device)
    pickle.dumps((fn, args))             # fail here, not in the ranks
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store, backend, str(device), fn,
                                   args, tmp), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        t0 = time.monotonic()
        try:
            while any(p.is_alive() for p in procs):
                bad = [p for p in procs if p.exitcode not in (None, 0)]
                if bad or time.monotonic() - t0 > timeout:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        errors = sorted((os.path.getmtime(os.path.join(tmp, f)), f)
                        for f in os.listdir(tmp) if f.startswith("error-"))
        if errors:                           # the first rank that failed
            name = errors[0][1]
            text = open(os.path.join(tmp, name)).read()
            raise RuntimeError(f"rank {name[6:-4]} of {world} failed:\n"
                               f"{text}")
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"ranks ended with exit codes "
                               f"{[p.exitcode for p in procs]} (time limit "
                               f"{timeout} s)")
        return torch.load(os.path.join(tmp, "result.pt"),
                          map_location="cpu", weights_only=False)
