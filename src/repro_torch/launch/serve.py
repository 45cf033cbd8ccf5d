"""Serving launcher of the port (``repro/launch/serve.py``): the LM's
continuous-batching loop on the PyTorch model of any family of the
registry (``--arch``), or (``--sim``) the multi-tenant simulation
service::

    python -m repro_torch.launch.serve --arch smollm-135m --reduced \\
        --requests 16 --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-7b --reduced \\
        --device cpu
    python -m repro_torch.launch.serve --sim --tenants 6 --lanes 3 \\
        --t-end 5 --device cpu

Requests arrive with prompts of 4-31 tokens; each is admitted into a free
batch slot and prefilled by feeding its prompt through the batched decode
step, with the cache write committed to the admitting slot only
(``merge_slot_state``): the other slots' caches stay bitwise untouched.
Then all slots decode in lockstep, greedily, at one shared host-side
``t_pos``; a slot retires after ``--max-new`` tokens or at the end of
the cache, and the whole window resets when the cache is exhausted (the
reference's toy rollover).  On the card every attention call is flash
attention (K10).  whisper decodes against the zero cross K/V of its
``make_cache``, as the reference's loop does.

``--sim`` serves ``--tenants`` FAP simulations of ``--n`` soma neurons
(``make_network(n, k_in=4, seed)``, currents 0.14-0.17 nA and QoS classes
0-1 from ``--seed``) through ``--lanes`` lanes of a ``SimService``, with
an optional poisoned tenant and per-tenant checkpoints, and prints the
accounting.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm


def merge_slot_state(new_state, old_state, slot: int, batch: int):
    """Keep slot ``slot``'s updates from ``new_state``; every other slot
    keeps ``old_state`` bitwise.  Every decode-state leaf is laid out
    [n_layers, B, ...] -- batch at axis 1."""
    if isinstance(new_state, dict):
        return {k: merge_slot_state(new_state[k], old_state[k], slot, batch)
                for k in new_state}
    if isinstance(new_state, (tuple, list)):
        return type(new_state)(merge_slot_state(n, o, slot, batch)
                               for n, o in zip(new_state, old_state))
    keep = torch.zeros((batch,), dtype=torch.bool, device=new_state.device)
    keep[slot] = True
    return torch.where(keep.reshape((1, batch) + (1,) * (new_state.dim() - 2)),
                       new_state, old_state)


def _clone(state):
    """A copy of a decode state (a flat dict of tensors), for the decode
    steps that write their caches in place."""
    return {k: v.clone() for k, v in state.items()}


def make_queue(cfg, requests: int, seed: int):
    """(id, prompt tokens) of ``requests`` requests, prompts of 4-31
    tokens, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab, rng.integers(4, 32)))
            for i in range(requests)]


class ServeResult(NamedTuple):
    done: int                 # requests served
    n_tokens: int             # tokens generated
    seconds: float            # host wall of the loop
    decode_steps: int         # decode_step calls, prefill included
    prefill_steps: int
    nonfinite_steps: int      # decode_step calls with a non-finite logit
    tokens: dict              # request id -> generated tokens, in order


def greedy(logits):
    """Next token of every slot: argmax of logits [B, V] (first of ties)."""
    return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()


def serve_requests(cfg, params, queue, slots: int, max_new: int,
                   cache_len: int, device="cuda", pick=greedy) -> ServeResult:
    """Serve ``queue`` (list of (id, prompt)) through ``slots`` batch
    slots of a ``cache_len`` KV cache; ``pick`` maps the decode logits
    [B, V] to the next tokens (numpy int [B])."""
    queue = list(queue)
    n_requests = len(queue)
    B, S = slots, cache_len
    state = lm.make_decode_state(cfg, B, S, device=device)
    dev = next(iter(state.values())).device
    slot_free = [True] * B
    slot_req = [None] * B
    slot_left = [0] * B
    cur_tok = np.zeros((B, 1), np.int32)
    tokens = {rid: [] for rid, _ in queue}
    done, n_tokens, steps, prefill_steps = 0, 0, 0, 0
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    t_pos = 0
    t0 = time.perf_counter()
    while done < n_requests or any(not f for f in slot_free):
        # admit
        for b in range(B):
            if slot_free[b] and queue:
                rid, prompt = queue.pop(0)
                # prefill by feeding prompt tokens through decode steps,
                # committing the cache write to slot b only
                for tok in prompt[:-1]:
                    if t_pos >= S - max_new - 1:
                        break
                    logits, new_state = lm.decode_step(
                        cfg, params, np.full((B, 1), tok, np.int32),
                        _clone(state), t_pos, device=device)
                    bad += (~torch.isfinite(logits)).any()
                    state = merge_slot_state(new_state, state, b, B)
                    t_pos += 1
                    steps += 1
                    prefill_steps += 1
                cur_tok[b, 0] = prompt[-1]
                slot_free[b] = False
                slot_req[b] = rid
                slot_left[b] = max_new
        if all(slot_free):
            break
        # decode one step for the whole batch
        logits, state = lm.decode_step(cfg, params, cur_tok.copy(), state,
                                       t_pos, device=device)
        bad += (~torch.isfinite(logits)).any()
        t_pos += 1
        steps += 1
        nxt = np.asarray(pick(logits[:, 0]), np.int32)
        for b in range(B):
            if slot_free[b]:
                continue
            cur_tok[b, 0] = nxt[b]
            tokens[slot_req[b]].append(int(nxt[b]))
            n_tokens += 1
            slot_left[b] -= 1
            if slot_left[b] <= 0 or t_pos >= S - 1:
                slot_free[b] = True
                done += 1
        if t_pos >= S - 2:
            # cache exhausted: reset window (toy rollover)
            state = lm.make_decode_state(cfg, B, S, device=device)
            t_pos = 0
    nonfinite = int(bad)
    return ServeResult(done, n_tokens, time.perf_counter() - t0, steps,
                       prefill_steps, nonfinite, tokens)


def lm_main(args) -> ServeResult:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, args.seed, device=args.device)
    queue = make_queue(cfg, args.requests, args.seed)
    res = serve_requests(cfg, params, queue, args.slots, args.max_new,
                         args.cache_len, device=args.device)
    dt = res.seconds
    print(f"served {res.done} requests, {res.n_tokens} tokens in {dt:.2f}s "
          f"({res.n_tokens/max(dt,1e-9):.1f} tok/s, slots={args.slots})")
    return res


def sim_main(args):
    """The ``--sim`` service run; prints its accounting and returns its
    ``serve.ServeResult``."""
    from repro_torch.checkpoint import ExponentialBackoff, FaultPlan
    from repro_torch.core import morphology, network
    from repro_torch.core.cell import CellModel
    from repro_torch.serve import SimService, TenantRequest

    model = CellModel(morphology.soma_only(), device=args.device)
    net = network.make_network(args.n, k_in=4, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    fault = None
    if args.poison_tenant >= 0:
        fault = FaultPlan(poison_at_round=args.poison_round,
                          poison_tenant=args.poison_tenant, poison_lane=0)
    svc = SimService(model, net, t_end=args.t_end, lanes=args.lanes,
                     queue_cap=args.queue_cap,
                     backoff=ExponentialBackoff(max_retries=args.max_retries),
                     qos_caps={0: max(2, args.n // 4)}, fault=fault,
                     ckpt_dir=args.ckpt_dir or None,
                     checkpoint_every=args.checkpoint_every,
                     runner_kwargs={"device": args.device})
    for rid in range(args.tenants):
        svc.submit(TenantRequest(
            rid=rid, iinj=float(0.14 + 0.03 * rng.random()),
            qos=int(rng.integers(0, 2))))
    t0 = time.perf_counter()
    res = svc.run()
    dt = time.perf_counter() - t0
    print(f"served {res.submitted} tenants in {res.rounds} rounds "
          f"({dt:.2f}s): {res.completed} completed, {res.evicted} evicted, "
          f"{res.rejected} rejected ({res.shed} shed), "
          f"{res.retried} retries / {res.quarantines} quarantines")
    w = res.health["admission_wait_rounds"]
    print(f"admission wait: mean {w['mean']:.1f} / max {w['max']} rounds; "
          f"straggler: {res.health['straggler']['flagged']} flagged of "
          f"{res.health['straggler']['recorded']}")
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim", action="store_true",
                    help="serve FAP simulations (repro_torch.serve) "
                    "instead of the LM")
    # LM mode
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4, help="batch slots")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # simulation mode
    ap.add_argument("--n", type=int, default=12, help="neurons per tenant")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--t-end", type=float, default=6.0)
    ap.add_argument("--queue-cap", type=int, default=8)
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--poison-tenant", type=int, default=-1,
                    help="rid to poison (FaultPlan demo; -1 = off)")
    ap.add_argument("--poison-round", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.sim:
        sim_main(args)
    else:
        lm_main(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
