"""Markdown table of the port's dry-run records::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both
    python3 scripts/dryrun_table.py [experiments/dryrun_torch]

One row per arch (and the paper's round), one column per shape, each
cell ``counted FLOP (model FLOP); argument GB per device, single / multi
mesh; collective GB per device, single / multi``; "-" where
``shape_applicable`` skips the cell.  Then the cells whose arguments
alone, unsharded on one card (reckoned here on the ``meta`` device),
exceed an 80 GB card, and each cell's one-device peak.  Counts of the
program, not measurements.
"""
from __future__ import annotations

import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

GB = 1e9
CARD_GB = 80.0


def one_card_gb(arch: str, shape: str) -> float:
    """The step's arguments unsharded, in GB."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_compat
    one = make_mesh_compat((1, 1), ("data", "model"))
    if arch in dryrun.PAPER_CELLS:
        from repro_torch.core.cell import CellModel
        from repro_torch.core.morphology import branched_tree
        from repro_torch.distributed.fap_spmd import PaperNeuroSpec
        model = CellModel(branched_tree(depth=3, seg_per_branch=2),
                          device="cpu")
        return dryrun.paper_argument_bytes(model, PaperNeuroSpec(), 1) / GB
    from repro_torch.configs import SHAPES, get_config
    kind = SHAPES[shape].kind
    _, args, specs = dryrun.build(get_config(arch), SHAPES[shape], one)
    return sum(dryrun.argument_bytes(kind, args, specs, one).values()) / GB


def load(d: str) -> dict:
    recs = {}
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        recs[r["arch"], r["shape"], r["mesh"]] = r
    return recs


def cell(one: dict, two: dict) -> str:
    flops = f"{one['counted_flops']:.4g} ({one['model_flops']:.4g}); " \
        if "counted_flops" in one else ""
    args = [r["argument_bytes_per_device"] / GB for r in (one, two)]
    coll = [r["collective_bytes_per_device"] / GB for r in (one, two)]
    return (f"{flops}{args[0]:.4g} / {args[1]:.4g}; "
            f"{coll[0]:.4g} / {coll[1]:.4g}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else os.path.join(os.path.dirname(__file__), "..",
                                          "experiments", "dryrun_torch")
    recs = load(d)
    shapes = sorted({s for _, s, _ in recs}, key=lambda s: (
        s == "sim_round", ["train_4k", "prefill_32k", "decode_32k",
                           "long_500k"].index(s) if s != "sim_round" else 0))
    lm_shapes = [s for s in shapes if s != "sim_round"]
    archs = sorted({a for a, _, _ in recs})
    print("| arch | " + " | ".join(lm_shapes) + " |")
    print("|---|" + "---|" * len(lm_shapes))
    errors, over, peaks = [], [], []
    for a in archs:
        row = []
        for s in (["sim_round"] if (a, "sim_round", "single") in recs
                  else lm_shapes):
            one, two = recs.get((a, s, "single")), recs.get((a, s, "multi"))
            if one is None or two is None:
                errors.append(f"{a} {s}: a mesh is missing")
                row.append("?")
                continue
            bad = [r for r in (one, two)
                   if r["status"] not in ("ok", "skipped")]
            if bad:
                errors.append(f"{a} {s}: {bad[0].get('error', '')[:80]}")
                row.append("error")
                continue
            if one["status"] == "skipped":
                row.append("-")
                continue
            row.append(cell(one, two))
            card = one_card_gb(a, s)
            if card > CARD_GB:
                over.append(f"{a} {s} {card:.4g}")
            if "peak_bytes_one_device" in one:
                peaks.append(f"{a} {s} {one['peak_bytes_one_device'] / GB:.4g}")
        if len(row) == 1 and len(lm_shapes) > 1:
            row[0] = f"{row[0]} (`sim_round`)"
        print(f"| {a} | " + " | ".join(row) + " |")
    print(f"\nArguments over {CARD_GB:.0f} GB on one card (GB): "
          f"{', '.join(over) or 'none'}.")
    print(f"\nPeak GB of the step on one device: {', '.join(peaks)}.")
    if errors:
        print(f"\nErrors: {'; '.join(errors)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
