"""End-to-end LM training on the port (the port's copy of
``examples/train_lm.py``): a ~22M-parameter smollm-family model for a few
hundred steps with checkpointing and fault tolerance, through
``launch/train.py``: smollm-135m's own width (d 576, head size 64) at 6
layers and a 2048-token vocabulary.  The JAX example's d 192 gives 9
heads of 21 dims, which RoPE's even split and K10's head sizes refuse.
The code path is that of the full configs.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args = ap.parse_args(argv)
    return train_main([
        "--arch", "smollm-135m",
        "--d-model", "576", "--n-layers", "6", "--vocab", "2048",
        "--steps", str(args.steps), "--batch", "8", "--seq", "128",
        "--ckpt-dir", args.ckpt_dir, "--save-every", "50",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
