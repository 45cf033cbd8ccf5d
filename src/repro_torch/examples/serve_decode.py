"""Batched serving example on the port: the continuous-batching decode
loop of ``launch/serve.py`` over the unified LM API, on reduced
qwen3-moe-30b-a3b.  The port's copy of ``examples/serve_decode.py``;
``python -m repro_torch.launch.serve --arch <name> --reduced`` serves any
other configuration of the registry.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve_main([
        "--arch", "qwen3-moe-30b-a3b", "--reduced",
        "--requests", "8", "--slots", "4", "--max-new", "16",
        "--cache-len", "128", "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
