"""Write variant trees of the Hines warp frame for ``scripts/kernel_ab.py``.

    python3 scripts/hines_variants.py OUT_DIR
    python3 scripts/kernel_ab.py . OUT_DIR/l1 OUT_DIR/frow --order ABCCBA \\
        --only hines --t-end 0

Each variant is this checkout's ``src/`` with ``csrc/hines.cu`` and
``kernels/hines/hines.py`` edited in one place of design, so that
``kernel_ab.py`` holds it against the frame as it is:

* ``l1``: K2 stages only b and reads d_elim through L1 (one row of C
  float64 a neuron, so up to 16 neurons a block at C = 1021, not 12);
* ``frow``: K2 stages a third row, its C multipliers g_axial[i] /
  d_elim[i] divided before the forward sweep by all 32 lanes (as the tile
  frame does; three rows a neuron, so 8 neurons a block at C = 1021).

Both keep the bits of the plain versions (``kernel_ab.py`` reports
``bitwise``).
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "src/repro_torch/csrc/hines.cu"
PY = "src/repro_torch/kernels/hines/hines.py"

ROWS_PY = ('WARP_ROWS = {"hines_factor": 1, "hines_solve_factored": 2, '
           '"hines_solve": 2}')

VARIANTS = {
    "l1": [
        (PY, ROWS_PY, ROWS_PY.replace('"hines_solve_factored": 2',
                                      '"hines_solve_factored": 1')),
        (CU, "  return kind == kFactor ? 1 : 2;",
         "  return kind == kFactor || kind == kFactored ? 1 : 2;"),
        (CU, "template <Kind kind, bool kPacked, class R>\n",
         "template <Kind kind, bool kPacked, class RW, class RX>\n"),
        (CU, "R W, R X,\n    int g) {", "RW W, RX X,\n    int g) {"),
        (CU, "      cp_async8(rows + c, a + m * a_sn + c * a_sc);\n"
             "      if (R == 2) cp_async8(rows + C + c, "
             "b + m * b_sn + c * b_sc);",
         "      if (kind != kFactored) "
         "cp_async8(rows + c, a + m * a_sn + c * a_sc);\n"
         "      if (kind != kFactor) cp_async8(rows + (R == 2 ? C : 0) + c, "
         "b + m * b_sn + c * b_sc);"),
        (CU, "    Row<kStaged> W, X;\n    if (kStaged) {\n"
             "      W = {rows, 1};\n      X = {rows + C, 1};",
         "    Row<kStaged && kind != kFactored> W;\n    Row<kStaged> X;\n"
         "    if (kStaged) {\n"
         "      W = {kind == kFactored ? const_cast<double*>(a + n * a_sn) "
         ": rows, a_sc};\n"
         "      X = {R == 2 ? rows + C : rows, 1};"),
        (CU, "      const double* r = kind == kFactor ? rows : rows + C;",
         "      const double* r = R == 1 ? rows : rows + C;"),
    ],
    "frow": [
        (PY, ROWS_PY, ROWS_PY.replace('"hines_solve_factored": 2',
                                      '"hines_solve_factored": 3')),
        (CU, "      if (R == 2) cp_async8(", "      if (R >= 2) cp_async8("),
        (CU, "  return kind == kFactor ? 1 : 2;",
         "  return kind == kFactor ? 1 : kind == kFactored ? 3 : 2;"),
        (CU, "R W, R X,\n    int g) {",
         "R W, R X,\n    int g, const double* Fr) {"),
        (CU, "        divide<2>(a, b, f);",
         "        if (kind == kFactored && Fr) {\n"
         "          f[0] = Fr[e.y];\n          f[1] = Fr[e.z];\n"
         "        } else {\n          divide<2>(a, b, f);\n        }"),
        (CU, "        divide<1>(a, b, f);",
         "        if (kind == kFactored && Fr)\n          f[0] = Fr[e.y];\n"
         "        else\n          divide<1>(a, b, f);"),
        (CU, "    warp_sweeps<kind, kPlace == kShared>(s, D, gs, fg, bg, W, X, "
             "g);",
         "    if (kStaged && kind == kFactored) {\n"
         "      for (int c = g; c < C; c += 32)\n"
         "        rows[2 * C + c] = gs[c] / rows[c];\n"
         "      __syncwarp();\n    }\n"
         "    warp_sweeps<kind, kPlace == kShared>(\n"
         "        s, D, gs, fg, bg, W, X, g,\n"
         "        kStaged && kind == kFactored ? rows + 2 * C : nullptr);"),
    ],
}


def write(out: Path, name: str) -> Path:
    """This checkout's ``src/`` as variant ``name`` under ``out``."""
    tree = out / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "src", tree / "src",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = tree / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {rel} does not hold {old!r} once")
        path.write_text(text.replace(old, new))
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="directory for the variant trees")
    args = ap.parse_args(argv)
    for name in VARIANTS:
        print(write(Path(args.out), name))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
