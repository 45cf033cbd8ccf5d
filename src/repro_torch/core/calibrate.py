"""Calibration utilities: threshold current (paper Fig. 6's x-axis) and
regime-current search (paper §4's five spiking regimes).  Counterpart of
``repro.core.calibrate``: bisections on the host over ``run_fixed``
(method 1a) traces."""
from __future__ import annotations

import numpy as np

from repro_torch.core.cell import CellModel
from repro_torch.core.exec_common import SPIKE_THR
from repro_torch.core.fixed_step import run_fixed

MS_PER_S = 1000.0


def spikes_in_trace(vs, thr=SPIKE_THR) -> int:
    """Upward threshold crossings of a recorded V_soma trace."""
    vs = np.asarray(vs.cpu() if hasattr(vs, "cpu") else vs)
    return int(((vs[1:] > thr) & (vs[:-1] <= thr)).sum())


def _n_spikes(model: CellModel, iinj: float, t_end: float, dt=0.025,
              device="cuda") -> int:
    y0 = model.init_state()
    _, _, tr = run_fixed(model, y0, t_end, iinj, method="cnexp", dt=dt,
                         record_every=4, device=device)
    return spikes_in_trace(tr)


def threshold_current(model: CellModel, t_end: float = 200.0,
                      lo: float = 0.0, hi: float = 1.0,
                      iters: int = 12, device="cuda") -> float:
    """Minimum continuous current that elicits a spike (bisection)."""
    while _n_spikes(model, hi, t_end, device=device) == 0:
        hi *= 2.0
        if hi > 1e3:
            raise RuntimeError("no spiking found up to 1000 nA")
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if _n_spikes(model, mid, t_end, device=device) > 0:
            hi = mid
        else:
            lo = mid
    return hi


def current_for_rate(model: CellModel, rate_hz: float, i_thresh: float,
                     t_end: float = 1000.0, iters: int = 10,
                     device="cuda") -> float:
    """Continuous current giving approximately ``rate_hz`` (bisection on the
    f-I curve, which is monotone for HH under DC input)."""
    # host floats: the same true division as the reference's
    target = rate_hz * t_end / MS_PER_S
    lo, hi = 0.8 * i_thresh, 6.0 * i_thresh
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        n = _n_spikes(model, mid, t_end, device=device)
        if n < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
