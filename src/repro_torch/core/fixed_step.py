"""Fixed-timestep solvers, the paper's baseline methods, batched over neurons.

Counterpart of ``repro.core.fixed_step``:

  cnexp          (1a) gates advanced analytically (exact exponential of
                 the linear gating ODE at frozen V), voltage by an
                 implicit linear Hines solve -- NEURON's default;
  euler          (1b) gates by explicit Euler, voltage implicit;
  derivimplicit  (2a) gates by backward Euler and the plasticity pair by
                 three Newton iterations on its 2x2 implicit system
                 (per-mechanism implicit), voltage implicit -- the
                 fixed-step reference for 2c.  Under cnexp and euler the
                 pair steps by explicit Euler.

All three share the staggered voltage update (paper §2.2): channel states
at t + dt/2 make the voltage system linear, one fused Hines solve per
neuron and step (kernel K3 on CUDA).  ``Y`` is ``[N, n_state]``.

The constants follow what the JAX runners compute under ``jax.jit``:
``cap / dt`` is folded at compile time by a true division, so it is
divided here once on the host (a division of a CUDA tensor by a Python
float would be a product with a rounded reciprocal); the synaptic decay
factors ``exp(-dt / tau)`` are folded constants, equal to the host's
``math.exp``; and XLA rewrites cnexp's ``-dt / tau_x`` with ``tau_x =
1 / (a + b)`` into ``-dt * (a + b)``, which is what is computed here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import detmath as dm
from repro_torch.core import mechanisms as mech
from repro_torch.core.cell import CellModel
from repro_torch.kernels.hines import ops as hines_ops

DT_DEFAULT = 0.025  # ms, paper's production step


def decay_factors(dt: float):
    """(exp(-dt/TAU_AMPA), exp(-dt/TAU_GABA)) as the host computes them;
    both reciprocals are powers of two, so ``-dt * (1/tau)`` is ``-dt /
    tau`` exactly."""
    return (math.exp(-dt * (1.0 / mech.TAU_AMPA)),
            math.exp(-dt * (1.0 / mech.TAU_GABA)))


def _voltage_update(model: CellModel, cap_dt, v, m, h, n, g_ampa, g_gaba,
                    iinj):
    """Implicit (backward-Euler) voltage step with frozen channel states;
    ``cap_dt`` = cap / dt [C]."""
    p = model.params
    g_na, g_k, g_l = mech.channel_conductances(p.area, m, h, n)
    g_tot = g_na + g_k + g_l
    rhs = cap_dt * v + g_na * mech.ENA + g_k * mech.EK + g_l * mech.EL
    g_tot[:, 0] = g_tot[:, 0] + (g_ampa + g_gaba)
    rhs[:, 0] = rhs[:, 0] + (g_ampa * mech.E_AMPA + g_gaba * mech.E_GABA
                             + iinj)
    d = model.assemble(cap_dt + g_tot)
    return hines_ops.hines_solve(p.parent, p.g_axial, d.T, rhs.T).T


def _gates_cnexp(v, m, h, n, dt):
    r = mech.gate_rates(v)
    a = torch.stack([r.a_m, r.a_h, r.a_n])
    s = torch.stack([r.a_m + r.b_m, r.a_h + r.b_h, r.a_n + r.b_n])
    # x_inf = a/(a+b); exp(-dt/tau) with tau = 1/(a+b) is exp(-dt*(a+b))
    x_inf = a / s
    x = x_inf + (torch.stack([m, h, n]) - x_inf) * dm.exp((-dt) * s)
    return x[0], x[1], x[2]


def _gates_euler(v, m, h, n, dt):
    dmv, dhv, dnv = mech.gate_derivs(v, m, h, n)
    return m + dt * dmv, h + dt * dhv, n + dt * dnv


def _gates_derivimplicit(v, m, h, n, dt):
    # backward Euler on dx/dt = a(1-x) - b x (linear in x at frozen V):
    #   x' = (x + dt*a) / (1 + dt*(a+b))
    r = mech.gate_rates(v)
    m2 = (m + dt * r.a_m) / (1.0 + dt * (r.a_m + r.b_m))
    h2 = (h + dt * r.a_h) / (1.0 + dt * (r.a_h + r.b_h))
    n2 = (n + dt * r.a_n) / (1.0 + dt * (r.a_n + r.b_n))
    return m2, h2, n2


def _solve2(a, b, c, d, r0, r1):
    """x with [[a, b], [c, d]] x = [r0, r1], elementwise over the lanes:
    LU with partial pivoting, written out (``torch.linalg.solve`` rounds
    unlike on the card)."""
    swap = torch.abs(c) > torch.abs(a)
    a, c = torch.where(swap, c, a), torch.where(swap, a, c)
    b, d = torch.where(swap, d, b), torch.where(swap, b, d)
    r0, r1 = torch.where(swap, r1, r0), torch.where(swap, r0, r1)
    lo = c / a
    x1 = (r1 - lo * r0) / (d - lo * b)
    return (r0 - b * x1) / a, x1


def _plasticity_derivimplicit(extra, dt, newton_iters: int = 3):
    """Per-mechanism implicit Newton on the correlated (ca, rho) pair:
    g(e) = e - extra - dt * f(e), J = I - dt * df/de."""
    e = extra
    for _ in range(newton_iters):
        ca, rho = e[:, 0], e[:, 1]
        dca, drho = mech.plasticity_derivs(ca, rho)
        g0 = e[:, 0] - extra[:, 0] - dt * dca
        g1 = e[:, 1] - extra[:, 1] - dt * drho
        j_cc, j_cr, j_rc, j_rr = mech.plasticity_jacobian(ca, rho)
        x0, x1 = _solve2(1.0 - dt * j_cc, 0.0 - dt * j_cr, 0.0 - dt * j_rc,
                         1.0 - dt * j_rr, g0, g1)
        e = e - torch.stack([x0, x1], dim=1)
    return e


def _plasticity_explicit(extra, dt):
    dca, drho = mech.plasticity_derivs(extra[:, 0], extra[:, 1])
    return extra + dt * torch.stack([dca, drho], dim=1)


GATE_UPDATES = {
    "cnexp": _gates_cnexp,
    "euler": _gates_euler,
    "derivimplicit": _gates_derivimplicit,
}


def make_stepper(model: CellModel, method: str = "cnexp",
                 dt: float = DT_DEFAULT, device="cuda"):
    """Returns ``step(Y [N, n_state], iinj) -> Y'`` advancing every neuron
    one fixed step of size dt; ``iinj`` is a scalar or f64[N] (nA)."""
    if method not in GATE_UPDATES:
        raise ValueError(f"unknown fixed-step method {method!r}")
    dev = model.runner_device(device)
    gate_fn = GATE_UPDATES[method]
    plastic_fn = _plasticity_derivimplicit if method == "derivimplicit" \
        else _plasticity_explicit
    # a host division, as XLA folds the constant (see the module docstring)
    cap_dt = torch.as_tensor(np.asarray(model.morph.cap, np.float64) / dt,
                             device=dev)
    e_ampa, e_gaba = decay_factors(dt)

    def step(Y, iinj=0.0):
        v, m, h, n, g_ampa, g_gaba, extra = model.split(Y)
        # staggered: states to t+dt/2 using V(t) ...
        m, h, n = gate_fn(v, m, h, n, dt)
        g_ampa = g_ampa * e_ampa
        g_gaba = g_gaba * e_gaba
        if model.with_plasticity:
            extra = plastic_fn(extra, dt)
        # ... then V(t) -> V(t+dt) with frozen states
        v = _voltage_update(model, cap_dt, v, m, h, n, g_ampa, g_gaba, iinj)
        return model.pack(v, m, h, n, g_ampa, g_gaba, extra)

    return step


def run_fixed(model: CellModel, y0, t_end: float, iinj=0.0,
              method: str = "cnexp", dt: float = DT_DEFAULT,
              record_every: int = 0, device="cuda"):
    """Integrate [0, t_end] with a fixed step; optionally record V_soma.

    ``y0`` is one neuron's state f64[n_state] or a batch [N, n_state].
    Returns ``(y_final, n_steps, trace | None)``; the trace holds V_soma
    after every ``record_every`` steps (``[n_rec]``, or ``[n_rec, N]`` for
    a batch), and then, as in the JAX version, only ``n_rec *
    record_every`` steps are taken."""
    step = make_stepper(model, method, dt, device=device)
    n_steps = int(round(t_end / dt))
    single = y0.dim() == 1
    Y = (y0[None, :] if single else y0).to(model.device)
    if record_every:
        n_rec = n_steps // record_every
        vs = []
        for _ in range(n_rec):
            for _ in range(record_every):
                Y = step(Y, iinj)
            vs.append(Y[:, model.idx_vsoma])
        trace = torch.stack(vs) if vs else Y.new_zeros((0, Y.shape[0]))
        return (Y[0] if single else Y), n_steps, \
            (trace[:, 0] if single else trace)
    for _ in range(n_steps):
        Y = step(Y, iinj)
    return (Y[0] if single else Y), n_steps, None
