"""Assembled compartmental neuron model, batched over neurons.

State layout of one neuron with C compartments (paper Eq. 1/2):

    y = [ V(0..C) | m(0..C) | h(0..C) | n(0..C) | g_ampa | g_gaba ]

A network's state is ``Y [N, n_state]``; every method below works on such
a batch (the JAX ``CellModel`` is written per neuron and vmapped).

``CellModel`` exposes:
  rhs(t, Y, iinj)            full ODE right-hand side  (the CVODE f); the
                             HH rates and currents come from the fused
                             HH-RHS kernel (K4) on CUDA
  jac_terms(Y)               the Hines-structured approximation to df/dy
  solve_newton_mat(Y, gamma, b)  assembles M = I - gamma*J~ and solves
                             M x = b in one pass (the fused Hines solve
                             kernel, K3)
  newton_setup(Y, gamma)     assembles + factors M = I - gamma*J~ (the
                             Hines factor kernel, K1); flat factor rows
  newton_solve(factors, b)   back-solves against stored factors (the
                             Hines factored-solve kernel, K2)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import mechanisms as mech
from repro_torch.core.morphology import Morphology
from repro_torch.core import detmath as dm
from repro_torch.core.hines import axial_contrib, child_levels
from repro_torch.kernels.hh_rhs import ops as hh_ops
from repro_torch.kernels.hines import ops as hines_ops

_LATER = "comes in a later slice of the port (ROADMAP queue 1, item 3)"


class CellParams(NamedTuple):
    """Per-compartment constants on the model's device."""

    parent: torch.Tensor      # i32[C]
    area: torch.Tensor        # f64[C] um^2
    cap: torch.Tensor         # f64[C] nF
    g_axial: torch.Tensor     # f64[C] uS


class CellModel:
    """Static model description; methods take batched ``[N, ...]`` tensors."""

    def __init__(self, morph: Morphology, with_plasticity: bool = False,
                 device="cuda"):
        if with_plasticity:
            raise NotImplementedError(f"with_plasticity=True {_LATER}")
        self.device = resolve_device(device)
        self.morph = morph
        self.C = morph.n_comp
        self.with_plasticity = False
        self.n_syn = 2
        self.n_extra = 0
        self.n_state = 4 * self.C + self.n_syn + self.n_extra
        f64 = dict(dtype=torch.float64, device=self.device)
        self.params = CellParams(
            parent=torch.as_tensor(morph.parent, dtype=torch.int32,
                                   device=self.device),
            area=torch.as_tensor(morph.area, **f64),
            cap=torch.as_tensor(morph.cap, **f64),
            g_axial=torch.as_tensor(morph.g_axial, **f64),
        )
        # the axial back-flow onto parents, in sibling-rank levels: within a
        # level every parent appears once, so the scatter-adds are plain
        # indexed adds in child order -- no atomics, the same sums on every
        # device (``hines.child_levels``); rows index the non-root flows
        self._child_parent = self.params.parent[1:].long()
        self._levels = [(torch.as_tensor([i - 1 for i in c],
                                         device=self.device),
                         torch.as_tensor(p, device=self.device))
                        for c, p in child_levels(morph.parent)]
        # each child's axial conductance on its parent's diagonal, [C]
        self._contrib = axial_contrib(morph.parent, self.params.g_axial)

    def runner_device(self, device) -> torch.device:
        """``resolve_device(device)``, which must be where the model lives
        (every entry point built on a model calls this)."""
        dev = resolve_device(device)
        if self.device != dev:
            raise ValueError(f"model lives on {self.device}, caller asks for "
                             f"{dev}")
        return dev

    def assemble(self, diag):
        """``hines_assemble``'s tree diagonal from the per-compartment terms
        ``diag`` [N, C]: diag + g_axial + the children's axial conductances
        (precomputed, ``_contrib``)."""
        return diag + self.params.g_axial + self._contrib

    # ---- packing -------------------------------------------------------------
    def split(self, Y):
        C = self.C
        return (Y[:, :C], Y[:, C:2 * C], Y[:, 2 * C:3 * C], Y[:, 3 * C:4 * C],
                Y[:, 4 * C], Y[:, 4 * C + 1], Y[:, 4 * C + 2:])

    def pack(self, v, m, h, n, g_ampa, g_gaba):
        return torch.cat([v, m, h, n, g_ampa[:, None], g_gaba[:, None]], dim=1)

    @property
    def idx_vsoma(self) -> int:
        return 0

    @property
    def idx_g_ampa(self) -> int:
        return 4 * self.C

    @property
    def idx_g_gaba(self) -> int:
        return 4 * self.C + 1

    def init_state(self, v0: float = -65.0):
        """One neuron's state f64[n_state]: gates at steady state for v0,
        synapses at zero."""
        v = torch.full((1, self.C), v0, dtype=torch.float64,
                       device=self.device)
        (m_inf, _), (h_inf, _), (n_inf, _) = mech.gate_inf_tau(v)
        g0 = torch.zeros((1,), dtype=torch.float64, device=self.device)
        return self.pack(v, m_inf, h_inf, n_inf, g0, g0)[0]

    # ---- dynamics --------------------------------------------------------------
    def rhs(self, t, Y, iinj=0.0):
        """f(t, Y): full right-hand side; iinj = injected soma current (nA),
        a scalar or f64[N]."""
        del t
        v, m, h, n, g_ampa, g_gaba, _ = self.split(Y)
        p = self.params
        dm, dh, dn, i_ion, _ = hh_ops.hh_rhs(p.area, v, m, h, n)
        dv_num = -i_ion
        if self.C > 1:
            # axial tree currents: flow into child i from its parent, and
            # the opposite flow onto the parent (the root has no parent)
            vp = v[:, self._child_parent]
            flow = p.g_axial[1:] * (vp - v[:, 1:])
            dv_num[:, 1:] = dv_num[:, 1:] + flow
            for rows, par in self._levels:
                dv_num[:, par] = dv_num[:, par] + (-flow[:, rows])
        i_syn = (g_ampa * (v[:, 0] - mech.E_AMPA)
                 + g_gaba * (v[:, 0] - mech.E_GABA))
        dv_num[:, 0] = dv_num[:, 0] + (-i_syn + iinj)
        dv = dv_num / p.cap
        dg_a = -g_ampa * (1.0 / mech.TAU_AMPA)
        dg_g = -g_gaba * (1.0 / mech.TAU_GABA)
        return self.pack(dv, dm, dh, dn, dg_a, dg_g)

    # ---- structured Newton matrix (paper §2.3 preconditioner) -------------------
    def jac_terms(self, Y):
        """Terms of the Hines-structured J~: (g_tot [N, C], diag_gates
        [N, 3C], diag_syn [2], diag_extra [N, 0]).  V<->gate couplings are
        dropped (inexact Newton; NEURON default)."""
        v, m, h, n, g_ampa, g_gaba, extra = self.split(Y)
        _, _, _, _, g_tot = hh_ops.hh_rhs(self.params.area, v, m, h, n)
        g_tot[:, 0] = g_tot[:, 0] + (g_ampa + g_gaba)
        r = mech.gate_rates(v)
        diag_gates = torch.cat([-(r.a_m + r.b_m), -(r.a_h + r.b_h),
                                -(r.a_n + r.b_n)], dim=1)
        diag_syn = torch.tensor([-1.0 / mech.TAU_AMPA, -1.0 / mech.TAU_GABA],
                                dtype=Y.dtype, device=Y.device)
        return g_tot, diag_gates, diag_syn, extra[:, :0]

    def solve_newton_mat(self, Y, gamma, b, mode: str = "neuron"):
        """Solve (I - gamma*J~) x = b at (Y, gamma[N]) with one fused Hines
        solve (kernel K3 on CUDA) and diagonal solves, assembling the
        matrix anew (``jac_policy="iteration"``).  The operation order is
        ``repro.core.cell.CellModel.solve_newton_mat``'s: ``(b*cap)/gamma``,
        not ``newton_setup``'s ``b * (cap/gamma)``."""
        if mode != "neuron":
            raise NotImplementedError(f"precond={mode!r} {_LATER}")
        C = self.C
        g_tot, diag_gates, diag_syn, diag_extra = self.jac_terms(Y)
        p = self.params
        gam = gamma[:, None]
        bv = b[:, :C] * p.cap / gam
        d = self.assemble(p.cap / gam + g_tot)
        xv = hines_ops.hines_solve(p.parent, p.g_axial, d.T, bv.T).T
        rest_diag = torch.cat(
            [diag_gates, diag_syn.expand(Y.shape[0], 2), diag_extra], dim=1)
        xr = b[:, C:] / (1.0 - gam * rest_diag)
        return torch.cat([xv, xr], dim=1)

    # ---- split setup/solve (factor reuse across Newton iterations) ---------------
    def n_factors(self, mode: str = "neuron") -> int:
        """Row length of the flat factors from ``newton_setup``:
        ``[d_elim(C) | vscale(C) | rest_den(n_state-C)]``."""
        if mode != "neuron":
            raise NotImplementedError(f"precond={mode!r} {_LATER}")
        return self.n_state + self.C

    def newton_setup(self, Y, gamma, mode: str = "neuron"):
        """Assemble and factor M = I - gamma*J~ at (Y, gamma[N]); returns
        the flat factor rows f64[N, n_factors] (layout of
        ``repro.core.cell.CellModel.newton_setup``)."""
        if mode != "neuron":
            raise NotImplementedError(f"precond={mode!r} {_LATER}")
        g_tot, diag_gates, diag_syn, diag_extra = self.jac_terms(Y)
        p = self.params
        gam = gamma[:, None]
        vscale = p.cap / gam
        d = self.assemble(vscale + g_tot)
        d_elim = hines_ops.hines_factor(p.parent, p.g_axial, d.T).T
        rest_diag = torch.cat(
            [diag_gates, diag_syn.expand(Y.shape[0], 2), diag_extra], dim=1)
        rest_den = 1.0 - gam * rest_diag
        return torch.cat([d_elim, vscale, rest_den], dim=1)

    def newton_solve(self, factors, b, mode: str = "neuron"):
        """Solve (I - gamma*J~) x = b against stored ``newton_setup`` rows."""
        if mode != "neuron":
            raise NotImplementedError(f"precond={mode!r} {_LATER}")
        C = self.C
        d_elim = factors[:, :C]
        vscale = factors[:, C:2 * C]
        rest_den = factors[:, 2 * C:C + self.n_state]
        bv = b[:, :C] * vscale
        xv = hines_ops.hines_solve_factored(self.params.parent,
                                            self.params.g_axial,
                                            d_elim.T, bv.T).T
        xr = b[:, C:] / rest_den
        return torch.cat([xv, xr], dim=1)

    # ---- events ------------------------------------------------------------------
    def apply_event(self, Y, w_ampa, w_gaba):
        """Deliver aggregated synaptic weights w[N] (the discontinuity)."""
        Y = Y.clone()
        Y[:, self.idx_g_ampa] = Y[:, self.idx_g_ampa] + w_ampa
        Y[:, self.idx_g_gaba] = Y[:, self.idx_g_gaba] + w_gaba
        return Y

    # ---- dense oracle (tests only) -------------------------------------------------
    def dense_jacobian(self, t, y, iinj=0.0):
        """df/dy of one neuron's state f64[n_state] (test oracle)."""
        return torch.func.jacfwd(
            lambda yy: self.rhs(t, yy[None, :], iinj)[0])(y)


def weighted_rms(x, y, atol, rtol):
    """CVODE WRMS norm over the last axis, ewt_i = 1/(rtol*|y_i| + atol)."""
    w = 1.0 / (rtol * torch.abs(y) + atol)
    return dm.sqrt(dm.fixed_mean((x * w) ** 2))
