"""Assembled compartmental neuron model, batched over neurons.

State layout of one neuron with C compartments (paper Eq. 1/2):

    y = [ V(0..C) | m(0..C) | h(0..C) | n(0..C) | g_ampa | g_gaba
          (| ca | rho) ]

The optional (ca, rho) pair (``with_plasticity``) is the correlated
mechanism that requires fully-implicit resolution (paper §2.2).  A
network's state is ``Y [N, n_state]``; every method below works on such a
batch (the JAX ``CellModel`` is written per neuron and vmapped).

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

The last three take ``mode="neuron"`` (NEURON's preconditioner: V<->gate
couplings dropped) or ``mode="schur"`` (the HH gate block eliminated
exactly into the voltage rows; its Schur terms are elementwise torch
work around the same kernels).  Where the JAX reference differentiates
(``jax.jvp`` of the gate rates, ``jax.jacfwd`` of the plasticity pair)
the derivatives are written out in ``mechanisms``.
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

MODES = ("neuron", "schur")


def _check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown preconditioner {mode!r}")


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
        self.device = resolve_device(device)
        self.morph = morph
        self.C = morph.n_comp
        self.with_plasticity = bool(with_plasticity)
        self.n_syn = 2
        self.n_extra = 2 if with_plasticity else 0
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

    def pack(self, v, m, h, n, g_ampa, g_gaba, extra=None):
        parts = [v, m, h, n, g_ampa[:, None], g_gaba[:, None]]
        if self.with_plasticity:
            parts.append(extra)
        return torch.cat(parts, dim=1)

    @property
    def idx_vsoma(self) -> int:
        return 0

    @property
    def idx_g_ampa(self) -> int:
        return 4 * self.C

    @property
    def idx_g_gaba(self) -> int:
        return 4 * self.C + 1

    @property
    def idx_ca(self) -> int:
        return 4 * self.C + 2

    def init_state(self, v0: float = -65.0):
        """One neuron's state f64[n_state]: gates at steady state for v0,
        synapses at zero, (ca, rho) = (0, 0.2) with plasticity."""
        f64 = dict(dtype=torch.float64, device=self.device)
        v = torch.full((1, self.C), v0, **f64)
        (m_inf, _), (h_inf, _), (n_inf, _) = mech.gate_inf_tau(v)
        g0 = torch.zeros((1,), **f64)
        extra = torch.tensor([[0.0, 0.2]], **f64) \
            if self.with_plasticity else None
        return self.pack(v, m_inf, h_inf, n_inf, g0, g0, extra)[0]

    # ---- dynamics --------------------------------------------------------------
    def rhs(self, t, Y, iinj=0.0):
        """f(t, Y): full right-hand side; iinj = injected soma current (nA),
        a scalar or f64[N]."""
        del t
        v, m, h, n, g_ampa, g_gaba, extra = self.split(Y)
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
        dextra = None
        if self.with_plasticity:
            dextra = torch.stack(mech.plasticity_derivs(extra[:, 0],
                                                        extra[:, 1]), dim=1)
        return self.pack(dv, dm, dh, dn, dg_a, dg_g, dextra)

    # ---- structured Newton matrix (paper §2.3 preconditioner) -------------------
    def jac_terms(self, Y):
        """Terms of the Hines-structured J~: (g_tot [N, C], diag_gates
        [N, 3C], diag_syn [2], diag_extra [N, n_extra]).  V<->gate
        couplings are dropped (inexact Newton; NEURON default); the
        plasticity pair contributes its Jacobian's diagonal."""
        v, m, h, n, g_ampa, g_gaba, extra = self.split(Y)
        _, _, _, _, g_tot = hh_ops.hh_rhs(self.params.area, v, m, h, n)
        g_tot[:, 0] = g_tot[:, 0] + (g_ampa + g_gaba)
        r = mech.gate_rates(v)
        diag_gates = torch.cat([-(r.a_m + r.b_m), -(r.a_h + r.b_h),
                                -(r.a_n + r.b_n)], dim=1)
        diag_syn = torch.tensor([-1.0 / mech.TAU_AMPA, -1.0 / mech.TAU_GABA],
                                dtype=Y.dtype, device=Y.device)
        diag_extra = extra[:, :0]
        if self.with_plasticity:
            j_cc, _, _, j_rr = mech.plasticity_jacobian(extra[:, 0],
                                                        extra[:, 1])
            diag_extra = torch.stack([j_cc, j_rr], dim=1)
        return g_tot, diag_gates, diag_syn, diag_extra

    def _schur_terms(self, Y, gam, diag_gates):
        """The HH block's V<->gate couplings for ``mode="schur"``, each
        [N, C]: cap * dVdot/dx (Jvm, Jvh, Jvn), dxdot/dV (Jmv, Jhv, Jnv)
        and the gate rows' diagonals 1 - gamma*(dxdot/dx) (den_m, den_h,
        den_n); ``gam`` is gamma [N, 1]."""
        C = self.C
        v, m, h, n, _, _, _ = self.split(Y)
        f = mech.S_PER_CM2_TO_US_PER_UM2 * self.params.area
        Jvm = -(mech.GNABAR * f * 3.0 * (m * m) * h) * (v - mech.ENA)
        Jvh = -(mech.GNABAR * f * (m * (m * m))) * (v - mech.ENA)
        Jvn = -(mech.GKBAR * f * 4.0 * (n * (n * n))) * (v - mech.EK)
        Jmv, Jhv, Jnv = mech.gate_slopes(v, m, h, n)
        den_m, den_h, den_n = (1.0 - gam * diag_gates[:, :C],
                               1.0 - gam * diag_gates[:, C:2 * C],
                               1.0 - gam * diag_gates[:, 2 * C:3 * C])
        return Jvm, Jvh, Jvn, Jmv, Jhv, Jnv, den_m, den_h, den_n

    @staticmethod
    def _syn_dens(gamma):
        """1 + gamma/tau of the two synapse rows (both 1/tau are powers of
        two, so the products are the divisions exactly)."""
        return (1.0 + gamma * (1.0 / mech.TAU_AMPA),
                1.0 + gamma * (1.0 / mech.TAU_GABA))

    def solve_newton_mat(self, Y, gamma, b, mode: str = "neuron"):
        """Solve (I - gamma*J~) x = b at (Y, gamma[N]) with one fused Hines
        solve (kernel K3 on CUDA) and diagonal solves, assembling the
        matrix anew (``jac_policy="iteration"``).  The operation order is
        ``repro.core.cell.CellModel.solve_newton_mat``'s: ``(b*cap)/gamma``,
        not ``newton_setup``'s ``b * (cap/gamma)``.  Under ``"schur"`` the
        gate block is eliminated into the voltage rows before the solve
        and its corrections back-substituted after it."""
        _check_mode(mode)
        C = self.C
        g_tot, diag_gates, diag_syn, diag_extra = self.jac_terms(Y)
        p = self.params
        gam = gamma[:, None]
        bv = b[:, :C] * p.cap / gam
        diag_v = p.cap / gam + g_tot
        if mode == "schur":
            Jvm, Jvh, Jvn, Jmv, Jhv, Jnv, den_m, den_h, den_n = \
                self._schur_terms(Y, gam, diag_gates)
            bm, bh, bn = b[:, C:2 * C], b[:, 2 * C:3 * C], b[:, 3 * C:4 * C]
            diag_v = diag_v - gam * (Jvm * Jmv / den_m + Jvh * Jhv / den_h
                                     + Jvn * Jnv / den_n)
            bv = bv + (Jvm * bm / den_m + Jvh * bh / den_h
                       + Jvn * bn / den_n)
            # the synapse rows couple into the soma's V row (rhs only)
            den_ga, den_gb = self._syn_dens(gamma)
            v0 = Y[:, 0]
            bv[:, 0] = bv[:, 0] + (
                -(v0 - mech.E_AMPA) * b[:, self.idx_g_ampa] / den_ga
                - (v0 - mech.E_GABA) * b[:, self.idx_g_gaba] / den_gb)
        d = self.assemble(diag_v)
        xv = hines_ops.hines_solve(p.parent, p.g_axial, d.T, bv.T).T
        rest_diag = torch.cat(
            [diag_gates, diag_syn.expand(Y.shape[0], 2), diag_extra], dim=1)
        xr = b[:, C:] / (1.0 - gam * rest_diag)
        if mode == "schur":
            corr = torch.cat([gam * Jmv * xv / den_m, gam * Jhv * xv / den_h,
                              gam * Jnv * xv / den_n], dim=1)
            xr = torch.cat([xr[:, :3 * C] + corr, xr[:, 3 * C:]], dim=1)
        return torch.cat([xv, xr], dim=1)

    # ---- split setup/solve (factor reuse across Newton iterations) ---------------
    def n_factors(self, mode: str = "neuron") -> int:
        """Row length of the flat factors from ``newton_setup``:
        ``[d_elim(C) | vscale(C) | rest_den(n_state-C)]``, plus ``6C + 2``
        Schur coefficients under ``"schur"``."""
        _check_mode(mode)
        base = self.n_state + self.C
        return base + 6 * self.C + 2 if mode == "schur" else base

    def newton_setup(self, Y, gamma, mode: str = "neuron"):
        """Assemble and factor M = I - gamma*J~ at (Y, gamma[N]); returns
        the flat factor rows f64[N, n_factors] (layout of
        ``repro.core.cell.CellModel.newton_setup``: under ``"schur"`` the
        rows go on with ``[Jvm/den_m, Jvh/den_h, Jvn/den_n, g*Jmv/den_m,
        g*Jhv/den_h, g*Jnv/den_n (C each) | the two synapse folds]``)."""
        _check_mode(mode)
        g_tot, diag_gates, diag_syn, diag_extra = self.jac_terms(Y)
        p = self.params
        gam = gamma[:, None]
        vscale = p.cap / gam
        diag_v = vscale + g_tot
        parts = []
        if mode == "schur":
            Jvm, Jvh, Jvn, Jmv, Jhv, Jnv, den_m, den_h, den_n = \
                self._schur_terms(Y, gam, diag_gates)
            diag_v = diag_v - gam * (Jvm * Jmv / den_m + Jvh * Jhv / den_h
                                     + Jvn * Jnv / den_n)
            den_ga, den_gb = self._syn_dens(gamma)
            v0 = Y[:, 0]
            parts = [Jvm / den_m, Jvh / den_h, Jvn / den_n,
                     gam * Jmv / den_m, gam * Jhv / den_h, gam * Jnv / den_n,
                     torch.stack([(v0 - mech.E_AMPA) / den_ga,
                                  (v0 - mech.E_GABA) / den_gb], dim=1)]
        d = self.assemble(diag_v)
        d_elim = hines_ops.hines_factor(p.parent, p.g_axial, d.T).T
        rest_diag = torch.cat(
            [diag_gates, diag_syn.expand(Y.shape[0], 2), diag_extra], dim=1)
        rest_den = 1.0 - gam * rest_diag
        return torch.cat([d_elim, vscale, rest_den] + parts, dim=1)

    def newton_solve(self, factors, b, mode: str = "neuron"):
        """Solve (I - gamma*J~) x = b against stored ``newton_setup`` rows."""
        _check_mode(mode)
        C = self.C
        d_elim = factors[:, :C]
        vscale = factors[:, C:2 * C]
        rest_den = factors[:, 2 * C:C + self.n_state]
        bv = b[:, :C] * vscale
        if mode == "schur":
            o = C + self.n_state
            fm, fh, fn, gm, gh, gn = (factors[:, o + k * C:o + (k + 1) * C]
                                      for k in range(6))
            sa, sg = factors[:, o + 6 * C], factors[:, o + 6 * C + 1]
            bv = bv + fm * b[:, C:2 * C] + fh * b[:, 2 * C:3 * C] \
                + fn * b[:, 3 * C:4 * C]
            bv[:, 0] = bv[:, 0] + (-sa * b[:, self.idx_g_ampa]
                                   - sg * b[:, self.idx_g_gaba])
        xv = hines_ops.hines_solve_factored(self.params.parent,
                                            self.params.g_axial,
                                            d_elim.T, bv.T).T
        xr = b[:, C:] / rest_den
        if mode == "schur":
            xr = torch.cat([xr[:, :3 * C] + torch.cat([gm * xv, gh * xv,
                                                       gn * xv], dim=1),
                            xr[:, 3 * C:]], dim=1)
        return torch.cat([xv, xr], dim=1)

    # ---- events ------------------------------------------------------------------
    def apply_event(self, Y, w_ampa, w_gaba):
        """Deliver aggregated synaptic weights w[N] (the discontinuity);
        with plasticity, a lane with a positive AMPA weight also takes one
        calcium jump."""
        Y = Y.clone()
        Y[:, self.idx_g_ampa] = Y[:, self.idx_g_ampa] + w_ampa
        Y[:, self.idx_g_gaba] = Y[:, self.idx_g_gaba] + w_gaba
        if self.with_plasticity:
            pos = torch.as_tensor(w_ampa, device=Y.device) > 0
            Y[:, self.idx_ca] = Y[:, self.idx_ca] + \
                mech.CA_JUMP * pos.to(Y.dtype)
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
