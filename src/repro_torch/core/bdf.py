"""Variable-order variable-timestep BDF integrator (CVODE), batched over lanes.

The port of ``repro.core.bdf``: the fixed-leading-coefficient BDF(1..5) of
CVODE in Nordsieck form with a modified-Newton corrector on the
Hines-structured Newton matrix, the WRMS local error test, order selection,
tstop semantics, IVP resets on synaptic events, the CVODE Jacobian-freshness
policy (``jac_policy="reuse"``) or a fresh assembly and fused Hines solve
on every Newton iteration (``jac_policy="iteration"``), the NDF error
constants (``method="ndf"``) and either Newton matrix of the cell
(``precond="neuron"`` or ``"schur"``, whose factor rows are 6C + 2
wider).

The JAX module is written per neuron and vmapped, so every ``lax.cond`` and
``while_loop`` of ``_step_impl`` runs per lane.  Here every state field has
a leading lane axis ``[L]`` and:

  * each ``while_loop`` (the attempt loop and the Newton loop) is a host
    loop that runs while any lane is live and freezes finished lanes --
    their counters included -- exactly as vmap's batched while does;
  * each ``lax.cond`` is a select; its branch is evaluated only when some
    lane takes it (the select then gives the same values);
  * the three outcome branches of an attempt are merged per lane.

Powers come from ``detmath`` and divisions by constants are
multiplications by reciprocals, so a step rounds alike on the CPU and the
card (see ``detmath``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import detmath as dm

QMAX = 5
LMAX = QMAX + 1           # zn rows: 0..QMAX

# CVODE constants
ETAMX1 = 1.0e4            # etamax after the very first step
ETAMX = 10.0              # etamax otherwise
ETAMIN_EF = 0.1           # min eta after an error-test failure
ETAMXF = 0.2              # max eta after an error-test failure
ETACF = 0.25              # eta after a Newton-convergence failure
THRESH = 1.5              # order/step change threshold
BIAS1, BIAS2, BIAS3 = 6.0, 6.0, 10.0
ADDON = 1.0e-6
NLS_COEF = 0.1
CRDOWN = 0.3
RDIV = 2.0
MAX_NEWTON = 4
MAX_NCF = 10
MAX_NEF = 7
HMIN = 1.0e-9             # ms
MAX_ATTEMPTS = 40

# Jacobian-freshness policy (cvLSetup decision in cvNlsNewton)
MSBP = 20                 # max steps between setups
DGMAX = 0.3               # |gamma/gamma_saved - 1| beyond which factors rebuild
MAX_NCF_RESTART = 4       # consecutive conv failures before the q->1 restart

# NDF (Shampine & Reichelt, ode15s): kappa-modified BDF error constants.
_NDF_KAPPA = np.array([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0])
_NDF_RATIO = np.ones((LMAX + 1,))
for _k in range(1, QMAX + 1):
    _gamk = sum(1.0 / _j for _j in range(1, _k + 1))
    _NDF_RATIO[_k] = abs(1.0 + (_k + 1) * _NDF_KAPPA[_k] * _gamk)
del _k, _gamk


class BDFState(NamedTuple):
    t: torch.Tensor            # f64[L]
    h: torch.Tensor            # f64[L] current (scaled-into-zn) step size
    q: torch.Tensor            # i32[L]
    zn: torch.Tensor           # f64[L, LMAX, n] Nordsieck array
    tau: torch.Tensor          # f64[L, LMAX+1]  tau[1..q(+1)] recent steps
    qwait: torch.Tensor        # i32[L]
    etamax: torch.Tensor       # f64[L]
    acor_save: torch.Tensor    # f64[L, n] correction of previous step
    nst: torch.Tensor          # i32[L] accepted steps
    nfe: torch.Tensor          # i32[L] rhs evaluations
    nni: torch.Tensor          # i32[L] newton iterations
    netf: torch.Tensor         # i32[L] error-test failures
    nncf: torch.Tensor         # i32[L] newton-convergence failures
    nreset: torch.Tensor       # i32[L] IVP resets (event deliveries)
    failed: torch.Tensor       # bool[L]
    gamma_saved: torch.Tensor  # f64[L] gamma the stored factors were built at
    nstlp: torch.Tensor        # i32[L] nst at the last setup (MSBP counter)
    nsetups: torch.Tensor      # i32[L] Newton-matrix assemblies+factorizations
    jbad: torch.Tensor         # bool[L] factors flagged stale
    factors: torch.Tensor      # f64[L, n_factors] flat newton_setup rows


class BDFOptions(NamedTuple):
    atol: float = 1.0e-3
    rtol: float = 0.0
    hmax: float = 1.0e9
    h0: float = -1.0          # <=0: use heuristic
    precond: str = "neuron"   # "neuron" (paper default) | "schur" (exact
    #                           HH-block elimination, 6C + 2 more factors)
    method: str = "bdf"       # "bdf" | "ndf" (kappa-modified error constants)
    jac_policy: str = "reuse" # "reuse" | "iteration" (fused rebuild per
    #                           Newton iteration, nsetups == nni)


# --------------------------------------------------------------------------
# lane helpers
# --------------------------------------------------------------------------
def _bc(mask, x):
    """Broadcast a lane mask [L] against x [L, ...]."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


def lane_where(mask, a, b):
    """Per-lane select of two BDFStates (or tensors)."""
    if isinstance(a, torch.Tensor):
        return torch.where(_bc(mask, a), a, b)
    return type(a)(*[torch.where(_bc(mask, x), x, y) for x, y in zip(a, b)])


def gather_lanes(st, ids):
    """Rows ``ids`` of every field of a batched state."""
    return type(st)(*[x.index_select(0, ids) for x in st])


def scatter_lanes(st, ids, sub):
    """``st`` with rows ``ids`` replaced by ``sub``'s rows."""
    return type(st)(*[x.index_copy(0, ids, y) for x, y in zip(st, sub)])


def _take(x, idx):
    """x[l, idx[l]] for x [L, K, ...] and idx int[L]."""
    ar = torch.arange(x.shape[0], device=x.device)
    return x[ar, idx.long()]


def _wrms(x, y, opts: BDFOptions):
    w = 1.0 / (opts.rtol * torch.abs(y) + opts.atol)
    return dm.sqrt(dm.fixed_mean((x * w) ** 2))


def _check_opts(opts: BDFOptions):
    if opts.method not in ("bdf", "ndf"):
        raise ValueError(f"unknown method {opts.method!r}")
    if opts.jac_policy not in ("reuse", "iteration"):
        raise ValueError(f"unknown jac_policy {opts.jac_policy!r}")
    if opts.precond not in ("neuron", "schur"):
        raise ValueError(f"unknown precond {opts.precond!r}")


def reinit(model, t, y, iinj, opts: BDFOptions, counters=None,
           f=None) -> BDFState:
    """(Re-)initialise the IVPs at (t[L], y[L, n]): order 1, heuristic h0.

    ``f`` may carry a precomputed rhs at (t, y) (the fused deliver/step
    path shares the Newton corrector's first evaluation).  The factor
    cache starts empty (``jbad=True``)."""
    _check_opts(opts)
    if f is None:
        f = model.rhs(t, y, iinj)
    L, n = y.shape
    dev, dt = y.device, y.dtype
    fn = _wrms(f, y, opts)
    h_heur = 0.5 / (fn + 1.0e-10)
    if opts.h0 > 0:
        h = torch.full((L,), float(opts.h0), dtype=dt, device=dev)
    else:
        h = torch.clamp(h_heur, 1.0e-6, 1.0)
    h = torch.clamp(h, max=opts.hmax)
    zn = torch.zeros((L, LMAX, n), dtype=dt, device=dev)
    zn[:, 0] = y
    zn[:, 1] = h[:, None] * f
    tau = torch.zeros((L, LMAX + 1), dtype=dt, device=dev)
    tau[:, 1] = h
    i32 = dict(dtype=torch.int32, device=dev)
    if counters is None:
        z = torch.zeros((L,), **i32)
        counters = (z, z + 1, z, z, z, z, z)
    t = torch.as_tensor(t, dtype=dt, device=dev).expand(L).clone()
    return BDFState(
        t=t, h=h, q=torch.ones((L,), **i32), zn=zn, tau=tau,
        qwait=torch.full((L,), 2, **i32),
        etamax=torch.full((L,), ETAMX1, dtype=dt, device=dev),
        acor_save=torch.zeros_like(y),
        nst=counters[0], nfe=counters[1], nni=counters[2], netf=counters[3],
        nncf=counters[4], nreset=counters[5],
        failed=torch.zeros((L,), dtype=torch.bool, device=dev),
        gamma_saved=torch.ones((L,), dtype=dt, device=dev),
        nstlp=counters[0].clone(), nsetups=counters[6],
        jbad=torch.ones((L,), dtype=torch.bool, device=dev),
        factors=torch.zeros((L, model.n_factors(opts.precond)), dtype=dt,
                            device=dev))


# --------------------------------------------------------------------------
# coefficient machinery (cvSetBDF / cvSetTqBDF), masked static loops to QMAX
# --------------------------------------------------------------------------
def _set_bdf_coeffs(q, h, tau, method: str = "bdf"):
    """Per-lane l [L, LMAX], tq (5 x [L]) and gamma [L]."""
    L = h.shape[0]
    qf = q.to(h.dtype)
    l = torch.zeros((L, LMAX), dtype=h.dtype, device=h.device)
    l[:, 0] = 1.0
    l[:, 1] = 1.0
    alpha0 = torch.full_like(h, -1.0)
    hsum = h
    xi_inv = torch.ones_like(h)
    xistar_inv = torch.ones_like(h)

    # for (j=2; j < q; j++)
    for j in range(2, QMAX):
        active = j < q
        hsum_n = hsum + tau[:, j - 1]
        xi_inv_n = h / hsum_n
        alpha0_n = alpha0 - 1.0 / j
        l_n = torch.cat([l[:, :1], l[:, 1:] + l[:, :-1] * xi_inv_n[:, None]],
                        dim=1)
        hsum = torch.where(active, hsum_n, hsum)
        alpha0 = torch.where(active, alpha0_n, alpha0)
        l = torch.where(active[:, None], l_n, l)

    # j = q  (only when q > 1)
    active = q > 1
    alpha0_n = alpha0 - 1.0 / torch.clamp(qf, min=1.0)
    xistar_inv_n = -l[:, 1] - alpha0_n
    hsum_n = hsum + _take(tau, torch.clamp(q - 1, min=1))
    xi_inv_n = h / hsum_n
    alpha0_hat_n = -l[:, 1] - xi_inv_n
    l_n = torch.cat([l[:, :1], l[:, 1:] + l[:, :-1] * xistar_inv_n[:, None]],
                    dim=1)
    alpha0 = torch.where(active, alpha0_n, alpha0)
    xistar_inv = torch.where(active, xistar_inv_n, xistar_inv)
    hsum = torch.where(active, hsum_n, hsum)
    xi_inv = torch.where(active, xi_inv_n, xi_inv)
    alpha0_hat = torch.where(active, alpha0_hat_n, alpha0)
    l = torch.where(active[:, None], l_n, l)

    # tq coefficients (cvSetTqBDF)
    A1 = 1.0 - alpha0_hat + alpha0
    A2 = 1.0 + qf * A1
    tq2 = torch.abs(A1 / (alpha0 * A2))
    lq = _take(l, torch.clamp(q, 0, QMAX))
    tq5 = torch.abs(A2 * xistar_inv / (lq * xi_inv))
    # order q-1 coefficient
    Cc = xistar_inv / lq
    A3 = alpha0 + 1.0 / qf
    A4 = alpha0_hat + xi_inv
    Cpinv = (1.0 - A4 + A3) / A3
    tq1 = torch.where(q > 1, torch.abs(Cc * Cpinv), 1.0)
    # order q+1 coefficient
    hsum_p = hsum + _take(tau, torch.clamp(q, 1, LMAX))
    xi_inv_p = h / hsum_p
    A5 = alpha0 - 1.0 / (qf + 1.0)
    A6 = alpha0_hat - xi_inv_p
    Cppinv = (1.0 - A6 + A5) / A2
    tq3 = torch.abs(Cppinv / (xi_inv_p * (qf + 2.0) * A5))
    if method == "ndf":
        r = torch.as_tensor(_NDF_RATIO, dtype=h.dtype, device=h.device)
        tq1 = tq1 * r[torch.clamp(q - 1, 0, LMAX).long()]
        tq2 = tq2 * r[torch.clamp(q, 0, LMAX).long()]
        tq3 = tq3 * r[torch.clamp(q + 1, 0, LMAX).long()]
    tq4 = NLS_COEF / tq2
    gamma = h / l[:, 1]
    return l, (tq1, tq2, tq3, tq4, tq5), gamma


def _predict(zn, q):
    """zn <- Pascal(q) zn  (cvPredict), per lane."""
    rows = list(zn.unbind(1))
    live = [None] + [(j <= q)[:, None] for j in range(1, QMAX + 1)]
    for k in range(1, QMAX + 1):
        for j in range(QMAX, k - 1, -1):
            rows[j - 1] = torch.where(live[j], rows[j - 1] + rows[j],
                                      rows[j - 1])
    return torch.stack(rows, dim=1)


def _unpredict(zn, q):
    """Inverse of _predict (cvRestore)."""
    rows = list(zn.unbind(1))
    live = [None] + [(j <= q)[:, None] for j in range(1, QMAX + 1)]
    for k in range(QMAX, 0, -1):
        for j in range(k, QMAX + 1):
            rows[j - 1] = torch.where(live[j], rows[j - 1] + (-rows[j]),
                                      rows[j - 1])
    return torch.stack(rows, dim=1)


def _rescale(zn, tau, h, q, eta):
    """Rows j <= q of zn scaled by eta**j (as repeated products)."""
    facs = [eta]
    for _ in range(2, LMAX):
        facs.append(facs[-1] * eta)
    fac = torch.stack(facs, dim=1)[:, :, None]                  # [L, 5, 1]
    live = (torch.arange(1, LMAX, device=q.device) <= q[:, None])[:, :, None]
    tail = torch.where(live, zn[:, 1:] * fac, zn[:, 1:])
    return torch.cat([zn[:, :1], tail], dim=1), h * eta


def _increase_order(zn, tau, h, q, acor_save):
    """cvIncreaseBDF: add one order using the saved correction."""
    L = h.shape[0]
    l = torch.zeros((L, LMAX), dtype=zn.dtype, device=zn.device)
    l[:, 2] = 1.0
    alpha0 = torch.full_like(h, -1.0)
    alpha1 = torch.ones_like(h)
    prod = torch.ones_like(h)
    xiold = torch.ones_like(h)
    hsum = h
    for j in range(1, QMAX):                     # j = 1 .. q-1
        active = j <= q - 1
        hsum_n = hsum + tau[:, j + 1]
        xi = hsum_n / h
        prod_n = prod * xi
        alpha0_n = alpha0 - 1.0 / (j + 1)
        alpha1_n = alpha1 + 1.0 / xi
        top = min(QMAX, j + 2)                   # i = j+2 .. 2, from old l
        l_n = torch.cat([l[:, :2],
                         l[:, 2:top + 1] * xiold[:, None] + l[:, 1:top],
                         l[:, top + 1:]], dim=1)
        hsum = torch.where(active, hsum_n, hsum)
        prod = torch.where(active, prod_n, prod)
        alpha0 = torch.where(active, alpha0_n, alpha0)
        alpha1 = torch.where(active, alpha1_n, alpha1)
        l = torch.where(active[:, None], l_n, l)
        xiold = torch.where(active, xi, xiold)
    A1 = (-alpha0 - alpha1) / prod
    lrow = torch.clamp(q + 1, 2, QMAX).long()
    zl = A1[:, None] * acor_save
    zn = zn.clone()
    zn[torch.arange(L, device=zn.device), lrow] = zl
    rows = list(zn.unbind(1))
    for j in range(2, QMAX):
        rows[j] = torch.where((j <= q)[:, None], rows[j] + l[:, j:j + 1] * zl,
                              rows[j])
    return torch.stack(rows, dim=1)


def _decrease_order(zn, tau, h, q):
    """cvDecreaseBDF: drop one order."""
    L = h.shape[0]
    l = torch.zeros((L, LMAX), dtype=zn.dtype, device=zn.device)
    l[:, 2] = 1.0
    hsum = torch.zeros_like(h)
    for j in range(1, QMAX - 1):                 # j = 1 .. q-2
        active = j <= q - 2
        hsum_n = hsum + tau[:, j]
        xi = hsum_n / h
        top = min(QMAX, j + 2)
        l_n = torch.cat([l[:, :2],
                         l[:, 2:top + 1] * xi[:, None] + l[:, 1:top],
                         l[:, top + 1:]], dim=1)
        hsum = torch.where(active, hsum_n, hsum)
        l = torch.where(active[:, None], l_n, l)
    zq = _take(zn, torch.clamp(q, 2, QMAX))
    rows = list(zn.unbind(1))
    for j in range(2, QMAX):
        rows[j] = torch.where((j < q)[:, None],
                              rows[j] + (-l[:, j:j + 1]) * zq, rows[j])
    return torch.stack(rows, dim=1)


# --------------------------------------------------------------------------
# one integration step with retries (cvStep)
# --------------------------------------------------------------------------
def step(model, st: BDFState, t_limit, iinj, opts: BDFOptions) -> BDFState:
    """Advance one accepted BDF step per lane, never crossing t_limit."""
    st, _ = _step_impl(model, st, t_limit, iinj, opts)
    return st


def _row1_set(zn, mask, row1):
    """zn with row 1 replaced by ``row1`` on the lanes of ``mask``."""
    new1 = torch.where(mask[:, None], row1, zn[:, 1])
    return torch.cat([zn[:, :1], new1[:, None], zn[:, 2:]], dim=1)


def _step_impl(model, st: BDFState, t_limit, iinj, opts: BDFOptions,
               deliver=None, y_ev=None):
    """One accepted BDF step per lane (cvStep).  Returns (state, f_first):
    ``f_first`` is the rhs of the first Newton iteration of each lane's
    last attempt.

    ``deliver`` (optional bool[L]) rides event-delivery lanes through the
    same Newton machinery: their first rhs is evaluated on the post-event
    state ``y_ev`` and they accept immediately; the caller rebuilds their
    order-1 reset from ``f_first``.
    """
    _check_opts(opts)
    reuse = opts.jac_policy == "reuse"
    dtype, dev = st.zn.dtype, st.zn.device
    L = st.t.shape[0]
    y_ref = st.zn[:, 0]
    t_limit = torch.as_tensor(t_limit, dtype=dtype, device=dev).expand(L)
    iinj = torch.as_tensor(iinj, dtype=dtype, device=dev).expand(L)
    i32 = dict(dtype=torch.int32, device=dev)
    false = torch.zeros((L,), dtype=torch.bool, device=dev)

    def wrms(x, y):
        return _wrms(x, y, opts)

    def rhs(y):
        return model.rhs(None, y, iinj)

    def attempt_body(st, ncf, nef, attempts, f_first, live):
        # ---- tstop / hmax clamp --------------------------------------------
        room = t_limit - st.t
        h_goal = torch.minimum(st.h, torch.clamp(room, max=opts.hmax))
        h_goal = torch.clamp(h_goal, min=HMIN)
        eta0 = h_goal / st.h
        zn, h = _rescale(st.zn, st.tau, st.h, st.q, eta0)
        st = st._replace(zn=zn, h=h)

        l, tq, gamma = _set_bdf_coeffs(st.q, st.h, st.tau, method=opts.method)
        tq1, tq2, tq3, tq4, tq5 = tq

        zn_pred = _predict(st.zn, st.q)
        ypred = zn_pred[:, 0]
        zdot_term = zn_pred[:, 1] / l[:, 1:2]          # gamma * ydot_pred

        # ---- Jacobian freshness (cvNlsNewton's callSetup decision) ---------
        if reuse:
            gamrat = gamma / st.gamma_saved
            need = st.jbad | ((st.nst - st.nstlp) >= MSBP) \
                | (torch.abs(gamrat - 1.0) > DGMAX)
            factors = st.factors
            if bool((need & live).any()):
                factors = torch.where(need[:, None],
                                      model.newton_setup(ypred, gamma,
                                                         mode=opts.precond),
                                      factors)
            st = st._replace(
                factors=factors,
                gamma_saved=torch.where(need, gamma, st.gamma_saved),
                nstlp=torch.where(need, st.nst, st.nstlp),
                nsetups=st.nsetups + need.to(torch.int32),
                jbad=false)
            jcur = need                          # factors current for this y?
        else:
            jcur = ~false                        # rebuilt every iteration

        # ---- modified Newton (cvNlsNewton) ---------------------------------
        y, acor = ypred, torch.zeros_like(ypred)
        delp = torch.zeros_like(gamma)
        crate = torch.ones_like(gamma)
        m = torch.zeros((L,), **i32)
        conv, div = false, false
        nni, nfe, f_keep = st.nni, st.nfe, f_first
        g_col = gamma[:, None]
        while True:
            nlive = (m < MAX_NEWTON) & ~conv & ~div & live
            if not bool(nlive.any()):
                break
            if deliver is None:
                f = rhs(y)
            else:
                # deliver lanes: rhs on the post-event state (reinit's f)
                f = rhs(torch.where(deliver[:, None], y_ev, y))
            f_keep_n = torch.where((m == 0)[:, None], f, f_keep)
            G = acor + zdot_term - g_col * f
            if reuse:
                delta = model.newton_solve(st.factors, -G, mode=opts.precond)
            else:
                delta = model.solve_newton_mat(y, gamma, -G,
                                               mode=opts.precond)
            dnrm = wrms(delta, y_ref)
            crate_n = torch.where(
                m > 0, torch.maximum(CRDOWN * crate,
                                     dnrm / torch.clamp(delp, min=1e-300)),
                crate)
            dcon = dnrm * torch.clamp(crate_n, max=1.0) / tq4
            conv_n = dcon < 1.0
            if deliver is not None:
                conv_n = conv_n | deliver
            div_n = (m >= 1) & (dnrm > RDIV * torch.clamp(delp, min=1e-300))
            nl = nlive[:, None]
            y = torch.where(nl, y + delta, y)
            acor = torch.where(nl, acor + delta, acor)
            delp = torch.where(nlive, dnrm, delp)
            crate = torch.where(nlive, crate_n, crate)
            conv = torch.where(nlive, conv_n, conv)
            div = torch.where(nlive, div_n, div)
            f_keep = torch.where(nl, f_keep_n, f_keep)
            nni = nni + nlive.to(torch.int32)
            nfe = nfe + nlive.to(torch.int32)
            m = m + nlive.to(torch.int32)
        f_first = f_keep
        m_it = m
        # under "iteration" every Newton iteration is one assembly + solve
        nsetups = st.nsetups if reuse else st.nsetups + (nni - st.nni)
        st = st._replace(nni=nni, nfe=nfe, nsetups=nsetups)

        acnrm = wrms(acor, y_ref)
        dsm = acnrm * tq2

        err_ok = dsm <= 1.0
        accepted = conv & err_ok
        if deliver is not None:
            accepted = accepted | deliver
        # stale-factor convergence failure: retry the SAME step with a
        # forced fresh setup before any h reduction
        stale = ~conv & ~jcur

        force_ef = conv & ~accepted & (nef + 1 >= MAX_NEF)
        # the q->1 restart of a convergence failure is the reuse policy's
        force_cf = ~conv & jcur & (ncf + 1 >= MAX_NCF_RESTART) & reuse
        force_any = force_ef | force_cf
        if bool((force_any & live).any()):
            f_restart = torch.where(force_any[:, None], rhs(y_ref), 0.0)
        else:
            f_restart = torch.zeros_like(y_ref)

        # ---- outcomes -------------------------------------------------------
        # convergence failure (under "iteration" never stale, never forced)
        force = ~stale & (ncf + 1 >= MAX_NCF_RESTART) & reuse
        eta = torch.where(stale, 1.0, ETACF).to(dtype)
        q_cf = torch.where(force, 1, st.q).to(torch.int32)
        zn_cf, h_cf = _rescale(st.zn, st.tau, st.h, q_cf, eta)
        zn_cf = _row1_set(zn_cf, force, h_cf[:, None] * f_restart)
        st_cf = st._replace(
            zn=zn_cf, h=h_cf, q=q_cf,
            etamax=torch.where(stale, st.etamax, 1.0),
            nncf=st.nncf + (~stale).to(torch.int32),
            jbad=~false, nfe=st.nfe + force.to(torch.int32))
        ncf_cf = ncf + (~stale).to(torch.int32)

        # error-test failure; etaq also sizes an accepted step
        Lq = (st.q + 1).to(dtype)
        etaq = 1.0 / (dm.pow(BIAS2 * dsm, 1.0 / Lq) + ADDON)
        eta = torch.clamp(etaq, ETAMIN_EF, ETAMXF)
        force = nef + 1 >= MAX_NEF
        q_ef = torch.where(force, 1, st.q).to(torch.int32)
        eta = torch.where(force, ETAMIN_EF, eta)
        zn_ef, h_ef = _rescale(st.zn, st.tau, st.h, q_ef, eta)
        zn_ef = _row1_set(zn_ef, force, h_ef[:, None] * f_restart)
        st_ef = st._replace(zn=zn_ef, h=h_ef, q=q_ef,
                            etamax=torch.full_like(st.etamax, 1.0),
                            netf=st.netf + 1,
                            nfe=st.nfe + force.to(torch.int32))
        nef_ef = nef + 1

        st_ok = _on_accept(st, l, tq1, tq3, etaq, zn_pred, acor, y_ref, m_it,
                           crate, opts)

        st = lane_where(accepted, st_ok, lane_where(conv, st_ef, st_cf))
        ncf = torch.where(accepted | conv, ncf, ncf_cf)
        nef = torch.where(accepted | ~conv, nef, nef_ef)

        give_up = (ncf >= MAX_NCF) | (nef >= MAX_NEF + 3) \
            | (attempts + 1 >= MAX_ATTEMPTS)
        if deliver is not None:
            give_up = give_up & ~deliver
        st = st._replace(failed=st.failed | give_up)
        done = accepted | give_up
        return st, ncf, nef, attempts + 1, done, f_first

    ncf = torch.zeros((L,), **i32)
    nef = torch.zeros((L,), **i32)
    attempts = torch.zeros((L,), **i32)
    done = false
    f_first = torch.zeros_like(y_ref)
    while True:
        live = ~done
        if not bool(live.any()):
            break
        st_n, ncf_n, nef_n, att_n, done_n, f_n = attempt_body(
            st, ncf, nef, attempts, f_first, live)
        st = lane_where(live, st_n, st)
        ncf = torch.where(live, ncf_n, ncf)
        nef = torch.where(live, nef_n, nef)
        attempts = torch.where(live, att_n, attempts)
        done = torch.where(live, done_n, done)
        f_first = torch.where(live[:, None], f_n, f_first)
    # snap to t_limit when within rounding distance
    snap = (t_limit - st.t) < 1e-10
    st = st._replace(t=torch.where(snap, t_limit, st.t))
    return st, f_first


def _on_accept(st, l, tq1, tq3, etaq, zn_pred, acor, y_ref, m_it, crate,
               opts):
    """cvCompleteStep + cvPrepareNextStep for every lane."""
    dtype = st.zn.dtype
    q, h = st.q, st.h
    nst = st.nst + 1
    tau = st.tau
    # tau[i] = tau[i-1] for i = q .. 2 (descending: all from the old row)
    idx = torch.arange(2, LMAX + 1, device=q.device)
    shifted = torch.where(idx[None, :] <= q[:, None], tau[:, 1:LMAX],
                          tau[:, 2:])
    tau = torch.cat([tau[:, :2], shifted], dim=1)
    tau2 = torch.where((q == 1) & (nst > 1), tau[:, 1], tau[:, 2])
    tau = torch.cat([tau[:, :1], h[:, None], tau2[:, None], tau[:, 3:]],
                    dim=1)
    live = (torch.arange(LMAX, device=q.device)[None, :] <= q[:, None])
    zn = torch.where(live[:, :, None], zn_pred + l[:, :, None] * acor[:, None],
                     zn_pred)
    qwait = st.qwait - 1

    # ---- order & step selection (cvPrepareNextStep) ----------------
    # etaq (order q) comes from the error test; orders q-1 and q+1 share
    # one stacked power
    Lq = (q + 1).to(dtype)
    do_sel = qwait == 0
    ddn = _wrms(_take(zn, torch.clamp(q, 1, QMAX)), y_ref, opts) * tq1
    dup = _wrms(acor - st.acor_save, y_ref, opts) * tq3
    pw = dm.pow(torch.stack([BIAS1 * ddn, BIAS3 * dup]),
                torch.stack([1.0 / q.to(dtype), 1.0 / (Lq + 1.0)]))
    etaqm1 = torch.where(q > 1, 1.0 / (pw[0] + ADDON), 0.0)
    etaqp1 = torch.where(q < QMAX, 1.0 / (pw[1] + ADDON), 0.0)
    etam = torch.maximum(etaqm1, torch.maximum(etaq, etaqp1))
    qprime_sel = torch.where(etam == etaqm1, q - 1,
                             torch.where(etam == etaq, q, q + 1))
    eta_sel = torch.where(etam < THRESH, 1.0, etam)
    qprime_sel = torch.where(etam < THRESH, q, qprime_sel)

    eta_noq = torch.where(etaq < THRESH, 1.0, etaq)
    eta = torch.where(do_sel, eta_sel, eta_noq)
    qprime = torch.where(do_sel, qprime_sel, q)
    eta = torch.minimum(eta, st.etamax)
    # never exceed hmax
    eta = eta / torch.clamp(eta * h * (1.0 / opts.hmax), min=1.0)

    # apply order change on zn
    inc, dec = qprime > q, qprime < q
    if bool(inc.any()):
        zn = torch.where(_bc(inc, zn), _increase_order(zn, tau, h, q, acor),
                         zn)
    if bool(dec.any()):
        zn = torch.where(_bc(dec, zn), _decrease_order(zn, tau, h, q), zn)
    qnew = torch.clamp(qprime, 1, QMAX).to(torch.int32)
    zn, hnew = _rescale(zn, tau, h, qnew, eta)
    qwait = torch.where(do_sel, qnew + 1, qwait).to(torch.int32)

    # convergence-rate decay flags the factors stale for the next step
    jbad_next = (m_it >= 2) & (crate > CRDOWN)
    return st._replace(
        t=st.t + h, h=hnew, q=qnew, zn=zn, tau=tau, qwait=qwait,
        etamax=torch.full_like(st.etamax, ETAMX), acor_save=acor, nst=nst,
        jbad=st.jbad | jbad_next)


def step_or_deliver(model, st: BDFState, t_limit, w_ampa, w_gaba, deliver,
                    iinj, opts: BDFOptions) -> BDFState:
    """Per lane: ``deliver`` -> apply the synaptic discontinuity at the
    current time and reset the IVP (``deliver_event`` semantics); else one
    accepted BDF step clamped at ``t_limit`` (``step`` semantics).  The
    deliver lanes ride the step's Newton machinery, so the reset's rhs is
    the corrector's first evaluation."""
    y_ev = model.apply_event(st.zn[:, 0], w_ampa, w_gaba)
    st_stepped, f_ev = _step_impl(model, st, t_limit, iinj, opts,
                                  deliver=deliver, y_ev=y_ev)
    counters = (st.nst, st.nfe + 1, st.nni, st.netf, st.nncf, st.nreset + 1,
                st.nsetups)
    st_del = reinit(model, st.t, y_ev, iinj, opts, counters=counters, f=f_ev)
    st_del = st_del._replace(failed=st.failed)
    return lane_where(deliver, st_del, st_stepped)


def advance_to(model, st: BDFState, t_target, iinj, opts: BDFOptions,
               max_steps: int = 100000) -> BDFState:
    """Step every lane until st.t >= t_target (or failure)."""
    L = st.t.shape[0]
    k = torch.zeros((L,), dtype=torch.int32, device=st.t.device)
    t_target = torch.as_tensor(t_target, dtype=st.t.dtype,
                               device=st.t.device).expand(L)
    while True:
        live = (st.t < t_target - 1e-12) & ~st.failed & (k < max_steps)
        if not bool(live.any()):
            return st
        ids = live.nonzero().squeeze(1)
        sub = step(model, gather_lanes(st, ids), t_target[ids],
                   torch.as_tensor(iinj, dtype=st.t.dtype,
                                   device=st.t.device).expand(L)[ids], opts)
        st = scatter_lanes(st, ids, sub)
        k = k + live.to(torch.int32)


def interpolate(st: BDFState, t_eval):
    """Evaluate each lane's Nordsieck polynomial at t_eval in [t-h_used, t]."""
    s = (t_eval - st.t) / st.h
    y = torch.zeros_like(st.zn[:, 0])
    sj = torch.ones_like(s)
    for j in range(LMAX):
        y = y + torch.where(j <= st.q, sj, 0.0)[:, None] * st.zn[:, j]
        sj = sj * s
    return y


def deliver_event(model, st: BDFState, w_ampa, w_gaba, iinj,
                  opts: BDFOptions) -> BDFState:
    """Apply a synaptic discontinuity at the current time and reset the IVP
    (paper §2.3)."""
    y = model.apply_event(st.zn[:, 0], w_ampa, w_gaba)
    counters = (st.nst, st.nfe + 1, st.nni, st.netf, st.nncf, st.nreset + 1,
                st.nsetups)
    new = reinit(model, st.t, y, iinj, opts, counters=counters)
    return new._replace(failed=st.failed)
