"""Compartmental morphologies in Hines ordering.

Host numpy, a copy of the JAX package's ``repro.core.morphology`` kept
here so the port imports nothing of that package.

A neuron morphology is spatially discretised into a tree of cylindrical
compartments (paper §2.1, Fig. 2b).  We store the tree in *Hines order*:
``parent[i] < i`` for every non-root compartment, root (soma) at index 0.
This ordering makes the quasi-tridiagonal membrane system solvable in O(C)
with one backward elimination + one forward substitution (Hines 1984), and
is the layout the Hines kernels consume.

Units used throughout ``repro_torch.core`` (NEURON-compatible):
  voltage mV, time ms, capacitance nF, conductance uS, current nA,
  lengths um, specific capacitance uF/cm^2, specific conductance S/cm^2,
  axial resistivity Ohm*cm.
With these, ``1 nA / 1 nF = 1 mV/ms`` and ``1 uS * 1 mV = 1 nA``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class Morphology(NamedTuple):
    """Static description of one compartmental tree (numpy, not traced)."""

    parent: np.ndarray      # int32[C]; parent[0] == -1; parent[i] < i
    length: np.ndarray      # f64[C] um
    diam: np.ndarray        # f64[C] um
    area: np.ndarray        # f64[C] um^2 (membrane area, pi*d*L)
    cap: np.ndarray         # f64[C] nF   (cm * area)
    g_axial: np.ndarray     # f64[C] uS   (conductance to parent; 0 for root)

    @property
    def n_comp(self) -> int:
        return int(self.parent.shape[0])


_CM_UF_PER_CM2 = 1.0       # specific membrane capacitance
_RA_OHM_CM = 100.0         # axial resistivity


def _finalize(parent, length, diam) -> Morphology:
    parent = np.asarray(parent, np.int32)
    length = np.asarray(length, np.float64)
    diam = np.asarray(diam, np.float64)
    c = parent.shape[0]
    if c == 0:
        raise ValueError("empty morphology")
    if parent[0] != -1:
        raise ValueError("root must be compartment 0")
    if not np.all(parent[1:] < np.arange(1, c)):
        raise ValueError("not in Hines order (need parent[i] < i)")
    area = math.pi * diam * length                          # um^2
    # cm [uF/cm^2] * area [um^2] -> nF:  1 um^2 = 1e-8 cm^2; 1 uF = 1e3 nF
    cap = _CM_UF_PER_CM2 * area * 1e-8 * 1e3                # nF
    # axial resistance between compartment centres, child i <-> parent p:
    #   R = Ra * (L_i/2)/(pi d_i^2/4) + Ra * (L_p/2)/(pi d_p^2/4)   [Ohm*cm * um/um^2]
    # convert: Ra [Ohm*cm] * L [um] / A [um^2] = Ra * 1e4 * (L/A) [Ohm] (1 cm = 1e4 um)
    g_ax = np.zeros(c, np.float64)
    for i in range(1, c):
        p = parent[i]
        r_i = _RA_OHM_CM * 1e4 * (length[i] / 2.0) / (math.pi * diam[i] ** 2 / 4.0)
        r_p = _RA_OHM_CM * 1e4 * (length[p] / 2.0) / (math.pi * diam[p] ** 2 / 4.0)
        r_ohm = r_i + r_p
        g_ax[i] = 1e6 / r_ohm                               # Ohm -> uS (1/Ohm = 1e6 uS)
    return Morphology(parent, length, diam, area, cap, g_ax)


def soma_only(diam: float = 20.0) -> Morphology:
    """Single isopotential compartment (classic HH point soma)."""
    return _finalize([-1], [diam], [diam])


def ball_and_stick(n_dend: int = 10, dend_len: float = 50.0,
                   dend_diam: float = 2.0, soma_diam: float = 20.0) -> Morphology:
    """Soma + one unbranched dendrite of ``n_dend`` compartments."""
    parent = [-1] + list(range(0, n_dend))
    length = [soma_diam] + [dend_len] * n_dend
    diam = [soma_diam] + [dend_diam] * n_dend
    return _finalize(parent, length, diam)


def branched_tree(depth: int = 3, seg_per_branch: int = 2,
                  soma_diam: float = 20.0, trunk_diam: float = 3.0,
                  taper: float = 0.7, seg_len: float = 40.0) -> Morphology:
    """Synthetic binary dendritic tree: at each level the branch bifurcates and
    its diameter tapers.  Models the layer-5-pyramidal-like arborisation used
    in the paper's single-cell experiments (L5_TTPC2) at configurable size.
    Emitted in Hines order by construction (BFS)."""
    parent = [-1]
    length = [soma_diam]
    diam = [soma_diam]
    frontier = [(0, trunk_diam)]                 # (attach index, diameter)
    for _level in range(depth):
        nxt = []
        for attach, d in frontier:
            for _child in range(2):
                prev = attach
                for _s in range(seg_per_branch):
                    parent.append(prev)
                    length.append(seg_len)
                    diam.append(d)
                    prev = len(parent) - 1
                nxt.append((prev, d * taper))
        frontier = nxt
    return _finalize(parent, length, diam)


def by_name(name: str, **kw) -> Morphology:
    if name == "soma":
        return soma_only(**kw)
    if name == "ball_and_stick":
        return ball_and_stick(**kw)
    if name == "branched":
        return branched_tree(**kw)
    raise ValueError(f"unknown morphology {name!r}")
