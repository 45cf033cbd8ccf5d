"""Plain PyTorch version of the fused HH right-hand side."""
from __future__ import annotations

from repro_torch.core import mechanisms as mech


def hh_rhs_ref(area, v, m, h, n):
    """area: [C]; v, m, h, n: [N, C] -> (dm, dh, dn, i_ion, g_tot)."""
    dm, dh, dn = mech.gate_derivs(v, m, h, n)
    g_na, g_k, g_l = mech.channel_conductances(area[None, :], m, h, n)
    i_ion = g_na * (v - mech.ENA) + g_k * (v - mech.EK) + g_l * (v - mech.EL)
    return dm, dh, dn, i_ion, g_na + g_k + g_l
