"""Elastic plus kinetic energy of a state.

Counterpart of ``gcm_tpu/utils/energy.py`` on torch tensors:
``E = sum_nodes (rho |v|^2 / 2 + W(sigma)) * cell_volume``. With absorbing
borders E decays (outgoing characteristics leave, nothing enters); with
free borders it is conserved up to splitting error.

Isotropic strain energy density in d dimensions (from inverting
``sigma = lam tr(eps) I + 2 mu eps``):

    W = (1/2) [ sigma:sigma / (2 mu)
                - lam (tr sigma)^2 / (2 mu (d lam + 2 mu)) ]

(1D: W = sigma^2 / (2 (lam + 2 mu)); acoustic: W = p^2 / (2 lam).)
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from gcm_tpu_torch.models.spec import Model


def elastic_energy(
    model: Model,
    u: torch.Tensor,
    rho: torch.Tensor,
    lam: torch.Tensor,
    mu: torch.Tensor,
    h: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Total energy of a state (a 0-d tensor), summed over the nodes and
    times the cell volume when ``h`` is given.

    ``rho``, ``lam`` and ``mu`` are per-node tensors. Acoustic models (state
    ``(v.., p)``, ``mu`` unused) take the bulk term ``p^2 / (2 lam)``.
    """
    dim = model.dim
    names = model.comp_names
    kinetic = 0.5 * rho * sum(u[i] ** 2 for i in range(dim))

    if "p" in names:
        p = u[model.comp("p")]
        potential = 0.5 * p ** 2 / torch.clamp(lam, min=1e-300)
    else:
        ax = "xyz"[:dim]
        diag = [u[model.comp(f"s{a}{a}")] for a in ax]
        offd = [u[model.comp(f"s{ax[i]}{ax[j]}")]
                for i in range(dim) for j in range(i + 1, dim)]
        ss = sum(d ** 2 for d in diag) + 2.0 * sum(o ** 2 for o in offd)
        tr = sum(diag)
        mu_s = torch.clamp(mu, min=1e-300)
        potential = 0.5 * (ss / (2.0 * mu_s)
                           - lam * tr ** 2
                           / (2.0 * mu_s * (dim * lam + 2.0 * mu_s)))

    total = torch.sum(kinetic + potential)
    if h is not None:
        vol = 1.0
        for hh in h:
            vol = vol * hh
        total = total * vol
    return total
