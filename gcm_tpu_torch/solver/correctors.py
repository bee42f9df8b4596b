"""Per-node ODE correctors applied after the hyperbolic sweeps.

Counterpart of ``gcm_tpu/solver/correctors.py``: viscoelastic Maxwell
relaxation and continual damage. Each corrector is a pure elementwise update
``(u, aux, dt) -> (u, aux)`` on tensors, run by the engine after each step
and its source injection (split-step coupling with the hyperbolic part).
``ops/fused.py`` folds the same updates into the fused kernels' epilogue.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from gcm_tpu_torch.models.spec import Model


def _diag_stress_indices(model: Model):
    names = model.comp_names
    return [i for i, n in enumerate(names)
            if n.startswith("s") and len(set(n[1:])) == 1]


def _shear_stress_indices(model: Model):
    names = model.comp_names
    return [i for i, n in enumerate(names)
            if n.startswith("s") and len(set(n[1:])) == 2]


@dataclasses.dataclass(frozen=True)
class MaxwellCorrector:
    """Maxwell viscoelasticity: deviatoric stress relaxes with time tau.

    d sigma_dev / dt = -sigma_dev / tau  (exact exponential integrator:
    sigma_dev *= exp(-dt/tau), computed in the state dtype); the isotropic
    (pressure) part is elastic. ``tau`` may be a scalar or a per-node
    tensor.
    """

    tau: Any
    name: str = "maxwell"

    def init_aux(self, model: Model, shape, device="cpu") -> Dict[str, torch.Tensor]:
        return {}

    def __call__(self, model: Model, u: torch.Tensor, aux: Dict, dt: float
                 ) -> Tuple[torch.Tensor, Dict]:
        decay = torch.exp(-dt / torch.as_tensor(self.tau, dtype=u.dtype,
                                                device=u.device))
        diag = _diag_stress_indices(model)
        shear = _shear_stress_indices(model)
        if not diag:
            return u, aux
        mean = sum(u[i] for i in diag) / len(diag)
        u = u.clone()
        for i in diag:
            u[i] = mean + (u[i] - mean) * decay
        for i in shear:
            u[i] = u[i] * decay
        return u, aux


@dataclasses.dataclass(frozen=True)
class DamageCorrector:
    """Continual damage: a per-node scalar d in [0, 1] grows where the
    maximum tensile normal stress exceeds a threshold, and degrades the
    stress the node can carry: the carried stress tracks ``(1 - d)`` times
    the undamaged evolution, applied incrementally per step
    (sigma *= (1-d_new)/(1-d_old)). Irreversible.

    The incremental form matters: multiplying the evolving stress by the
    full ``(1-d)`` every step would compound, a dt-dependent decay that does
    not converge under time refinement.

    d_t = rate * max(0, max_diag_stress - threshold) / threshold
    """

    threshold: float
    rate: float
    name: str = "damage"

    def init_aux(self, model: Model, shape, device="cpu") -> Dict[str, torch.Tensor]:
        # float32 whatever the state dtype, as in the JAX package: against a
        # float64 state the first update promotes it
        return {"damage": torch.zeros(tuple(shape), dtype=torch.float32,
                                      device=device)}

    def __call__(self, model: Model, u: torch.Tensor, aux: Dict, dt: float
                 ) -> Tuple[torch.Tensor, Dict]:
        diag = _diag_stress_indices(model)
        shear = _shear_stress_indices(model)
        d = aux["damage"]
        smax = torch.stack([u[i] for i in diag]).amax(0)
        over = torch.clamp(smax - self.threshold, min=0.0) / self.threshold
        d_new = torch.clamp(d + self.rate * over * dt, 0.0, 1.0)
        # incremental: cumulative scaling is (1 - d) vs the undamaged
        # stress; fully damaged nodes (d == 1) stay at zero stress
        factor = torch.clamp(
            (1.0 - d_new) / torch.clamp(1.0 - d, min=1e-12), max=1.0
        ).to(u.dtype)
        u = u.clone()
        for i in diag + shear:
            u[i] = u[i] * factor
        aux = dict(aux)
        aux["damage"] = d_new
        return u, aux
