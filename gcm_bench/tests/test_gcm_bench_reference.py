"""The reference against the port's plain path, at tiny sizes on the CPU in
float64: the sweep with layered media and both borders, and the contact
solve with fracture. (The test imports the port; the reference does not.)"""

import numpy as np
import pytest
import torch

from gcm_bench.reference.elastic import Block, Contact, Medium, sweep
from gcm_tpu_torch.materials import IsotropicMaterial, MaterialFields
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.solver.contact import ContactSpec
from gcm_tpu_torch.solver.gcm import stage
from gcm_tpu_torch.solver.multi import stage_multi
from gcm_tpu_torch.task import BorderSpec

F64 = torch.float64


def _layers(nz):
    rho = np.where(np.arange(nz) < nz // 2, 1900.0, 2700.0)
    cp = np.where(np.arange(nz) < nz // 2, 2100.0, 5200.0)
    cs = np.where(np.arange(nz) < nz // 2, 900.0, 3000.0)
    return rho, cp, cs


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_a_sweep_matches_the_plain_step(axis, order):
    shape = (10, 9, 12)
    g = torch.Generator().manual_seed(axis * 10 + order)
    u = torch.randn((9,) + shape, generator=g, dtype=F64)
    rho, cp, cs = _layers(shape[2])
    full = [torch.as_tensor(np.broadcast_to(a, shape).copy()) for a in
            (rho, cp, cs)]
    mu = full[0] * full[2] ** 2
    lam = full[0] * full[1] ** 2 - 2 * mu
    mat = MaterialFields.from_arrays(full[0], lam, mu, dtype=F64)
    h, dt = (3.0, 4.0, 5.0), 4e-4
    kinds = {(0, 0): "absorbing", (0, 1): "free", (1, 0): "free",
             (1, 1): "absorbing", (2, 0): "free", (2, 1): "absorbing"}
    borders = {f: BorderSpec(k) for f, k in kinds.items()}
    want = stage(get_model("elastic3d"), u, mat, dt, h, axis, order,
                 borders)
    view = (1, 1, shape[2])
    med = Medium.from_speeds(*(torch.as_tensor(a).reshape(view)
                               for a in (rho, cp, cs)))
    blk = Block(u=u.clone(), med=med, h=h, faces=kinds)
    sweep({"b": blk}, [], {}, dt, axis, order)
    torch.testing.assert_close(blk.u, want, rtol=1e-11, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_a_bonded_contact_with_fracture_matches_the_plain_step(axis):
    shape = (8, 7, 6)
    g = torch.Generator().manual_seed(axis)
    us = {k: 1e5 * torch.randn((9,) + shape, generator=g, dtype=F64)
          for k in ("a", "b")}
    mats = {"a": IsotropicMaterial.from_speeds(2000.0, 2500.0, 1200.0),
            "b": IsotropicMaterial.from_speeds(2500.0, 4000.0, 2300.0)}
    fields = {k: MaterialFields.uniform(m, shape, dtype=F64)
              for k, m in mats.items()}
    face = tuple(s for a, s in enumerate(shape) if a != 2)
    bonded = torch.ones(face, dtype=F64)
    bonded[0, 0] = 0.0
    spec = ContactSpec("a", "b", axis=2, kind="bonded",
                       tensile_strength=1e5, broken_kind="free")
    borders = {"a": {(2, 0): BorderSpec("free"),
                     (0, 0): BorderSpec("absorbing")},
               "b": {(2, 1): BorderSpec("absorbing")}}
    h, dt = (2.0, 2.0, 2.0), 3e-4
    want, wbond = stage_multi(get_model("elastic3d"), us, fields, dt,
                              {"a": h, "b": h}, axis, 2, borders, [spec],
                              {0: bonded})
    blocks = {}
    for k, m in mats.items():
        med = Medium.from_speeds(*(torch.tensor(v, dtype=F64).reshape(
            1, 1, 1) for v in (m.rho, m.cp, m.cs)))
        faces = {f: b.kind for f, b in borders[k].items()}
        blocks[k] = Block(u=us[k].clone(), med=med, h=h, faces=faces)
    got = sweep(blocks, [Contact("a", "b", 2, 1e5)], {0: bonded}, dt, axis,
                2)
    for k in us:
        torch.testing.assert_close(blocks[k].u, want[k], rtol=1e-11,
                                   atol=1e-4)
    torch.testing.assert_close(got[0], wbond[0])
    if axis == 2:
        assert 0 < float(got[0].mean()) < 1
