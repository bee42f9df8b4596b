"""The port's contact solvers and multi-body steps against the JAX package.

Both packages get identical inputs made with a seeded numpy generator, in
float64 on the CPU. The contact algebra (``apply_contact``,
``apply_contact_post``, the non-conforming ``apply_contact_nc_post``) and
the multi-body step (``step_multi``) run the same arithmetic in the same
order as their JAX counterparts, so they agree to round-off: 1e-12 (rtol,
with an atol of 1e-12 of the field's max). The interface maps are numpy in
both and must be equal. The port's fused composition (``step_multi_fused``,
the fused wrappers' plain versions on the CPU, with face-row fixups) is
held to the port's own ``step_multi`` to 1e-12, as tests/
test_multibody_fast.py holds the JAX one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.materials import MaterialFields as JMat
from gcm_tpu.models.spec import get_model as jget_model
from gcm_tpu.ops.stage import stage_pair_updates as jpair_updates
from gcm_tpu.solver import contact as jc
from gcm_tpu.solver import contact_nc as jnc
from gcm_tpu.solver.multi import step_multi as jstep_multi
from gcm_tpu.task import BorderSpec as JBorderSpec
from gcm_tpu.task import GridSpec as JGridSpec
from gcm_tpu_torch.convert import (
    MATERIAL_LEAVES, bonded_from_numpy, interface_maps_from_numpy,
    material_fields_from_numpy)
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import fused_step, fused_step_2d, stack_mats
from gcm_tpu_torch.ops.stage import stage_pair_updates
from gcm_tpu_torch.solver import contact as tc
from gcm_tpu_torch.solver import contact_nc as tnc
from gcm_tpu_torch.solver.multi import (
    fused_contacts_ok, step_multi, step_multi_fused)
from gcm_tpu_torch.task import BorderSpec, GridSpec


def close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * (np.abs(want).max() + 1e-300))


def mats_pair(rng, shape):
    """Heterogeneous float64 materials for both packages."""
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    jm = JMat.from_arrays(rho, lam, mu, xp=jnp, dtype=np.float64)
    tm = material_fields_from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in MATERIAL_LEAVES},
        dtype=torch.float64)
    return jm, tm


def spec_pair(**kw):
    return jc.ContactSpec(**kw), tc.ContactSpec(**kw)


#: (dim, shapes a/b, contact fields): every kind, fracture with each
#: broken kind, 2D and 3D, interfaces on axes 0, 1 and 2, partial overlaps
ALGEBRA_CASES = [
    (2, (8, 6), (7, 6), dict(axis=0, kind="bonded", tensile_strength=5e4,
                             broken_kind="free")),
    (2, (6, 8), (6, 7), dict(axis=1, kind="slip", tensile_strength=5e4,
                             broken_kind="slip")),
    (2, (8, 6), (7, 6), dict(axis=0, kind="friction", friction_mu=0.3,
                             tensile_strength=5e4, broken_kind="friction")),
    (3, (6, 7, 5), (8, 6, 4), dict(axis=2, kind="bonded", lo_a=(1, 2),
                                   lo_b=(0, 1), span=(5, 4),
                                   tensile_strength=5e4,
                                   broken_kind="friction", friction_mu=0.3)),
    (3, (5, 6, 4), (4, 6, 4), dict(axis=0, kind="friction",
                                   friction_mu=0.3)),
    (3, (6, 5, 5), (6, 5, 4), dict(axis=2, kind="slip", tensile_strength=5e4,
                                   broken_kind="free")),
]


def _algebra_inputs(rng, dim, sa, sb, fields):
    name = f"elastic{dim}d"
    model, tmodel = jget_model(name), get_model(name)
    (jma, tma), (jmb, tmb) = mats_pair(rng, sa), mats_pair(rng, sb)
    C = model.ncomp
    ua = rng.standard_normal((C,) + sa) * 1e5
    ub = rng.standard_normal((C,) + sb) * 1e5
    jspec, tspec = spec_pair(body_a="a", body_b="b", **fields)
    ax = fields["axis"]
    if fields.get("span") is not None:
        mshape = fields["span"]
    else:
        mshape = tuple(s for d, s in enumerate(sa) if d != ax)
    bonded = (rng.random(mshape) > 0.2).astype(np.float64) \
        if fields.get("tensile_strength") else None
    return (model, tmodel, jma, tma, jmb, tmb, ua, ub, jspec, tspec, bonded)


@pytest.mark.parametrize("case", range(len(ALGEBRA_CASES)))
def test_apply_contact_matches_jax(rng, case):
    """The in-sweep contact solve on the raw invariants of both bodies."""
    dim, sa, sb, fields = ALGEBRA_CASES[case]
    (model, tmodel, jma, tma, jmb, tmb, ua, ub, jspec, tspec,
     bonded) = _algebra_inputs(rng, dim, sa, sb, fields)
    ax = fields["axis"]
    st = model.stage(ax)
    dt, order = 0.6 / 4000.0, 2
    jv = (jma.axis_view(ax, st), jmb.axis_view(ax, st))
    tv = (tma.axis_view(ax, tmodel.stage(ax)),
          tmb.axis_view(ax, tmodel.stage(ax)))
    jp = [jpair_updates(model, jnp.asarray(u), v, dt / 10.0, ax, order)
          for u, v in ((ua, jv[0]), (ub, jv[1]))]
    tp = [stage_pair_updates(tmodel, torch.tensor(u), v, dt / 10.0, ax,
                             order) for u, v in ((ua, tv[0]), (ub, tv[1]))]
    jb = None if bonded is None else jnp.asarray(bonded)
    tb = None if bonded is None else torch.tensor(bonded)
    jpa, jpb, jnb = jc.apply_contact(jspec, dim, jp[0], jp[1], *jv, jb)
    tpa, tpb, tnb = tc.apply_contact(tspec, dim, tp[0], tp[1], *tv, tb)
    for jd, td in ((jpa, tpa), (jpb, tpb)):
        for k in jd:
            close(td[k][0], jd[k][0])
            close(td[k][1], jd[k][1])
    if bonded is not None:
        np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
        assert 0 < tnb.sum() < bonded.sum() or fields["kind"] != "bonded"


@pytest.mark.parametrize("case", range(len(ALGEBRA_CASES)))
def test_apply_contact_post_matches_jax(rng, case):
    """The contact solve as a fixup on raw post-sweep states."""
    dim, sa, sb, fields = ALGEBRA_CASES[case]
    (model, tmodel, jma, tma, jmb, tmb, ua, ub, jspec, tspec,
     bonded) = _algebra_inputs(rng, dim, sa, sb, fields)
    ax = fields["axis"]
    ua_old = ua + rng.standard_normal(ua.shape) * 1e4
    ub_old = ub + rng.standard_normal(ub.shape) * 1e4
    st, tst = model.stage(ax), tmodel.stage(ax)
    jb = None if bonded is None else jnp.asarray(bonded)
    tb = None if bonded is None else torch.tensor(bonded)
    ja, jbb, jnb = jc.apply_contact_post(
        jspec, model, *map(jnp.asarray, (ua_old, ua, ub_old, ub)),
        jma.axis_view(ax, st), jmb.axis_view(ax, st), jb)
    ta, tbb, tnb = tc.apply_contact_post(
        tspec, tmodel, *map(torch.tensor, (ua_old, ua, ub_old, ub)),
        tma.axis_view(ax, tst), tmb.axis_view(ax, tst), tb)
    close(ta, ja)
    close(tbb, jbb)
    assert not np.array_equal(ta.numpy(), ua)      # the face was solved
    if bonded is not None:
        np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))


def _nc_grids(dim):
    """A coarse grid and a finer, offset one meeting on axis 0."""
    if dim == 2:
        ga = dict(shape=(6, 9), h=(1.0, 1.0), origin=(0.0, 0.0))
        gb = dict(shape=(9, 13), h=(0.5, 0.5), origin=(5.0, 1.25))
    else:
        ga = dict(shape=(5, 7, 6), h=(1.0, 1.0, 1.0), origin=(0.0,) * 3)
        gb = dict(shape=(7, 9, 7), h=(0.5, 0.75, 0.5),
                  origin=(4.0, 0.5, 1.0))
    return (JGridSpec(**ga), JGridSpec(**gb)), (GridSpec(**ga),
                                                GridSpec(**gb))


@pytest.mark.parametrize("dim", [2, 3])
def test_interface_maps_and_nc_post_match_jax(rng, dim):
    (jga, jgb), (tga, tgb) = _nc_grids(dim)
    jmaps = jnc.build_interface_maps(jga, jgb, 0)
    tmaps = tnc.build_interface_maps(tga, tgb, 0)
    assert not tnc.faces_conform(tga, tgb, 0)
    assert tnc.faces_conform(tga, tga, 0) == jnc.faces_conform(jga, jga, 0)
    for js, ts in ((jmaps.a, tmaps.a), (jmaps.b, tmaps.b)):
        assert ts.lo == js.lo and ts.span == js.span
        for jm, tm in zip(js.from_other, ts.from_other):
            np.testing.assert_array_equal(tm.idx, jm.idx)
            np.testing.assert_array_equal(tm.w, jm.w)
    assert interface_maps_from_numpy(jmaps).a.span == tmaps.a.span

    name = f"elastic{dim}d"
    model, tmodel = jget_model(name), get_model(name)
    (jma, tma), (jmb, tmb) = mats_pair(rng, jga.shape), mats_pair(rng,
                                                                  jgb.shape)
    C = model.ncomp
    us = [rng.standard_normal((C,) + g.shape) * 1e5
          for g in (jga, jga, jgb, jgb)]
    bonded = {"a": (rng.random(tmaps.a.span) > 0.2).astype(np.float64),
              "b": (rng.random(tmaps.b.span) > 0.2).astype(np.float64)}
    for kind, mu in (("bonded", 0.0), ("friction", 0.3)):
        jspec, tspec = spec_pair(body_a="a", body_b="b", axis=0, kind=kind,
                                 friction_mu=mu, tensile_strength=5e4,
                                 broken_kind="slip")
        st, tst = model.stage(0), tmodel.stage(0)
        ja, jb, jnb = jnc.apply_contact_nc_post(
            jspec, model, jmaps, *map(jnp.asarray, us),
            jma.axis_view(0, st), jmb.axis_view(0, st),
            {k: jnp.asarray(v) for k, v in bonded.items()})
        ta, tb, tnb = tnc.apply_contact_nc_post(
            tspec, tmodel, tmaps, *map(torch.tensor, us),
            tma.axis_view(0, tst), tmb.axis_view(0, tst),
            bonded_from_numpy({0: bonded})[0])
        close(ta, ja)
        close(tb, jb)
        for s in "ab":
            np.testing.assert_array_equal(tnb[s].numpy(), np.asarray(jnb[s]))


# ------------------------------------------------------------ multi-body steps

def _borders(kind, dim, skip=()):
    faces = [(a, s) for a in range(dim) for s in (0, 1) if (a, s) not in skip]
    return ({f: JBorderSpec(kind) for f in faces},
            {f: BorderSpec(kind) for f in faces})


def _multi_case(rng, case):
    """Bodies, materials, borders and contacts of tests/
    test_multibody_fast.py's cases, for both packages."""
    if case in ("bonded", "slip", "friction"):
        dim, shapes = 2, {"a": (12, 8), "b": (10, 8)}
        fields = [dict(body_a="a", body_b="b", axis=0, kind=case,
                       friction_mu=0.3 if case == "friction" else 0.0,
                       tensile_strength=5e4)]
        bkind, skip = "absorbing", {}
    elif case == "partial3d":
        dim, shapes = 3, {"a": (8, 10, 6), "b": (8, 8, 6)}
        fields = [dict(body_a="a", body_b="b", axis=1, kind="bonded",
                       lo_a=(1, 0), lo_b=(0, 0), span=(6, 6))]
        bkind, skip = "free", {}
    else:  # a three-body chain along x
        dim, shapes = 2, {"a": (8, 6), "b": (7, 6), "c": (9, 6)}
        fields = [dict(body_a="a", body_b="b", axis=0, kind="bonded"),
                  dict(body_a="b", body_b="c", axis=0, kind="bonded",
                       tensile_strength=4e4)]
        bkind, skip = "absorbing", {}
    name = f"elastic{dim}d"
    C = get_model(name).ncomp
    mats = {k: mats_pair(rng, s) for k, s in shapes.items()}
    u0 = {k: rng.standard_normal((C,) + s) * 1e5 for k, s in shapes.items()}
    jb, tb = _borders(bkind, dim)
    specs = [spec_pair(**f) for f in fields]
    bonded = {}
    for ci, f in enumerate(fields):
        if f.get("tensile_strength"):
            sa = shapes[f["body_a"]]
            bonded[ci] = np.ones(tuple(s for d, s in enumerate(sa)
                                       if d != f["axis"]))
    return dict(
        dim=dim, name=name, shapes=shapes, u0=u0, bonded=bonded,
        jmats={k: m[0] for k, m in mats.items()},
        tmats={k: m[1] for k, m in mats.items()},
        jborders={k: dict(jb) for k in shapes},
        tborders={k: dict(tb) for k in shapes},
        jcontacts=tuple(s[0] for s in specs),
        tcontacts=tuple(s[1] for s in specs))


MULTI_CASES = ["bonded", "slip", "friction", "partial3d", "chain"]


@pytest.mark.parametrize("case", MULTI_CASES)
def test_step_multi_matches_jax(rng, case):
    c = _multi_case(rng, case)
    dim = c["dim"]
    model, tmodel = jget_model(c["name"]), get_model(c["name"])
    hs = {k: (1.0,) * dim for k in c["shapes"]}
    dt = 0.5 / 4000.0
    ju = {k: jnp.asarray(v) for k, v in c["u0"].items()}
    tu = {k: torch.tensor(v) for k, v in c["u0"].items()}
    jbd = {k: jnp.asarray(v) for k, v in c["bonded"].items()}
    tbd = bonded_from_numpy(c["bonded"])
    for n in range(4):
        axes = tuple(range(dim))[::(-1 if n % 2 else 1)]
        ju, jbd = jstep_multi(model, ju, c["jmats"], dt, hs, 2,
                              c["jborders"], c["jcontacts"], jbd, axes)
        tu, tbd = step_multi(tmodel, tu, c["tmats"], dt, hs, 2,
                             c["tborders"], c["tcontacts"], tbd, axes)
    for k in tu:
        close(tu[k], ju[k])
    for ci in tbd:
        np.testing.assert_array_equal(tbd[ci].numpy(), np.asarray(jbd[ci]))
    if case in ("bonded", "slip", "friction", "chain"):
        assert min(float(v.mean()) for v in tbd.values()) < 1.0  # broke


@pytest.mark.parametrize("case", MULTI_CASES)
def test_step_multi_fused_equals_step_multi(rng, case):
    """One fused-wrapper step per body (its plain version on the CPU) plus
    the face-row fixups == the in-sweep contact solve."""
    c = _multi_case(rng, case)
    dim = c["dim"]
    tmodel = get_model(c["name"])
    hs = {k: (1.0,) * dim for k in c["shapes"]}
    dt = 0.5 / 4000.0
    assert fused_contacts_ok(tmodel, c["shapes"], c["tcontacts"], 2)
    faces = {(ct.body_a, ct.axis, 1) for ct in c["tcontacts"]
             if ct.span is None} | {(ct.body_b, ct.axis, 0)
                                    for ct in c["tcontacts"]
                                    if ct.span is None}
    ms = {k: stack_mats(tmodel, m) for k, m in c["tmats"].items()}
    fn = fused_step if dim == 3 else fused_step_2d

    def body(name, u, axes):
        bcs = {f: b for f, b in c["tborders"][name].items()
               if (name,) + f not in faces}
        return fn(tmodel, u, ms[name], dt, hs[name], 2, bcs, axes)

    got = {k: torch.tensor(v) for k, v in c["u0"].items()}
    want = dict(got)
    gb = bonded_from_numpy(c["bonded"])
    wb = dict(gb)
    for n in range(4):
        axes = tuple(range(dim))[::(-1 if n % 2 else 1)]
        got, gb = step_multi_fused(tmodel, got, c["tmats"], dt, hs, 2,
                                   c["tborders"], c["tcontacts"], gb, body,
                                   axes)
        want, wb = step_multi(tmodel, want, c["tmats"], dt, hs, 2,
                              c["tborders"], c["tcontacts"], wb, axes)
    for k in got:
        close(got[k], want[k])
    for ci in gb:
        np.testing.assert_array_equal(gb[ci].numpy(), wb[ci].numpy())


def test_fused_contacts_eligibility():
    model = get_model("elastic3d")
    shapes = {"a": (8, 8, 8), "b": (8, 8, 8)}
    C = tc.ContactSpec
    ok = (C("a", "b", 0),)
    assert fused_contacts_ok(model, shapes, ok, 2)
    # two contact axes on one body couple at the face-edge line
    assert not fused_contacts_ok(model, shapes,
                                 (C("a", "b", 0), C("b", "a", 1)), 2)
    # two contacts on the same face
    dup = (C("a", "b", 0, lo_a=(0, 0), lo_b=(0, 0), span=(2, 2)),
           C("a", "b", 0, lo_a=(4, 4), lo_b=(4, 4), span=(2, 2)))
    assert not fused_contacts_ok(model, shapes, dup, 2)
    # a body shallower than the fixup slab
    assert not fused_contacts_ok(model, {"a": (2, 8, 8), "b": (8, 8, 8)},
                                 ok, 2)
    # non-conforming maps present
    assert not fused_contacts_ok(model, shapes, ok, 2, ncmaps={0: object()})


def test_contact_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        tc.ContactSpec("a", "b", 0, kind="glued")
    with pytest.raises(ValueError, match="broken"):
        tc.ContactSpec("a", "b", 0, broken_kind="molten")
    with pytest.raises(ValueError, match="together"):
        tc.ContactSpec("a", "b", 0, lo_a=(0,))
    assert dataclasses.astuple(tc.ContactSpec("a", "b", 2)) == \
        dataclasses.astuple(jc.ContactSpec("a", "b", 2))
