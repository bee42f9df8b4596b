"""The fused full steps: every splitting sweep of a step in one kernel.

Counterpart of ``gcm_tpu/ops/pallas_fused.py::fused_step``,
``fused_step_slab`` and ``fused_step_2d`` (material stack helpers, the
folded ODE correctors, bf16 material stacks, ``axes_seq`` temporal blocking
and the single-step contract). The kernels are CUDA C++ for Hopper,
``csrc/fused_step_slab.cu`` (3D, float or bf16 stack, one or two steps a
pass, the two-step body in ``csrc/fused_pair_stream.cuh``, compiled one
stencil order a source; ``fused_step`` launches its float, one-step form)
and ``csrc/fused_step_2d.cu`` (2D, both options: one step on the
row-streamed body, two on its two-step form),
sharing their sweep and epilogue (``csrc/gcm_common.cuh``). The streamed
bodies keep a cell's components in registers under a component map
compiled for each model (``STREAM_MODELS``); ``check_compiled_map`` holds
the runtime model to it. ``fused_step_reference`` is the plain PyTorch version of one step
(the port's ``solver.gcm.step`` on materials derived from the compact
stack exactly as the kernels derive them, then
``corrector_epilogue_reference``); ``fused_step_slab_reference``
runs it once per step of a sequence on the upcast stack, and
``fused_step_2d_reference`` names it for the 2D kernel.

``fused_step``, ``fused_step_slab`` and ``fused_step_2d`` launch their
kernel for a CUDA tensor and run the plain version for a CPU tensor; for a
CUDA tensor they launch or raise, they never fall back. ``fused_step``
hands bf16 stacks and two-step sequences to ``fused_step_slab``.
``fused_step.launches``, ``fused_step_slab.launches`` and
``fused_step_2d.launches`` count the kernel launches (``.pair_launches``
of the last two those of two steps a pass). While a recording is on
(``utils.profiling``), each one-step 3D launch, here and in
``ops.fused_spmd``, also counts the body it runs (:func:`stream_body`):
``gcm.kernels.stream.owned`` or ``gcm.kernels.stream.ring``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gcm_tpu_torch.materials import (
    _DIAG_AXIS_OF_COMP, AxisView, MaterialFields, OrthotropicMaterialFields,
)
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.solver.correctors import (
    DamageCorrector, MaxwellCorrector, _diag_stress_indices,
    _shear_stress_indices,
)
from gcm_tpu_torch.solver.gcm import step
from gcm_tpu_torch.task import BorderSpec
from gcm_tpu_torch.utils import profiling

Borders = Dict[Tuple[int, int], BorderSpec]

_Z_EPS = 1e-30
_BC_CODES = {"absorbing": 0, "free": 1, "fixed_force": 2, "fixed_velocity": 3}
_MAXC, _MAXP, _MAXZ, _MAXSPEC = 9, 3, 2, 4


# --------------------------------------------------------------- material stack

def _model_waves(model: Model) -> List[str]:
    waves = []
    for st in model.stages:
        for p in st.pairs:
            if p.wave not in waves:
                waves.append(p.wave)
    return waves


def mat_layout(model: Model) -> List[str]:
    """Names of the compact stack's material fields, in stack order:
    ``c<w>`` per wave family, ``rho`` and (where the model has zero-speed
    invariants) ``kappa``. Impedances and their half-reciprocals are
    derived where they are used."""
    fields = [f"c{w}" for w in _model_waves(model)] + ["rho"]
    if any(st.zeros for st in model.stages):
        fields.append("kappa")
    return fields


def _stiff_label(model_dim: int, a: int, t: int) -> str:
    """Voigt label of the stiffness that drives the (a, t) pair's speed."""
    if a == t:
        return f"{a + 1}{a + 1}"
    if model_dim == 2:
        return "66"
    return {(1, 2): "44", (0, 2): "55", (0, 1): "66"}[(min(a, t), max(a, t))]


def _zero_axis(zc) -> int:
    """Spatial axis of a zero-invariant's diagonal stress component."""
    return _DIAG_AXIS_OF_COMP[zc.comp]


def ortho_mat_layout(model: Model) -> List[str]:
    """Field names of the orthotropic stack: per-stiffness speeds
    ``v<lbl> = sqrt(c_lbl/rho)``, ``rho``, and per-(sweep, zero) coupling
    ratios ``k<a><b> = c_ab/c_aa`` (13 fields for elastic3d, 6 for
    elastic2d). Impedances z<lbl> = rho*v<lbl> and their half-reciprocals
    are derived where they are used, as for the compact stack."""
    speeds: List[str] = []
    kaps: List[str] = []
    for st in model.stages:
        for p in st.pairs:
            name = f"v{_stiff_label(model.dim, st.axis, p.traction_axis)}"
            if name not in speeds:
                speeds.append(name)
        for zc in st.zeros:
            name = f"k{st.axis}{_zero_axis(zc)}"
            if name not in kaps:
                kaps.append(name)
    return speeds + ["rho"] + kaps


def infer_layout(model: Model, nm: int) -> str:
    """Which material layout a stack of height ``nm`` carries: "compact"
    or "ortho" (the two have distinct heights for every 2D and 3D model;
    the JAX package's "derived" isotropic layout is not ported)."""
    if nm == len(mat_layout(model)):
        return "compact"
    if nm == len(ortho_mat_layout(model)):
        return "ortho"
    raise ValueError(f"no ported material layout of {model.name} has {nm} "
                     "fields")


def layout_names(model: Model, mode: str) -> List[str]:
    """The stack's field names of layout ``mode`` ("compact" or "ortho")."""
    return ortho_mat_layout(model) if mode == "ortho" else mat_layout(model)


def stack_mats(model: Model, mat, compact: bool = True,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stack per-node material fields into one contiguous ``(nm,
    *spatial)`` tensor, rounded to ``dtype`` if given (``torch.bfloat16``
    halves the material stream; the kernels upcast at the load): the
    compact layout for ``MaterialFields``, the orthotropic one
    (:func:`stack_mats_ortho`) for ``OrthotropicMaterialFields``. Call once
    at setup, not per step."""
    if not compact:
        raise NotImplementedError("only the compact stack layout is ported")
    if isinstance(mat, OrthotropicMaterialFields):
        return stack_mats_ortho(model, mat, dtype)
    name_map = {"cp": mat.cp, "cs": mat.cs, "rho": mat.rho,
                "kappa": mat.kappa}
    out = torch.stack([name_map[f] for f in mat_layout(model)])
    return (out if dtype is None else out.to(dtype)).contiguous()


def stack_mats_ortho(model: Model, mat: OrthotropicMaterialFields,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stack ``OrthotropicMaterialFields`` into the :func:`ortho_mat_layout`
    order, computed in the fields' type and rounded to ``dtype`` if
    given."""
    rho = mat.rho
    stiff = {"11": mat.c11, "22": mat.c22, "33": mat.c33,
             "44": mat.c44, "55": mat.c55, "66": mat.c66}
    arrs = []
    for name in ortho_mat_layout(model):
        if name == "rho":
            arrs.append(rho)
        elif name.startswith("v"):
            arrs.append(torch.sqrt(stiff[name[1:]] / rho))
        else:  # k<a><b>
            a, b = int(name[1]), int(name[2])
            arrs.append(mat._offdiag(a, b) / mat._diag(a))
    out = torch.stack([torch.broadcast_to(x, rho.shape) for x in arrs])
    return (out if dtype is None else out.to(dtype)).contiguous()


def derive_window_mats(model: Model, mats: Dict[str, torch.Tensor],
                       mode: str = "compact") -> Dict[str, torch.Tensor]:
    """Expand compact (``c<w>``) or orthotropic (``v<lbl>``) material fields
    to the full set: impedances ``z = rho*c`` and half-reciprocals
    ``r = 0.5/z`` (0 where z == 0)."""
    out = dict(mats)
    rho = mats["rho"]
    keys = ([f"c{w}" for w in _model_waves(model)] if mode == "compact"
            else [k for k in mats if k.startswith("v")])
    for ckey in keys:
        z = rho * mats[ckey]
        out[f"z{ckey[1:]}"] = z
        out[f"r{ckey[1:]}"] = torch.where(
            z > 0, 0.5 / torch.clamp(z, min=_Z_EPS), torch.zeros_like(z))
    return out


class _OrthoStackViews:
    """The per-axis views of an orthotropic stack, for the plain step: per
    pair the speed ``v<lbl>`` and impedance ``z<lbl>`` of the stiffness
    that drives it, per zero-speed invariant the ratio ``k<a><b>``."""

    def __init__(self, model: Model, mats: Dict[str, torch.Tensor]):
        self.model, self.mats = model, mats

    def axis_view(self, axis: int, stage_spec) -> AxisView:
        lbls = [_stiff_label(self.model.dim, axis, p.traction_axis)
                for p in stage_spec.pairs]
        return AxisView(
            pair_c=[self.mats[f"v{lbl}"] for lbl in lbls],
            pair_z=[self.mats[f"z{lbl}"] for lbl in lbls],
            zero_kappa=[self.mats[f"k{axis}{_zero_axis(zc)}"]
                        for zc in stage_spec.zeros])


# --------------------------------------------------------------- correctors

def fold_corrector_specs(correctors, dt: float):
    """Static in-kernel descriptors of the ODE correctors, or ``(None, 0)``
    if any corrector cannot be folded (per-node Maxwell tau, unknown types).

    Returns ``(specs, naux)``: ``("maxwell", exp(-dt/tau))`` with the decay
    computed on the host in double, ``("damage", threshold, rate)``; each
    damage corrector consumes and produces one aux field, in corrector
    order."""
    specs = []
    naux = 0
    for c in correctors:
        if isinstance(c, MaxwellCorrector) and np.ndim(c.tau) == 0:
            specs.append(("maxwell", math.exp(-dt / float(c.tau))))
        elif isinstance(c, DamageCorrector):
            specs.append(("damage", float(c.threshold), float(c.rate)))
            naux += 1
        else:
            return None, 0
    return tuple(specs), naux


def corrector_epilogue_reference(model: Model, specs, u: torch.Tensor,
                                 aux: Optional[torch.Tensor], dt: float
                                 ) -> Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]:
    """Plain version of the kernels' epilogue: the folded correctors on a
    whole state, in spec order (``_corrector_epilogue`` of the JAX package,
    term for term). ``aux`` stacks one field per damage spec; returns the
    new state and the new aux stack (None when ``aux`` is None)."""
    if not specs:
        return u, (None if aux is None else aux.clone())
    diag = _diag_stress_indices(model)
    shear = _shear_stress_indices(model)
    comps = list(u.unbind(0))
    aux_out = []
    qi = 0
    for spec in specs:
        if spec[0] == "maxwell":
            decay = spec[1]
            if diag:
                mean = sum(comps[i] for i in diag) / len(diag)
                for i in diag:
                    comps[i] = mean + (comps[i] - mean) * decay
                for i in shear:
                    comps[i] = comps[i] * decay
        else:
            thr, rate = spec[1], spec[2]
            d = aux[qi]
            qi += 1
            smax = comps[diag[0]]
            for i in diag[1:]:
                smax = torch.maximum(smax, comps[i])
            over = torch.clamp(smax - thr, min=0.0) / thr
            d_new = torch.clamp(d + rate * over * dt, 0.0, 1.0)
            # incremental degradation, as solver.correctors.DamageCorrector
            factor = torch.clamp(
                (1.0 - d_new) / torch.clamp(1.0 - d, min=1e-12), max=1.0)
            for i in diag + shear:
                comps[i] = comps[i] * factor
            aux_out.append(d_new)
    new_aux = None if aux is None else (torch.stack(aux_out) if aux_out
                                        else aux.clone())
    return torch.stack(comps), new_aux


# -------------------------------------------------------------- plain version

def fused_step_reference(model: Model, u: torch.Tensor, mstack: torch.Tensor,
                         dt: float, h: Sequence[float], order: int,
                         borders: Optional[Borders] = None,
                         axes: Optional[Sequence[int]] = None,
                         correctors=None, aux: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the fused kernels (2D and 3D): the port's
    ``solver.gcm.step`` on c/z/kappa derived from the stack as the kernels
    derive them, then the folded correctors ``correctors`` (specs of
    ``fold_corrector_specs``). The layout follows the stack's height
    (:func:`infer_layout`): a compact stack gives isotropic fields (waves
    or zeros a model lacks read as zero fields it never uses), an
    orthotropic one per-axis views (c from ``v<lbl>``, z = rho*c, kappa
    from ``k<a><b>``). A stack of another type (bf16) is upcast to the
    state's first, so z = rho*c comes from the rounded fields, as in the
    kernels. Returns the new state, or ``(state, aux)`` when ``aux`` is
    given."""
    if mstack.dtype != u.dtype:
        mstack = mstack.to(u.dtype)
    mode = infer_layout(model, mstack.shape[0])
    mats = derive_window_mats(
        model, dict(zip(layout_names(model, mode), mstack.unbind(0))), mode)
    if mode == "ortho":
        mf = _OrthoStackViews(model, mats)
    else:
        zero = torch.zeros_like(mats["rho"])
        mf = MaterialFields(cp=mats["cp"], cs=mats.get("cs", zero),
                            zp=mats["zp"], zs=mats.get("zs", zero),
                            kappa=mats.get("kappa", zero), rho=mats["rho"])
    out = step(model, u, mf, dt, h, order, borders, axes)
    out, new_aux = corrector_epilogue_reference(model, correctors or (), out,
                                                aux, dt)
    return out if aux is None else (out, new_aux)


def norm_axes_seq(axes: Optional[Sequence[int]],
                  axes_seq: Optional[Sequence[Sequence[int]]],
                  dim: int) -> Tuple[Tuple[int, ...], ...]:
    """The (axes, axes_seq) pair as one validated sequence of sweep orders,
    one per step of a pass (``_norm_axes_seq`` of the JAX package). Each
    entry may be any order of the ``dim`` axes: the port runs the
    canonical splitting order as axes, not as a storage permutation."""
    if axes_seq is None:
        seq = (tuple(axes) if axes is not None else tuple(range(dim)),)
    else:
        if axes is not None:
            raise ValueError("pass either axes or axes_seq, not both")
        seq = tuple(tuple(a) for a in axes_seq)
    if not seq:
        raise ValueError("axes_seq holds no step")
    for ax in seq:
        if sorted(ax) != list(range(dim)):
            raise ValueError(f"axes {ax} is not an order of the {dim} axes")
    return seq


def fused_step_slab_reference(model: Model, u: torch.Tensor,
                              mstack: torch.Tensor, dt: float,
                              h: Sequence[float], order: int,
                              borders: Optional[Borders] = None,
                              axes: Optional[Sequence[int]] = None,
                              axes_seq=None, correctors=None,
                              aux: Optional[torch.Tensor] = None):
    """Plain version of the slab kernel (and of the 2D kernel's sequences):
    the stack upcast to the state's type (a bf16 stack keeps its rounding),
    ``fused_step_reference`` once per entry of ``axes_seq`` (or the one
    ``axes``), and the folded correctors after the last step, which only a
    single-step sequence takes. Returns the new state, or ``(state, aux)``
    when ``aux`` is given."""
    seq = norm_axes_seq(axes, axes_seq, model.dim)
    specs = tuple(correctors) if correctors else ()
    if specs and len(seq) > 1:
        raise ValueError("folded correctors require a single step per pass "
                         "(len(axes_seq) == 1)")
    ms = mstack.to(u.dtype)
    for ax in seq[:-1]:
        u = fused_step_reference(model, u, ms, dt, h, order, borders, ax)
    return fused_step_reference(model, u, ms, dt, h, order, borders, seq[-1],
                                specs, aux)


#: the 2D kernel's plain version: the same dimension-generic steps
fused_step_2d_reference = fused_step_slab_reference


# ------------------------------------------------------------------- kernels

def _i(n: int):
    return ctypes.c_int * n


class _Params(ctypes.Structure):
    """Mirror of ``GcmFusedParams`` in csrc/gcm_common.cuh."""

    _fields_ = [
        ("n", _i(3)), ("ncomp", ctypes.c_int), ("nm", ctypes.c_int),
        ("sign", ctypes.c_int), ("axes", _i(3)), ("rho_idx", ctypes.c_int),
        ("zero_kappa", _i(_MAXZ) * 3), ("npairs", _i(3)),
        ("pair_sigma", _i(_MAXP) * 3), ("pair_vel", _i(_MAXP) * 3),
        ("pair_c", _i(_MAXP) * 3), ("nzeros", _i(3)),
        ("zero_comp", _i(_MAXZ) * 3), ("zero_src", _i(_MAXZ) * 3),
        ("bc_kind", _i(2) * 3), ("bc_val", (ctypes.c_float * _MAXP * 2) * 3),
        ("dtoh", ctypes.c_float * 3),
        ("nspec", ctypes.c_int), ("spec_kind", _i(_MAXSPEC)),
        ("spec_a", ctypes.c_float * _MAXSPEC),
        ("spec_b", ctypes.c_float * _MAXSPEC), ("dt", ctypes.c_float),
        ("ndiag", ctypes.c_int), ("diag", _i(3)),
        ("nshear", ctypes.c_int), ("shear", _i(3)),
        ("axes_next", _i(3)), ("model", ctypes.c_int),
    ]


#: the component maps the streamed 3D and 2D bodies are compiled for
#: (csrc/gcm_common.cuh, STREAM_MODEL_* and SWEEP_MODEL_*2D), by model name
STREAM_MODELS = {"elastic3d": 0, "acoustic3d": 1, "elastic2d": 2,
                 "acoustic2d": 3}
_MAP_FIELDS = ("ncomp", "sign", "ndiag", "nshear")
_verified_maps = set()


def _model_map(p: _Params) -> tuple:
    """The component map a parameter block carries: the fields a compiled
    map fixes, cut to their counts."""
    per_axis = tuple(
        (p.npairs[a], tuple(p.pair_sigma[a][:p.npairs[a]]),
         tuple(p.pair_vel[a][:p.npairs[a]]), p.nzeros[a],
         tuple(p.zero_comp[a][:p.nzeros[a]]),
         tuple(p.zero_src[a][:p.nzeros[a]])) for a in range(3))
    return (tuple(getattr(p, f) for f in _MAP_FIELDS), per_axis,
            tuple(p.diag[:p.ndiag]), tuple(p.shear[:p.nshear]))


def check_compiled_map(lib, model: Model, kernel: str) -> None:
    """Raise unless the component map that the library is compiled for
    under ``model``'s id (``gcm_model_map``: one map a model, shared by the
    streamed 3D and 2D bodies, the per-sweep kernel and the simplex sweep)
    is the model's own: ``kernel`` keeps a cell's components in registers
    under that map and reads only its stack rows, material rows or fields
    from the parameters. Checked once a model and library; a model without
    a compiled map (1D) raises ``ValueError`` before the library is
    asked."""
    if model.name not in STREAM_MODELS:
        raise ValueError(f"{kernel} is compiled for {sorted(STREAM_MODELS)}, "
                         f"not {model.name}")
    key = (id(lib), model.name)
    if key in _verified_maps:
        return
    compiled = _Params()
    if lib.gcm_model_map(STREAM_MODELS[model.name],
                         ctypes.addressof(compiled)) != 0:
        raise RuntimeError(f"the kernel library has no component map for "
                           f"{model.name}")
    runtime = _params(model, (1,) * model.dim, len(mat_layout(model)), 1.0,
                      (1.0,) * model.dim, None, tuple(range(model.dim)), ())
    if _model_map(compiled) != _model_map(runtime):
        raise RuntimeError(f"{model.name}: the component map compiled into "
                           f"{kernel} differs from the model's")
    _verified_maps.add(key)


def _params(model: Model, shape, nm: int, dt: float, h: Sequence[float],
            borders: Optional[Borders], axes: Sequence[int],
            specs) -> _Params:
    """The kernels' parameters for a stack of height ``nm``, whose layout
    (compact or orthotropic) names the stack row of each pair's speed and
    of each zero's coupling ratio."""
    mode = infer_layout(model, nm)
    names, ortho = layout_names(model, mode), mode == "ortho"
    p = _Params()
    p.n[:] = list(shape) + [1] * (3 - len(shape))
    p.ncomp = model.ncomp
    p.nm = nm
    p.sign = model.sign
    p.axes[:] = list(axes) + [-1] * (3 - len(axes))
    p.axes_next[:] = [-1, -1, -1]
    p.model = STREAM_MODELS.get(model.name, -1)
    p.rho_idx = names.index("rho")
    for a in range(3):
        p.bc_kind[a][:] = [-1, -1]
        p.zero_kappa[a][:] = [-1] * _MAXZ
    for a in range(model.dim):
        st = model.stage(a)
        p.npairs[a] = len(st.pairs)
        p.nzeros[a] = len(st.zeros)
        for k, pair in enumerate(st.pairs):
            p.pair_sigma[a][k] = pair.sigma
            p.pair_vel[a][k] = pair.vel
            p.pair_c[a][k] = names.index(
                f"v{_stiff_label(model.dim, a, pair.traction_axis)}" if ortho
                else f"c{pair.wave}")
        for j, zc in enumerate(st.zeros):
            p.zero_comp[a][j] = zc.comp
            p.zero_src[a][j] = zc.src
            p.zero_kappa[a][j] = names.index(
                f"k{a}{_zero_axis(zc)}" if ortho else "kappa")
        for side in (0, 1):
            bc = (borders or {}).get((a, side))
            p.bc_kind[a][side] = -1 if bc is None else _BC_CODES[bc.kind]
            for k, pair in enumerate(st.pairs):
                p.bc_val[a][side][k] = (0.0 if bc is None else
                                        bc.pair_value(pair.traction_axis, st.axis))
        p.dtoh[a] = float(dt / h[a])
    p.nspec = len(specs)
    for s, spec in enumerate(specs):
        p.spec_kind[s] = 0 if spec[0] == "maxwell" else 1
        p.spec_a[s] = spec[1]
        p.spec_b[s] = spec[2] if spec[0] == "damage" else 0.0
    p.dt = float(dt)
    diag, shear = _diag_stress_indices(model), _shear_stress_indices(model)
    p.ndiag, p.nshear = len(diag), len(shear)
    p.diag[:len(diag)] = diag
    p.shear[:len(shear)] = shear
    return p


def stream_body(lib, params: _Params, order: int) -> str:
    """The body a one-step 3D launch with ``params`` at stencil ``order``
    runs, as the library compiles it (``gcm_stream_body``, which asks no
    device): "owned" (elastic3d at orders 1-2 on a compact stack: a thread
    owns its cells in every sweep, ``csrc/gcm_common.cuh::
    stream_step_owned``) or "ring" (``stream_step``: the other orders and
    models, and orthotropic stacks)."""
    return ("owned" if lib.gcm_stream_body(ctypes.addressof(params), order)
            else "ring")


def count_stream_body(lib, params: _Params, order: int) -> None:
    """Count one launch of the one-step 3D body under
    ``gcm.kernels.stream.<body>`` while a recording is on."""
    if profiling.enabled():
        body = stream_body(lib, params, order)
        profiling.count(f"gcm.kernels.stream.{body}", 1)


def _check(model: Model, dim: int, u: torch.Tensor, mstack: torch.Tensor,
           order: int, specs, aux: Optional[torch.Tensor]) -> None:
    """Raise on anything the kernels do not take (the sweep orders are
    checked by ``norm_axes_seq``)."""
    if u.shape[0] != model.ncomp or model.ncomp > _MAXC:
        raise ValueError(f"state has {u.shape[0]} components, "
                         f"{model.name} has {model.ncomp}")
    if any(len(st.pairs) > _MAXP or len(st.zeros) > _MAXZ
           for st in model.stages):
        raise ValueError(f"{model.name}: too many pairs or zeros per sweep")
    infer_layout(model, mstack.shape[0])
    if tuple(mstack.shape[1:]) != tuple(u.shape[1:]):
        raise ValueError(f"mstack shape {tuple(mstack.shape)} does not "
                         f"match the state's {tuple(u.shape[1:])}")
    tensors = [u, mstack] + ([aux] if aux is not None else [])
    if any(t.dtype != torch.float32 for t in tensors if t is not mstack) \
            or mstack.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("the fused kernels take float32 state and aux and a "
                        "float32 or bfloat16 stack")
    if any(t.device != u.device for t in tensors):
        raise ValueError("u, mstack and aux lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the fused kernels take contiguous tensors")
    if order not in (1, 2, 3, 4):
        raise ValueError(f"unsupported interpolation order {order}")
    if len(specs) > _MAXSPEC:
        raise ValueError(f"at most {_MAXSPEC} folded correctors")
    if any(s[0] == "damage" for s in specs) and not _diag_stress_indices(model):
        raise ValueError(f"{model.name} has no normal stresses to damage")


def _fused(dim: int, entry: str, model: Model, u: torch.Tensor,
           mstack: torch.Tensor, dt: float, h: Sequence[float], order: int,
           borders: Optional[Borders], axes: Optional[Sequence[int]],
           axes_seq, correctors, aux: Optional[torch.Tensor]):
    """Shared body of the fused wrappers: the plain version for a CPU
    tensor, else checks and one launch of ``entry`` (``gcm_fused_step_slab``
    or ``gcm_fused_step_2d``: a float or bf16 stack, one or two steps).
    Returns the new state and aux stack, and whether a kernel launched."""
    if model.dim != dim or u.ndim != dim + 1:
        raise ValueError(f"this fused step runs {dim}D models on "
                         f"[C, {dim} spatial axes] state")
    seq = norm_axes_seq(axes, axes_seq, dim)
    if len(seq) > 2:
        raise ValueError("the fused kernels run one or two steps a pass")
    specs = tuple(correctors) if correctors else ()
    if specs and len(seq) > 1:
        # split-step semantics apply the correctors after every step; the
        # epilogue runs once a pass
        raise ValueError("folded correctors require a single step per pass "
                         "(len(axes_seq) == 1)")
    ndamage = sum(s[0] == "damage" for s in specs)
    if ndamage and aux is None:
        raise ValueError("damage correctors need the aux array")
    if aux is not None and aux.shape[0] != ndamage:
        raise ValueError(f"aux holds {aux.shape[0]} fields for {ndamage} "
                         "damage correctors")
    if u.device.type == "cpu":
        res = fused_step_slab_reference(model, u, mstack, dt, h, order,
                                        borders, axes_seq=seq,
                                        correctors=specs, aux=aux)
        return (res if aux is not None else (res, None)), False
    if u.device.type != "cuda":
        raise ValueError(f"the fused kernels have no build for device "
                         f"{u.device}")
    _check(model, dim, u, mstack, order, specs, aux)
    bf16 = mstack.dtype == torch.bfloat16
    lib = _build.load()
    params = _params(model, u.shape[1:], mstack.shape[0], dt, h, borders,
                     seq[0], specs)
    if len(seq) == 2:
        params.axes_next[:] = list(seq[1]) + [-1] * (3 - dim)
    if ctypes.sizeof(params) != lib.gcm_params_size():
        raise RuntimeError("GcmFusedParams layout differs from its binding")
    check_compiled_map(lib, model, "the fused kernels")
    out = torch.empty_like(u)
    aux_out = torch.empty_like(aux) if aux is not None else None
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = getattr(lib, entry)(
        u.data_ptr(), mstack.data_ptr(),
        aux.data_ptr() if aux is not None else None, out.data_ptr(),
        aux_out.data_ptr() if aux_out is not None else None,
        ctypes.addressof(params), order, int(bf16), len(seq), u.device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error "
                           f"{err} ({lib.gcm_error_string(err).decode()})")
    if dim == 3 and len(seq) == 1:
        count_stream_body(lib, params, order)
    return (out, aux_out), True


def fused_step(model: Model, u: torch.Tensor, mstack: torch.Tensor,
               dt: float, h: Sequence[float], order: int,
               borders: Optional[Borders] = None,
               axes: Optional[Sequence[int]] = None,
               correctors=None, aux: Optional[torch.Tensor] = None,
               axes_seq=None):
    """One full 3D time step: sweeps along ``axes`` (default (0, 1, 2)),
    then the folded ``correctors`` (specs of ``fold_corrector_specs``) on
    each output cell; ``aux`` stacks one float32 field per damage spec.

    ``mstack`` is ``stack_mats(model, mat)``, built once at setup. A bf16
    stack, or an ``axes_seq`` of two steps, goes to :func:`fused_step_slab`
    (as the JAX package routes bf16 stacks to its slab kernel). A CUDA
    tensor goes through the slab kernel's float, one-step form
    (``csrc/fused_step_slab.cu``), counted here; a CPU tensor runs
    ``fused_step_reference``. Returns a new state tensor, or ``(state,
    aux)`` when ``aux`` is given."""
    if mstack.dtype == torch.bfloat16 or (axes_seq is not None
                                          and len(axes_seq) > 1):
        return fused_step_slab(model, u, mstack, dt, h, order, borders, axes,
                               axes_seq, correctors, aux)
    (out, new_aux), launched = _fused(3, "gcm_fused_step_slab", model, u,
                                      mstack, dt, h, order, borders, axes,
                                      axes_seq, correctors, aux)
    if launched:
        fused_step.launches += 1
    return out if aux is None else (out, new_aux)


def fused_step_slab(model: Model, u: torch.Tensor, mstack: torch.Tensor,
                    dt: float, h: Sequence[float], order: int,
                    borders: Optional[Borders] = None,
                    axes: Optional[Sequence[int]] = None, axes_seq=None,
                    correctors=None, aux: Optional[torch.Tensor] = None):
    """One pass of ``len(axes_seq)`` (1 or 2) full 3D steps, the sweeps of
    step k along ``axes_seq[k]`` (or one step along ``axes``), on a float32
    or bf16 ``mstack``; the folded ``correctors`` only with one step. Any
    extents. A CUDA tensor goes through the CUDA kernel
    (``csrc/fused_step_slab.cu``); a CPU tensor runs
    ``fused_step_slab_reference``. Returns the new state, or ``(state,
    aux)`` when ``aux`` is given. ``fused_step_slab.launches`` counts every
    launch, ``fused_step_slab.pair_launches`` those of two steps (the
    two-step body, a kernel of its own)."""
    (out, new_aux), launched = _fused(3, "gcm_fused_step_slab", model, u,
                                      mstack, dt, h, order, borders, axes,
                                      axes_seq, correctors, aux)
    if launched:
        fused_step_slab.launches += 1
        if axes_seq is not None and len(axes_seq) == 2:
            fused_step_slab.pair_launches += 1
    return out if aux is None else (out, new_aux)


def fused_step_2d(model: Model, u: torch.Tensor, mstack: torch.Tensor,
                  dt: float, h: Sequence[float], order: int,
                  borders: Optional[Borders] = None,
                  axes: Optional[Sequence[int]] = None,
                  correctors=None, aux: Optional[torch.Tensor] = None,
                  axes_seq=None):
    """One full 2D time step, the contract of ``fused_step`` on ``[C, nx,
    ny]`` state (any extents), or two steps a pass with ``axes_seq``, on a
    float32 or bf16 stack. A CUDA tensor goes through the CUDA kernel
    (``csrc/fused_step_2d.cu``: one step on the row-streamed body, compiled
    for elastic2d and acoustic2d, two on its two-step form); a CPU tensor
    runs ``fused_step_2d_reference``. ``fused_step_2d.launches`` counts
    every launch, ``fused_step_2d.pair_launches`` those of two steps."""
    (out, new_aux), launched = _fused(2, "gcm_fused_step_2d", model, u,
                                      mstack, dt, h, order, borders, axes,
                                      axes_seq, correctors, aux)
    if launched:
        fused_step_2d.launches += 1
        if axes_seq is not None and len(axes_seq) == 2:
            fused_step_2d.pair_launches += 1
    return out if aux is None else (out, new_aux)


def _occupancy(entry: str, dim: int, model: Model, u: torch.Tensor,
               mstack: torch.Tensor, dt: float, h: Sequence[float],
               order: int, borders: Optional[Borders], axes,
               axes_seq) -> Tuple[int, int]:
    """Shared body of the occupancy queries: ``entry`` is
    ``gcm_fused_step_slab_occupancy`` or ``gcm_fused_step_2d_occupancy``."""
    seq = norm_axes_seq(axes, axes_seq, dim)
    if len(seq) > 2:
        raise ValueError("the fused kernels run one or two steps a pass")
    _check(model, dim, u, mstack, order, (), None)
    lib = _build.load()
    params = _params(model, u.shape[1:], mstack.shape[0], dt, h, borders,
                     seq[0], ())
    if len(seq) == 2:
        params.axes_next[:] = list(seq[1]) + [-1] * (3 - dim)
    check_compiled_map(lib, model, "the fused kernels")
    out = (ctypes.c_int * 2)()
    err = getattr(lib, entry)(
        ctypes.addressof(params), order,
        int(mstack.dtype == torch.bfloat16), len(seq), u.device.index, out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err} "
                           f"({lib.gcm_error_string(err).decode()})")
    return out[0], out[1]


def fused_step_slab_occupancy(model: Model, u: torch.Tensor,
                              mstack: torch.Tensor, dt: float,
                              h: Sequence[float], order: int,
                              borders: Optional[Borders] = None,
                              axes: Optional[Sequence[int]] = None,
                              axes_seq=None) -> Tuple[int, int]:
    """``(blocks_per_sm, smem_bytes)`` that a launch of the 3D kernel on
    these arguments (``fused_step``, or ``fused_step_slab`` with one step
    or, given a two-step ``axes_seq``, two) gets on ``u``'s card: resident
    blocks an SM at its dynamic shared memory, and that shared memory in
    bytes."""
    return _occupancy("gcm_fused_step_slab_occupancy", 3, model, u, mstack,
                      dt, h, order, borders, axes, axes_seq)


def fused_step_2d_occupancy(model: Model, u: torch.Tensor,
                            mstack: torch.Tensor, dt: float,
                            h: Sequence[float], order: int,
                            borders: Optional[Borders] = None,
                            axes: Optional[Sequence[int]] = None,
                            axes_seq=None) -> Tuple[int, int]:
    """``fused_step_slab_occupancy`` of the 2D kernel: the row-streamed body
    for one step, its two-step form for a two-step ``axes_seq``."""
    return _occupancy("gcm_fused_step_2d_occupancy", 2, model, u, mstack,
                      dt, h, order, borders, axes, axes_seq)


fused_step.launches = 0
fused_step_slab.launches = 0
fused_step_slab.pair_launches = 0
fused_step_2d.launches = 0
fused_step_2d.pair_launches = 0
