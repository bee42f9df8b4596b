"""One process, several cards: the port's mesh over distinct CUDA devices
against the JAX package's multi-device mesh, on the CPU.

JAX's own multi-chip mode is one process with a mesh over every device it
sees (``gcm_tpu/parallel/sharding.py::domain_mesh``, the CLI's ``--mesh``).
The port's counterpart puts one card a shard: ``domain_mesh(3,
["cuda:0", .., "cuda:3"], (2, 2))``, or ``run --mesh 2,2 --device cuda``.
No card is needed to hold the mapping: the port's mesh over four distinct
device names is held to JAX's over four of the 8 virtual CPU devices of
tests/conftest.py (shape, axis names, shard-to-device order, where a node
lands), and the CLI's mesh with ``torch.cuda`` reporting four cards to
JAX's CLI mesh.

Every kernel entry point makes its shard's card current for the launch
and must give the caller back the device that was current before: the
entries are compiled here with g++ against a stand-in CUDA runtime (one
global current device; a launch records the device current at the time
and runs nothing) and called through ctypes.
"""

import concurrent.futures
import ctypes
import dataclasses
import itertools
import re
import subprocess

import jax
import numpy as np
import pytest
import torch

from gcm_tpu.parallel.sharding import domain_mesh as jdomain_mesh
from gcm_tpu.parallel.sharding import field_sharding
from gcm_tpu_torch import cli
from gcm_tpu_torch.materials import MaterialFields
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops import fused as ofu
from gcm_tpu_torch.ops import simplex as osx
from gcm_tpu_torch.ops.fused_spmd import split_3d
from gcm_tpu_torch.ops.sweep import _sweep_params
from gcm_tpu_torch.parallel.sharding import block_shape, domain_mesh, place
from gcm_tpu_torch.scenarios import get_scenario

CARDS = [f"cuda:{i}" for i in range(4)]


def _jax_meshes(dim, shape):
    return (jdomain_mesh(dim, devices=jax.devices("cpu")[:4], shape=shape),
            domain_mesh(dim, CARDS, shape))


def _jax_place(jmesh, dim, grid, node):
    """(device id, local node) of ``node`` under JAX's field sharding."""
    idx = field_sharding(jmesh, dim).devices_indices_map((1,) + grid)
    for dev, sl in idx.items():
        spans = [s.indices(n) for s, n in zip(sl[1:], grid)]
        if all(a <= x < b for (a, b, _), x in zip(spans, node)):
            return dev.id, tuple(x - a for (a, _, _), x in zip(spans, node))
    raise AssertionError(f"no device holds {node}")


@pytest.mark.parametrize("dim,shape,scenario", [
    (3, (2, 2), "elastic3d_explosion"), (3, (4, 1), "elastic3d_explosion"),
    (3, None, "elastic3d_explosion"), (2, None, "elastic2d_viscoelastic")])
def test_mesh_over_distinct_cards_is_jax_mesh(dim, shape, scenario):
    """Shape, axis names and shard k on card k as JAX's mesh puts shard k
    on device k; the source, the receivers and the block corners land on
    the same shard and local node as under JAX's field sharding (the
    explosion's source sits at x=y=128 of 256x256x128, a corner of shard
    3 on 2x2)."""
    jmesh, mesh = _jax_meshes(dim, shape)
    assert mesh.shape == tuple(jmesh.devices.shape)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert [d.index for d in mesh.devices] == [
        d.id for d in jmesh.devices.flat]
    assert mesh.devices == tuple(torch.device(c) for c in CARDS)
    assert mesh.local == (0, 1, 2, 3) and not mesh.spans_processes
    task = get_scenario(scenario, n=256 if dim == 3 else 2048)
    grid = task.grid.shape
    block = block_shape(mesh, grid)
    nodes = [task.grid.index_of(s.position) for s in task.sources]
    nodes += [task.grid.index_of(p) for p in task.detectors.points]
    for corner in np.ndindex(*(2,) * dim):
        for k in range(4):
            i, j = mesh.coords(k)
            lo = (i * block[0], j * block[1] if dim == 3 else 0)
            nodes.append(tuple(lo[a] + c * (block[a] - 1) if a < 2 else
                               c * (grid[a] - 1)
                               for a, c in enumerate(corner)))
    if shape == (2, 2):
        assert nodes[0][:2] == (128, 128)
        assert place(mesh, block, nodes[0]) == (3, (0, 0) + nodes[0][2:])
    for node in nodes:
        k, local = place(mesh, block, node)
        assert (mesh.devices[k].index, local) == _jax_place(
            jmesh, dim, grid, node), node


@pytest.fixture
def four_cards(monkeypatch):
    """torch.cuda reporting ``count`` cards."""
    def set_count(count):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    set_count(4)
    return set_count


@pytest.mark.parametrize("spec,dim", [("2,2", 3), ("4,1", 3), ("4", 3),
                                      ("2", 3), ("4", 2)])
def test_cli_mesh_puts_one_card_a_shard_as_jax(four_cards, spec, dim):
    """``--mesh`` with ``--device cuda`` on four cards: cuda:0..n-1 in
    JAX's order and shape (the JAX CLI's ``domain_mesh(dim,
    jax.devices()[:n], shape if two counts else None)``), a single count
    factored near-square on a 3D grid."""
    shape = tuple(int(v) for v in spec.split(","))
    n = int(np.prod(shape))
    jmesh = jdomain_mesh(dim, devices=jax.devices("cpu")[:n],
                         shape=shape if len(shape) > 1 else None)
    mesh = cli._mesh(spec, dim, "cuda")
    assert mesh.shape == tuple(jmesh.devices.shape)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.devices == tuple(torch.device("cuda", d.id)
                                 for d in jmesh.devices.flat)
    cpu = cli._mesh(spec, dim, "cpu")
    assert cpu.shape == mesh.shape and set(cpu.devices) == {
        torch.device("cpu")}


def test_cli_mesh_refuses_fewer_cards_than_shards(four_cards):
    """Three cards take no 2x2 mesh, and no card takes none: the CLI
    refuses, it does not put two shards on one card."""
    four_cards(3)
    with pytest.raises(SystemExit, match="needs 4 CUDA devices, torch sees 3"):
        cli._mesh("2,2", 3, "cuda")
    assert cli._mesh("3", 2, "cuda").devices == tuple(
        torch.device("cuda", i) for i in range(3))
    four_cards(0)
    with pytest.raises(SystemExit, match="needs 2 CUDA devices, torch sees 0"):
        cli._mesh("2", 2, "cuda")


# --------------------------------------- the entries' device scope (g++)

#: the stand-in CUDA runtime: one current device of ``stub_ndev``; a
#: launch records the device current when it is made and runs nothing
STUB_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorInvalidDevice = 101 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3s { unsigned x, y, z; };
inline thread_local uint3s threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
    return {a, b, c, d};
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcs(const T* p) { return *p; }
inline void __syncthreads() {}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
using std::min;
using std::max;
extern "C" {
extern int stub_device, stub_ndev, stub_sets, stub_launches,
    stub_launch_device;
}
inline cudaError_t cudaGetDevice(int* d) {
    *d = stub_device;
    return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int d) {
    ++stub_sets;
    if (d < 0 || d >= stub_ndev) return cudaErrorInvalidDevice;
    stub_device = d;
    return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "stub"; }
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
    return cudaSuccess;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
    *n = 2;
    return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* n, cudaDeviceAttr, int) {
    *n = 4;
    return cudaSuccess;
}
template <class... A> inline void gcm_stub_launch(A&&...) {
    ++stub_launches;
    stub_launch_device = stub_device;
}
"""

STUB_BF16 = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) {
    uint32_t v = (uint32_t)b.x << 16;
    float f;
    std::memcpy(&f, &v, 4);
    return f;
}
"""

STUB_STATE = r"""
extern "C" {
int stub_device = 0, stub_ndev = 4, stub_sets = 0, stub_launches = 0,
    stub_launch_device = -1;
}
"""

#: ``kernel<<<grid, block, smem, stream>>>(args)``
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^;<>]*>)?)\s*<<<(.*?)>>>\s*\(",
                     re.S)


def _host_source(text: str) -> str:
    """A kernel source as host C++: launches become stub calls (the kernel
    is still instantiated), dynamic shared memory a static array."""
    text = _LAUNCH.sub(lambda m: f"gcm_stub_launch({m.group(1)}, "
                       f"{m.group(2)}, ", text)
    text = re.sub(r"extern\s+__shared__", "static", text)
    return re.sub(r"(static[^;\n]*\bsmem)\[\]", r"\1[1]", text)


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    """Every kernel source built with g++ against the stand-in runtime into
    one library, bound as the real one (``_build.bind``)."""
    root = tmp_path_factory.mktemp("stub_kernels")
    (root / "cuda_runtime.h").write_text(STUB_RUNTIME)
    (root / "cuda_bf16.h").write_text(STUB_BF16)
    (root / "stub_state.cpp").write_text(STUB_STATE)
    srcs = []
    for src in sorted(_build.CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            (root / src.name).write_text(_host_source(src.read_text()))
            if src.suffix == ".cu":
                srcs.append(root / src.name)

    def compile_one(src):
        obj = src.with_suffix(".o")
        subprocess.run(["g++", "-std=c++20", "-O0", "-fPIC", "-w", "-x",
                        "c++", f"-I{root}", "-c", str(src), "-o", str(obj)],
                       check=True, capture_output=True)
        return str(obj)

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        objs = list(pool.map(compile_one, srcs + [root / "stub_state.cpp"]))
    lib = root / "libstub.so"
    subprocess.run(["g++", "-shared", "-o", str(lib), *objs], check=True,
                   capture_output=True)
    return _build.bind(ctypes.CDLL(str(lib)))


def _state(lib, name):
    return ctypes.c_int.in_dll(lib, name)


def _fused_params(name, shape, axes=None):
    model = get_model(name)
    dim = model.dim
    return ofu._params(model, shape, len(ofu.mat_layout(model)), 1e-3,
                       (1.0,) * dim, None, axes or tuple(range(dim)), ())


def _entries():
    """(entry, launches, call(lib, device) -> error code): every entry
    point that takes a device, called with arguments it launches with
    (``launches``: 1) or only sizes (0). The stand-in launch runs nothing,
    so the pointers are never read."""
    keep = []

    def held(x):
        keep.append(x)
        return x

    def ptr(x):
        return ctypes.addressof(held(x))

    out = ctypes.c_int * 2
    u = torch.zeros((9, 16, 16, 32))
    mat = MaterialFields(*(torch.ones((16, 16, 32)) for _ in
                           dataclasses.fields(MaterialFields)))
    sweep, _ = _sweep_params(get_model("elastic3d"), u, mat, 1e-3,
                             (1.0,) * 3, 0, None)
    sx = osx._SimplexParams(N=64, K=4, model=0, axis=0)
    p3 = _fused_params("elastic3d", (16, 16, 32))
    p3b = _fused_params("elastic3d", (16, 16, 32))
    p3b.axes_next[:] = [2, 1, 0]
    p2 = _fused_params("elastic2d", (32, 32))
    p2b = _fused_params("elastic2d", (32, 32))
    p2b.axes_next[:] = [1, 0, 2]
    ps = _fused_params("elastic3d", (32, 32, 32))
    split = (ctypes.c_int * 6)(*split_3d(32, 32, 1))
    slabs = [1] * 4
    return [
        ("gcm_fused_step_slab", 1, lambda lib, d: lib.gcm_fused_step_slab(
            1, 1, None, 1, None, ptr(p3), 2, 0, 1, d, None)),
        ("gcm_fused_step_slab (two steps)", 1,
         lambda lib, d: lib.gcm_fused_step_slab(
             1, 1, None, 1, None, ptr(p3b), 2, 0, 2, d, None)),
        ("gcm_fused_step_slab_occupancy", 0,
         lambda lib, d: lib.gcm_fused_step_slab_occupancy(
             ptr(p3), 2, 0, 1, d, ptr(out()))),
        ("gcm_fused_step_2d", 1, lambda lib, d: lib.gcm_fused_step_2d(
            1, 1, None, 1, None, ptr(p2), 2, 0, 1, d, None)),
        ("gcm_fused_step_2d (two steps)", 1,
         lambda lib, d: lib.gcm_fused_step_2d(
             1, 1, None, 1, None, ptr(p2b), 2, 0, 2, d, None)),
        ("gcm_fused_step_2d_occupancy", 0,
         lambda lib, d: lib.gcm_fused_step_2d_occupancy(
             ptr(p2), 2, 0, 1, d, ptr(out()))),
        ("gcm_fused_spmd (interior)", 1, lambda lib, d: lib.gcm_fused_spmd(
            1, 1, None, 1, None, None, None, None, None, ptr(split), 0,
            ptr(ps), 2, d, None)),
        ("gcm_fused_spmd (ring)", 1, lambda lib, d: lib.gcm_fused_spmd(
            1, 1, None, 1, None, *slabs, ptr(split), 1, ptr(ps), 2, d,
            None)),
        ("gcm_fused_spmd_occupancy", 0,
         lambda lib, d: lib.gcm_fused_spmd_occupancy(
             ptr(ps), 2, 1, d, ptr(out()))),
        ("gcm_fused_spmd_2d (ring)", 1, lambda lib, d: lib.gcm_fused_spmd_2d(
            1, 1, 1, 1, 1, 1, 31, 1, ptr(p2), 2, 0, d, None)),
        ("gcm_fused_spmd_2d_occupancy", 0,
         lambda lib, d: lib.gcm_fused_spmd_2d_occupancy(
             ptr(p2), 2, 0, d, ptr(out()))),
        ("gcm_sweep_stage", 1, lambda lib, d: lib.gcm_sweep_stage(
            1, 1, ptr(sweep), 2, d, None)),
        ("gcm_simplex_sweep", 1, lambda lib, d: lib.gcm_simplex_sweep(
            1, 1, ptr(sx), d, None)),
        ("gcm_simplex_occupancy", 0,
         lambda lib, d: lib.gcm_simplex_occupancy(ptr(sx), d, ptr(out()))),
    ], keep


ENTRY_NAMES = [name for name, _, _ in _entries()[0]]


@pytest.mark.parametrize("name,order,layout,body", [
    ("elastic3d", 1, "compact", 1), ("elastic3d", 2, "compact", 1),
    ("elastic3d", 3, "compact", 0), ("elastic3d", 4, "compact", 0),
    ("elastic3d", 1, "ortho", 0), ("elastic3d", 2, "ortho", 0),
    ("acoustic3d", 1, "compact", 0), ("acoustic3d", 2, "compact", 0)])
def test_stream_body_follows_the_form(stub_lib, name, order, layout, body):
    """``gcm_stream_body`` names the one-step 3D body a form compiles to,
    asking no device: the owned body (1) for elastic3d at orders 1-2 on a
    compact stack, float or bf16 alike (the stored type is not a
    parameter), the ring body (0) for orders 3-4, orthotropic stacks and
    acoustic3d, in every sweep order."""
    model = get_model(name)
    nm = len(ofu.layout_names(model, layout))
    for axes in itertools.permutations(range(3)):
        p = ofu._params(model, (16, 16, 32), nm, 1e-3, (1.0,) * 3, None,
                        axes, ())
        assert stub_lib.gcm_stream_body(ctypes.addressof(p), order) == body
        assert ofu.stream_body(stub_lib, p, order) == ("owned" if body
                                                       else "ring")


@pytest.mark.parametrize("entry", ENTRY_NAMES)
def test_entry_leaves_the_current_device_as_it_found_it(stub_lib, entry):
    """With cuda:1 current, an entry asked for cuda:3 launches on cuda:3
    and returns with cuda:1 current again; asked for a card that is not
    there it fails and leaves cuda:1 current; asked for the current card it
    sets no device at all."""
    entries, keep = _entries()
    _, launches, call = next(e for e in entries if e[0] == entry)
    dev, sets = _state(stub_lib, "stub_device"), _state(stub_lib, "stub_sets")
    n, where = (_state(stub_lib, "stub_launches"),
                _state(stub_lib, "stub_launch_device"))
    dev.value, n.value, where.value = 1, 0, -1
    assert call(stub_lib, 3) == 0
    assert (n.value, where.value) == ((1, 3) if launches else (0, -1))
    assert dev.value == 1
    assert call(stub_lib, 9) != 0
    assert dev.value == 1 and n.value == launches
    s0 = sets.value
    assert call(stub_lib, 1) == 0
    assert sets.value == s0 and dev.value == 1
    assert (n.value, where.value) == ((2, 1) if launches else (0, -1))
    del keep
