"""Build the CUDA sources of ``gcm_tpu_torch/csrc`` and bind them with ctypes.

``nvcc`` compiles the sources into a shared library with a plain C interface
under ``build/kernels/`` at the root of the checkout, at first use and never
at import: one ``nvcc -c`` per ``.cu`` file, all started together, then one
link. The file name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one loads the library already built. A
failed build raises with the compiler's output. Processes started together
on a fresh checkout (the ranks of a run) build once: the build holds an
``fcntl`` lock on ``build/kernels/.lock``, and a process that waited for it
loads the library the first one built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Tuple

from gcm_tpu_torch.utils.profiling import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# --split-compile runs the device optimizer of a source over 4 threads:
# the one-step 3D body has 96 instantiations in each of two sources, the
# two-step 3D body 72 in each of four (one a stencil order), the 2D bodies
# 16 + 32 in one
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "--split-compile=4")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels of gcm_tpu_torch "
                       "are built on a machine with the CUDA toolkit")


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgcm_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the sources unless the library of this hash exists. Returns
    the library's path and what the compiler printed ("" when nothing was
    built); ptxas reports each kernel's registers, shared memory and
    spills, and a line ``nvcc <source>: <s> s`` a source gives the seconds
    from the start of the build to the end of its compile."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if out.exists():
            return out, ""
        return out, _compile(out)


def _compile(out: Path) -> str:
    """Compile and link the library into ``out``; what the compiler
    printed."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # each compiler writes to a file of its own: through a pipe, read
        # one source after another, a source's ptxas report could fill the
        # pipe and stall that compiler until the ones before it finished
        t0 = time.perf_counter()
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            with open(obj + ".log", "w") as f:
                proc = subprocess.Popen(
                    [nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(src)],
                    stdout=f, stderr=subprocess.STDOUT)
            jobs.append((src.name, obj, proc))
        seconds = {}
        while len(seconds) < len(jobs):
            for name, _, proc in jobs:
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            time.sleep(0.05)
        log = ""
        for name, obj, _ in jobs:
            with open(obj + ".log") as f:
                log += f.read()
        log += "".join(f"nvcc {name}: {seconds[name]:.1f} s\n"
                       for name, _, _ in jobs)
        objs = [obj for _, obj, _ in jobs]
        failed = [p.returncode for _, _, p in jobs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(lib, out)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every function typed; the
    tracer counts ``gcm.kernels.built`` when this process compiled it."""
    global _lib
    if _lib is not None:
        return _lib
    with span("gcm.kernels.load"):
        path, log = build()
        if log:
            count("gcm.kernels.built", 1)
        _lib = bind(ctypes.CDLL(str(path)))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of every entry point."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("gcm_fused_step_2d", "gcm_fused_step_slab"):
        fn = getattr(lib, name)
        # u, mstack, aux_in, out, aux_out, params, order, mat_bf16, ksteps,
        # device, stream
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
        fn.restype = i32
    # u, mext, aux_in, out, aux_out, xlo, xhi, ylo, yhi, split, ring,
    # params, order, device, stream
    lib.gcm_fused_spmd.argtypes = [vp] * 10 + [i32, vp, i32, i32, vp]
    lib.gcm_fused_spmd.restype = i32
    # u, mext, out, xlo, xhi, ix0, ix1, ring, params, order, mat_bf16,
    # device, stream
    lib.gcm_fused_spmd_2d.argtypes = [vp] * 5 + [i32] * 3 + [vp, i32, i32,
                                                              i32, vp]
    lib.gcm_fused_spmd_2d.restype = i32
    lib.gcm_fused_spmd_tile.argtypes = [i32]
    lib.gcm_fused_spmd_tile.restype = i32
    # params, order, mat_bf16, ksteps, device, out[2]
    for name in ("gcm_fused_step_slab_occupancy",
                 "gcm_fused_step_2d_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i32, i32, i32, i32, vp]
        fn.restype = i32
    # params, order: the one-step 3D body (1 owned, 0 ring)
    lib.gcm_stream_body.argtypes = [vp, i32]
    lib.gcm_stream_body.restype = i32
    # params, order, ring, device, out[2]
    for name in ("gcm_fused_spmd_occupancy", "gcm_fused_spmd_2d_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i32, i32, i32, vp]
        fn.restype = i32
    # params, device, out[2]
    lib.gcm_simplex_occupancy.argtypes = [vp, i32, vp]
    lib.gcm_simplex_occupancy.restype = i32
    # model id, params out
    lib.gcm_model_map.argtypes = [i32, vp]
    lib.gcm_model_map.restype = i32
    lib.gcm_fused_spmd_2d_tile.argtypes = []
    lib.gcm_fused_spmd_2d_tile.restype = i32
    # u, out, params, order, device, stream
    lib.gcm_sweep_stage.argtypes = [vp, vp, vp, i32, i32, vp]
    lib.gcm_sweep_stage.restype = i32
    # u, out, params, device, stream
    lib.gcm_simplex_sweep.argtypes = [vp, vp, vp, i32, vp]
    lib.gcm_simplex_sweep.restype = i32
    lib.gcm_error_string.argtypes = [i32]
    lib.gcm_error_string.restype = ctypes.c_char_p
    for name in ("gcm_params_size", "gcm_sweep_params_size",
                 "gcm_simplex_params_size"):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = i32
    return lib
