"""gcm_tpu_torch: the grid-characteristic method on PyTorch and CUDA.

The PyTorch port of ``gcm_tpu``. It mirrors the JAX package's layout (each
module here has its counterpart of the same path there) and imports torch
and numpy only (and scipy for simplex meshes). The hot paths are CUDA C++
kernels for Hopper (``csrc/``: the fused 3D and 2D steps, their interior
and ring forms on the shards of a mesh, the per-sweep kernel and the
simplex sweep) built at first use; every kernel has a plain PyTorch version
beside it that CPU tensors run. The entry points run on the card unless
asked for the CPU (``device="cpu"``).

Importing this package builds nothing and starts nothing.
"""
