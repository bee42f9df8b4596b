#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gcm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from the sources in this checkout
   (one nvcc per source, in parallel);
3. kernel vs plain, on the card, in float32, on random heterogeneous
   problems with all four border kinds; per-component normalized max error
   under 2e-6, the damage aux stream to rtol 1e-5, atol 1e-6:
   - ``fused_step`` against ``fused_step_reference`` (orders 1-3, the
     sweep orders (0,1,2), (2,1,0), (2,0,1) and (1,0,2), elastic3d, one
     acoustic3d case, two ragged shapes and a tile-multiple one);
   - ``fused_step_2d`` against ``fused_step_2d_reference`` (orders 1-4, both
     axes orders, elastic2d and acoustic2d, float32 and bf16 stacks; a
     ragged shape whose rows are not a multiple of 4 cells (4-byte copies),
     aligned ones, one a multiple of the row-streamed body's strip, and
     shapes thinner than the 2r halo along x with fewer columns than a
     strip);
   - both fused kernels with Maxwell and damage correctors folded into
     their epilogue, 3 steps each from the plain step's state (the damage
     must become non-zero; the 2D kernel at orders 2 and 4, on a ragged and
     an aligned shape);
   - ``sweep_stage`` against ``solver.gcm.stage`` on each axis of 3D and
     2D problems, orders 1-4, and per axis on the 3D and 2D paths' states;
4. the 3D main path: ``Engine(elastic3d_explosion, n=256, nsteps=300)``
   (256x256x128) resolves to the fused kernel, launches it once per step,
   gives finite fields, motion at the free surface and non-zero traces, and
   agrees with the plain torch path (normalized error under 1e-4);
5. the 2D path: ``Engine(elastic2d_viscoelastic, n=2048, nsteps=1600)``
   (2048x2048) resolves to ``fused_step_2d``, once per step, with the
   Maxwell corrector run after the source (not folded); finite, non-zero
   traces; after 300 steps it agrees with the torch path (under 1e-4);
6. the folded corrector path: source-free ``elastic3d_layered`` at n=256
   with Maxwell and damage correctors for 100 steps folds them into the
   fused kernel; the damage is non-zero; state and damage agree with the
   torch path with unfolded correctors (under 1e-4);
7. the per-sweep path: ``kernel="sweep"`` on ``elastic3d_explosion`` n=256
   for 100 steps launches ``sweep_stage`` once per axis and step and agrees
   with the fused path (under 1e-4);
8. the simplex path: ``simplex_sweep`` against ``simplex_sweep_reference``
   on random heterogeneous jittered meshes (3D elastic orders 1 and 2, a
   fluid, 2D elastic orders 1 and 2, a 9^3 mesh whose 729 nodes are no
   multiple of a block; the four uniform border kinds and per-node borders;
   every axis in both axis orders; under 2e-6 per sweep), then
   ``SimplexEngine.from_task(simplex3d_layered(n=65))`` (274,625 nodes)
   until the P wave has reached the surface receivers: it resolves to
   ``"simplex"``, launches the kernel 3 times a step, gives finite fields
   and non-zero receiver traces, and after 100 steps agrees with
   ``kernel="torch"`` (under 1e-4). The host setup (Delaunay, foot tables)
   is timed and printed on its own; the mesh, like phase 17's, is built in
   a process of its own from before the build (``HostSetup``).
9. the SPMD kernels (checked with phase 3, before the paths): the 3D
   interior and ring kernels against their plain versions on every shard
   of 2x2 and 4x1 meshes whose shards all lie on cuda:0 (orders 1-3, both
   axes orders, tile-multiple, ragged and ring-only shards, all four border
   kinds), each sharded step against the unsharded plain step, Maxwell and
   damage folded (3 steps, each from the plain state); both kernels in the
   sweep orders with x in the middle on ragged shards, the interior launch
   writing exactly its cells of a NaN buffer and the ring launch all the
   others; the 2D kernel likewise in both modes on sx = 2 and 4 (orders
   1-4, both axes orders, elastic2d and acoustic2d, shards with an
   interior and shards so thin (nxl <= 2r) that the interior launch is
   empty), the interior launch writing exactly its rows of a NaN buffer and
   the ring launch all the others; all under 2e-6;
10. the sharded 3D path: ``Engine(elastic3d_explosion, n=256,
   mesh=domain_mesh(3, [cuda:0] * 4, (2, 2)))`` for 100 steps launches
   ``fused_spmd_interior`` and ``fused_spmd_ring`` 4 times a step each and
   ``fused_step`` never, and agrees with the unsharded fused path (under
   2e-6, max difference printed); one step with ``force_spmd`` on a 1x1
   mesh against ``fused_step``; both kernels on shard 0 timed beside their
   plain versions; the device idle share under ``torch.profiler``;
11. the sharded folded-corrector path (``elastic3d_layered`` n=256, Maxwell
   + damage, 2x2, 50 steps) against the unsharded folded path, the sharded
   2D path (``elastic2d_viscoelastic`` n=2048 on sx=4, 300 steps, both
   modes of ``fused_spmd_2d`` once per shard and step) and the sharded
   per-sweep path (``kernel="sweep"``, n=256, 2x2, 50 steps) against their
   unsharded paths (under 1e-4);
12. the slab kernel (checked with phase 3): ``fused_step_slab`` against
   ``fused_step_slab_reference`` on random heterogeneous problems (orders
   1-4, one step in the sweep orders (0,1,2), (2,1,0) and the canonical
   (2,0,1), (1,0,2), two steps a pass in every pair of sweep orders,
   float32 and bf16 stacks, elastic3d and acoustic3d, all four border
   kinds, ragged and thinner-than-halo extents; under 2e-6 a step),
   Maxwell + damage folded at one step a pass; ``fused_step_2d`` with bf16
   stacks and two steps a pass (every pair of the two sweep orders, orders
   1-4, both models, float32 and bf16, shapes thinner than the two steps'
   2r halo, aligned and wider than one strip), ``fused_spmd_2d`` with bf16
   stacks;
13. the contact path: ``MultiBodyEngine(*elastic3d_contact(n=256,
   nsteps=200), canonical_layout=True)`` (two bodies of 256x256x128)
   resolves to ``fused_canonical``, launches ``fused_step_slab`` twice a
   step and ``fused_step`` never, moves the upper body and agrees with the
   plain multi-body path in the same order (under 1e-4; the bond mask cells
   that differ are printed); the same with bf16 stacks (100 steps, against
   the float32 run: a rounding-level deviation), the non-canonical fused
   path (100 steps, ``fused_step`` per body) and the non-conforming 2D
   ``elastic2d_basin_refined`` n=1025 (the per-sweep path, ``sweep_stage``)
   against their plain paths; each slab variant timed at 256x256x128;
14. the pair-fused body: ``elastic3d_layered`` n=256 without receivers and
   with ``temporal_block=True`` launches the two-step pass once a pair (100
   steps, 50 launches) and agrees with the per-step fused path (under
   1e-4); one pass on the path's state is held against its plain version
   (under 2e-6 a step against the float64 plain pass) and timed beside two
   one-step launches, and the path's device idle share is traced; the
   same in 2D (``elastic2d_ps`` n=2048 without receivers, 100 steps, 50
   two-step ``fused_step_2d`` launches), its pass timed on float32 and
   bf16 stacks (and, in phase 15, on the orthotropic 2D state);
15. orthotropic media (every layer of a scenario made orthotropic by
   :func:`_orthotropic`, positive definite): each kernel of the structured
   paths on random heterogeneous orthotropic stacks (13 rows in 3D, 6 in
   2D) or views against its plain version (under 2e-6 a step), and one
   float32 step of each fused kernel against the float64 plain step on the
   fields (under 3e-6); then ``elastic3d_explosion`` n=256 on the fused
   path (300 steps, ``fused_step`` only, against ``kernel="torch"``, and the
   anisotropy of its wavefront after ``NSTEPS_ANISO`` steps), the per-sweep
   path (50 steps against the fused one), ``elastic2d_viscoelastic``
   n=2048 (300 steps against ``kernel="torch"``, and 50 on sx=4 shards
   against the unsharded path), the 2x2 sharded path (50 steps, against
   the unsharded fused path under 2e-6), the bf16 stack (50 steps, through
   ``fused_step_slab``, against float32 under ``BF16_PATH_TOL``) and
   ``elastic3d_contact`` n=256 asked for the canonical layout (200 steps,
   which stays on ``"fused"`` for orthotropic bodies, against the plain
   multi-body path); each kernel's orthotropic form timed on its path's
   state;
16. outputs and resume, in a temporary directory deleted after:
   ``elastic3d_explosion`` n=256 x 120 steps through ``run_with_outputs``
   (``.vti`` of vz, szz and the velocity every 60 steps, checkpoints every
   40) launches ``fused_step`` once a step, copies the state to the host at
   steps 40, 60, 80 and 120 only, and equals ``run()``; fresh engines
   resumed from the checkpoint at 80 and from an odd cut at 41 equal the
   uninterrupted run (state and traces); the pair-fused body cut at an odd
   step resumes with one single step and equals its continuation without
   the checkpoint and the uninterrupted run (which takes the two steps
   around the cut in one pass); the canonical contact path (2 x
   256x256x128, 100 steps, checkpoints every 50, cut at 51) and a partly
   broken n=32 interface (cut at 17) resume equal, no restored broken cell
   healing; the 65^3 simplex path of phase 8 (its tables reused) writes
   ``.vtu`` snapshots and resumes equal; a profiled ``cli.main(["run",
   ...])`` at n=256 launches ``fused_step`` 20 times (the counters) and
   writes a trace holding the fused kernel's events (their count, and the
   trace's launches in order with those that have no kernel event, are
   printed). The copy, write, save and restore times are printed;
17. the simplex contact path: ``SimplexMultiEngine`` at bench.py's simplex
   contact configuration (two jittered 25x49x49 tet boxes, 120,050 nodes,
   bonded across x with a 5e5 Pa strength, random stresses) for 200 steps
   launches ``simplex_sweep`` 6 times a step (its points/s, untraced idle
   share, host setup and intact bond share printed) and after 100 steps
   agrees with the plain path (under 1e-4; the bond cells that differ
   printed); the kernel on the path's state against its plain version and
   timed, and the host time of one contact fixup; a resume at step 31 of
   60 through a checkpoint file equals the uninterrupted run; a tensile
   pulse through two 17x33x33 lattices breaks bonds on both paths with
   equal masks, a compressive one none; a non-conforming pair (h against
   h/2) agrees with its plain path (under 1e-4) with bonds partly broken;
   the orthotropic ``simplex3d_layered`` at n=33 resolves to ``"torch"``
   (no kernel launch), stays finite and spreads farther along the stiffer
   x axis, and its isotropic limit agrees with the isotropic kernel path
   after 50 steps (under 1e-4).
18. the contact path on a mesh, every shard on cuda:0: the contact bodies
   of phase 13 with ``canonical_layout=True`` on 2x2 shards for 200 steps
   resolve to ``"fused_spmd"`` in (0, 1, 2) / (2, 1, 0) (a 2-axis mesh, as
   in JAX), launch ``fused_spmd_interior`` and ``fused_spmd_ring`` 8 times
   a step each (2 bodies x 4 shards) and no unsharded kernel, and agree
   with the unsharded path in the same order after 100 steps (under 2e-6,
   bond masks equal; the error after 200 printed); its points/s, untraced
   idle share, the host ms of the put-together contact fixup inside its
   step loop (and of one fixup called alone, with its device ms), and
   both SPMD kernels on its own shard beside their plain versions and
   bounds; both SPMD kernels against their plain versions in the canonical
   orders (2, 0, 1) and (1, 0, 2) on 2x2, 4x1 and one-axis sx = 4 shards
   (``SPMD_CANON_CASES``, under 2e-6 a step), then the canonical order on
   the sx = 4 mesh (``"fused_canonical_spmd"``, 100 steps) against the
   unsharded ``"fused_canonical"`` path, ``kernel="sweep"`` on 2x2
   (``"sweep_spmd"``, ``sweep_stage`` 24 times a step) against the
   unsharded per-sweep path, with ``sweep_stage`` held against its plain
   version on a shard's halo-extended blocks along each axis, orthotropic bodies on 2x2 (``"fused_spmd"``,
   13-field stacks) against theirs (each under 2e-6, masks equal); the
   partly broken n=32 interface on 2x2 against the unsharded run (masks
   equal) and resumed from step 17 bit for bit with no broken cell
   healing; the 2x2 run cut at step 51 of 100 through a checkpoint file
   equal to its uninterrupted run, and an unsharded engine's checkpoint
   resumed on the mesh (under 2e-6 of the unsharded run, masks equal).
19. one run across two processes: two ranks of a gloo group at
   ``tcp://127.0.0.1:<free port>`` (this script with ``--multiproc-rank``,
   each bounded by ``MP_TIMEOUT``), both on cuda:0, one mesh row (two
   shards) a rank, the slabs between them through pinned host memory: (a)
   ``elastic3d_explosion`` n=256 fused on 2x2 x 50 steps, (b) the same
   with ``kernel="sweep"`` x 25, (c) ``elastic2d_viscoelastic`` n=2048 on
   sx=4 x 50; each rank launches its shards' kernels only, and the
   gathered state and traces equal the one-process run on the same mesh
   bit for bit ((a) also under 2e-6 of the unsharded fused run); each
   path's points/s, the host ms of the exchange inside the step loop
   (median of 20 steps, and its share of the loop's wall) and the card's
   idle share (both ranks traced); rows 6a, 6b, 4 and 6c held against
   their plain versions on rank 1's shard with the slabs rank 0 sent, and
   timed. With two or more cards, (a) again under NCCL, one rank a card;
   with one, ``nccl: not run (1 card)``.
20. the contact path and the outputs across two processes, two gloo ranks
   on cuda:0 as in phase 19 (``--multiproc-contact-rank``), one mesh row a
   rank: (a) the contact bodies of phase 13 (with two receivers on shard
   edges of the upper body) fused on 2x2 (``"fused_spmd"``) x 100 steps,
   (b) ``kernel="sweep"`` on 2x2 (``"sweep_spmd"``) x 50, (c) the
   canonical order on sx=4 (``"fused_canonical_spmd"``) x 50; each rank
   launches its own shards' kernels only (4 interior + 4 ring, 12
   ``sweep_stage``, 4 + 4 a step), and both ranks' bodies, bond masks and
   traces equal the one-process run on the same mesh bit for bit; (d) the
   partly broken n=32 interface through ``run_with_outputs`` (snapshots
   every 16, checkpoints every 8) x 32, cut at 17 (its checkpoint saved by
   rank 0 from ``state_dict``) and resumed on both ranks, no broken cell
   healing; (e) ``elastic3d_explosion`` n=256 fused on 2x2 through
   ``run_with_outputs`` (a vz snapshot and a checkpoint every 10) x 20, cut
   at 10 and resumed; (d) and (e) equal their uninterrupted runs, every
   file equal to the one-process run's (``.npz`` by their arrays), and the
   two-rank checkpoints resume in one process bit for bit; each path's
   points/s, the host ms of the cross-rank contact fixup inside the step
   loop (median of 20 steps) and its share of the loop's wall (rank 0's
   figures), the card's idle share (both ranks traced); rows 6a, 6b and 4
   held against their plain versions on rank 1's shard of the lower body
   (which holds the source) with the slabs rank 0 sent, both checked to be
   nonzero first, and timed. With two or more cards, (a)-(c) again under
   NCCL, one rank a card (the contact faces gathered across the cards),
   both ranks' bodies, masks and traces equal to the one-process runs bit
   for bit; with one, ``nccl: contact not run (1 card)``.
21. the benchmark: ``gcm_tpu_torch.bench.main`` in this process at
   256x256x128 with every path (its 33^3 and 65^3 jittered unit boxes and
   foot tables built on the host from phase 3 on, in a process of its own
   on one thread at the lowest priority, phase 8's mesh being another;
   phase 17's simplex contact bodies and tables reused), its line printed
   as ``bench: {...}``; the bench holds each kernel form's end state to
   its plain twin's (``sweep`` and ``fused`` to ``torch`` on the flagship,
   each unit box's kernel sweeps to its plain sweeps, the simplex contact
   kernel engine's bodies and bond masks to the plain engine's) under
   ``PATH_TOL`` and fails the phase otherwise; the line's ``device`` ends
   in the card's power limit in W; every rate finite and > 0; the kernels launched as the bench's step counts
   say (``fused_step`` a step of the fused and visco paths,
   ``sweep_stage`` 3, ``fused_step_slab`` 2 on the contact path,
   ``simplex_sweep`` 6 a step pair of a body) and nothing else; no rate
   above the points of a step over its launches' bounds (rows 1, 2, 4 and
   5, as ``_bound`` counts them); the contact path ``fused_canonical`` and
   the 65^3 and contact simplex forms the kernel's. Then the CLI's ``bench
   --path fused``: its line, its launches and its bound.
22. one process, a mesh over distinct cards (one card a shard, as the JAX
   package runs its meshes over ``jax.devices()``), with four or more
   cards: (a) ``elastic3d_explosion`` n=256 fused on 2x2 cards x 300
   (strong scaling; also under 2e-6 of the unsharded fused run), (b) n=512
   (512x512x256, a 256x256x256 shard a card) x 100 (weak scaling, against
   one card alone on such a shard), (c) the per-sweep path and the folded
   Maxwell + damage path on 2x2 x 50 and ``elastic2d_viscoelastic`` n=2048
   on sx=4 x 300, (d) the contact forms ``fused_spmd`` (2x2),
   ``fused_canonical_spmd`` (sx=4) and ``sweep_spmd`` (2x2) at n=256 x 100
   and the partly broken n=32 interface x 32, (e) ``python -m
   gcm_tpu_torch run elastic3d_explosion|elastic3d_contact --n 256 --mesh
   2,2 --device cuda`` (the summary's kernel or path, mesh and launches);
   each run launches its kernels as often as on one card and equals bit
   for bit the same mesh with every shard on cuda:0; the peer access
   between the cards, each run's points/s, the host ms a step of its
   exchange (slab or halo exchange, contact fixup) and share of the loop's
   wall, each card's idle share (traced), the scaling efficiencies, and
   rows 6a and 6b held and timed on the last card's shard. With two or
   three cards (a) on 2x1 cards and the 2D path on sx=2; with one,
   ``phase 22: not run (1 card)``.

Each path's points/s and each kernel's ms against its plain version's at
the path's own shape are printed, and the whole run's seconds. The line
before the last is a JSON object with the kernels' launches on their main
paths, errors, times and bounds (the least time for the bytes a call must
move at 3.35 TB/s or its operations at 67 TFLOP/s, whichever is larger),
for the four launches of the one-step 3D body (``fused_step``,
``fused_step_slab``, ``fused_spmd_interior``, ``fused_spmd_ring``) and the
two-step one (``fused_step_slab_k2``: launches on the pair-fused path) the
resident blocks an SM at their shared memory (``blocks_per_sm``,
``smem_bytes``, from the library's occupancy query), and for the kernels
of the structured paths the same for their orthotropic
form (``ortho_launches``, ``ortho_max_abs_err``, ``ortho_ms``,
``ortho_plain_ms``, ``ortho_bound_ms``); the 2D kernels' entries
(``fused_step_2d``, its two-step pass ``fused_step_2d_k2``,
``fused_spmd_2d`` with ``interior_ms`` and ``ring_ms``) carry their
occupancy too, and ``simplex_sweep`` its blocks an SM and nodes a block;
``fused_step``, ``fused_step_slab``, ``sweep_stage`` and ``simplex_sweep``
carry their launches in phase 21's bench run (``bench_launches``);
``simplex_sweep`` also carries its launches, error, times and bound on the
simplex contact path (``contact_*``) and that path's rate, idle share and
host setup; ``fused_spmd_interior`` and ``fused_spmd_ring`` carry their
launches on the 2x2 contact mesh path, their error, times and bounds on
its shard, its rate, idle share and the contact fixup's host ms in the
step loop and alone (``contact_mesh_*``), and ``sweep_stage`` its
launches, rate, error, times and bound on the per-sweep contact mesh
path's shard blocks; ``fused_spmd_interior``, ``fused_spmd_ring``,
``sweep_stage`` and ``fused_spmd_2d`` carry their launches in a rank of
phase 19 and their error, times and bound on rank 1's shard there
(``multiproc_*``), and ``fused_spmd_interior``, ``fused_spmd_ring`` and
``sweep_stage`` the same on the contact path of phase 20 with its rate,
fixup host ms and share and idle share (``multiproc_contact_*``);
with two or more cards ``fused_spmd_interior`` and ``fused_spmd_ring``
carry their launches in phase 22's (a), its rate and their error, times
and bound on the last card's shard (``multicard_*``), ``sweep_stage`` and
``fused_spmd_2d`` their launches and rate in (c); the
last line is ``{"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: the explosion sits 34 cells below the free surface at n=256 and a step
#: moves information at most one cell along z, so 20 steps leave the
#: surface exactly at rest; by step ~250 the P wave has arrived there
NSTEPS = 300
N_MAIN = 256
#: 2D viscoelastic section: 2048x2048 points; by 1600 steps (~0.195 s) the
#: P wave has passed the receiver at 0.75 L
N_2D, NSTEPS_2D, NSTEPS_2D_CMP = 2048, 1600, 300
NSTEPS_VISCO = NSTEPS_SWEEP = 100
PATH_TOL = 1e-4
#: the sharded paths, on meshes whose shards lie on cuda:0 together
NSTEPS_SHARDED, NSTEPS_SHARDED_VISCO = 100, 50
NSTEPS_SHARDED_2D, NSTEPS_SHARDED_SWEEP = 300, 50
#: the contact path, BASELINE config 4 at bench.py's shape: two bodies of
#: 256x256x128 (16,777,216 points). The lower body's Ricker source peaks at
#: t0 = 0.12 s, 249 m below the interface (0.062 s at 4000 m/s); its
#: leading lobe reaches the interface after ~100 steps of dt = 0.8 h /
#: 4000 m/s, so by 200 steps (0.157 s) the wave has crossed it (its peak at
#: ~230 steps). The bf16, non-canonical and pair-fused runs take 100 steps;
#: the 2D non-conforming basin runs at n=1025 (1025^2 + 2049^2 points).
N_CONTACT, NSTEPS_CONTACT, NSTEPS_CONTACT_SHORT = 256, 200, 100
N_BASIN, NSTEPS_BASIN, NSTEPS_PAIR = 1025, 100, 100
#: the bf16-stack contact run against the float32 one after 100 steps: the
#: stacks round rho, c and kappa by up to 2e-3, which shifts the waves'
#: arrival; the limit is the CPU tests' bf16 contract
#: (tests/test_torch_slab.py)
BF16_PATH_TOL = 3e-2
#: the simplex path: simplex3d_layered on bench.py's production mesh, 65^3 =
#: 274,625 nodes over L = 150 m. Its Ricker source (f0 = 40 Hz) peaks at
#: t0 = 1.2/f0 = 0.03 s at z = L/3 = 50 m; the P wave then crosses 50 m of
#: sandstone at 3300 m/s (0.015 s) and 50 m of sediments at 2100 m/s
#: (0.024 s) to the receivers at z = 150 m, about 0.07 s in all. So the path
#: runs T_SIMPLEX = 0.08 s of simulated time: ceil(0.08 / dt) steps of the
#: engine's own dt = 0.6 h_min / 5200 m/s, several hundred (printed).
N_SIMPLEX, T_SIMPLEX, NSTEPS_SIMPLEX_CMP = 65, 0.08, 100
#: the orthotropic paths: the per-sweep, sharded, 2D sharded and bf16 runs
#: take 50 steps; the contact run takes NSTEPS_CONTACT (200), since the
#: lower body's wave reaches the interface only after ~100 steps (its c33
#: is the isotropic P modulus).
NSTEPS_ORTHO_SHORT = 50
#: the anisotropy check (the recipe of tests/test_orthotropic.py): the
#: explosion sits at (1000, 1000, 400) m in the orthotropic sediments, whose
#: P speed is 2394 m/s along x, 2203 m/s along y and 2100 m/s along z; its
#: Ricker wavelet (f0 = 8 Hz) passes 2% of its peak at ~0.06 s. After 210
#: steps (0.222 s at dt = 1.058e-3 s) the region where |v| exceeds 2% of its
#: largest value on the source's horizontal plane reaches ~250 m from the
#: source along x, short of the free surface 400 m above it and of every
#: other face (checked). There reach_x / reach_y must lie within 35% of
#: sqrt(c11 / c22) = 1.087, and reach_x must exceed reach_y.
NSTEPS_ANISO, ANISO_FRAC, ANISO_TOL = 210, 0.02, 0.35
BORDER_SET = (
    ((0, 0), "free", None),
    ((0, 1), "absorbing", None),
    ((1, 0), "fixed_force", (1e5, 2e5, -1e5)),
    ((1, 1), "fixed_velocity", (0.1, -0.2, 0.3)),
    ((2, 0), "absorbing", None),
    ((2, 1), "free", None),
)


def _norm_err(got, want):
    """Per-component max error over the component's max magnitude."""
    c = want.shape[0]
    scale = want.abs().reshape(c, -1).amax(1) + 1e-30
    return ((got - want).abs().reshape(c, -1).amax(1) / scale).max().item()


def _np_err(got, want):
    return _norm_err(torch.from_numpy(got), torch.from_numpy(want))


def _mat_as(mat, dtype):
    """Material fields cast to ``dtype``."""
    return dataclasses.replace(mat, **{
        f.name: getattr(mat, f.name).to(dtype)
        for f in dataclasses.fields(mat)})


def _borders(dim):
    from gcm_tpu_torch.task import BorderSpec

    return {f: BorderSpec(k, value=v if v is None else v[:dim])
            for f, k, v in BORDER_SET if f[0] < dim}


def _problem(rng, shape, name):
    """Random heterogeneous medium and smooth random state (float32):
    (model, state, material fields, compact stack, dt)."""
    from gcm_tpu_torch.materials import MaterialFields
    from gcm_tpu_torch.models.spec import get_model
    from gcm_tpu_torch.ops.fused import stack_mats

    model = get_model(name)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    if name.startswith("acoustic"):
        mu = np.zeros(shape)
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = rng.standard_normal((model.ncomp,) + shape)
    for a in range(1, u0.ndim):
        u0 = 0.25 * np.roll(u0, 1, a) + 0.5 * u0 + 0.25 * np.roll(u0, -1, a)
    u0[model.dim:] *= 1e6
    mat = MaterialFields.from_arrays(rho, lam, mu, device="cuda")
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    u = torch.tensor(u0, dtype=torch.float32, device="cuda")
    return model, u, mat, stack_mats(model, mat), dt


def _seqs_2d(k):
    """The 2D sweep sequences of a pass of ``k`` steps: both orders for
    one step, every pair of them for two."""
    orders = ((0, 1), (1, 0))
    return ([(ax,) for ax in orders] if k == 1
            else list(itertools.product(orders, orders)))


def _time_ms(fn, reps):
    """Device ms a call of ``fn``: the mean over ``reps`` calls queued behind
    a spin kernel that outlasts their enqueueing, so a call whose host side
    (the wrapper's checks and parameters) takes longer than its kernels is
    not timed at the host's pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1.5 * reps * wall + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _hold_on_path_state(tag, kernel, plain, args, kw=None, steps=1):
    """One kernel launch of ``steps`` steps on a main path's own state,
    against its plain version. Such a state can be badly conditioned for
    float32: near a source the stress over the impedance exceeds the
    largest velocity many times over, and then the velocities of both
    float32 versions carry round-off of ~1e-6 of their maximum. So the
    kernel is held to the plain step in float64: its normalized error there
    must stay under 2e-6 a step, or under twice the float32 plain step's
    own. Returns the kernel's output and its normalized and max abs error
    against the float32 plain step."""
    kw = kw or {}

    def f64(x):
        return x.double() if torch.is_tensor(x) else x

    def first(r):
        return r[0] if isinstance(r, tuple) else r

    got, want = kernel(*args, **kw), plain(*args, **kw)
    exact = first(plain(*map(f64, args), **{k: f64(v) for k, v in kw.items()}))
    err_k = _norm_err(first(got).double(), exact)
    err_p = _norm_err(first(want).double(), exact)
    _check(err_k < max(2e-6 * steps, 2 * err_p),
           f"{tag}: error vs the float64 plain step {err_k:.3e}, float32 "
           f"plain's own {err_p:.3e}")
    print(f"{tag}: normalized error vs float64 plain {err_k:.3e} (float32 "
          f"plain {err_p:.3e}), vs float32 plain "
          f"{_norm_err(first(got), first(want)):.3e}")
    return got, want, (first(got) - first(want)).abs().max().item()


class Counts:
    """The kernels' launch counters: zeroed just before a main path, read
    just after it."""

    def __init__(self):
        from gcm_tpu_torch.ops.fused import (
            fused_step, fused_step_2d, fused_step_slab)
        from gcm_tpu_torch.ops.simplex import simplex_sweep
        from gcm_tpu_torch.ops.sweep import sweep_stage

        from gcm_tpu_torch.ops.fused_spmd import (
            fused_spmd_2d, fused_spmd_interior, fused_spmd_ring)

        self.fns = {"fused_step": fused_step,
                    "fused_step_slab": fused_step_slab,
                    "fused_step_2d": fused_step_2d,
                    "sweep_stage": sweep_stage,
                    "simplex_sweep": simplex_sweep,
                    "fused_spmd_interior": fused_spmd_interior,
                    "fused_spmd_ring": fused_spmd_ring,
                    "fused_spmd_2d": fused_spmd_2d}

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0
        self.fns["fused_spmd_2d"].ring_launches = 0
        self.fns["fused_step_slab"].pair_launches = 0
        self.fns["fused_step_2d"].pair_launches = 0

    def read(self):
        """Launches by kernel; ``fused_step_slab_k2`` and
        ``fused_step_2d_k2`` count the two-step passes among
        ``fused_step_slab``'s and ``fused_step_2d``'s."""
        out = {k: fn.launches for k, fn in self.fns.items()}
        out["fused_step_slab_k2"] = self.fns["fused_step_slab"].pair_launches
        out["fused_step_2d_k2"] = self.fns["fused_step_2d"].pair_launches
        return out

    def expect(self, tag, launched, **want):
        """Fail unless the kernels in ``want`` launched that often and
        every other kernel never."""
        full = {k: want.get(k, 0) for k in self.read()}
        _check(launched == full, f"{tag} launches {launched}, expected "
               f"{full}")


def _warm(task, kernels):
    """Two steps of each path, so first-launch costs stay out of the runs."""
    from gcm_tpu_torch.engine import Engine

    for kern in kernels:
        Engine(dataclasses.replace(task, kernel=kern, time=dataclasses.replace(
            task.time, nsteps=2)), device="cuda").run()


def kernels_vs_plain():
    """Phase 3: every kernel against its plain version on small problems."""
    from gcm_tpu_torch.ops.fused import (
        fold_corrector_specs, fused_step, fused_step_2d,
        fused_step_2d_reference, fused_step_reference)
    from gcm_tpu_torch.ops.sweep import sweep_stage
    from gcm_tpu_torch.solver.correctors import (
        DamageCorrector, MaxwellCorrector)
    from gcm_tpu_torch.solver.gcm import stage

    rng = np.random.default_rng(0)
    h3 = (10.0, 12.0, 9.0)

    def hold(tag, got, want):
        err = _norm_err(got, want)
        _check(err < 2e-6, f"{tag}: err {err:.3e}")
        return err

    worst = 0.0
    cases = [("elastic3d", shape, order, axes)
             for shape in ((24, 40, 56), (64, 64, 32), (70, 19, 45))
             for order in (1, 2, 3)
             for axes in ((0, 1, 2), (2, 1, 0), (2, 0, 1), (1, 0, 2))]
    cases.append(("acoustic3d", (24, 40, 56), 2, (2, 1, 0)))
    for name, shape, order, axes in cases:
        model, u, _, ms, dt = _problem(rng, shape, name)
        args = (model, u, ms, dt, h3, order, _borders(3), axes)
        got = fused_step(*args)
        torch.cuda.synchronize()
        worst = max(worst, hold(f"fused_step {name} {shape} order {order} "
                                f"axes {axes}", got,
                                fused_step_reference(*args)))
    print(f"fused_step vs plain: {len(cases)} cases, worst normalized error "
          f"{worst:.3e} (limit 2e-6)")

    # ragged with unaligned rows, aligned, a multiple of the 126-column
    # strip (r = 1), thinner than the halo along x and narrower than a
    # strip, aligned (4, 40) and not (3, 130)
    worst, n2 = 0.0, 0
    for shape in ((37, 61), (64, 128), (70, 252), (3, 130), (4, 40)):
        for name in ("elastic2d", "acoustic2d"):
            for order in (1, 2, 3, 4):
                model, u, _, ms, dt = _problem(rng, shape, name)
                for stack in (ms, ms.to(torch.bfloat16)):
                    for axes in ((0, 1), (1, 0)):
                        args = (model, u, stack, dt, h3[:2], order,
                                _borders(2), axes)
                        got = fused_step_2d(*args)
                        torch.cuda.synchronize()
                        worst = max(worst, hold(
                            f"fused_step_2d {name} {shape} order {order} "
                            f"{stack.dtype} axes {axes}", got,
                            fused_step_2d_reference(*args)))
                        n2 += 1
    print(f"fused_step_2d vs plain: {n2} cases, worst normalized error "
          f"{worst:.3e} (limit 2e-6)")

    for name, shape, kernel, order in (
            ("elastic3d", (24, 40, 56), fused_step, 2),
            ("elastic2d", (37, 61), fused_step_2d, 2),
            ("elastic2d", (64, 128), fused_step_2d, 4)):
        model, u, _, ms, dt = _problem(rng, shape, name)
        dim = model.dim
        specs, naux = fold_corrector_specs(
            (MaxwellCorrector(tau=40 * dt),
             DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
        _check(specs is not None and naux == 1, "correctors did not fold")
        # each step from the plain step's state and damage (see the
        # sharded folded check in spmd_kernels_vs_plain)
        want, waux = u, torch.zeros((1,) + shape, device="cuda")
        err, aerr = 0.0, 0.0
        for n in range(3):
            axes = tuple(range(dim))[::(-1 if n % 2 else 1)]
            rest = (ms, dt, h3[:dim], order, _borders(dim), axes)
            got, gaux = kernel(model, want, *rest, correctors=specs,
                               aux=waux)
            want, waux = fused_step_reference(model, want, *rest,
                                              correctors=specs, aux=waux)
            torch.cuda.synchronize()
            err = max(err, hold(f"{kernel.__name__} step {n} with folded "
                                "correctors", got, want))
            torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)
            aerr = max(aerr, (gaux - waux).abs().max().item())
        _check(waux.max().item() > 1e-4, f"{name}: damage stayed zero")
        print(f"{kernel.__name__} with folded Maxwell + damage, 3 steps "
              f"{name} {shape} order {order}, each from the plain state: "
              f"normalized error "
              f"{err:.3e}, damage max {waux.max().item():.4g}, aux max abs "
              f"error {aerr:.3e} (rtol 1e-5, atol 1e-6)")

    worst, ns = 0.0, 0
    for name, shape in (("elastic3d", (24, 40, 56)), ("elastic3d", (9, 17, 2)),
                        ("elastic3d", (64, 64, 128)),
                        ("acoustic3d", (13, 21, 37)), ("elastic2d", (37, 61)),
                        ("elastic2d", (5, 3)), ("acoustic2d", (130, 64))):
        for order in (1, 2, 3, 4):
            model, u, mat, _, dt = _problem(rng, shape, name)
            for axis in range(model.dim):
                args = (model, u, mat, dt, h3[:model.dim], axis, order,
                        _borders(model.dim))
                got = sweep_stage(*args)
                torch.cuda.synchronize()
                worst = max(worst, hold(f"sweep_stage {name} axis {axis} "
                                        f"order {order}", got, stage(*args)))
                ns += 1
    print(f"sweep_stage vs plain: {ns} cases, worst normalized error "
          f"{worst:.3e} (limit 2e-6)")


def _simplex_problem(rng, n, dim, name, order, fluid=False):
    """Random heterogeneous medium on a jittered box mesh of n^dim nodes,
    its foot tables, and a random float32 state on the card:
    (grid, model, material fields, tables, state)."""
    from scipy.spatial import cKDTree

    from gcm_tpu_torch.grids.simplex import SimplexGrid, build_foot_tables
    from gcm_tpu_torch.materials import MaterialFields
    from gcm_tpu_torch.models.spec import get_model

    grid = SimplexGrid.box((0.0,) * dim, (1.0,) * dim, (n,) * dim,
                           jitter=0.1, seed=n)
    N = grid.npoints
    model = get_model(name)
    rho = 2500.0 * (1.0 + 0.2 * rng.random(N))
    mu = np.zeros(N) if fluid else 1e9 * (0.5 + rng.random(N))
    lam = 1e9 * (1.0 + rng.random(N))
    mat = MaterialFields.from_arrays(rho, lam, mu, device="cuda")
    d, _ = cKDTree(grid.points).query(grid.points, k=2)
    dt = 0.7 * float(d[:, 1].min()) / mat.max_cp()
    waves = {"p": mat.cp.double().cpu().numpy()}
    if not fluid:
        waves["s"] = mat.cs.double().cpu().numpy()
    tables = build_foot_tables(grid, waves, dt, order=order)
    u0 = rng.standard_normal((model.ncomp, N))
    u0[model.dim:] *= 1e6
    return (grid, model, mat, tables,
            torch.tensor(u0, dtype=torch.float32, device="cuda"))


def _simplex_borders(grid, dim):
    """The four uniform border kinds, and per-node borders: free top,
    fixed_force on the low x side, fixed_velocity on the high one,
    absorbing elsewhere."""
    from gcm_tpu_torch.solver.simplex_gcm import build_node_borders
    from gcm_tpu_torch.task import AreaLayer, BorderSpec

    node = build_node_borders(grid, [
        (AreaLayer(axis=dim - 1, lo=0.99, hi=1.01), BorderSpec("free")),
        (AreaLayer(axis=0, lo=-0.01, hi=0.01),
         BorderSpec("fixed_force", value=(2e5, 1e5, -1e5)[:dim])),
        (AreaLayer(axis=0, lo=0.99, hi=1.01),
         BorderSpec("fixed_velocity", value=(0.1, -0.2, 0.3)[:dim]))])
    return ["absorbing", "free",
            BorderSpec("fixed_force", value=(1e5, -2e5, 3e5)[:dim]),
            BorderSpec("fixed_velocity", value=(0.1, 0.2, -0.3)[:dim]), node]


def simplex_kernel_vs_plain():
    """Phase 8, first part: ``simplex_sweep`` against its plain version,
    each sweep of both axis orders from the plain version's state."""
    from gcm_tpu_torch.ops.simplex import (
        build_simplex_plan, simplex_sweep, simplex_sweep_reference)

    rng = np.random.default_rng(1)
    cases = [(8, 3, "elastic3d", 1, False), (8, 3, "elastic3d", 2, False),
             (8, 3, "elastic3d", 1, True), (8, 3, "acoustic3d", 1, True),
             (12, 2, "elastic2d", 1, False), (9, 3, "elastic3d", 1, False),
             (12, 2, "elastic2d", 2, False), (12, 2, "elastic2d", 3, False),
             (8, 3, "elastic3d", 3, False)]
    worst, nsweeps = 0.0, 0
    for n, dim, name, order, fluid in cases:
        grid, model, mat, tables, u0 = _simplex_problem(rng, n, dim, name,
                                                        order, fluid)
        for border in _simplex_borders(grid, dim):
            plan = build_simplex_plan(model, mat, tables, border, "cuda")
            for axes in (tuple(range(dim)), tuple(range(dim))[::-1]):
                u = u0
                for a in axes:
                    got = simplex_sweep(plan, u, a)
                    torch.cuda.synchronize()
                    want = simplex_sweep_reference(plan, u, a)
                    err = _norm_err(got, want)
                    _check(err < 2e-6, f"simplex_sweep {name} order {order} "
                           f"fluid {fluid} {border!r:.40} axis {a}: err "
                           f"{err:.3e}")
                    worst = max(worst, err)
                    nsweeps += 1
                    u = want
    print(f"simplex_sweep vs plain: {nsweeps} sweeps over {len(cases)} "
          f"meshes x 5 borders, worst normalized error {worst:.3e} "
          f"(limit 2e-6)")


def simplex_path(counts, result, mesh_setup):
    """Phase 8, second part: the simplex main path at 65^3, on the task
    ``mesh_setup`` (a ``HostSetup`` of ``_simplex_task_setup``) built."""
    from gcm_tpu_torch.engine_simplex import SimplexEngine
    from gcm_tpu_torch.ops.simplex import (
        simplex_sweep, simplex_sweep_occupancy, simplex_sweep_reference)
    from gcm_tpu_torch.task import TimeSpec

    t0 = time.perf_counter()
    task, t_mesh = mesh_setup.get()
    mesh_setup.stop()
    t_wait = time.perf_counter() - t0
    task = dataclasses.replace(task, time=TimeSpec(cfl=task.time.cfl,
                                                   t_end=T_SIMPLEX))
    t0 = time.perf_counter()
    eng = SimplexEngine.from_task(task, device="cuda")
    t_tables = time.perf_counter() - t0
    grid = task.grid
    print(f"simplex setup on the host CPU: Delaunay {t_mesh:.1f} s (in a "
          f"process of its own from before the build; waited {t_wait:.1f} "
          f"s for it here), foot tables and plan {t_tables:.1f} s "
          f"({grid.npoints} nodes, "
          f"{len(grid.cells)} cells, {len(eng.tables)} tables of K="
          f"{next(iter(eng.tables.values())).ids.shape[1]}); dt {eng.dt:.6g} s, {eng.nsteps} steps for "
          f"{T_SIMPLEX} s")

    def sibling(kernel, nsteps):
        """An engine on the same task and tables, with its own state."""
        return SimplexEngine.from_task(dataclasses.replace(
            task, kernel=kernel, time=TimeSpec(cfl=task.time.cfl,
                                               nsteps=nsteps)),
            device="cuda", tables=eng.tables)

    for kern in ("simplex", "torch"):
        sibling(kern, 2).run()
    counts.zero()
    res = eng.run()
    launched = counts.read()
    _check(res.kernel == "simplex", f"simplex path resolved to {res.kernel!r}")
    counts.expect("simplex path", launched,
                  simplex_sweep=3 * eng.nsteps)
    _check(res.u.shape == (9, grid.npoints) and np.isfinite(res.u).all()
           and np.isfinite(res.traces).all(),
           "simplex path: state or traces not finite, or of wrong shape")
    vmax = np.abs(res.traces[:, :, :3]).max(axis=(0, 2))
    _check((vmax > 0).all(), f"simplex path: receiver velocities {vmax}")
    res_k = sibling("simplex", NSTEPS_SIMPLEX_CMP).run()
    res_t = sibling("torch", NSTEPS_SIMPLEX_CMP).run()
    err = _np_err(res_k.u, res_t.u)
    _check(err < PATH_TOL, f"simplex vs torch path: err {err:.3e}")
    print(f"simplex path {task.name} {grid.npoints} nodes x {eng.nsteps} "
          f"steps: {res.points_per_second:.6g} points/s, "
          f"{launched['simplex_sweep']} simplex_sweep launches; receiver "
          f"max|v| {vmax[0]:.4e}, {vmax[1]:.4e}; after {NSTEPS_SIMPLEX_CMP} "
          f"steps simplex {res_k.points_per_second:.6g} vs torch "
          f"{res_t.points_per_second:.6g} points/s, normalized error "
          f"{err:.3e} (limit 1e-4)")

    # the kernel alone on the path's own state, each axis
    ms, plain_ms, max_abs = [], [], 0.0
    for axis in range(3):
        a = (eng._plan, eng.u, axis)
        *_, e = _hold_on_path_state(f"simplex_sweep on the 65^3 state, axis "
                                    f"{axis}", simplex_sweep,
                                    simplex_sweep_reference, a)
        max_abs = max(max_abs, e)
        ms.append(_time_ms(lambda: simplex_sweep(*a), 50))
        plain_ms.append(_time_ms(lambda: simplex_sweep_reference(*a), 10))
        print(f"simplex_sweep at {tuple(eng.u.shape)} axis {axis}: kernel "
              f"{ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f} ms")
    K = next(iter(eng.tables.values())).ids.shape[1]
    flops = grid.npoints * sum(len(st.pairs) * (8 * K + 20)
                               for st in eng.model.stages) / 3
    bps, nb = simplex_sweep_occupancy(eng._plan, eng.u, 0)
    print(f"  occupancy: {bps} blocks an SM, {nb} nodes a block")
    result["simplex_sweep"] = dict(
        launches=launched["simplex_sweep"], max_abs_err=max_abs,
        ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
        ms_by_axis=ms, blocks_per_sm=bps, nodes_per_block=nb,
        **_bound_entry(B_SIMPLEX * grid.npoints, flops))
    return task, eng.tables


# ------------------------------------------------------------- sharded paths

#: bytes a point of the fused 3D and 2D steps must move (state in and out,
#: compact materials; a damage aux in and out adds 8), the per-sweep
#: kernel's (state in and out, cp cs zp zs kappa) and the simplex sweep's
#: compulsory streams per node (4 tables of K=4 ids and weights, flags,
#: materials, state in and out)
B_FUSED3, B_FUSED2, B_SWEEP, B_SIMPLEX = 88, 56, 92, 216
#: the 2D per-sweep kernel's: state in and out (5 components), cp cs zp zs
#: kappa
B_SWEEP2 = 60
#: the same with a bf16 material stack: the slab step's 36 + 8 + 36 bytes,
#: the 2D step's 20 + 8 + 20; a two-step pass moves the bytes of one step
B_SLAB_BF16, B_FUSED2_BF16 = 80, 48
#: the same with the orthotropic stacks (13 fields in 3D, 52 bytes in
#: float32 and 26 in bf16; 6 in 2D) and views (a 3D sweep reads 3 speeds, 3
#: impedances and 2 ratios)
B_FUSED3_ORTHO, B_SLAB_BF16_ORTHO, B_FUSED2_ORTHO, B_SWEEP_ORTHO = (
    124, 98, 64, 104)
#: the published H100 SXM peaks the bounds are taken against
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12
#: flops of one pair update at a point (Lagrange weights, four
#: interpolations of order+1 taps, invariants, reconstruction) by order
PAIR_FLOPS = {1: 30, 2: 45, 3: 62, 4: 80}


def _step_flops(model, order, npts, nsweeps=None):
    """Operations of a step (or of ``nsweeps`` sweeps) over ``npts`` points:
    every pair and zero-speed invariant of each sweep, counted as above."""
    sweeps = model.stages[:nsweeps] if nsweeps else model.stages
    per = sum(len(st.pairs) * PAIR_FLOPS[order] + 3 * len(st.zeros)
              for st in sweeps)
    return per * npts


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _bound_entry(nbytes, flops):
    """The bound keys of a kernel's JSON entry; no single PyTorch call
    computes any of these steps, so there is no library time."""
    bms, by = _bound(nbytes, flops)
    return dict(bound_ms=bms, bound_by=by, library_ms=None)


#: the kernels' names in the CUDA sources
KERNEL_NAMES = ("fused_step_stream_kernel", "fused_pair_stream_kernel",
                "fused_spmd_kernel", "fused_step_rows_kernel",
                "fused_pair_rows_kernel", "fused_spmd_rows_kernel",
                "sweep_stage_kernel", "simplex_sweep_kernel")


def _print_ptxas(log):
    """What ptxas said of the kernels, one line per kernel, first template
    argument (the stencil order; taps for the simplex sweep) and model: the
    entry functions (sweep orders, stack types), their registers, and their
    largest stack frame and spill stores in bytes."""
    groups, entry, frame = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and entry:
            frame = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            key = entry
            for name in KERNEL_NAMES:   # mangled as <length><identifier>
                at = entry.find(f"{len(name)}{name}I")
                if at >= 0:
                    order = re.match(r"ILi(\d+)E",
                                     entry[at + len(str(len(name))) +
                                           len(name):])
                    model = re.search(r"(Elastic|Acoustic)[23]D", entry)
                    key = (name + (f"<{order.group(1)}>" if order else "")
                           + (" " + model.group(0) if model else ""))
                    break
            g = groups.setdefault(key, [0, 999, 0, 0, 0])
            regs = int(m.group(1))
            g[0] += 1
            g[1], g[2] = min(g[1], regs), max(g[2], regs)
            g[3], g[4] = max(g[3], frame[0]), max(g[4], frame[1])
            entry, frame = None, (0, 0)
    for key, (n, lo, hi, stack, spill) in sorted(groups.items()):
        print(f"  ptxas {key}: {n} entries, {lo}-{hi} registers, stack "
              f"frame up to {stack} B, spill stores up to {spill} B")


def _occupancy(occ):
    """The occupancy keys of a kernel's JSON entry, from ``(blocks_per_sm,
    smem_bytes)``."""
    bps, smem = occ
    print(f"  occupancy: {bps} blocks an SM at {smem} bytes of shared "
          "memory")
    return dict(blocks_per_sm=bps, smem_bytes=smem)


def _spmd_bytes(model, shape, r, which, nm):
    """Bytes one SPMD launch must move on a shard of ``shape`` (C, nxl[,
    nyl], nz or ny) with a float32 stack of ``nm`` fields (4 compact, 13 or
    6 orthotropic): state in and out and materials of its own cells, and,
    for the ring, the received slabs and the material stack's halo rows."""
    from gcm_tpu_torch.ops.fused_spmd import (
        TILE_2D, TILE_3D, interior_mask)

    C, sp = shape[0], tuple(shape[1:])
    tile = TILE_3D if len(sp) == 3 else (TILE_2D,)
    mask = interior_mask(sp, r, tile)
    inner = int(mask.sum()) * int(np.prod(sp[mask.ndim:]))
    cells = inner if which == "interior" else int(np.prod(sp)) - inner
    nbytes = (2 * C + nm) * 4 * cells
    if which == "ring":
        ext = [n + 2 * r for n in sp[:-1]] + [sp[-1]]
        halo = int(np.prod(ext)) - int(np.prod(sp))
        nbytes += (C + nm) * 4 * halo
    return nbytes, cells


def _device_busy(run_steps):
    """(host wall ms, device busy ms) of ``run_steps()`` under
    torch.profiler: the union of this process's kernel and copy events,
    overlaps counted once (None without device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return wall, _union_ms(spans) if spans else None


def _union_ms(spans):
    """The ms that the intervals ``spans`` (profiler us) cover, overlaps
    counted once."""
    total, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            total += (b - max(a, end)) / 1e3
            end = b
    return total


def _idle_share(run_steps, nsteps, step_ms):
    """Device busy time over the host wall of ``nsteps`` steps under
    torch.profiler (kernels and copies, overlaps counted once). The
    profiler slows the host, so the traced idle share is an upper bound;
    the busy time a step over the untraced step time ``step_ms`` (from the
    path's own run) estimates the untraced one."""
    wall, busy = _device_busy(run_steps)
    if busy is None:
        print(f"  trace of {nsteps} steps: no device events recorded; idle "
              "share not measured")
        return None
    print(f"  trace of {nsteps} steps: loop wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; untraced step "
          f"{step_ms:.4f} ms, device busy a step {busy / nsteps:.4f} ms, "
          f"idle share ~{1 - busy / nsteps / step_ms:.3f}")
    return 1 - busy / wall


def _step_ms(res, task):
    """A path's untraced wall time a step, from its run's rate."""
    return float(np.prod(task.grid.shape)) / res.points_per_second * 1e3


def _spmd_steps_vs_plain(rng, cases):
    """Both SPMD kernels against their plain versions on every shard of
    random heterogeneous problems, and each sharded step against the
    unsharded plain step, all under 2e-6: ``cases`` of (global shape,
    DomainMesh, order, axes). Returns (worst kernel error, launches)."""
    from gcm_tpu_torch.ops.fused import fused_step_reference
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_interior, fused_spmd_interior_reference, fused_spmd_ring,
        fused_spmd_ring_reference)
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack, face_flags, make_fused_spmd_step)
    from gcm_tpu_torch.parallel.sharding import gather_state, shard_state

    h3 = (10.0, 12.0, 9.0)
    worst, nk = 0.0, 0

    def hold(tag, got, want):
        err = _norm_err(got, want)
        _check(err < 2e-6, f"{tag}: err {err:.3e}")
        return err

    for shape, mesh, order, axes in cases:
        model, u, mat, ms, dt = _problem(rng, shape, "elastic3d")
        mext = extended_mstack(model, mat, mesh, order)
        us = shard_state(u, mesh)
        slabs = exchange_slabs(us, mesh, stencil_radius(order))
        bc = _borders(3)
        where = f"{shape} on {mesh.shape} {mesh.axis_names} order {order} " \
            f"axes {axes}"
        for k, uk in enumerate(us):
            args = (model, uk, mext[k], dt, h3, order, bc, axes)
            got = fused_spmd_interior(*args, out=torch.zeros_like(uk))
            want = fused_spmd_interior_reference(
                *args, out=torch.zeros_like(uk))
            f = face_flags(mesh, k)
            ring = fused_spmd_ring(model, uk, mext[k], slabs[k], f,
                                   torch.zeros_like(uk), dt, h3, order, bc,
                                   axes)
            torch.cuda.synchronize()
            tag = f"{where} shard {k}"
            worst = max(worst, hold(f"fused_spmd_interior {tag}", got, want),
                        hold(f"fused_spmd_ring {tag}", ring,
                             fused_spmd_ring_reference(
                                 model, uk, mext[k], slabs[k], f,
                                 torch.zeros_like(uk), dt, h3, order, bc,
                                 axes)))
            nk += 2
        step = make_fused_spmd_step(model, mesh, dt, h3, order, bc)
        hold(f"sharded step {where}",
             gather_state(step(us, mext, axes), mesh),
             fused_step_reference(model, u, ms, dt, h3, order, bc, axes))
    return worst, nk


def spmd_kernels_vs_plain():
    """The SPMD kernels against their plain versions on the card, one
    launch each, on random heterogeneous problems whose shards lie on
    cuda:0 together; then the whole sharded steps against the unsharded
    plain step."""
    from gcm_tpu_torch.ops.fused import (
        fold_corrector_specs, fused_step_reference)
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_2d, fused_spmd_2d_reference, fused_spmd_interior,
        fused_spmd_interior_reference, fused_spmd_ring,
        fused_spmd_ring_reference, interior_mask)
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack, face_flags, make_fused_spmd_step,
        make_fused_spmd_step_2d)
    from gcm_tpu_torch.parallel.sharding import (
        domain_mesh, gather_state, shard_state)
    from gcm_tpu_torch.solver.correctors import (
        DamageCorrector, MaxwellCorrector)

    rng = np.random.default_rng(2)
    h3 = (10.0, 12.0, 9.0)
    dev = torch.device("cuda", 0)
    worst, nk = 0.0, 0

    def hold(tag, got, want, lim=2e-6):
        err = _norm_err(got, want)
        _check(err < lim, f"{tag}: err {err:.3e}")
        return err

    # (global shape, mesh, order, axes): tile-multiple and ragged shards on
    # 2x2 and 4x1 meshes, and a ring-only one (8-row shards)
    cases = [((64, 48, 16), (2, 2), o, ax) for o in (1, 2, 3)
             for ax in ((0, 1, 2), (2, 1, 0))]
    cases += [((50, 38, 20), (2, 2), 2, (0, 1, 2)),
              ((50, 38, 20), (2, 2), 3, (2, 1, 0)),
              ((96, 20, 16), (4, 1), 1, (0, 1, 2)),
              ((96, 20, 16), (4, 1), 2, (2, 1, 0)),
              ((32, 16, 16), (4, 1), 2, (0, 1, 2))]
    worst, nk = _spmd_steps_vs_plain(rng, [
        (shape, domain_mesh(3, [dev] * int(np.prod(mshape)), mshape), order,
         axes) for shape, mshape, order, axes in cases])
    print(f"fused_spmd_interior/ring vs plain: {nk} launches over "
          f"{len(cases)} problems, worst normalized error {worst:.3e} (limit "
          "2e-6); every sharded step vs the unsharded plain step under 2e-6")

    # x in the middle of the sweep order, ragged shards: the interior
    # launch fills exactly its cells of a NaN buffer, the ring the others
    worst, nk = 0.0, 0
    for shape, mshape, order, axes in (
            ((70, 38, 45), (2, 2), 2, (2, 0, 1)),
            ((70, 38, 45), (2, 2), 3, (1, 0, 2)),
            ((140, 38, 33), (2, 2), 1, (2, 0, 1)),
            ((8, 36, 9), (2, 2), 4, (1, 0, 2))):
        model, u, mat, ms, dt = _problem(rng, shape, "elastic3d")
        mesh = domain_mesh(3, [dev] * 4, mshape)
        r = stencil_radius(order)
        mext = extended_mstack(model, mat, mesh, order)
        us = shard_state(u, mesh)
        slabs = exchange_slabs(us, mesh, r)
        outs = []
        for k, uk in enumerate(us):
            args = (model, uk, mext[k], dt, h3, order, _borders(3), axes)
            f = face_flags(mesh, k)
            got = fused_spmd_interior(*args,
                                      out=torch.full_like(uk, float("nan")))
            torch.cuda.synchronize()
            inner = interior_mask(uk.shape[1:], r, device=dev)
            _check(bool(torch.isnan(got[:, ~inner]).all())
                   and not bool(torch.isnan(got[:, inner]).any()),
                   f"fused_spmd_interior {shape} {axes}: wrote other cells")
            want = fused_spmd_interior_reference(*args,
                                                 out=torch.zeros_like(uk))
            tag = f"{shape} order {order} axes {axes} shard {k}"
            worst = max(worst, hold(f"fused_spmd_interior {tag}",
                                    torch.nan_to_num(got), want))
            got = fused_spmd_ring(model, uk, mext[k], slabs[k], f, got,
                                  *args[3:])
            torch.cuda.synchronize()
            _check(not bool(torch.isnan(got).any()),
                   f"fused_spmd_ring {tag}: cells left unwritten")
            worst = max(worst, hold(f"fused_spmd_ring {tag}", got,
                                    fused_spmd_ring_reference(
                                        model, uk, mext[k], slabs[k], f,
                                        want, *args[3:])))
            outs.append(got)
            nk += 2
        hold(f"interior + ring {shape} order {order} axes {axes}",
             gather_state(outs, mesh),
             fused_step_reference(model, u, ms, dt, h3, order, _borders(3),
                                  axes))
    print(f"fused_spmd_interior/ring with x in the middle of the sweep "
          f"order: {nk} launches, every cell written once, worst normalized "
          f"error {worst:.3e} (limit 2e-6)")

    # Maxwell + damage folded into both launches: 3 steps of the sharded
    # step, each from the plain step's state and damage, against the
    # unsharded plain step with its epilogue (a damage cell near the
    # threshold moves by ~0.5 x the stress error / threshold a step, so
    # errors carried from step to step would compound there)
    shape = (48, 48, 16)
    model, u, mat, ms, dt = _problem(rng, shape, "elastic3d")
    specs, naux = fold_corrector_specs(
        (MaxwellCorrector(tau=40 * dt),
         DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    mesh = domain_mesh(3, [dev] * 4, (2, 2))
    mext = extended_mstack(model, mat, mesh, 2)
    step = make_fused_spmd_step(model, mesh, dt, h3, 2, _borders(3),
                                correctors=specs)
    want, waux = u, torch.zeros((1,) + shape, device=dev)
    err, aerr = 0.0, 0.0
    for n in range(3):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        got, gaux = step(shard_state(want, mesh), mext, axes,
                         aux=shard_state(waux, mesh))
        want, waux = fused_step_reference(model, want, ms, dt, h3, 2,
                                          _borders(3), axes, specs, waux)
        torch.cuda.synchronize()
        gaux = gather_state(gaux, mesh)
        err = max(err, hold(f"sharded step {n} with folded correctors",
                            gather_state(got, mesh), want))
        torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)
        aerr = max(aerr, (gaux - waux).abs().max().item())
    _check(waux.max().item() > 1e-4, "sharded folded: damage stayed zero")
    print(f"sharded step with Maxwell + damage folded, 3 steps {shape} on "
          f"(2, 2), each from the plain state: normalized error {err:.3e}, "
          f"damage max {waux.max().item():.4g}, aux max abs error "
          f"{aerr:.3e} (rtol 1e-5, atol 1e-6)")

    # the 2D kernel: both modes, sx = 2 and 4, orders 1-4, both axes
    # orders, both 2D models; aligned shards with an interior, ragged ones
    # with unaligned rows, and shards so thin that the interior is empty
    # (nxl = 2 <= 2r; nxl = 3 at r = 2); the interior launch fills exactly
    # its rows of a NaN buffer, the ring launch the others
    worst, nk, nc = 0.0, 0, 0
    for shape, nsh in (((512, 70), 2), ((400, 61), 4), ((64, 40), 4),
                       ((8, 132), 4), ((12, 61), 4)):
        for name in ("elastic2d", "acoustic2d"):
            for order in (1, 2, 3, 4):
                for axes in ((0, 1), (1, 0)):
                    model, u, mat, ms, dt = _problem(rng, shape, name)
                    mesh = domain_mesh(2, [dev] * nsh)
                    r = stencil_radius(order)
                    mext = extended_mstack(model, mat, mesh, order)
                    us = shard_state(u, mesh)
                    slabs = exchange_slabs(us, mesh, r, dim=2)
                    bc = _borders(2)
                    tag = f"{name} {shape}/{nsh} order {order} axes {axes}"
                    for k, uk in enumerate(us):
                        f = face_flags(mesh, k)[:2]
                        args = (model, uk, mext[k], dt, h3[:2], order, bc,
                                axes)
                        got = fused_spmd_2d(
                            *args, "interior",
                            base=torch.full_like(uk, float("nan")))
                        torch.cuda.synchronize()
                        inner = interior_mask(uk.shape[1:], r, (1,), dev)
                        _check(bool(torch.isnan(got[:, ~inner]).all())
                               and not bool(torch.isnan(got[:, inner]).any()),
                               f"fused_spmd_2d interior {tag}: wrote other "
                               "rows")
                        want = fused_spmd_2d_reference(*args, "interior")
                        worst = max(worst, hold(
                            f"fused_spmd_2d interior {tag} shard {k}",
                            torch.nan_to_num(got), want))
                        got = fused_spmd_2d(*args, "ring", slabs[k], f, got)
                        torch.cuda.synchronize()
                        _check(not bool(torch.isnan(got).any()),
                               f"fused_spmd_2d ring {tag}: rows left "
                               "unwritten")
                        worst = max(worst, hold(
                            f"fused_spmd_2d ring {tag} shard {k}", got,
                            fused_spmd_2d_reference(*args, "ring", slabs[k],
                                                    f, want)))
                        nk += 2
                    step = make_fused_spmd_step_2d(model, mesh, dt, h3[:2],
                                                   order, bc)
                    hold(f"sharded 2D step {tag}",
                         gather_state(step(us, mext, axes), mesh),
                         fused_step_reference(model, u, ms, dt, h3[:2],
                                              order, bc, axes))
                    nc += 1
    print(f"fused_spmd_2d vs plain: {nk} launches over {nc} problems, worst "
          f"normalized error {worst:.3e} (limit 2e-6), every row written "
          "once; every sharded 2D step vs the unsharded plain step under "
          "2e-6")


def _spmd_kernels_on_shard(tag, model, us, mexts, mesh, k, dt, h, order,
                           bc, axes, slabs=None):
    """Both SPMD kernels on shard ``k`` of a path's own sharded state: each
    held against its plain version (``_hold_on_path_state``), then timed
    beside it; ``slabs`` (default: exchanged here) are the shard's halo
    slabs. Returns ``({name: {max_abs_err, ms, plain_ms, bound_ms,
    bound_by}}, the interior launch's arguments)``."""
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_interior, fused_spmd_interior_reference, fused_spmd_ring,
        fused_spmd_ring_reference)
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import exchange_slabs, face_flags

    r = stencil_radius(order)
    u0, m0 = us[k], mexts[k]
    if slabs is None:
        slabs = exchange_slabs(us, mesh, r)[k]
    f0 = face_flags(mesh, k)
    where = f"{tag}shard {k} {tuple(u0.shape)}, axes {tuple(axes)}"
    iargs = (model, u0, m0, dt, h, order, bc, axes)
    *_, e_in = _hold_on_path_state(
        f"fused_spmd_interior on {where}",
        lambda *a: fused_spmd_interior(*a, out=torch.zeros_like(u0)),
        lambda *a: fused_spmd_interior_reference(
            *a, out=torch.zeros_like(a[1])), iargs)
    rargs = (model, u0, m0, slabs, f0)
    rrest = (dt, h, order, bc, axes)
    *_, e_ring = _hold_on_path_state(
        f"fused_spmd_ring on {where}",
        lambda m, u, me, sl, f, *rest: fused_spmd_ring(
            m, u, me, sl, f, torch.zeros_like(u), *rest),
        lambda m, u, me, sl, f, *rest: fused_spmd_ring_reference(
            m, u, me, tuple(x.to(u.dtype) for x in sl), f,
            torch.zeros_like(u), *rest), rargs + rrest)
    base = torch.zeros_like(u0)
    t_in = _time_ms(lambda: fused_spmd_interior(*iargs, out=base), 50)
    p_in = _time_ms(lambda: fused_spmd_interior_reference(*iargs, out=base),
                    5)
    t_ring = _time_ms(lambda: fused_spmd_ring(*rargs, base, *rrest), 50)
    p_ring = _time_ms(lambda: fused_spmd_ring_reference(*rargs, base,
                                                        *rrest), 5)
    out = {}
    for name, which, ms, plain, e in (
            ("fused_spmd_interior", "interior", t_in, p_in, e_in),
            ("fused_spmd_ring", "ring", t_ring, p_ring, e_ring)):
        nbytes, cells = _spmd_bytes(model, u0.shape, r, which, m0.shape[0])
        bms, by = _bound(nbytes, _step_flops(model, order, cells))
        out[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain, bound_ms=bms,
                         bound_by=by)
    print(f"fused_spmd_interior on {where}: kernel {t_in:.4f} ms, plain "
          f"{p_in:.4f} ms, bound {out['fused_spmd_interior']['bound_ms']:.4f}"
          f" ms; fused_spmd_ring: kernel {t_ring:.4f} ms, plain "
          f"{p_ring:.4f} ms, bound {out['fused_spmd_ring']['bound_ms']:.4f}"
          " ms")
    return out, iargs


def _spmd_2d_on_shard(where, eng, k, slabs):
    """The 2D SPMD kernel in both modes on shard ``k`` of a sharded 2D
    engine's state, with its halo ``slabs``: each mode held against its
    plain version, then both timed beside it. Returns ``({max_abs_err, ms,
    plain_ms, bound_ms, bound_by, interior_ms, ring_ms}, the launch's
    arguments)``."""
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_2d, fused_spmd_2d_reference)
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import face_flags

    task, model = eng.task, eng.model
    u2, me2 = eng.u[k], eng._carry[k]
    f2 = face_flags(eng.mesh, k)[:2]
    a2 = (model, u2, me2, eng.dt, task.grid.h, task.order, task.borders,
          (0, 1))
    e2 = 0.0
    for which in ("interior", "ring"):
        *_, e = _hold_on_path_state(
            f"fused_spmd_2d {which} on {where} {tuple(u2.shape)}",
            lambda *a, w=which: fused_spmd_2d(*a, w, slabs, f2,
                                              torch.zeros_like(u2)),
            lambda *a, w=which: fused_spmd_2d_reference(
                *a, w, tuple(x.to(a[1].dtype) for x in slabs), f2,
                torch.zeros_like(a[1])), a2)
        e2 = max(e2, e)
    b2 = torch.zeros_like(u2)

    def both(fn):
        return lambda: [fn(*a2, w, slabs, f2, b2) for w in ("interior",
                                                             "ring")]

    t2 = _time_ms(both(fused_spmd_2d), 50)
    p2 = _time_ms(both(fused_spmd_2d_reference), 10)
    t2w = {w: _time_ms(lambda w=w: fused_spmd_2d(*a2, w, slabs, f2, b2), 50)
           for w in ("interior", "ring")}
    print(f"fused_spmd_2d (interior + ring) at {where} {tuple(u2.shape)}: "
          f"kernel {t2:.4f} ms (interior {t2w['interior']:.4f}, ring "
          f"{t2w['ring']:.4f}), plain {p2:.4f} ms")
    r = stencil_radius(task.order)
    nb = sum(_spmd_bytes(model, u2.shape, r, w, me2.shape[0])[0]
             for w in ("interior", "ring"))
    bms, by = _bound(nb, _step_flops(model, task.order, u2[0].numel()))
    return dict(max_abs_err=e2, ms=t2, plain_ms=p2, bound_ms=bms,
                bound_by=by, interior_ms=t2w["interior"],
                ring_ms=t2w["ring"]), a2


def _sweep_on_block(where, model, u, mat, dt, h, axis, order):
    """``sweep_stage`` on a path's own (halo-extended) block, held against
    its plain version and timed beside it: ``{max_abs_err, ms, plain_ms,
    bound_ms, bound_by}``."""
    from gcm_tpu_torch.ops.sweep import sweep_stage
    from gcm_tpu_torch.solver.gcm import stage

    a = (model, u, mat, dt, h, axis, order, None)
    *_, e = _hold_on_path_state(
        f"sweep_stage on {where} {tuple(u.shape)}, axis {axis}", sweep_stage,
        lambda model, u, mat, *rest: stage(
            model, u, _mat_as(mat, u.dtype), *rest), a)
    npts = u[0].numel()
    bms, by = _bound(B_SWEEP * npts, _step_flops(model, order, npts) / 3)
    out = dict(max_abs_err=e, ms=_time_ms(lambda: sweep_stage(*a), 20),
               plain_ms=_time_ms(lambda: stage(*a), 5), bound_ms=bms,
               bound_by=by)
    print(f"sweep_stage at {tuple(u.shape)} axis {axis}: kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bound "
          f"{bms:.4f} ms")
    return out


def sharded_paths(counts, result):
    """Phases 10-11: the sharded 3D, folded-corrector, 2D and per-sweep
    paths on meshes whose shards lie on cuda:0 together."""
    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.ops.fused import fused_step, stack_mats
    from gcm_tpu_torch.ops.fused_spmd import fused_spmd_occupancy
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack, make_fused_spmd_step)
    from gcm_tpu_torch.parallel.sharding import domain_mesh, gather_state
    from gcm_tpu_torch.scenarios import get_scenario
    from gcm_tpu_torch.solver.correctors import (
        DamageCorrector, MaxwellCorrector)
    from gcm_tpu_torch.solver.gcm import cfl_dt

    dev = torch.device("cuda", 0)
    mesh4 = domain_mesh(3, [dev] * 4, (2, 2))

    def short(task, n=2):
        return dataclasses.replace(task, time=dataclasses.replace(
            task.time, nsteps=n))

    # ---- 10. the sharded 3D path
    task = get_scenario("elastic3d_explosion", n=N_MAIN,
                        nsteps=NSTEPS_SHARDED)
    Engine(short(task), mesh=mesh4).run()
    Engine(short(task), device=dev).run()
    eng = Engine(task, mesh=mesh4)
    counts.zero()
    res = eng.run()
    launched = counts.read()
    _check(res.kernel == "fused", f"sharded path resolved to {res.kernel!r}")
    counts.expect("sharded 3D path", launched,
                  fused_spmd_interior=4 * NSTEPS_SHARDED,
                  fused_spmd_ring=4 * NSTEPS_SHARDED)
    _check(np.isfinite(res.u).all() and np.isfinite(res.traces).all(),
           "sharded 3D path: state or traces not finite")
    _check(np.abs(res.traces).max() > 0, "sharded 3D path: traces are zero")
    ref = Engine(task, device=dev).run()
    err = _np_err(res.u, ref.u)
    _check(err < 2e-6, f"sharded vs unsharded fused path: err {err:.3e}")
    terr = float(np.abs(res.traces - ref.traces).max()
                 / np.abs(ref.traces).max())
    _check(terr < 2e-6, f"sharded vs unsharded traces: err {terr:.3e}")
    print(f"sharded 3D path {task.name} {task.grid.shape} on 2x2 shards of "
          f"cuda:0 x {NSTEPS_SHARDED} steps: {res.points_per_second:.6g} "
          f"points/s (unsharded fused {ref.points_per_second:.6g}); "
          f"{launched['fused_spmd_interior']} interior + "
          f"{launched['fused_spmd_ring']} ring launches, 0 fused_step; vs "
          f"unsharded: normalized error {err:.3e} (limit 2e-6), max "
          f"|difference| {np.abs(res.u - ref.u).max():.3e}, traces "
          f"{terr:.3e}")
    model, h, order, bc = eng.model, task.grid.h, task.order, task.borders
    axes = (0, 1, 2)

    def steps(e, n):
        """n more steps of a sharded engine from its state (traced)."""
        return lambda: [e._one_step_mesh(e.u, e.aux, i % e.nsteps)
                        for i in range(n)]

    _idle_share(steps(eng, 20), 20, _step_ms(res, task))

    # one step with force_spmd on a 1x1 mesh, against fused_step
    mesh1 = domain_mesh(3, [dev], (1, 1))
    u_glob = gather_state(eng.u, mesh4)
    one = make_fused_spmd_step(model, mesh1, eng.dt, h, order, bc,
                               force_spmd=True)
    counts.zero()
    got = one([u_glob], extended_mstack(model, eng.mat, mesh1, order),
              axes)[0]
    counts.expect("force_spmd 1x1 step", counts.read(), fused_spmd_ring=1,
                  fused_spmd_interior=1)
    want = fused_step(model, u_glob, stack_mats(model, eng.mat), eng.dt, h,
                      order, bc, axes)
    torch.cuda.synchronize()
    err1 = _norm_err(got, want)
    _check(err1 < 2e-6, f"force_spmd 1x1 vs fused_step: err {err1:.3e}")
    print(f"force_spmd on a 1x1 mesh, one step at {tuple(u_glob.shape)}: "
          f"vs fused_step normalized error {err1:.3e} (limit 2e-6)")
    del one, got, want, u_glob

    # each kernel on shard 0 of the path's own state
    entries, iargs = _spmd_kernels_on_shard(
        "", model, eng.u, eng._carry, mesh4, 0, eng.dt, h, order, bc, axes)
    for name, entry in entries.items():
        result[name] = dict(launches=launched[name], **entry,
                            library_ms=None, **_occupancy(
                                fused_spmd_occupancy(
                                    *iargs, ring=name.endswith("ring"))))
    del eng, res, ref, iargs

    # ---- 11. the sharded folded-corrector path
    base6 = get_scenario("elastic3d_layered", n=N_MAIN,
                         nsteps=NSTEPS_SHARDED_VISCO)
    dt6 = cfl_dt(base6.material_fields(), base6.grid.h, base6.time.cfl)
    task6 = dataclasses.replace(base6, correctors=(
        MaxwellCorrector(tau=50 * dt6),
        DamageCorrector(threshold=5e5, rate=0.1 / dt6)))
    Engine(short(task6), mesh=mesh4).run()
    eng6 = Engine(task6, mesh=mesh4)
    _check(eng6._fold_specs is not None and eng6._fold_naux == 1,
           "sharded visco path did not fold its correctors")
    counts.zero()
    res6 = eng6.run()
    counts.expect("sharded visco path", counts.read(),
                  fused_spmd_interior=4 * NSTEPS_SHARDED_VISCO,
                  fused_spmd_ring=4 * NSTEPS_SHARDED_VISCO)
    eng6u = Engine(task6, device=dev)
    res6u = eng6u.run()
    dmg = gather_state(eng6.aux["damage"], mesh4, lead=0).cpu().numpy()
    dmg_u = eng6u.aux["damage"].cpu().numpy()
    _check(dmg.max() > 0, "sharded visco path: damage stayed zero")
    err6 = _np_err(res6.u, res6u.u)
    derr6 = float(np.abs(dmg - dmg_u).max() / max(np.abs(dmg_u).max(),
                                                   1e-30))
    _check(err6 < PATH_TOL and derr6 < PATH_TOL,
           f"sharded vs unsharded folded: state {err6:.3e}, damage "
           f"{derr6:.3e}")
    print(f"sharded visco path {task6.name} {task6.grid.shape} on 2x2 x "
          f"{NSTEPS_SHARDED_VISCO} steps, Maxwell + damage folded: "
          f"{res6.points_per_second:.6g} points/s (unsharded "
          f"{res6u.points_per_second:.6g}); vs unsharded: state "
          f"{err6:.3e}, damage {derr6:.3e} (limit 1e-4); damage max "
          f"{dmg.max():.4g}")
    del eng6, eng6u, res6, res6u

    # ---- 11. the sharded 2D path
    task2 = get_scenario("elastic2d_viscoelastic", n=N_2D,
                         nsteps=NSTEPS_SHARDED_2D)
    mesh2 = domain_mesh(2, [dev] * 4)
    Engine(short(task2), mesh=mesh2).run()
    eng2 = Engine(task2, mesh=mesh2)
    counts.zero()
    res2 = eng2.run()
    launched2 = counts.read()
    counts.expect("sharded 2D path", launched2,
                  fused_spmd_2d=2 * 4 * NSTEPS_SHARDED_2D)
    from gcm_tpu_torch.ops.fused_spmd import fused_spmd_2d as f2d

    _check(f2d.ring_launches == 4 * NSTEPS_SHARDED_2D,
           f"sharded 2D path: {f2d.ring_launches} ring launches")
    _check(np.isfinite(res2.u).all() and np.abs(res2.u).max() > 0,
           "sharded 2D path: state not finite or zero")
    res2u = Engine(task2, device=dev).run()
    err2 = _np_err(res2.u, res2u.u)
    _check(err2 < PATH_TOL, f"sharded vs unsharded 2D: err {err2:.3e}")
    print(f"sharded 2D path {task2.name} {task2.grid.shape} on sx=4 x "
          f"{NSTEPS_SHARDED_2D} steps: {res2.points_per_second:.6g} points/s "
          f"(unsharded {res2u.points_per_second:.6g}); "
          f"{launched2['fused_spmd_2d']} fused_spmd_2d launches "
          f"({f2d.ring_launches} ring); vs unsharded normalized error "
          f"{err2:.3e} (limit 1e-4)")
    _idle_share(steps(eng2, 20), 20, _step_ms(res2, task2))
    sl2 = exchange_slabs(eng2.u, mesh2, stencil_radius(task2.order),
                         dim=2)[1]
    entry, a2 = _spmd_2d_on_shard("shard 1", eng2, 1, sl2)
    result["fused_spmd_2d"] = dict(
        launches=launched2["fused_spmd_2d"], **entry, library_ms=None,
        **_occupancy(fused_spmd_occupancy(*a2)))
    del eng2, res2, res2u, sl2, a2

    # ---- 11. the sharded per-sweep path
    task7 = dataclasses.replace(get_scenario(
        "elastic3d_explosion", n=N_MAIN, nsteps=NSTEPS_SHARDED_SWEEP),
        kernel="sweep")
    Engine(short(task7), mesh=mesh4).run()
    eng7 = Engine(task7, mesh=mesh4)
    counts.zero()
    res7 = eng7.run()
    counts.expect("sharded sweep path", counts.read(),
                  sweep_stage=3 * 4 * NSTEPS_SHARDED_SWEEP)
    res7u = Engine(task7, device=dev).run()
    err7 = _np_err(res7.u, res7u.u)
    _check(err7 < PATH_TOL, f"sharded vs unsharded sweep: err {err7:.3e}")
    print(f"sharded sweep path {task7.name} {task7.grid.shape} on 2x2 x "
          f"{NSTEPS_SHARDED_SWEEP} steps: {res7.points_per_second:.6g} "
          f"points/s (unsharded sweep {res7u.points_per_second:.6g}); "
          f"{3 * 4 * NSTEPS_SHARDED_SWEEP} sweep_stage launches; vs "
          f"unsharded normalized error {err7:.3e} (limit 1e-4)")
    _idle_share(steps(eng7, 10), 10, _step_ms(res7, task7))


# ------------------------------------------------------------- the slab step

def slab_kernels_vs_plain():
    """Phase 12: the slab kernel, and the 2D kernels' bf16 and two-step
    options, against their plain versions on random problems."""
    from gcm_tpu_torch.ops.fused import (
        fold_corrector_specs, fused_step_2d, fused_step_2d_reference,
        fused_step_slab, fused_step_slab_reference)
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_2d, fused_spmd_2d_reference)
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack_2d, face_flags)
    from gcm_tpu_torch.parallel.sharding import domain_mesh, shard_state
    from gcm_tpu_torch.solver.correctors import (
        DamageCorrector, MaxwellCorrector)

    rng = np.random.default_rng(5)
    h3 = (10.0, 12.0, 9.0)
    worst, n = 0.0, 0
    orders3 = list(itertools.permutations(range(3)))
    for name, shape in (("elastic3d", (24, 40, 56)),
                        ("elastic3d", (9, 17, 2)), ("elastic3d", (3, 2, 5)),
                        ("acoustic3d", (13, 21, 37))):
        for order in (1, 2, 3, 4):
            model, u, _, ms, dt = _problem(rng, shape, name)
            # one step in four orders; two steps in every order pair on the
            # ragged elastic shape, each order and its reverse on the others
            pairs = (itertools.product(orders3, orders3) if shape[0] == 24
                     else ((ax, ax[::-1]) for ax in orders3))
            seqs = [((0, 1, 2),), ((2, 1, 0),), ((2, 0, 1),), ((1, 0, 2),)]
            seqs += list(pairs)
            for stack in (ms, ms.to(torch.bfloat16)):
                for seq in seqs:
                    args = (model, u, stack, dt, h3, order, _borders(3))
                    got = fused_step_slab(*args, axes_seq=seq)
                    torch.cuda.synchronize()
                    err = _norm_err(got, fused_step_slab_reference(
                        *args, axes_seq=seq))
                    _check(err < 2e-6 * len(seq),
                           f"fused_step_slab {name} {shape} order {order} "
                           f"{stack.dtype} {seq}: err {err:.3e}")
                    worst = max(worst, err / len(seq))
                    n += 1
    print(f"fused_step_slab vs plain: {n} launches (orders 1-4, 4 sweep "
          f"orders a step, every order pair two steps a pass, float32 and "
          f"bf16 stacks, ragged and thinner-than-halo shapes, elastic3d "
          f"and acoustic3d), worst "
          f"normalized error a step {worst:.3e} (limit 2e-6)")

    shape = (12, 16, 24)
    model, u, _, ms, dt = _problem(rng, shape, "elastic3d")
    specs, _ = fold_corrector_specs(
        (MaxwellCorrector(tau=40 * dt),
         DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    for stack in (ms, ms.to(torch.bfloat16)):
        # each step from the plain step's state and damage (see the sharded
        # folded check in spmd_kernels_vs_plain)
        want, waux = u, torch.zeros((1,) + shape, device="cuda")
        err, aerr = 0.0, 0.0
        for k in range(3):
            axes = (2, 0, 1) if k % 2 == 0 else (1, 0, 2)
            rest = (stack, dt, h3, 2, _borders(3), axes)
            got, gaux = fused_step_slab(model, want, *rest, correctors=specs,
                                        aux=waux)
            want, waux = fused_step_slab_reference(
                model, want, *rest, correctors=specs, aux=waux)
            torch.cuda.synchronize()
            e = _norm_err(got, want)
            _check(e < 2e-6, f"slab folded {stack.dtype} step {k}: err "
                   f"{e:.3e}")
            torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)
            err, aerr = max(err, e), max(aerr, (gaux - waux).abs().max()
                                         .item())
        _check(waux.max().item() > 1e-4, "slab folded: damage stayed zero")
        print(f"fused_step_slab with folded Maxwell + damage, {stack.dtype} "
              f"stack, 3 canonical-order steps {shape}, each from the plain "
              f"state: normalized error {err:.3e}, aux max abs error "
              f"{aerr:.3e} (rtol 1e-5, atol 1e-6)")

    worst, n = 0.0, 0
    # two steps a pass in every sequence pair; (5, 3) and (2, 300) are
    # thinner than the 2r halo of two steps, (64, 128) has aligned rows and
    # (2, 300) three strips of the two-step body
    for shape in ((37, 61), (5, 3), (64, 128), (2, 300)):
        for name in ("elastic2d", "acoustic2d"):
            for order in (1, 2, 3, 4):
                model, u, _, ms, dt = _problem(rng, shape, name)
                for stack, k in ((ms.to(torch.bfloat16), 1), (ms, 2),
                                 (ms.to(torch.bfloat16), 2)):
                    for seq in _seqs_2d(k):
                        args = (model, u, stack, dt, h3[:2], order,
                                _borders(2))
                        got = fused_step_2d(*args, axes_seq=seq)
                        torch.cuda.synchronize()
                        err = _norm_err(got, fused_step_2d_reference(
                            *args, axes_seq=seq))
                        _check(err < 2e-6 * k, f"fused_step_2d {name} "
                               f"{shape} {stack.dtype} {seq}: {err:.3e}")
                        worst = max(worst, err / k)
                        n += 1
    print(f"fused_step_2d with bf16 stacks and two steps a pass (every "
          f"sequence pair) vs plain: {n} launches, worst normalized error a "
          f"step {worst:.3e} (limit 2e-6)")

    worst, n = 0.0, 0
    dev = torch.device("cuda", 0)
    for order in (1, 2, 3, 4):
        model, u, mat, _, dt = _problem(rng, (400, 61), "elastic2d")
        mesh = domain_mesh(2, [dev] * 4)
        mext = extended_mstack_2d(model, mat, mesh, order, torch.bfloat16)
        us = shard_state(u, mesh)
        slabs = exchange_slabs(us, mesh, stencil_radius(order), dim=2)
        for k, uk in enumerate(us):
            for which in ("interior", "ring"):
                args = (model, uk, mext[k], dt, h3[:2], order, _borders(2),
                        (0, 1), which, slabs[k], face_flags(mesh, k)[:2])
                got = fused_spmd_2d(*args, torch.zeros_like(uk))
                torch.cuda.synchronize()
                err = _norm_err(got, fused_spmd_2d_reference(
                    *args, torch.zeros_like(uk)))
                _check(err < 2e-6, f"fused_spmd_2d bf16 {which} order "
                       f"{order} shard {k}: err {err:.3e}")
                worst = max(worst, err)
                n += 1
    print(f"fused_spmd_2d with bf16 stacks vs plain: {n} launches, worst "
          f"normalized error {worst:.3e} (limit 2e-6)")


def _multi_steps(eng, n):
    """n more steps of a multi-body engine from its state (traced)."""
    def run():
        us, bonded, auxs = eng.us, eng.bonded, eng.auxs
        for i in range(n):
            us, bonded, auxs = eng._one_step(us, bonded, auxs, i)
    return run


def _bodies_err(got, want):
    """The largest per-body normalized error of two multi-body results."""
    return max(_np_err(got.bodies[k], want.bodies[k]) for k in want.bodies)


def contact_paths(counts, result):
    """Phase 13: the contact paths at full width."""
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.ops.fused import (
        fused_step_slab, fused_step_slab_occupancy, fused_step_slab_reference)
    from gcm_tpu_torch.scenarios import (
        elastic2d_basin_refined, elastic3d_contact)

    def bodies_with(bodies, **kw):
        return {k: dataclasses.replace(t, **kw) for k, t in bodies.items()}

    def plain(bodies, contacts, fwd):
        """The plain multi-body path in the splitting order ``fwd``."""
        eng = MultiBodyEngine(bodies_with(bodies, kernel="torch"), contacts,
                              device="cuda")
        eng._fwd = fwd
        return eng.run()

    bodies, contacts = elastic3d_contact(n=N_CONTACT, nsteps=NSTEPS_CONTACT)
    npts = sum(int(np.prod(t.grid.shape)) for t in bodies.values())
    short = bodies_with(bodies, time=dataclasses.replace(
        bodies["upper"].time, nsteps=2))
    MultiBodyEngine(short, contacts, device="cuda",
                    canonical_layout=True).run()
    eng = MultiBodyEngine(bodies, contacts, device="cuda",
                          canonical_layout=True)
    counts.zero()
    res = eng.run()
    launched = counts.read()
    _check(res.path == "fused_canonical",
           f"contact path resolved to {res.path!r}")
    counts.expect("contact path", launched,
                  fused_step_slab=2 * NSTEPS_CONTACT)
    _check(all(np.isfinite(v).all() for v in res.bodies.values()),
           "contact path: state not finite")
    v_up = float(np.abs(res.bodies["upper"][:3]).max())
    _check(v_up > 0, "contact path: the upper body did not move")
    mask = res.bonded[0]
    ref = plain(bodies, contacts, eng._fwd)
    ndiff = int((mask != ref.bonded[0]).sum())
    err = _bodies_err(res, ref)
    print(f"contact path {N_CONTACT}x{N_CONTACT}x{N_CONTACT // 2} x 2 "
          f"bodies ({npts} points) x {NSTEPS_CONTACT} steps, canonical "
          f"order {eng._fwd}: {res.points_per_second:.6g} points/s, "
          f"{launched['fused_step_slab']} fused_step_slab launches, 0 "
          f"fused_step; upper body max|v| {v_up:.4e}; bond mask mean "
          f"{mask.mean():.6f} ({int((mask < 0.5).sum())} of {mask.size} "
          f"broken); vs the plain path ({ref.points_per_second:.6g} "
          f"points/s): normalized error {err:.3e} (limit 1e-4), bond mask "
          f"cells that differ: {ndiff}")
    if ndiff:
        # a cell whose normal traction lies within round-off of the
        # strength can break in one float32 version and not the other;
        # the state is then held without fracture, and the masks to a few
        # cells
        free = tuple(dataclasses.replace(c, tensile_strength=None)
                     for c in contacts)
        got0 = MultiBodyEngine(bodies, free, device="cuda",
                               canonical_layout=True).run()
        err0 = _bodies_err(got0, plain(bodies, free, eng._fwd))
        print(f"  {ndiff} mask cells differ; without fracture the two "
              f"paths agree to {err0:.3e} (limit 1e-4)")
        _check(err0 < PATH_TOL and ndiff <= 0.001 * mask.size,
               f"contact path: {ndiff} mask cells differ, error without "
               f"fracture {err0:.3e}")
    else:
        _check(err < PATH_TOL, f"contact vs plain path: err {err:.3e}")
    step_ms = npts / res.points_per_second * 1e3
    _idle_share(_multi_steps(eng, 20), 20, step_ms)

    # the slab variants on the path's own state (the upper body): each
    # held against its plain version, then timed
    model = eng.model
    u, ms = eng.us["upper"], eng._mstacks["upper"]
    bcs, h = eng._kernel_bcs["upper"], eng.hs["upper"]
    fwd = eng._fwd
    pair = (fwd, fwd[::-1])
    cells = int(np.prod(u.shape[1:]))
    times = {}
    for tag, stack, seq, nb in (
            ("f32 K=1", ms, (fwd,), B_FUSED3),
            ("bf16 K=1", ms.to(torch.bfloat16), (fwd,), B_SLAB_BF16),
            ("f32 K=2", ms, pair, B_FUSED3),
            ("bf16 K=2", ms.to(torch.bfloat16), pair, B_SLAB_BF16)):
        a = (model, u, stack, eng.dt, h, eng.order, bcs)
        *_, max_abs = _hold_on_path_state(
            f"fused_step_slab {tag} on the contact state {tuple(u.shape)}",
            fused_step_slab, fused_step_slab_reference, a,
            dict(axes_seq=seq), steps=len(seq))
        t = _time_ms(lambda: fused_step_slab(*a, axes_seq=seq), 20)
        p = _time_ms(lambda: fused_step_slab_reference(*a, axes_seq=seq), 3)
        bms, by = _bound(nb * cells, len(seq) * _step_flops(
            model, eng.order, cells))
        times[tag] = (t, p, bms, by, max_abs)
        print(f"fused_step_slab {tag} at {tuple(u.shape)}: kernel {t:.4f} "
              f"ms a launch ({t / len(seq):.4f} a step), plain {p:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")
    t, p, bms, by, max_abs = times["f32 K=1"]
    result["fused_step_slab"] = dict(
        launches=launched["fused_step_slab"], max_abs_err=max_abs, ms=t,
        plain_ms=p, bound_ms=bms, bound_by=by, library_ms=None,
        **_occupancy(fused_step_slab_occupancy(
            model, u, ms, eng.dt, h, eng.order, bcs, fwd)))
    f32_short = dataclasses.replace(bodies["upper"].time,
                                    nsteps=NSTEPS_CONTACT_SHORT)
    del eng, res, ref, u, ms

    # ---- bf16 stacks on both bodies, against the float32 run
    b100 = bodies_with(bodies, time=f32_short)
    r32 = MultiBodyEngine(b100, contacts, device="cuda",
                          canonical_layout=True).run()
    counts.zero()
    r16 = MultiBodyEngine(bodies_with(b100, mat_dtype="bf16"), contacts,
                          device="cuda", canonical_layout=True).run()
    counts.expect("bf16 contact path", counts.read(),
                  fused_step_slab=2 * NSTEPS_CONTACT_SHORT)
    dev16 = _bodies_err(r16, r32)
    _check(0.0 < dev16 < BF16_PATH_TOL,
           f"bf16 vs float32 contact path: deviation {dev16:.3e}")
    print(f"bf16 contact path x {NSTEPS_CONTACT_SHORT} steps: "
          f"{r16.points_per_second:.6g} points/s (float32 "
          f"{r32.points_per_second:.6g}); deviation from the float32 run "
          f"{dev16:.3e} (material rounding; limit {BF16_PATH_TOL})")

    # ---- the non-canonical fused path: fused_step per body
    counts.zero()
    rnc = MultiBodyEngine(b100, contacts, device="cuda").run()
    counts.expect("non-canonical contact path", counts.read(),
                  fused_step=2 * NSTEPS_CONTACT_SHORT)
    _check(rnc.path == "fused", f"non-canonical path: {rnc.path!r}")
    pnc = plain(b100, contacts, (0, 1, 2))
    errnc = _bodies_err(rnc, pnc)
    _check(errnc < PATH_TOL, f"non-canonical vs plain: err {errnc:.3e}")
    print(f"non-canonical contact path x {NSTEPS_CONTACT_SHORT} steps: "
          f"{rnc.points_per_second:.6g} points/s, 2 fused_step launches a "
          f"step; vs plain normalized error {errnc:.3e} (limit 1e-4), mask "
          f"cells that differ {int((rnc.bonded[0] != pnc.bonded[0]).sum())}")
    del r32, r16, rnc, pnc

    # ---- the non-conforming 2D basin: the per-sweep path
    bb, bc = elastic2d_basin_refined(n=N_BASIN, nsteps=NSTEPS_BASIN)
    MultiBodyEngine(bodies_with(bb, time=dataclasses.replace(
        bb["basin"].time, nsteps=2)), bc, device="cuda").run()
    engb = MultiBodyEngine(bb, bc, device="cuda")
    counts.zero()
    resb = engb.run()
    counts.expect("basin path", counts.read(),
                  sweep_stage=2 * 2 * NSTEPS_BASIN)
    _check(resb.path == "sweep", f"basin path: {resb.path!r}")
    refb = plain(bb, bc, (0, 1))
    errb = _bodies_err(resb, refb)
    terr = float(np.abs(resb.traces["basin"] - refb.traces["basin"]).max()
                 / (np.abs(refb.traces["basin"]).max() + 1e-30))
    _check(errb < PATH_TOL and terr < PATH_TOL,
           f"basin vs plain: err {errb:.3e}, traces {terr:.3e}")
    nb_pts = sum(int(np.prod(t.grid.shape)) for t in bb.values())
    print(f"basin path (non-conforming, h/2) {nb_pts} points x "
          f"{NSTEPS_BASIN} steps: {resb.points_per_second:.6g} points/s, "
          f"{4 * NSTEPS_BASIN} sweep_stage launches; vs plain "
          f"({refb.points_per_second:.6g} points/s) normalized error "
          f"{errb:.3e}, traces {terr:.3e} (limit 1e-4)")
    _idle_share(_multi_steps(engb, 10), 10,
                nb_pts / resb.points_per_second * 1e3)


def pair_fused_path(counts, result):
    """Phase 14: the pair-fused single body, then its two-step pass on the
    path's own state: held against its plain version, timed beside two
    one-step launches and the plain pass, and the path's idle share; then
    the 2D pair-fused body the same way (no idle share)."""
    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.ops.fused import (
        fused_step_2d, fused_step_2d_occupancy, fused_step_2d_reference,
        fused_step_slab, fused_step_slab_occupancy, fused_step_slab_reference)
    from gcm_tpu_torch.scenarios import get_scenario

    task = dataclasses.replace(
        get_scenario("elastic3d_layered", n=N_MAIN, nsteps=NSTEPS_PAIR),
        detectors=None)
    pair = dataclasses.replace(task, temporal_block=True)
    _warm(pair, ("auto",))
    eng = Engine(pair, device="cuda")
    _check(eng._pair_fused, "the pair-fused body was not selected")
    counts.zero()
    res = eng.run()
    launched = counts.read()
    counts.expect("pair-fused path", launched,
                  fused_step_slab=NSTEPS_PAIR // 2,
                  fused_step_slab_k2=NSTEPS_PAIR // 2)
    ref = Engine(task, device="cuda").run()
    err = _np_err(res.u, ref.u)
    _check(err < PATH_TOL, f"pair-fused vs per-step: err {err:.3e}")
    print(f"pair-fused path {task.name} {task.grid.shape} x {NSTEPS_PAIR} "
          f"steps: {res.points_per_second:.6g} points/s "
          f"({launched['fused_step_slab_k2']} two-step fused_step_slab "
          f"launches), per-step fused {ref.points_per_second:.6g} points/s; "
          f"normalized error {err:.3e} (limit 1e-4)")

    seq = (eng._fwd, eng._fwd[::-1])
    a = (eng.model, eng.u, eng._mstack, eng.dt, task.grid.h, task.order,
         task.borders)
    *_, max_abs = _hold_on_path_state(
        f"two-step fused_step_slab {seq} on the pair-fused state",
        fused_step_slab, fused_step_slab_reference, a, dict(axes_seq=seq),
        steps=2)
    t = _time_ms(lambda: fused_step_slab(*a, axes_seq=seq), 20)
    t1 = _time_ms(lambda: (fused_step_slab(*a, axes_seq=seq[:1]),
                           fused_step_slab(*a, axes_seq=seq[1:])), 20)
    p = _time_ms(lambda: fused_step_slab_reference(*a, axes_seq=seq), 3)
    cells = int(np.prod(task.grid.shape))
    bound = _bound_entry(B_FUSED3 * cells,
                         2 * _step_flops(eng.model, task.order, cells))
    print(f"fused_step_slab two steps at {tuple(eng.u.shape)}: kernel "
          f"{t:.4f} ms a pass ({t / 2:.4f} a step), two one-step launches "
          f"{t1:.4f} ms, plain {p:.4f} ms, bound {bound['bound_ms']:.4f} ms")
    result["fused_step_slab_k2"] = dict(
        launches=launched["fused_step_slab_k2"], max_abs_err=max_abs, ms=t,
        plain_ms=p, one_step_pair_ms=t1, **bound,
        **_occupancy(fused_step_slab_occupancy(*a, axes_seq=seq)))

    def passes():
        u = eng.u
        for _ in range(10):
            u = fused_step_slab(*a[:1], u, *a[2:], axes_seq=seq)
    result["fused_step_slab_k2"]["idle_share"] = _idle_share(
        passes, 20, _step_ms(res, task))
    del eng, ref, res, a

    # the 2D two-step pass (stream_rows_pair) on its path: elastic2d_ps at
    # n=2048, whose initial ball needs no source, without receivers
    task2 = dataclasses.replace(
        get_scenario("elastic2d_ps", n=N_2D, nsteps=NSTEPS_PAIR),
        detectors=None)
    pair2 = dataclasses.replace(task2, temporal_block=True)
    _warm(pair2, ("auto",))
    eng2 = Engine(pair2, device="cuda")
    _check(eng2._pair_fused, "the 2D pair-fused body was not selected")
    counts.zero()
    res2 = eng2.run()
    launched2 = counts.read()
    counts.expect("2D pair-fused path", launched2,
                  fused_step_2d=NSTEPS_PAIR // 2,
                  fused_step_2d_k2=NSTEPS_PAIR // 2)
    ref2 = Engine(task2, device="cuda").run()
    err2 = _np_err(res2.u, ref2.u)
    _check(err2 < PATH_TOL, f"2D pair-fused vs per-step: err {err2:.3e}")
    print(f"2D pair-fused path {task2.name} {task2.grid.shape} x "
          f"{NSTEPS_PAIR} steps: {res2.points_per_second:.6g} points/s "
          f"({launched2['fused_step_2d_k2']} two-step fused_step_2d "
          f"launches), per-step fused {ref2.points_per_second:.6g} "
          f"points/s; normalized error {err2:.3e} (limit 1e-4)")
    seq2 = (eng2._fwd, eng2._fwd[::-1])
    a2 = (eng2.model, eng2.u, eng2._mstack, eng2.dt, task2.grid.h,
          task2.order, task2.borders)
    *_, max_abs2 = _hold_on_path_state(
        f"two-step fused_step_2d {seq2} on the 2D pair-fused state",
        fused_step_2d, fused_step_2d_reference, a2, dict(axes_seq=seq2),
        steps=2)
    a16 = a2[:2] + (eng2._mstack.to(torch.bfloat16),) + a2[3:]
    t2 = _time_ms(lambda: fused_step_2d(*a2, axes_seq=seq2), 50)
    t2b = _time_ms(lambda: fused_step_2d(*a16, axes_seq=seq2), 50)
    t21 = _time_ms(lambda: (fused_step_2d(*a2, axes_seq=seq2[:1]),
                            fused_step_2d(*a2, axes_seq=seq2[1:])), 50)
    p2 = _time_ms(lambda: fused_step_2d_reference(*a2, axes_seq=seq2), 5)
    cells2 = int(np.prod(task2.grid.shape))
    bound2 = _bound_entry(B_FUSED2 * cells2,
                          2 * _step_flops(eng2.model, task2.order, cells2))
    bound2b = _bound(B_FUSED2_BF16 * cells2, 0)[0]
    print(f"fused_step_2d two steps at {tuple(eng2.u.shape)}: kernel "
          f"{t2:.4f} ms a pass ({t2 / 2:.4f} a step), bf16 {t2b:.4f} ms, "
          f"two one-step launches {t21:.4f} ms, plain {p2:.4f} ms, bound "
          f"{bound2['bound_ms']:.4f} ms (bf16 {bound2b:.4f})")
    result["fused_step_2d_k2"] = dict(
        launches=launched2["fused_step_2d_k2"], max_abs_err=max_abs2, ms=t2,
        plain_ms=p2, bf16_ms=t2b, bf16_bound_ms=bound2b,
        one_step_pair_ms=t21, **bound2,
        **_occupancy(fused_step_2d_occupancy(*a2, axes_seq=seq2)))


# ------------------------------------------------------- orthotropic media

def _orthotropic(m):
    """The orthotropic medium built on the isotropic ``m``: c33 = lam+2mu,
    c11 = 1.3 c33, c22 = 1.1 c33, c12 = c13 = c23 = lam, c44 = mu,
    c55 = 1.15 mu, c66 = 1.3 mu. Its 6x6 Voigt matrix must be positive
    definite."""
    from gcm_tpu_torch.materials import OrthotropicMaterial
    from gcm_tpu_torch.oracle.oracle_ortho import _stiffness_matrix

    c33 = m.lam + 2.0 * m.mu
    o = OrthotropicMaterial(rho=m.rho, c11=1.3 * c33, c12=m.lam, c13=m.lam,
                            c22=1.1 * c33, c23=m.lam, c33=c33, c44=m.mu,
                            c55=1.15 * m.mu, c66=1.3 * m.mu)
    ev = np.linalg.eigvalsh(_stiffness_matrix(o, 3))
    _check(ev.min() > 0, f"{o} is not positive definite")
    return o


def _orthoize(task):
    """``task`` with every material region made :func:`_orthotropic`."""
    return dataclasses.replace(
        task, default_material=_orthotropic(task.default_material),
        materials=tuple(dataclasses.replace(r, material=_orthotropic(
            r.material)) for r in task.materials))


def _ortho_problem(rng, shape, name):
    """Random heterogeneous orthotropic medium (the recipe of
    tests/test_fused_variants.py) and random float32 state on the card, dt
    at Courant number 0.5 on the smallest of (10, 12, 9): (model, state,
    OrthotropicMaterialFields, orthotropic stack, dt)."""
    from gcm_tpu_torch.materials import OrthotropicMaterialFields
    from gcm_tpu_torch.models.spec import get_model
    from gcm_tpu_torch.ops.fused import stack_mats

    model = get_model(name)
    ones = np.ones(shape)
    rho = 2500.0 * (1.0 + 0.2 * rng.random(shape))
    c = {"c11": 60e9 * (1 + 0.1 * rng.random(shape)), "c22": 45e9 * ones,
         "c33": 70e9 * (1 + 0.1 * rng.random(shape)), "c12": 12e9 * ones,
         "c13": 10e9 * ones, "c23": 14e9 * ones, "c44": 18e9 * ones,
         "c55": 22e9 * (1 + 0.1 * rng.random(shape)), "c66": 16e9 * ones}
    mat = OrthotropicMaterialFields.from_constants(rho, c, device="cuda")
    u0 = rng.standard_normal((model.ncomp,) + shape)
    u0[model.dim:] *= 1e6
    u = torch.tensor(u0, dtype=torch.float32, device="cuda")
    ms = stack_mats(model, mat)
    _check(ms.shape[0] == {3: 13, 2: 6}[model.dim],
           f"{name}: orthotropic stack of {ms.shape[0]} fields")
    return model, u, mat, ms, 0.5 * 9.0 / mat.max_cp()


def ortho_kernels_vs_plain():
    """Phase 15, first part: every kernel of the structured paths on
    orthotropic stacks or views against its plain version on the same
    inputs (under 2e-6 a step), and one float32 step of each fused kernel
    against the float64 plain step on the fields (under 3e-6, the JAX
    limit: the stack's v = sqrt(c/rho) rounds in float32)."""
    from gcm_tpu_torch.ops.fused import (
        fused_step, fused_step_2d, fused_step_2d_reference,
        fused_step_reference, fused_step_slab, fused_step_slab_reference)
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_2d, fused_spmd_2d_reference, fused_spmd_interior,
        fused_spmd_interior_reference, fused_spmd_ring,
        fused_spmd_ring_reference)
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.ops.sweep import sweep_stage
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack, extended_mstack_2d, face_flags,
        make_fused_spmd_step, make_fused_spmd_step_2d)
    from gcm_tpu_torch.parallel.sharding import (
        domain_mesh, gather_state, shard_state)
    from gcm_tpu_torch.solver.gcm import stage, step

    rng = np.random.default_rng(6)
    h3 = (10.0, 12.0, 9.0)
    dev = torch.device("cuda", 0)
    worst, nlaunch = {}, {}

    def hold(kernel, tag, got, want, steps=1):
        err = _norm_err(got, want)
        _check(err < 2e-6 * steps,
               f"{kernel} on an orthotropic stack, {tag}: err {err:.3e}")
        worst[kernel] = max(worst.get(kernel, 0.0), err / steps)
        nlaunch[kernel] = nlaunch.get(kernel, 0) + 1

    def exact(kernel, tag, got, model, u, mat, dt, h, order, bc, axes):
        """A float32 kernel step against the float64 plain step."""
        want = step(model, u.double(), _mat_as(mat, torch.float64), dt, h,
                    order, bc, axes)
        err = _norm_err(got.double(), want)
        _check(err < 3e-6, f"{kernel} orthotropic {tag} vs the float64 "
               f"plain step: err {err:.3e}")
        key = kernel + " vs float64"
        worst[key] = max(worst.get(key, 0.0), err)

    for shape in ((24, 40, 56), (64, 64, 32)):
        for order in (1, 2, 3):
            for axes in ((0, 1, 2), (2, 1, 0)):
                model, u, mat, ms, dt = _ortho_problem(rng, shape,
                                                       "elastic3d")
                args = (model, u, ms, dt, h3, order, _borders(3), axes)
                got = fused_step(*args)
                torch.cuda.synchronize()
                tag = f"{shape} order {order} axes {axes}"
                hold("fused_step", tag, got, fused_step_reference(*args))
                exact("fused_step", tag, got, model, u, mat, dt, h3, order,
                      _borders(3), axes)

    orders3 = list(itertools.permutations(range(3)))
    for shape in ((24, 40, 56), (9, 17, 2)):
        for order in (1, 2, 3, 4):
            model, u, mat, ms, dt = _ortho_problem(rng, shape, "elastic3d")
            # two steps a pass in every order pair on the ragged shape
            seqs = [(ax,) for ax in ((0, 1, 2), (2, 1, 0), (2, 0, 1))] + (
                list(itertools.product(orders3, orders3)) if shape[0] == 24
                else [(ax, ax[::-1]) for ax in orders3])
            for stack in (ms, ms.to(torch.bfloat16)):
                for seq in seqs:
                    ax = seq[0]
                    args = (model, u, stack, dt, h3, order, _borders(3))
                    got = fused_step_slab(*args, axes_seq=seq)
                    torch.cuda.synchronize()
                    tag = f"{shape} order {order} {stack.dtype} {seq}"
                    hold("fused_step_slab", tag, got,
                         fused_step_slab_reference(*args, axes_seq=seq),
                         len(seq))
                    if stack is ms and len(seq) == 1:
                        exact("fused_step_slab", tag, got, model, u, mat,
                              dt, h3, order, _borders(3), ax)

    for shape in ((37, 61), (64, 128)):
        for order in (1, 2, 3, 4):
            model, u, mat, ms, dt = _ortho_problem(rng, shape, "elastic2d")
            for stack, k in ((ms, 1), (ms.to(torch.bfloat16), 1), (ms, 2),
                             (ms.to(torch.bfloat16), 2)):
                for seq in _seqs_2d(k):
                    args = (model, u, stack, dt, h3[:2], order, _borders(2))
                    got = fused_step_2d(*args, axes_seq=seq)
                    torch.cuda.synchronize()
                    tag = f"{shape} order {order} {stack.dtype} {seq}"
                    hold("fused_step_2d", tag, got,
                         fused_step_2d_reference(*args, axes_seq=seq), k)
                    if stack is ms and k == 1:
                        exact("fused_step_2d", tag, got, model, u, mat, dt,
                              h3[:2], order, _borders(2), seq[0])

    for name, shape in (("elastic3d", (24, 40, 56)), ("elastic2d", (37, 61))):
        for order in (1, 2, 3, 4):
            model, u, mat, _, dt = _ortho_problem(rng, shape, name)
            for axis in range(model.dim):
                args = (model, u, mat, dt, h3[:model.dim], axis, order,
                        _borders(model.dim))
                got = sweep_stage(*args)
                torch.cuda.synchronize()
                hold("sweep_stage", f"{name} axis {axis} order {order}", got,
                     stage(*args))

    # the SPMD kernels on 2x2 (3D) and sx = 2 (2D) shards of cuda:0
    for shape, order, axes in (((64, 48, 16), 1, (0, 1, 2)),
                               ((64, 48, 16), 2, (2, 1, 0)),
                               ((50, 38, 20), 3, (0, 1, 2)),
                               ((50, 38, 20), 2, (2, 1, 0))):
        model, u, mat, ms, dt = _ortho_problem(rng, shape, "elastic3d")
        mesh = domain_mesh(3, [dev] * 4, (2, 2))
        mext = extended_mstack(model, mat, mesh, order)
        _check(all(m.shape[0] == 13 for m in mext),
               "the orthotropic extended stacks are not 13 fields")
        us = shard_state(u, mesh)
        slabs = exchange_slabs(us, mesh, stencil_radius(order))
        bc = _borders(3)
        tag = f"{shape} order {order} axes {axes}"
        for k, uk in enumerate(us):
            args = (model, uk, mext[k], dt, h3, order, bc, axes)
            got = fused_spmd_interior(*args, out=torch.zeros_like(uk))
            rargs = (model, uk, mext[k], slabs[k], face_flags(mesh, k),
                     torch.zeros_like(uk), dt, h3, order, bc, axes)
            ring = fused_spmd_ring(*rargs)
            torch.cuda.synchronize()
            hold("fused_spmd_interior", f"{tag} shard {k}", got,
                 fused_spmd_interior_reference(*args,
                                               out=torch.zeros_like(uk)))
            hold("fused_spmd_ring", f"{tag} shard {k}", ring,
                 fused_spmd_ring_reference(*rargs))
        got = gather_state(make_fused_spmd_step(model, mesh, dt, h3, order,
                                                bc)(us, mext, axes), mesh)
        hold("sharded 3D step", tag, got,
             fused_step_reference(model, u, ms, dt, h3, order, bc, axes))
        exact("sharded 3D step", tag, got, model, u, mat, dt, h3, order, bc,
              axes)

    for order in (1, 2, 3, 4):
        for bf16 in (False, True):
            model, u, mat, ms, dt = _ortho_problem(rng, (512, 70),
                                                   "elastic2d")
            mesh = domain_mesh(2, [dev] * 2)
            mext = extended_mstack_2d(model, mat, mesh, order,
                                      torch.bfloat16 if bf16 else None)
            _check(all(m.shape[0] == 6 for m in mext),
                   "the orthotropic 2D extended stacks are not 6 fields")
            us = shard_state(u, mesh)
            slabs = exchange_slabs(us, mesh, stencil_radius(order), dim=2)
            bc = _borders(2)
            tag = f"order {order} bf16 {bf16}"
            for k, uk in enumerate(us):
                for which in ("interior", "ring"):
                    args = (model, uk, mext[k], dt, h3[:2], order, bc,
                            (0, 1), which, slabs[k], face_flags(mesh, k)[:2])
                    got = fused_spmd_2d(*args, torch.zeros_like(uk))
                    torch.cuda.synchronize()
                    hold("fused_spmd_2d", f"{which} {tag} shard {k}", got,
                         fused_spmd_2d_reference(*args,
                                                 torch.zeros_like(uk)))
            if not bf16:
                got = gather_state(make_fused_spmd_step_2d(
                    model, mesh, dt, h3[:2], order, bc)(us, mext, (0, 1)),
                    mesh)
                hold("sharded 2D step", tag, got, fused_step_reference(
                    model, u, ms, dt, h3[:2], order, bc, (0, 1)))
                exact("sharded 2D step", tag, got, model, u, mat, dt,
                      h3[:2], order, bc, (0, 1))

    for kernel, n in nlaunch.items():
        f64 = worst.get(kernel + " vs float64")
        print(f"{kernel} on orthotropic stacks vs plain: {n} cases, worst "
              f"normalized error a step {worst[kernel]:.3e} (limit 2e-6)"
              + ("" if f64 is None else f"; float32 vs the float64 plain "
                 f"step on the fields {f64:.3e} (limit 3e-6)"))


def _ortho_entry(result, name, launches, max_abs, ms, plain_ms, nbytes,
                 flops):
    """The orthotropic form's keys in kernel ``name``'s JSON entry."""
    result[name].update(ortho_launches=launches, ortho_max_abs_err=max_abs,
                        ortho_ms=ms, ortho_plain_ms=plain_ms,
                        ortho_bound_ms=_bound(nbytes, flops)[0])
    print(f"{name} orthotropic: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {result[name]['ortho_bound_ms']:.4f} ms; isotropic kernel "
          f"{result[name]['ms']:.4f} ms")


def ortho_paths(counts, result):
    """Phase 15, second part: the orthotropic paths at full width, each
    kernel's orthotropic form held and timed on its path's own state. The
    kernels are the ones the isotropic phases built and warmed, so no run
    here is warmed."""
    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.materials import OrthotropicMaterialFields
    from gcm_tpu_torch.ops.fused import (
        fused_step, fused_step_2d, fused_step_2d_reference,
        fused_step_reference, fused_step_slab, fused_step_slab_reference)
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_2d, fused_spmd_2d_reference, fused_spmd_interior,
        fused_spmd_interior_reference, fused_spmd_ring,
        fused_spmd_ring_reference)
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.ops.sweep import sweep_stage
    from gcm_tpu_torch.parallel.fused_spmd import exchange_slabs, face_flags
    from gcm_tpu_torch.parallel.sharding import domain_mesh
    from gcm_tpu_torch.scenarios import elastic3d_contact, get_scenario
    from gcm_tpu_torch.solver.gcm import stage

    dev = torch.device("cuda", 0)

    def steps_of(task, n, **kw):
        return dataclasses.replace(task, time=dataclasses.replace(
            task.time, nsteps=n), **kw)

    # ---- the 3D orthotropic path
    task = _orthoize(get_scenario("elastic3d_explosion", n=N_MAIN,
                                  nsteps=NSTEPS))
    eng = Engine(task, device="cuda")
    _check(isinstance(eng.mat, OrthotropicMaterialFields)
           and eng._mstack.shape[0] == 13,
           "the orthotropic 3D path does not carry a 13-field stack")
    counts.zero()
    res = eng.run()
    launched = counts.read()
    _check(res.kernel == "fused", f"ortho 3D path resolved to {res.kernel!r}")
    counts.expect("orthotropic 3D path", launched, fused_step=NSTEPS)
    _check(np.isfinite(res.u).all() and np.isfinite(res.traces).all(),
           "orthotropic 3D path: state or traces not finite")
    vz_surface = np.abs(res.u[eng.model.comp("vz"), :, :, 0]).max()
    _check(vz_surface > 0 and np.abs(res.traces).max() > 0,
           "orthotropic 3D path: no motion at the free surface or zero "
           "traces")
    res_t = Engine(dataclasses.replace(task, kernel="torch"),
                   device="cuda").run()
    err = _np_err(res.u, res_t.u)
    _check(err < PATH_TOL, f"ortho fused vs torch path: err {err:.3e}")
    print(f"orthotropic 3D path {task.grid.shape} x {NSTEPS} steps: fused "
          f"{res.points_per_second:.6g} points/s, torch "
          f"{res_t.points_per_second:.6g} points/s; normalized error "
          f"{err:.3e} (limit 1e-4); |vz| at z=0 {vz_surface:.3e}; "
          f"{launched['fused_step']} fused_step launches")
    model, h, order, bc = eng.model, task.grid.h, task.order, task.borders
    npts = int(np.prod(task.grid.shape))
    flops = _step_flops(model, order, npts)
    args = (model, eng.u, eng._mstack, eng.dt, h, order, bc, (0, 1, 2))
    *_, max_abs = _hold_on_path_state("fused_step on the orthotropic 3D "
                                      "state", fused_step,
                                      fused_step_reference, args)
    _ortho_entry(result, "fused_step", launched["fused_step"], max_abs,
                 _time_ms(lambda: fused_step(*args), 20),
                 _time_ms(lambda: fused_step_reference(*args), 5),
                 B_FUSED3_ORTHO * npts, flops)

    # the per-sweep kernel on the same state, through views computed once
    views = eng._sweep_mat
    sw_ms, sw_plain, sw_err = [], [], 0.0
    for axis in range(3):
        a = (model, eng.u, eng.mat, eng.dt, h, axis, order, bc)
        *_, e = _hold_on_path_state(
            f"sweep_stage on the orthotropic 3D state, axis {axis}",
            lambda m, u, _mat, *rest: sweep_stage(m, u, views, *rest),
            lambda m, u, mat, *rest: stage(m, u, _mat_as(mat, u.dtype),
                                           *rest), a)
        sw_err = max(sw_err, e)
        sw_ms.append(_time_ms(lambda: sweep_stage(model, eng.u, views,
                                                  *a[3:]), 20))
        sw_plain.append(_time_ms(lambda: stage(*a), 5))
        print(f"sweep_stage orthotropic axis {axis}: kernel {sw_ms[-1]:.4f} "
              f"ms, plain {sw_plain[-1]:.4f} ms")
    del eng, res, res_t, args, views

    # ---- anisotropy: the wavefront on the source's horizontal plane
    ta = steps_of(task, NSTEPS_ANISO)
    resa = Engine(ta, device="cuda").run()
    i, j, k = ta.grid.index_of(ta.sources[0].position)
    vmag = np.sqrt((resa.u[:3].astype(np.float64) ** 2).sum(0))
    thresh = ANISO_FRAC * vmag[:, :, k].max()
    faces = max(vmag[(slice(None),) * a + (e,)].max()
                for a in range(3) for e in (0, -1))
    _check(faces < thresh, f"anisotropy check: after {NSTEPS_ANISO} steps "
           f"|v| {faces:.3e} at a border exceeds the front level {thresh:.3e}")
    reach_x = np.abs(np.nonzero(vmag[:, j, k] > thresh)[0] - i).max()
    reach_y = np.abs(np.nonzero(vmag[i, :, k] > thresh)[0] - j).max()
    src = task.default_material      # the last region holding the source
    for region in task.materials:
        if region.area.mask(task.grid)[i, j, k]:
            src = region.material
    want = float(np.sqrt(src.c11 / src.c22))
    ratio = reach_x / reach_y
    _check(reach_x > reach_y and abs(ratio - want) <= ANISO_TOL * want,
           f"anisotropy: reach x {reach_x}, y {reach_y} cells, ratio "
           f"{ratio:.4f}, sqrt(c11/c22) {want:.4f}")
    print(f"orthotropic anisotropy after {NSTEPS_ANISO} steps "
          f"({NSTEPS_ANISO * resa.dt:.4f} s): the front at {ANISO_FRAC} of "
          f"max|v| reaches {reach_x} cells along x and {reach_y} along y "
          f"from the source, ratio {ratio:.4f} against sqrt(c11/c22) "
          f"{want:.4f} (rtol {ANISO_TOL}); largest |v| on a border "
          f"{faces / thresh:.3f} of the front level")
    del resa, vmag

    # ---- the per-sweep orthotropic path, against the fused one
    t100 = steps_of(task, NSTEPS_ORTHO_SHORT)
    eng7 = Engine(dataclasses.replace(t100, kernel="sweep"), device="cuda")
    counts.zero()
    res7 = eng7.run()
    launched7 = counts.read()
    counts.expect("orthotropic sweep path", launched7,
                  sweep_stage=3 * NSTEPS_ORTHO_SHORT)
    res_f = Engine(t100, device="cuda").run()
    err7 = _np_err(res7.u, res_f.u)
    _check(err7 < PATH_TOL, f"ortho sweep vs fused path: err {err7:.3e}")
    print(f"orthotropic sweep path x {NSTEPS_ORTHO_SHORT} steps: "
          f"{res7.points_per_second:.6g} points/s (fused "
          f"{res_f.points_per_second:.6g}); {launched7['sweep_stage']} "
          f"sweep_stage launches; vs fused normalized error {err7:.3e} "
          f"(limit 1e-4)")
    _ortho_entry(result, "sweep_stage", launched7["sweep_stage"], sw_err,
                 float(np.mean(sw_ms)), float(np.mean(sw_plain)),
                 B_SWEEP_ORTHO * npts, flops / 3)
    del eng7, res7

    # ---- the sharded orthotropic path (2x2 shards of cuda:0)
    mesh4 = domain_mesh(3, [dev] * 4, (2, 2))
    eng4 = Engine(t100, mesh=mesh4)
    _check(all(m.shape[0] == 13 for m in eng4._carry),
           "the sharded orthotropic path's stacks are not 13 fields")
    counts.zero()
    res4 = eng4.run()
    launched4 = counts.read()
    counts.expect("orthotropic sharded path", launched4,
                  fused_spmd_interior=4 * NSTEPS_ORTHO_SHORT,
                  fused_spmd_ring=4 * NSTEPS_ORTHO_SHORT)
    err4 = _np_err(res4.u, res_f.u)
    _check(err4 < 2e-6, f"ortho sharded vs unsharded: err {err4:.3e}")
    print(f"orthotropic sharded path 2x2 x {NSTEPS_ORTHO_SHORT} steps: "
          f"{res4.points_per_second:.6g} points/s; "
          f"{launched4['fused_spmd_interior']} interior + "
          f"{launched4['fused_spmd_ring']} ring launches, 0 fused_step; vs "
          f"unsharded fused normalized error {err4:.3e} (limit 2e-6), max "
          f"|difference| {np.abs(res4.u - res_f.u).max():.3e}")
    r = stencil_radius(order)
    u0, m0 = eng4.u[0], eng4._carry[0]
    slabs = exchange_slabs(eng4.u, mesh4, r)
    f0 = face_flags(mesh4, 0)
    iargs = (model, u0, m0, eng4.dt, h, order, bc, (0, 1, 2))
    *_, e_in = _hold_on_path_state(
        "fused_spmd_interior on an orthotropic shard",
        lambda *a: fused_spmd_interior(*a, out=torch.zeros_like(u0)),
        lambda *a: fused_spmd_interior_reference(
            *a, out=torch.zeros_like(a[1])), iargs)
    rargs = (model, u0, m0, slabs[0], f0)
    rrest = iargs[3:]
    *_, e_ring = _hold_on_path_state(
        "fused_spmd_ring on an orthotropic shard",
        lambda m, u, me, sl, f, *rest: fused_spmd_ring(
            m, u, me, sl, f, torch.zeros_like(u), *rest),
        lambda m, u, me, sl, f, *rest: fused_spmd_ring_reference(
            m, u, me, tuple(x.to(u.dtype) for x in sl), f,
            torch.zeros_like(u), *rest), rargs + rrest)
    base = torch.zeros_like(u0)
    for name, which, e, kern, ref in (
            ("fused_spmd_interior", "interior", e_in,
             lambda: fused_spmd_interior(*iargs, out=base),
             lambda: fused_spmd_interior_reference(*iargs, out=base)),
            ("fused_spmd_ring", "ring", e_ring,
             lambda: fused_spmd_ring(*rargs, base, *rrest),
             lambda: fused_spmd_ring_reference(*rargs, base, *rrest))):
        nbytes, cells = _spmd_bytes(model, u0.shape, r, which, m0.shape[0])
        _ortho_entry(result, name, launched4[name], e, _time_ms(kern, 50),
                     _time_ms(ref, 5), nbytes,
                     _step_flops(model, order, cells))
    del eng4, res4, u0, m0, slabs, base

    # ---- the bf16 orthotropic stack, through fused_step_slab
    eng16 = Engine(dataclasses.replace(t100, mat_dtype="bf16"), device="cuda")
    counts.zero()
    res16 = eng16.run()
    launched16 = counts.read()
    counts.expect("orthotropic bf16 path", launched16,
                  fused_step_slab=NSTEPS_ORTHO_SHORT)
    dev16 = _np_err(res16.u, res_f.u)
    _check(0.0 < dev16 < BF16_PATH_TOL,
           f"ortho bf16 vs float32 path: deviation {dev16:.3e}")
    print(f"orthotropic bf16 path x {NSTEPS_ORTHO_SHORT} steps: "
          f"{res16.points_per_second:.6g} points/s (float32 "
          f"{res_f.points_per_second:.6g}); deviation from the float32 run "
          f"{dev16:.3e} (limit {BF16_PATH_TOL})")
    ms16 = eng16._mstack
    for tag, stack, seq in (("bf16 K=1", ms16, ((0, 1, 2),)),
                            ("bf16 K=2", ms16, ((0, 1, 2), (2, 1, 0)))):
        a = (model, eng16.u, stack, eng16.dt, h, order, bc)
        *_, e = _hold_on_path_state(
            f"fused_step_slab {tag} on the orthotropic bf16 state",
            fused_step_slab, fused_step_slab_reference, a,
            dict(axes_seq=seq), steps=len(seq))
        t = _time_ms(lambda: fused_step_slab(*a, axes_seq=seq), 20)
        p = _time_ms(lambda: fused_step_slab_reference(*a, axes_seq=seq), 3)
        if len(seq) == 1:
            _ortho_entry(result, "fused_step_slab",
                         launched16["fused_step_slab"], e, t, p,
                         B_SLAB_BF16_ORTHO * npts, flops)
        else:
            print(f"fused_step_slab orthotropic {tag}: kernel {t:.4f} ms a "
                  f"launch ({t / 2:.4f} a step), plain {p:.4f} ms")
    del eng16, res16, res_f, ms16

    # ---- the 2D orthotropic path, and on sx = 4 shards
    task2 = _orthoize(get_scenario("elastic2d_viscoelastic", n=N_2D,
                                   nsteps=NSTEPS_2D_CMP))
    eng2 = Engine(task2, device="cuda")
    _check(eng2._mstack.shape[0] == 6,
           "the orthotropic 2D path does not carry a 6-field stack")
    counts.zero()
    res2 = eng2.run()
    launched2 = counts.read()
    counts.expect("orthotropic 2D path", launched2,
                  fused_step_2d=NSTEPS_2D_CMP)
    # (its receiver, 250 m from the source, hears the wave only after
    # ~1000 steps, so the state is checked, not the traces)
    _check(np.isfinite(res2.u).all() and np.abs(res2.u).max() > 0,
           "orthotropic 2D path: state not finite or zero")
    res2t = Engine(dataclasses.replace(task2, kernel="torch"),
                   device="cuda").run()
    err2 = _np_err(res2.u, res2t.u)
    _check(err2 < PATH_TOL, f"ortho 2D fused vs torch: err {err2:.3e}")
    print(f"orthotropic 2D path {task2.grid.shape} x {NSTEPS_2D_CMP} steps: "
          f"fused {res2.points_per_second:.6g} points/s, torch "
          f"{res2t.points_per_second:.6g} points/s; normalized error "
          f"{err2:.3e} (limit 1e-4); {launched2['fused_step_2d']} "
          f"fused_step_2d launches")
    m2, h2, o2, bc2 = eng2.model, task2.grid.h, task2.order, task2.borders
    npts2 = int(np.prod(task2.grid.shape))
    args2 = (m2, eng2.u, eng2._mstack, eng2.dt, h2, o2, bc2, (0, 1))
    *_, e2 = _hold_on_path_state("fused_step_2d on the orthotropic 2D state",
                                 fused_step_2d, fused_step_2d_reference,
                                 args2)
    _ortho_entry(result, "fused_step_2d", launched2["fused_step_2d"], e2,
                 _time_ms(lambda: fused_step_2d(*args2), 50),
                 _time_ms(lambda: fused_step_2d_reference(*args2), 10),
                 B_FUSED2_ORTHO * npts2, _step_flops(m2, o2, npts2))
    # the two-step pass of the 2D pair-fused path on the orthotropic state
    seq2 = ((0, 1), (1, 0))
    a2 = args2[:7]
    *_, e2k = _hold_on_path_state(
        f"two-step fused_step_2d {seq2} on the orthotropic 2D state",
        fused_step_2d, fused_step_2d_reference, a2, dict(axes_seq=seq2),
        steps=2)
    k2 = result["fused_step_2d_k2"]
    k2.update(ortho_max_abs_err=e2k,
              ortho_ms=_time_ms(lambda: fused_step_2d(*a2, axes_seq=seq2),
                                50),
              ortho_plain_ms=_time_ms(
                  lambda: fused_step_2d_reference(*a2, axes_seq=seq2), 5),
              ortho_bound_ms=_bound(B_FUSED2_ORTHO * npts2,
                                    2 * _step_flops(m2, o2, npts2))[0])
    print(f"fused_step_2d two steps orthotropic: kernel {k2['ortho_ms']:.4f}"
          f" ms a pass, plain {k2['ortho_plain_ms']:.4f} ms, bound "
          f"{k2['ortho_bound_ms']:.4f} ms; isotropic kernel {k2['ms']:.4f} "
          f"ms")
    del eng2, res2, res2t, args2, a2

    t2s = steps_of(task2, NSTEPS_ORTHO_SHORT)
    mesh2 = domain_mesh(2, [dev] * 4)
    eng2s = Engine(t2s, mesh=mesh2)
    counts.zero()
    res2s = eng2s.run()
    launched2s = counts.read()
    counts.expect("orthotropic sharded 2D path", launched2s,
                  fused_spmd_2d=2 * 4 * NSTEPS_ORTHO_SHORT)
    _check(fused_spmd_2d.ring_launches == 4 * NSTEPS_ORTHO_SHORT,
           f"ortho sharded 2D: {fused_spmd_2d.ring_launches} ring launches")
    res2u = Engine(t2s, device="cuda").run()
    err2s = _np_err(res2s.u, res2u.u)
    _check(err2s < PATH_TOL, f"ortho sharded vs unsharded 2D: {err2s:.3e}")
    print(f"orthotropic sharded 2D path on sx=4 x {NSTEPS_ORTHO_SHORT} "
          f"steps: {res2s.points_per_second:.6g} points/s (unsharded "
          f"{res2u.points_per_second:.6g}); "
          f"{launched2s['fused_spmd_2d']} fused_spmd_2d launches; vs "
          f"unsharded normalized error {err2s:.3e} (limit 1e-4)")
    r2 = stencil_radius(o2)
    u2, me2 = eng2s.u[1], eng2s._carry[1]
    sl2 = exchange_slabs(eng2s.u, mesh2, r2, dim=2)[1]
    f21 = face_flags(mesh2, 1)[:2]
    a2 = (m2, u2, me2, eng2s.dt, h2, o2, bc2, (0, 1))
    e2s = 0.0
    for which in ("interior", "ring"):
        *_, e = _hold_on_path_state(
            f"fused_spmd_2d {which} on an orthotropic 2D shard",
            lambda *a, w=which: fused_spmd_2d(*a, w, sl2, f21,
                                              torch.zeros_like(u2)),
            lambda *a, w=which: fused_spmd_2d_reference(
                *a, w, tuple(x.to(a[1].dtype) for x in sl2), f21,
                torch.zeros_like(a[1])), a2)
        e2s = max(e2s, e)
    b2 = torch.zeros_like(u2)

    def both(fn):
        return lambda: [fn(*a2, w, sl2, f21, b2) for w in ("interior",
                                                            "ring")]

    nb2 = sum(_spmd_bytes(m2, u2.shape, r2, w, me2.shape[0])[0]
              for w in ("interior", "ring"))
    _ortho_entry(result, "fused_spmd_2d", launched2s["fused_spmd_2d"], e2s,
                 _time_ms(both(fused_spmd_2d), 50),
                 _time_ms(both(fused_spmd_2d_reference), 10), nb2,
                 _step_flops(m2, o2, u2[0].numel()))
    del eng2s, res2s, res2u, u2, me2, sl2, b2

    # ---- orthotropic contact: the canonical layout stays off
    bodies, contacts = elastic3d_contact(n=N_CONTACT, nsteps=NSTEPS_CONTACT)
    bodies = {k: _orthoize(t) for k, t in bodies.items()}
    engc = MultiBodyEngine(bodies, contacts, device="cuda",
                           canonical_layout=True)
    _check(engc.path == "fused" and engc._fwd == (0, 1, 2)
           and all(m.shape[0] == 13 for m in engc._mstacks.values()),
           f"orthotropic contact path {engc.path!r}, order {engc._fwd}")
    counts.zero()
    resc = engc.run()
    counts.expect("orthotropic contact path", counts.read(),
                  fused_step=2 * NSTEPS_CONTACT)
    v_up = float(np.abs(resc.bodies["upper"][:3]).max())
    _check(all(np.isfinite(v).all() for v in resc.bodies.values())
           and v_up > 0, "orthotropic contact path: state not finite or "
           "the upper body did not move")
    plain = {k: dataclasses.replace(t, kernel="torch")
             for k, t in bodies.items()}
    refc = MultiBodyEngine(plain, contacts, device="cuda").run()
    errc = _bodies_err(resc, refc)
    ndiff = int((resc.bonded[0] != refc.bonded[0]).sum())
    if ndiff:
        # as on the isotropic contact path: a cell within round-off of the
        # strength may break in one version only; then the state is held
        # without fracture and the masks to 0.1% of the cells
        free = tuple(dataclasses.replace(c, tensile_strength=None)
                     for c in contacts)
        errc = _bodies_err(
            MultiBodyEngine(bodies, free, device="cuda").run(),
            MultiBodyEngine(plain, free, device="cuda").run())
        print(f"  {ndiff} mask cells differ; without fracture the two paths "
              f"agree to {errc:.3e}")
    _check(errc < PATH_TOL and ndiff <= 0.001 * resc.bonded[0].size,
           f"ortho contact vs plain: err {errc:.3e}, {ndiff} mask cells "
           "differ")
    npc = sum(int(np.prod(t.grid.shape)) for t in bodies.values())
    print(f"orthotropic contact path 2 x {bodies['upper'].grid.shape} x "
          f"{NSTEPS_CONTACT} steps, canonical_layout=True -> path "
          f"{engc.path!r}, order {engc._fwd}: {resc.points_per_second:.6g} "
          f"points/s ({npc} points), {2 * NSTEPS_CONTACT} fused_step "
          f"launches; upper body max|v| {v_up:.4e}; bond mask mean "
          f"{resc.bonded[0].mean():.6f}; vs the plain path "
          f"({refc.points_per_second:.6g} points/s) normalized error "
          f"{errc:.3e} (limit 1e-4), mask cells that differ {ndiff}")


# ------------------------------------------------------- outputs and resume

#: the outputs phase: elastic3d_explosion at 256x256x128 for 120 steps with
#: snapshots (vz, szz and the velocity vector) every 60 steps and
#: checkpoints every 40, so the callback fires every 20 steps and the state
#: leaves the card at 40, 60, 80 and 120 only; resumed from the checkpoint
#: at 80 and from an odd cut at 41. The pair-fused body runs 40 steps cut
#: at 21, the contact path 100 cut at 51 (and n=32 from a partly broken
#: mask, 32 steps cut at 17, before the interface breaks further), the
#: simplex path 40 steps with snapshots and checkpoints every 20.
NSTEPS_OUT, SNAP_OUT, CK_OUT, CUT_OUT, ODD_CUT_OUT = 120, 60, 40, 80, 41
NSTEPS_PAIR_OUT, CUT_PAIR_OUT = 40, 21
NSTEPS_CONTACT_OUT, CK_CONTACT_OUT, CUT_CONTACT_OUT = 100, 50, 51
NSTEPS_CONTACT32, CUT_CONTACT32 = 32, 17
NSTEPS_SIMPLEX_OUT, EVERY_SIMPLEX_OUT = 40, 20


def _same_state(tag, pairs):
    """Fail unless each (got, want) pair of tensors or arrays is equal."""
    for name, a, b in pairs:
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        b = b if isinstance(b, torch.Tensor) else torch.from_numpy(b)
        _check(a.shape == b.shape and torch.equal(a.cpu(), b.cpu()),
               f"{tag}: {name} differs from the uninterrupted run "
               f"(normalized {_norm_err(a.cpu(), b.cpu()):.3e})")


def _through_file(ckdir, state):
    """``state`` saved as a checkpoint and restored: (restored, save s,
    restore s)."""
    from gcm_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    t0 = time.perf_counter()
    save_checkpoint(ckdir, int(state["step"]), state)
    t1 = time.perf_counter()
    out = restore_checkpoint(ckdir, step=int(state["step"]))
    return out, t1 - t0, time.perf_counter() - t1


def _launch_record(events):
    """The trace's kernel launch calls (``cudaLaunchKernel`` and its CUDA
    API kin) in host order, one letter each: F a launch whose kernel event
    is the fused step's, k another kernel's, ? a launch without a kernel
    event."""
    kernels = {e.get("args", {}).get("correlation"): e.get("name", "")
               for e in events if e.get("cat") == "kernel"}
    calls = sorted((e for e in events
                    if e.get("cat", "").startswith("cuda_")
                    and "LaunchKernel" in e.get("name", "")),
                   key=lambda e: e.get("ts", 0))
    out = []
    for e in calls:
        name = kernels.get(e.get("args", {}).get("correlation"))
        out.append("?" if name is None else
                   "F" if "fused_step_stream_kernel" in name else "k")
    return "".join(out)


def outputs_and_resume(counts, simplex_task, simplex_tables):
    """Phase 16: snapshots, seismograms, checkpoints and resume of the three
    engines at full width, and a profiled CLI run, in a temporary directory
    that is deleted after."""
    import contextlib
    import io
    import shutil
    import tempfile

    from gcm_tpu_torch import cli
    from gcm_tpu_torch.convert import bonded_from_numpy
    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.engine_multi import (
        MultiBodyEngine, write_body_snapshots)
    from gcm_tpu_torch.engine_simplex import SimplexEngine
    from gcm_tpu_torch.scenarios import elastic3d_contact, get_scenario
    from gcm_tpu_torch.snapshot import snapshot_fields, write_vti
    from gcm_tpu_torch.task import SnapshotSpec, TimeSpec
    from gcm_tpu_torch.utils.checkpoint import restore_checkpoint

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="outputs_", dir=build_dir)
    try:
        # (a) the 3D fused path with outputs, resumed at a checkpoint
        task = dataclasses.replace(
            get_scenario("elastic3d_explosion", n=N_MAIN, nsteps=NSTEPS_OUT),
            snapshots=SnapshotSpec(every=SNAP_OUT, fields=("vz", "szz")))
        plain = Engine(task, device="cuda").run()
        eng = Engine(task, device="cuda")
        out = os.path.join(root, "explosion")
        counts.zero()
        res = eng.run_with_outputs(out, checkpoint_every=CK_OUT)
        launched = counts.read()
        counts.expect("outputs path", launched, fused_step=NSTEPS_OUT)
        _check(eng.host_copies == [40, 60, 80, 120],
               f"outputs path: host copies at steps {eng.host_copies}")
        _same_state("outputs path against run()",
                    [("u", res.u, plain.u),
                     ("traces", res.traces, plain.traces)])
        snaps = sorted(os.listdir(os.path.join(out, "snapshots")))
        ckdir = os.path.join(out, "checkpoints")
        cks = sorted(os.listdir(ckdir))
        _check(snaps == ["elastic3d_explosion.pvd",
                         "elastic3d_explosion_000060.vti",
                         "elastic3d_explosion_000120.vti"]
               and cks == ["step_120.npz", "step_40.npz", "step_80.npz"]
               and os.path.exists(os.path.join(out, "elastic3d_explosion.npz")),
               f"outputs path wrote snapshots {snaps}, checkpoints {cks}")
        vti_mb = os.path.getsize(os.path.join(
            out, "snapshots", "elastic3d_explosion_000060.vti")) / 1e6
        ck_mb = os.path.getsize(os.path.join(ckdir, "step_80.npz")) / 1e6
        t0 = time.perf_counter()
        state = restore_checkpoint(ckdir, step=CUT_OUT)
        t_restore = time.perf_counter() - t0
        resumed = Engine(task, device="cuda")
        resumed.load_state(state)
        counts.zero()
        rres = resumed.run()
        counts.expect("resumed outputs path", counts.read(),
                      fused_step=NSTEPS_OUT - CUT_OUT)
        _same_state(f"resume at {CUT_OUT}", [
            ("u", resumed.u, eng.u), ("traces", rres.traces, res.traces)]
            + [(f"aux {k}", resumed.aux[k], v) for k, v in eng.aux.items()])
        del state, resumed
        shutil.rmtree(ckdir)
        # (b) an odd cut
        part = Engine(task, device="cuda")
        part.nsteps = ODD_CUT_OUT
        part.run()
        state, t_save, t_restore_odd = _through_file(
            os.path.join(root, "odd"), part.state_dict())
        del part
        odd = Engine(task, device="cuda")
        odd.load_state(state)
        ores = odd.run()
        _same_state(f"resume at {ODD_CUT_OUT}", [
            ("u", odd.u, eng.u), ("traces", ores.traces, res.traces)])
        del state, odd
        shutil.rmtree(os.path.join(root, "odd"))
        # what the outputs cost: a copy of the state, a .vti, a checkpoint
        torch.cuda.synchronize()
        copy_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            host = eng.u.cpu()
            copy_ms.append((time.perf_counter() - t0) * 1e3)
        fields = {k: v for k, v in snapshot_fields(
            eng.model, host.numpy()).items() if k in ("vz", "szz", "velocity")}
        t0 = time.perf_counter()
        write_vti(os.path.join(root, "t.vti"), task.grid.shape, task.grid.h,
                  task.grid.origin, fields)
        t_vti = time.perf_counter() - t0
        nbytes = eng.u.numel() * eng.u.element_size()
        print(f"outputs path {task.name} {task.grid.shape} x {NSTEPS_OUT} "
              f"steps, snapshots every {SNAP_OUT} ({vti_mb:.1f} MB .vti), "
              f"checkpoints every {CK_OUT} ({ck_mb:.1f} MB): run() "
              f"{plain.points_per_second:.6g} points/s, run_with_outputs() "
              f"{res.points_per_second:.6g} points/s ({launched['fused_step']}"
              f" fused_step launches), equal states and traces; host copies "
              f"at steps {eng.host_copies} (none at 20 or 100)")
        print(f"  device-to-host copy of the {nbytes / 1e6:.1f} MB state: "
              f"{', '.join(f'{t:.2f}' for t in copy_ms)} ms; .vti write "
              f"{t_vti:.3f} s; checkpoint save {t_save:.3f} s (state_dict "
              f"and file), restore {t_restore:.3f} s / {t_restore_odd:.3f} s")
        print(f"  resumed at {CUT_OUT} (a checkpoint) and at {ODD_CUT_OUT} "
              f"(odd): states and traces equal to the uninterrupted run (no "
              f"aux field); {rres.points_per_second:.6g} and "
              f"{ores.points_per_second:.6g} points/s over the steps run")
        del eng, plain, host, fields

        # (c) the pair-fused body from an odd step
        ptask = dataclasses.replace(
            get_scenario("elastic3d_layered", n=N_MAIN, nsteps=NSTEPS_PAIR_OUT),
            detectors=None, temporal_block=True)
        full = Engine(ptask, device="cuda")
        full.run()
        part = Engine(ptask, device="cuda")
        part.nsteps = CUT_PAIR_OUT
        part.run()
        state, *_ = _through_file(os.path.join(root, "pair"),
                                  part.state_dict())
        pres = Engine(ptask, device="cuda")
        pres.load_state(state)
        counts.zero()
        pres.run()
        npairs = (NSTEPS_PAIR_OUT - CUT_PAIR_OUT - 1) // 2
        counts.expect("resumed pair-fused path", counts.read(), fused_step=1,
                      fused_step_slab=npairs, fused_step_slab_k2=npairs)
        # the same continuation without the file
        part.start_step, part.nsteps = CUT_PAIR_OUT, NSTEPS_PAIR_OUT
        part.run()
        _same_state("pair-fused resume against its continuation",
                    [("u", pres.u, part.u)])
        # the uninterrupted run takes steps CUT - 1 and CUT in one two-step
        # pass, the cut run in two one-step launches: the same arithmetic
        _same_state("pair-fused resume against the uninterrupted run",
                    [("u", pres.u, full.u)])
        print(f"pair-fused {ptask.name} x {NSTEPS_PAIR_OUT} cut at "
              f"{CUT_PAIR_OUT}: one single step, then {npairs} two-step "
              f"passes; equal to the run continued without the checkpoint "
              f"and to the uninterrupted run")
        del full, part, pres, state
        shutil.rmtree(os.path.join(root, "pair"))

        # (d) the canonical contact path, then a partly broken mask at n=32
        bodies, contacts = elastic3d_contact(n=N_CONTACT,
                                             nsteps=NSTEPS_CONTACT_OUT)

        def contact(b=bodies, c=contacts, mask=None):
            e = MultiBodyEngine(b, c, device="cuda", canonical_layout=True)
            if mask is not None:
                e.bonded = bonded_from_numpy({0: mask}, device="cuda")
            return e

        full = contact()
        out = os.path.join(root, "contact")
        counts.zero()
        cres = full.run_with_outputs(out, checkpoint_every=CK_CONTACT_OUT)
        counts.expect("contact outputs path", counts.read(),
                      fused_step_slab=2 * NSTEPS_CONTACT_OUT)
        copies = list(full.host_copies)
        _check(copies == [50, 100], f"contact path: host copies at {copies}")
        t0 = time.perf_counter()
        write_body_snapshots(out, "final", full.tasks, full.model,
                             cres.bodies, cres.bonded)
        t_final = time.perf_counter() - t0
        shutil.rmtree(os.path.join(out, "checkpoints"))
        part = contact()
        part.nsteps = CUT_CONTACT_OUT
        part.run()
        state, t_csave, t_crestore = _through_file(
            os.path.join(root, "contact_ck"), part.state_dict())
        del part
        cr = contact()
        cr.load_state(state)
        crr = cr.run()
        _same_state(f"contact resume at {CUT_CONTACT_OUT}",
                    [(f"body {k}", cr.us[k], full.us[k]) for k in full.us]
                    + [(f"mask {k}", cr.bonded[k], full.bonded[k])
                       for k in full.bonded]
                    + [(f"traces {k}", crr.traces[k], cres.traces[k])
                       for k in (cres.traces or {})])
        print(f"contact path 2 x {N_CONTACT}x{N_CONTACT}x{N_CONTACT // 2} x "
              f"{NSTEPS_CONTACT_OUT} steps, checkpoints every "
              f"{CK_CONTACT_OUT}: {cres.points_per_second:.6g} points/s, "
              f"host copies at {copies}; final snapshots and masks "
              f"{t_final:.3f} s; resumed at {CUT_CONTACT_OUT} (save "
              f"{t_csave:.3f} s, restore {t_crestore:.3f} s): bodies, masks "
              f"and traces equal")
        del full, cr, state
        shutil.rmtree(os.path.join(root, "contact_ck"))
        b32, c32 = elastic3d_contact(n=32, nsteps=NSTEPS_CONTACT32)
        mask = (np.random.default_rng(3).random((32, 32)) > 0.3).astype(
            np.float32)
        full32 = contact(b32, c32, mask).run()
        part = contact(b32, c32, mask)
        part.nsteps = CUT_CONTACT32
        part.run()
        state, *_ = _through_file(os.path.join(root, "c32"),
                                  part.state_dict())
        at_cut = state["bonded"]["0"]
        r32 = contact(b32, c32)
        r32.load_state(state)
        rr32 = r32.run()
        _same_state("n=32 contact resume",
                    [(f"body {k}", rr32.bodies[k], full32.bodies[k])
                     for k in full32.bodies]
                    + [("mask", rr32.bonded[0], full32.bonded[0])])
        _check((rr32.bonded[0][at_cut == 0] == 0).all()
               and rr32.bonded[0].mean() < at_cut.mean(),
               "n=32 contact resume: a restored broken cell healed, or the "
               "interface did not break further")
        print(f"contact n=32 from a partly broken mask, cut at "
              f"{CUT_CONTACT32}: bond mean {mask.mean():.4f} at the start, "
              f"{at_cut.mean():.4f} at the cut, {rr32.bonded[0].mean():.4f} "
              f"at {NSTEPS_CONTACT32} steps, equal to the uninterrupted run; "
              f"no restored broken cell healed")
        del part, r32

        # (e) the simplex path on the 65^3 mesh of phase 8
        stask = dataclasses.replace(
            simplex_task, time=TimeSpec(cfl=simplex_task.time.cfl,
                                        nsteps=NSTEPS_SIMPLEX_OUT),
            snapshots=SnapshotSpec(every=EVERY_SIMPLEX_OUT))

        def sbuild():
            return SimplexEngine.from_task(stask, device="cuda",
                                           tables=simplex_tables)

        seng = sbuild()
        out = os.path.join(root, "simplex")
        counts.zero()
        sres = seng.run_with_outputs(out, checkpoint_every=EVERY_SIMPLEX_OUT)
        counts.expect("simplex outputs path", counts.read(),
                      simplex_sweep=3 * NSTEPS_SIMPLEX_OUT)
        snaps = sorted(os.listdir(os.path.join(out, "snapshots")))
        _check(seng.host_copies == [20, 40]
               and snaps == [f"{stask.name}.pvd", f"{stask.name}_000020.vtu",
                             f"{stask.name}_000040.vtu"],
               f"simplex outputs: copies {seng.host_copies}, files {snaps}")
        sr = sbuild()
        sr.load_state(restore_checkpoint(os.path.join(out, "checkpoints"),
                                         step=EVERY_SIMPLEX_OUT))
        srr = sr.run()
        _same_state("simplex resume",
                    [("u", sr.u, seng.u), ("traces", srr.traces, sres.traces)])
        vtu_mb = os.path.getsize(os.path.join(
            out, "snapshots", f"{stask.name}_000020.vtu")) / 1e6
        print(f"simplex path {simplex_task.grid.npoints} nodes x "
              f"{NSTEPS_SIMPLEX_OUT} steps with a .vtu ({vtu_mb:.1f} MB) and "
              f"a checkpoint every {EVERY_SIMPLEX_OUT}: "
              f"{sres.points_per_second:.6g} points/s; resumed at "
              f"{EVERY_SIMPLEX_OUT}: state and traces equal")
        del seng, sr

        # (f) a profiled CLI run
        out = os.path.join(root, "profile")
        said = io.StringIO()
        counts.zero()
        with contextlib.redirect_stdout(said):
            rc = cli.main(["run", "elastic3d_explosion", "--n", str(N_MAIN),
                           "--nsteps", "20", "--outdir", out, "--profile",
                           "--checkpoint-every", "10"])
        counts.expect("profiled CLI run", counts.read(), fused_step=20)
        summary = json.loads(said.getvalue().strip().splitlines()[-1])
        with open(os.path.join(out, "trace", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        fused = [e for e in events if e.get("cat") == "kernel"
                 and "fused_step_stream_kernel" in e.get("name", "")]
        cks = sorted(os.listdir(os.path.join(out, "checkpoints")))
        # the launch counters hold the 20 launches; the trace must hold the
        # kernel's events
        _check(rc == 0 and summary["kernel"] == "fused" and fused
               and cks == ["step_10.npz", "step_20.npz"],
               f"profiled CLI run: rc {rc}, {len(fused)} fused kernel events, "
               f"checkpoints {cks}")
        print(f"profiled CLI run (n={N_MAIN}, 20 steps, checkpoints every "
              f"10): 20 fused_step launches counted, {len(fused)} "
              f"fused_step_stream_kernel events, {len(events)} events in the "
              f"trace; {summary['points_per_second']:.6g} points/s under the "
              f"profiler")
        print(f"  launch records in order: {_launch_record(events)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)



# ------------------------------------------------------- simplex contact

#: the simplex contact path, bench.py:249-273 (the unstructured analogue of
#: BASELINE config 4): two jittered tet boxes of 25 x 49 x 49 = 60,025
#: nodes meeting at x = 0.5 (the faces are not jittered, so the 2,401
#: interface nodes pair), rock, stresses 1e5 N(0, 1) from
#: default_rng(0), bonded with a 5e5 Pa tensile strength. 200 steps on the
#: kernel path, 100 against the plain path, the resume cut at 31 of 60.
N_SC, HALF_SC, NSTEPS_SC, NSTEPS_SC_CMP = 49, 25, 200, 100
NSTEPS_SC_RESUME, CUT_SC = 60, 31
#: the tensile pulse: two 17 x 33 x 33 lattices (h = 0.5 m) meeting at
#: x = 8 m, a P pulse 3 m short of the interface, 20 steps (the JAX
#: package's 2D test, tests/test_simplex_contact.py:88, in 3D)
N_SC_PULSE, NSTEPS_SC_PULSE = 33, 20
#: the non-conforming pair: 13 x 25 x 25 nodes (h = 1 m) against
#: 25 x 49 x 49 (h = 0.5 m), jittered, 40 steps
NSTEPS_SC_NC = 40
#: the orthotropic simplex3d_layered at n=33: 130 steps (the Ricker source
#: peaks at step ~90, and the P front then stays ~20 m short of the sides);
#: its isotropic limit against the isotropic kernel path after 50 steps
N_SC_ORTHO, NSTEPS_SC_ORTHO, NSTEPS_SC_ISO = 33, 130, 50


def _mask_cells(mask):
    """A bond mask (per-side dict where non-conforming) as one array."""
    if isinstance(mask, dict):
        return np.concatenate([mask["a"], mask["b"]])
    return mask


def _simplex_steps(eng, n):
    """n more steps of a simplex multi-body engine from its state."""
    def run():
        us, bonded, auxs = eng.us, eng.bonded, eng.auxs
        amps = torch.zeros((n, 0), device="cuda")
        for i in range(n):
            us, bonded, auxs = eng._one_step(us, bonded, auxs, i, amps)
    return run


def simplex_contact_path(counts, result, mesh_setup):
    """Phase 17: SimplexMultiEngine on the simplex_sweep kernel, at bench.py's
    simplex contact configuration (its bodies from ``mesh_setup``, a
    ``HostSetup`` of ``_simplex_contact_setup``); a tensile pulse, a
    non-conforming pair, orthotropic simplex media and a resume. Returns
    the bench configuration ``(bodies, contacts, tables)`` for phase 21."""
    import shutil
    import tempfile

    from gcm_tpu_torch.engine_simplex import (
        SimplexBody, SimplexEngine, SimplexMultiEngine)
    from gcm_tpu_torch.grids.simplex import SimplexGrid
    from gcm_tpu_torch.materials import IsotropicMaterial, OrthotropicMaterial
    from gcm_tpu_torch.ops.simplex import simplex_sweep, simplex_sweep_reference
    from gcm_tpu_torch.scenarios import get_scenario
    from gcm_tpu_torch.solver.simplex_contact import (
        SimplexContactSpec, apply_simplex_contact_post)
    from gcm_tpu_torch.task import TimeSpec

    # ---- (a) the bench configuration
    t0 = time.perf_counter()
    bodies, contacts, t_mesh = mesh_setup.get()
    mesh_setup.stop()
    t_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = SimplexMultiEngine(bodies, contacts, "elastic3d", cfl=0.8,
                             device="cuda")
    t_setup = time.perf_counter() - t0
    npts = sum(b.grid.npoints for b in bodies.values())
    ia, ib = eng._pairs[0]
    print(f"simplex contact setup on the host CPU: Delaunay {t_mesh:.1f} s "
          f"(in a process of its own from before the build; waited "
          f"{t_wait:.1f} s for it here); "
          f"foot tables, pairing and plans {t_setup:.1f} s ({npts} nodes, "
          f"{len(ia)} interface pairs); dt {eng.dt:.6g} s")

    def sibling(kernel):
        return SimplexMultiEngine(bodies, contacts, "elastic3d", cfl=0.8,
                                  kernel=kernel, device="cuda",
                                  tables=eng.tables)

    for kern in ("auto", "torch"):
        sibling(kern).run(2)
    counts.zero()
    res = eng.run(NSTEPS_SC)
    launched = counts.read()
    _check(res.kernels == {"a": "simplex", "b": "simplex"},
           f"simplex contact path resolved to {res.kernels}")
    counts.expect("simplex contact path", launched,
                  simplex_sweep=6 * NSTEPS_SC)
    _check(all(np.isfinite(v).all() and v.shape == (9, b.grid.npoints)
               for v, b in zip(res.bodies.values(), bodies.values())),
           "simplex contact path: state not finite or of wrong shape")
    intact = float(res.bonded[0].mean())
    step_ms = res.wall_seconds / NSTEPS_SC * 1e3
    print(f"simplex contact path 2 x {HALF_SC}x{N_SC}x{N_SC} ({npts} nodes) "
          f"x {NSTEPS_SC} steps: {res.points_per_second:.6g} points/s, "
          f"{step_ms:.4f} ms a step, {launched['simplex_sweep']} "
          f"simplex_sweep launches; bonds intact {intact:.6f} "
          f"({int((res.bonded[0] < 0.5).sum())} of {res.bonded[0].size} "
          f"broken)")
    idle = _idle_share(_simplex_steps(eng, 50), 50, step_ms)
    res_k = sibling("auto").run(NSTEPS_SC_CMP)
    res_t = sibling("torch").run(NSTEPS_SC_CMP)
    err = _bodies_err(res_k, res_t)
    ndiff = int((res_k.bonded[0] != res_t.bonded[0]).sum())
    print(f"  after {NSTEPS_SC_CMP} steps: kernel path "
          f"{res_k.points_per_second:.6g} vs plain "
          f"{res_t.points_per_second:.6g} points/s, normalized error "
          f"{err:.3e} (limit 1e-4), bond cells that differ: {ndiff}")
    if ndiff:
        # a bond whose normal traction lies within round-off of the
        # strength can break in one float32 version and not the other
        free = [dataclasses.replace(c, tensile_strength=None)
                for c in contacts]
        err0 = _bodies_err(*(SimplexMultiEngine(
            bodies, free, "elastic3d", cfl=0.8, kernel=k, device="cuda",
            tables=eng.tables).run(NSTEPS_SC_CMP) for k in ("auto", "torch")))
        print(f"  {ndiff} bond cells differ; without fracture the two paths "
              f"agree to {err0:.3e} (limit 1e-4)")
        _check(err0 < PATH_TOL and ndiff <= 0.001 * len(ia),
               f"simplex contact: {ndiff} bond cells differ, error without "
               f"fracture {err0:.3e}")
    else:
        _check(err < PATH_TOL, f"simplex contact vs plain: err {err:.3e}")

    # the kernel on the path's own state (body a), each axis, and the host
    # time of one contact fixup
    plan = eng._sweeps["a"].plan
    ms, plain_ms, max_abs = [], [], 0.0
    for axis in range(3):
        a = (plan, eng.us["a"], axis)
        *_, e = _hold_on_path_state(
            f"simplex_sweep on the contact path's state, axis {axis}",
            simplex_sweep, simplex_sweep_reference, a)
        max_abs = max(max_abs, e)
        ms.append(_time_ms(lambda: simplex_sweep(*a), 50))
        plain_ms.append(_time_ms(lambda: simplex_sweep_reference(*a), 10))
    ua, ub = eng.us["a"].clone(), eng.us["b"].clone()
    st = eng.model.stage(0)
    va = eng._sweeps["a"].views.axis_view(0, st)
    vb = eng._sweeps["b"].views.axis_view(0, st)
    fix = (contacts[0], eng.model, eng.us["a"], ua, eng.us["b"], ub, va, vb,
           ia, ib, eng.bonded[0])
    apply_simplex_contact_post(*fix)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        apply_simplex_contact_post(*fix)
    torch.cuda.synchronize()
    fix_ms = (time.perf_counter() - t0) / 50 * 1e3
    fix_dev = _time_ms(lambda: apply_simplex_contact_post(*fix), 20)
    N = bodies["a"].grid.npoints
    K = next(iter(eng.tables["a"].values())).ids.shape[1]
    flops = N * sum(len(s.pairs) * (8 * K + 20) for s in eng.model.stages) / 3
    bound = _bound_entry(B_SIMPLEX * N, flops)
    print(f"simplex_sweep at {tuple(eng.us['a'].shape)}: kernel "
          f"{np.mean(ms):.4f} ms a sweep ({', '.join(f'{m:.4f}' for m in ms)}"
          f"), plain {np.mean(plain_ms):.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms; 6 sweeps {6 * np.mean(ms):.4f} ms of "
          f"a {step_ms:.4f} ms step; one contact fixup: host "
          f"{fix_ms:.4f} ms a call, device {fix_dev:.4f} ms")
    result["simplex_sweep"].update(
        contact_launches=launched["simplex_sweep"],
        contact_max_abs_err=max_abs, contact_ms=float(np.mean(ms)),
        contact_plain_ms=float(np.mean(plain_ms)),
        contact_bound_ms=bound["bound_ms"],
        contact_points_per_s=res.points_per_second,
        contact_idle_share=idle, contact_setup_s=t_setup + t_mesh)
    del res_k, res_t, ua, ub, fix

    # ---- (e) a resume at an odd step, through a checkpoint file
    root = tempfile.mkdtemp(prefix="simplex_contact_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        full = sibling("auto")
        rf = full.run(NSTEPS_SC_RESUME)
        part = sibling("auto")
        part.run(CUT_SC)
        state, t_save, t_restore = _through_file(root, part.state_dict())
        resumed = sibling("auto")
        resumed.load_state(state)
        counts.zero()
        rr = resumed.run(NSTEPS_SC_RESUME)
        counts.expect("simplex contact resume", counts.read(),
                      simplex_sweep=6 * (NSTEPS_SC_RESUME - CUT_SC))
        _same_state("simplex contact resume",
                    [(f"body {k}", rr.bodies[k], rf.bodies[k])
                     for k in rf.bodies]
                    + [("bond mask", rr.bonded[0], rf.bonded[0])])
        print(f"simplex contact resume: cut at {CUT_SC} of "
              f"{NSTEPS_SC_RESUME}, checkpoint save {t_save:.3f} s, restore "
              f"{t_restore:.3f} s; state and bond mask equal the "
              f"uninterrupted run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bench_setup = (bodies, contacts, eng.tables)
    del eng, full, part, resumed

    # ---- (b) a tensile pulse through two lattices
    rock = IsotropicMaterial.from_speeds(rho=1000.0, cp=2000.0, cs=1100.0)
    n = N_SC_PULSE
    ga = SimplexGrid.box((0, 0, 0), (8.0, 16.0, 16.0), ((n + 1) // 2, n, n))
    gb = SimplexGrid.box((8.0, 0, 0), (16.0, 16.0, 16.0),
                         ((n + 1) // 2, n, n))
    z = rock.rho * rock.cp
    prof = np.exp(-((ga.points[:, 0] - 5.0) ** 2) / 2.0)
    spec = [SimplexContactSpec("a", "b", axis=0, tensile_strength=2e5)]

    def pulse(sign, kernel, tables=None):
        u0 = np.zeros((9, ga.npoints))
        u0[3] = sign * 1e6 * prof
        u0[0] = -sign * 1e6 * prof / z
        e = SimplexMultiEngine(
            {"a": SimplexBody(ga, rock, u0=u0), "b": SimplexBody(gb, rock)},
            spec, "elastic3d", cfl=0.6, kernel=kernel, device="cuda",
            tables=tables)
        return e, e.run(NSTEPS_SC_PULSE)

    pe, tk = pulse(+1, "auto")
    _, tt = pulse(+1, "torch", pe.tables)
    _, ck = pulse(-1, "auto", pe.tables)
    perr = _bodies_err(tk, tt)
    sb = (np.abs(ck.bodies["b"][3]).max(), np.abs(tk.bodies["b"][3]).max())
    _check((tk.bonded[0] == 0).any() and np.array_equal(tk.bonded[0],
                                                        tt.bonded[0])
           and (ck.bonded[0] == 1).all() and perr < PATH_TOL
           and sb[0] > 3 * sb[1],
           f"tensile pulse: broken {int((tk.bonded[0] == 0).sum())} kernel, "
           f"{int((tt.bonded[0] == 0).sum())} plain, compression broken "
           f"{int((ck.bonded[0] == 0).sum())}, error {perr:.3e}, |sxx| in b "
           f"{sb}")
    print(f"tensile pulse 2 x {(n + 1) // 2}x{n}x{n} x {NSTEPS_SC_PULSE} "
          f"steps: tension breaks {int((tk.bonded[0] == 0).sum())} of "
          f"{tk.bonded[0].size} bonds on both paths (masks equal, state "
          f"error {perr:.3e}), compression none; transmitted max|sxx| "
          f"{sb[0]:.4e} intact against {sb[1]:.4e} broken")
    del pe

    # ---- (c) a non-conforming pair (h against h/2)
    ga = SimplexGrid.box((0, 0, 0), (12.0, 24.0, 24.0), (13, 25, 25),
                         jitter=0.2, seed=3)
    gb = SimplexGrid.box((12.0, 0, 0), (24.0, 24.0, 24.0), (25, 49, 49),
                         jitter=0.2, seed=4)
    p = ga.points
    prof = 1e6 * np.exp(-((p[:, 0] - 8.0) / 2.0) ** 2
                        - (((p[:, 1:] - 12.0) / 6.0) ** 2).sum(1))
    u0 = np.zeros((9, ga.npoints))
    u0[3] = prof
    u0[6] = u0[8] = rock.lam / (rock.lam + 2 * rock.mu) * prof
    u0[0] = -prof / z
    spec = [SimplexContactSpec("a", "b", axis=0, tensile_strength=3e5)]

    def nc(kernel, tables=None):
        e = SimplexMultiEngine(
            {"a": SimplexBody(ga, rock, u0=u0), "b": SimplexBody(gb, rock)},
            spec, "elastic3d", cfl=0.8, kernel=kernel, device="cuda",
            tables=tables)
        return e, e.run(NSTEPS_SC_NC)

    ne, nk = nc("auto")
    _, nt = nc("torch", ne.tables)
    _check(0 in ne._ncmaps, "non-conforming pair paired its nodes")
    nerr = _bodies_err(nk, nt)
    mk, mt = _mask_cells(nk.bonded[0]), _mask_cells(nt.bonded[0])
    _check(nerr < PATH_TOL and 0 < mk.mean() < 1,
           f"non-conforming pair: error {nerr:.3e}, bond mean {mk.mean()}")
    print(f"non-conforming pair {ga.npoints} + {gb.npoints} nodes x "
          f"{NSTEPS_SC_NC} steps: kernel {nk.points_per_second:.6g} vs plain "
          f"{nt.points_per_second:.6g} points/s, normalized error {nerr:.3e} "
          f"(limit 1e-4); bonds intact {mk.mean():.4f}, cells that differ "
          f"{int((mk != mt).sum())}")
    del ne

    # ---- (d) orthotropic simplex3d_layered on the per-pair plain path
    base = get_scenario("simplex3d_layered", n=N_SC_ORTHO)

    def layered(make, nsteps, kernel="auto"):
        return dataclasses.replace(
            base, default_material=make(base.default_material),
            materials=tuple(dataclasses.replace(r, material=make(r.material))
                            for r in base.materials),
            time=TimeSpec(cfl=base.time.cfl, nsteps=nsteps), kernel=kernel)

    counts.zero()
    oe = SimplexEngine.from_task(layered(_orthotropic, NSTEPS_SC_ORTHO),
                                 device="cuda")
    ores = oe.run()
    counts.expect("orthotropic simplex path", counts.read())
    _check(ores.kernel == "torch" and np.isfinite(ores.u).all(),
           f"orthotropic simplex: kernel {ores.kernel!r}, finite "
           f"{np.isfinite(ores.u).all()}")
    # the wave's spread on the source's horizontal plane: |v|^2-weighted
    # second moments along x (c11 = 1.3 c33) and y (c22 = 1.1 c33)
    pts = base.grid.points
    src = np.asarray(base.sources[0].position)
    h = 150.0 / (N_SC_ORTHO - 1)
    plane = np.abs(pts[:, 2] - src[2]) < 0.6 * h
    w = (ores.u[:3, plane] ** 2).sum(0)
    mx, my = (float(np.sqrt((w * (pts[plane, a] - src[a]) ** 2).sum()
                            / w.sum())) for a in (0, 1))
    lit = pts[plane][w > (0.02 ** 2) * w.max()]
    reach = [float(np.abs(lit[:, a] - src[a]).max()) for a in (0, 1)]
    _check(mx > my and reach[0] >= reach[1],
           f"orthotropic simplex: spread x {mx:.2f} m, y {my:.2f} m, reach "
           f"{reach}")
    iso = SimplexEngine.from_task(layered(lambda m: m, NSTEPS_SC_ISO),
                                  device="cuda").run()
    lim = SimplexEngine.from_task(layered(OrthotropicMaterial.from_isotropic,
                                          NSTEPS_SC_ISO),
                                  device="cuda").run()
    lerr = _np_err(lim.u, iso.u)
    _check(iso.kernel == "simplex" and lim.kernel == "torch"
           and lerr < PATH_TOL,
           f"orthotropic isotropic limit: {lim.kernel} vs {iso.kernel}, "
           f"err {lerr:.3e}")
    print(f"orthotropic simplex3d_layered n={N_SC_ORTHO} "
          f"({base.grid.npoints} nodes, {len(oe.tables)} per-pair tables) x "
          f"{NSTEPS_SC_ORTHO} steps on the plain path: "
          f"{ores.points_per_second:.6g} points/s; spread on the source "
          f"plane x {mx:.2f} m, y {my:.2f} m (ratio {mx / my:.4f}, "
          f"sqrt(c11/c22) = {np.sqrt(1.3 / 1.1):.4f}), 2% reach x "
          f"{reach[0]:.1f} m, y {reach[1]:.1f} m; isotropic limit vs the "
          f"isotropic kernel path after {NSTEPS_SC_ISO} steps: normalized "
          f"error {lerr:.3e} (limit 1e-4)")
    return bench_setup


#: the contact path on a mesh (phase 18), every shard on cuda:0: the
#: contact bodies of phase 13 (2 x 256x256x128) on 2x2 for NSTEPS_CONTACT
#: steps, held to the unsharded path after NSTEPS_MESH_CMP (the canonical
#: order on sx = 4, the per-sweep and orthotropic runs and the resume cut at
#: CUT_MESH take that many too); the partly broken n=32 interface of phase
#: 16 for NSTEPS_CONTACT32 steps, cut at CUT_CONTACT32
NSTEPS_MESH_CMP, CUT_MESH = 100, 51
#: the SPMD kernels in the canonical orders under a mesh, against their
#: plain versions: (global shape, mesh, order, axes), on 2x2, 4x1 and a
#: one-axis sx = 4 mesh, ragged and tile-multiple shards
SPMD_CANON_CASES = (((64, 48, 40), "2x2", 2, (2, 0, 1)),
                    ((64, 48, 40), "2x2", 1, (1, 0, 2)),
                    ((50, 38, 20), "2x2", 3, (2, 0, 1)),
                    ((96, 20, 24), "4x1", 2, (1, 0, 2)),
                    ((96, 20, 24), "4x1", 3, (2, 0, 1)),
                    ((96, 36, 20), "sx4", 2, (2, 0, 1)),
                    ((96, 36, 20), "sx4", 1, (1, 0, 2)),
                    ((72, 45, 33), "sx4", 2, (1, 0, 2)))


def contact_mesh_path(counts, result):
    """Phase 18: MultiBodyEngine(mesh=) on meshes whose shards all lie on
    cuda:0: (a) the fused SPMD composition on 2x2, (b) the canonical order
    on a one-axis mesh, after the SPMD kernels in its orders, (c) the
    per-sweep composition, (d) orthotropic bodies, (e) the partly broken
    n=32 interface with a resume, (f) resumes of the 2x2 run."""
    import shutil
    import tempfile

    from gcm_tpu_torch.convert import bonded_from_numpy
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.parallel.sharding import DomainMesh, domain_mesh
    from gcm_tpu_torch.scenarios import elastic3d_contact
    import gcm_tpu_torch.solver.multi as smulti
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.halo import halo_exchange
    from gcm_tpu_torch.parallel.sharding import AXIS_OF
    from gcm_tpu_torch.solver.multi import apply_contact_fixups

    dev = torch.device("cuda", 0)
    meshes = {"2x2": domain_mesh(3, [dev] * 4, (2, 2)),
              "4x1": domain_mesh(3, [dev] * 4, (4, 1)),
              "sx4": DomainMesh((dev,) * 4, (4,), ("sx",))}
    mesh22 = meshes["2x2"]
    bodies, contacts = elastic3d_contact(n=N_CONTACT, nsteps=NSTEPS_CONTACT)
    npts = sum(int(np.prod(t.grid.shape)) for t in bodies.values())

    def with_(b, **kw):
        return {k: dataclasses.replace(t, **kw) for k, t in b.items()}

    def steps(b, n):
        return with_(b, time=dataclasses.replace(b["upper"].time, nsteps=n))

    def build(b, c=contacts, mesh=None, mask=None, canon=True):
        """The contact engine, canonical_layout=True as the CLI asks it
        (``canon=False``: the unsharded path in the default order)."""
        e = MultiBodyEngine(b, c, device=None if mesh else dev, mesh=mesh,
                            canonical_layout=canon)
        if mask is not None:
            e.bonded = bonded_from_numpy({0: mask}, device="cuda")
        return e

    def drive(tag, eng, **want):
        """One run, the counters zeroed just before it and read after."""
        counts.zero()
        res = eng.run()
        launched = counts.read()
        counts.expect(tag, launched, **want)
        _check(all(np.isfinite(v).all() for v in res.bodies.values()),
               f"{tag}: state not finite")
        return res, launched

    def masks_equal(tag, got, want):
        for ci in want.bonded:
            nd = int((got.bonded[ci] != want.bonded[ci]).sum())
            _check(nd == 0, f"{tag}: {nd} bond mask cells differ")

    def idle(eng, res, n=20):
        return _idle_share(_multi_steps(eng, n), n,
                           npts / res.points_per_second * 1e3)

    per_step = 2 * 4                  # bodies x shards
    build(steps(bodies, 2), mesh=mesh22).run()

    # ---- (a) the fused SPMD composition on 2x2, canonical_layout asked
    eng = build(bodies, mesh=mesh22)
    _check(eng.path == "fused_spmd" and eng._fwd == (0, 1, 2),
           f"2x2 contact path: {eng.path!r} in {eng._fwd}, not fused_spmd "
           "in (0, 1, 2) as JAX on a 2-axis mesh")
    res, launched = drive("2x2 contact mesh path", eng,
                          fused_spmd_interior=per_step * NSTEPS_CONTACT,
                          fused_spmd_ring=per_step * NSTEPS_CONTACT)
    v_up = float(np.abs(res.bodies["upper"][:3]).max())
    _check(v_up > 0, "2x2 contact mesh path: the upper body did not move")
    ref_full = build(bodies, canon=False).run()   # the same order, unsharded
    err_full = _bodies_err(res, ref_full)
    nd_full = int((res.bonded[0] != ref_full.bonded[0]).sum())
    b100 = steps(bodies, NSTEPS_MESH_CMP)
    r100 = build(b100, mesh=mesh22).run()
    u100 = build(b100, canon=False).run()
    err100 = _bodies_err(r100, u100)
    _check(err100 < 2e-6, f"2x2 contact mesh vs unsharded after "
           f"{NSTEPS_MESH_CMP} steps: err {err100:.3e}")
    masks_equal("2x2 contact mesh path", r100, u100)
    print(f"contact mesh path 2 x {N_CONTACT}x{N_CONTACT}x{N_CONTACT // 2} "
          f"on 2x2 shards of cuda:0 x {NSTEPS_CONTACT} steps (order "
          f"{eng._fwd}): {res.points_per_second:.6g} points/s (unsharded "
          f"fused {ref_full.points_per_second:.6g}); "
          f"{launched['fused_spmd_interior']} interior + "
          f"{launched['fused_spmd_ring']} ring launches, 0 fused_step or "
          f"fused_step_slab; upper max|v| {v_up:.4e}; vs unsharded after "
          f"{NSTEPS_MESH_CMP} steps {err100:.3e} (limit 2e-6, masks equal), "
          f"after {NSTEPS_CONTACT} {err_full:.3e} (bond cells that differ "
          f"{nd_full}, bond mean {res.bonded[0].mean():.6f})")
    # one put-together contact fixup on the path's state: the host's time
    # to enqueue a call, a call's wall time with the card synchronised
    # after it, and its device time queued behind a spin kernel
    out = {k: [b.clone() for b in v] for k, v in eng.us.items()}
    fix = (eng.model, eng.us, out, eng.mats, eng.dt, eng.hs, eng.order,
           eng.borders, eng.contacts, eng.bonded, eng._fwd, eng._faces)
    apply_contact_fixups(*fix)
    torch.cuda.synchronize()
    enqueue, wall = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        apply_contact_fixups(*fix)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append(t1 - t0)
        wall.append(time.perf_counter() - t0)
    fix_ms = float(np.median(enqueue)) * 1e3
    fix_wall = float(np.median(wall)) * 1e3
    fix_dev = _time_ms(lambda: apply_contact_fixups(*fix), 10)
    # the metric: the fixup's host time inside the step loop, each call of
    # 20 untraced steps timed where the step makes it
    real_fixups, calls = smulti.apply_contact_fixups, []

    def timed_fixups(*a, **kw):
        t0 = time.perf_counter()
        r = real_fixups(*a, **kw)
        calls.append(time.perf_counter() - t0)
        return r

    smulti.apply_contact_fixups = timed_fixups
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _multi_steps(eng, 20)()
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3
    finally:
        smulti.apply_contact_fixups = real_fixups
    _check(len(calls) == 20, f"{len(calls)} contact fixups in 20 steps")
    fix_loop_ms = float(np.median(calls)) * 1e3
    fix_share = sum(calls) * 1e3 / loop_ms
    print(f"contact fixup in the step loop (2 slabs of (r + 1) x "
          f"{N_CONTACT} x {N_CONTACT} gathered from 4 shards, the face rows "
          f"scattered back), 20 untraced steps in {loop_ms:.4f} ms: host "
          f"{fix_loop_ms:.4f} ms a step (median), {fix_share:.4f} of the "
          f"loop's wall; the same fixup called alone: host {fix_ms:.4f} ms "
          f"to enqueue, {fix_wall:.4f} ms with the card synchronised, device "
          f"{fix_dev:.4f} ms queued; a step of the timed run "
          f"{npts / res.points_per_second * 1e3:.4f} ms")
    idle_a = idle(eng, res)
    entries, _ = _spmd_kernels_on_shard(
        "the contact mesh path's upper body, ", eng.model, eng.us["upper"],
        eng._mstacks["upper"], mesh22, 0, eng.dt, eng.hs["upper"],
        eng.order, eng._kernel_bcs["upper"], eng._fwd)
    for name, entry in entries.items():
        result[name].update(
            contact_mesh_launches=launched[name],
            contact_mesh_points_per_s=res.points_per_second,
            contact_mesh_idle_share=idle_a,
            contact_mesh_fixup_host_ms=fix_loop_ms,
            contact_mesh_fixup_host_share=fix_share,
            contact_mesh_fixup_isolated_host_ms=fix_ms,
            **{f"contact_mesh_{k}": v for k, v in entry.items()})
    del eng, res, ref_full, out, fix

    # ---- (b) the SPMD kernels in the canonical orders, then the
    # canonical order on a one-axis mesh
    _spmd_canonical_vs_plain(meshes)
    eng = build(b100, mesh=meshes["sx4"])
    _check(eng.path == "fused_canonical_spmd" and eng._fwd == (2, 0, 1)
           and eng.mesh.axis_names == ("sx",),
           f"sx=4 contact path: {eng.path!r} in {eng._fwd}")
    rc, _ = drive("canonical contact mesh path", eng,
                  fused_spmd_interior=per_step * NSTEPS_MESH_CMP,
                  fused_spmd_ring=per_step * NSTEPS_MESH_CMP)
    ref = build(b100)
    _check(ref.path == "fused_canonical", f"unsharded: {ref.path!r}")
    uc = ref.run()
    errc = _bodies_err(rc, uc)
    _check(errc < 2e-6, f"canonical contact mesh vs unsharded canonical: "
           f"err {errc:.3e}")
    masks_equal("canonical contact mesh path", rc, uc)
    print(f"canonical contact mesh path on sx=4 shards x {NSTEPS_MESH_CMP} "
          f"steps, order {eng._fwd}: {rc.points_per_second:.6g} points/s "
          f"(unsharded fused_canonical {uc.points_per_second:.6g}); vs "
          f"unsharded {errc:.3e} (limit 2e-6), masks equal")
    idle(eng, rc)
    _spmd_kernels_on_shard(
        "the canonical mesh path's lower body, ", eng.model, eng.us["lower"],
        eng._mstacks["lower"], eng.mesh, 1, eng.dt, eng.hs["lower"],
        eng.order, eng._kernel_bcs["lower"], eng._fwd)
    del eng, rc, uc

    # ---- (c) the per-sweep composition on 2x2
    bs = with_(b100, kernel="sweep")
    eng = build(bs, mesh=mesh22)
    _check(eng.path == "sweep_spmd", f"sweep contact mesh: {eng.path!r}")
    rs, ls = drive("per-sweep contact mesh path", eng,
                   sweep_stage=3 * per_step * NSTEPS_MESH_CMP)
    us_ = build(bs).run()
    errs = _bodies_err(rs, us_)
    _check(errs < 2e-6, f"per-sweep contact mesh vs unsharded: {errs:.3e}")
    masks_equal("per-sweep contact mesh path", rs, us_)
    print(f"per-sweep contact mesh path on 2x2 x {NSTEPS_MESH_CMP} steps: "
          f"{rs.points_per_second:.6g} points/s (unsharded sweep "
          f"{us_.points_per_second:.6g}); {ls['sweep_stage']} sweep_stage "
          f"launches; vs unsharded {errs:.3e} (limit 2e-6)")
    idle(eng, rs, 10)
    # sweep_stage on shard 0's own blocks, halo-extended along each split
    # axis as the path gives them, against its plain version
    split = {AXIS_OF[n]: n for n in eng.mesh.axis_names}
    r, k, sw = stencil_radius(eng.order), 0, []
    for axis in range(3):
        mats_k = eng._sweep_mats["upper"][k]
        if axis in split:
            u = halo_exchange(eng.us["upper"], eng.mesh, split[axis],
                              axis + 1, r)[k]
            mat = mats_k[f"ax{axis}"].mat
        else:
            u, mat = eng.us["upper"][k], mats_k["base"].mat
        sw.append(_sweep_on_block(
            f"the per-sweep contact mesh path's upper shard {k}", eng.model,
            u, mat, eng.dt, eng.hs["upper"], axis, eng.order))
    result["sweep_stage"].update(
        contact_mesh_launches=ls["sweep_stage"],
        contact_mesh_points_per_s=rs.points_per_second,
        contact_mesh_max_abs_err=max(x["max_abs_err"] for x in sw),
        contact_mesh_ms=float(np.mean([x["ms"] for x in sw])),
        contact_mesh_plain_ms=float(np.mean([x["plain_ms"] for x in sw])),
        contact_mesh_bound_ms=float(np.mean([x["bound_ms"] for x in sw])),
        contact_mesh_bound_by=sw[0]["bound_by"],
        contact_mesh_ms_by_axis=[x["ms"] for x in sw])
    del eng, rs, us_

    # ---- (d) orthotropic bodies on 2x2: the 13-field stacks, no canonical
    # order (isotropic only, as in JAX)
    bo = {k: _orthoize(t) for k, t in b100.items()}
    eng = build(bo, mesh=mesh22)
    _check(eng.path == "fused_spmd" and eng._fwd == (0, 1, 2)
           and eng._mstacks["upper"][0].shape[0] == 13,
           f"orthotropic contact mesh: {eng.path!r} in {eng._fwd}")
    ro, _ = drive("orthotropic contact mesh path", eng,
                  fused_spmd_interior=per_step * NSTEPS_MESH_CMP,
                  fused_spmd_ring=per_step * NSTEPS_MESH_CMP)
    ref = build(bo)
    _check(ref.path == "fused", f"unsharded orthotropic: {ref.path!r}")
    uo = ref.run()
    erro = _bodies_err(ro, uo)
    _check(erro < 2e-6, f"orthotropic contact mesh vs unsharded: "
           f"{erro:.3e}")
    masks_equal("orthotropic contact mesh path", ro, uo)
    print(f"orthotropic contact mesh path on 2x2 x {NSTEPS_MESH_CMP} steps: "
          f"{ro.points_per_second:.6g} points/s (unsharded "
          f"{uo.points_per_second:.6g}); vs unsharded {erro:.3e} (limit "
          f"2e-6)")
    idle(eng, ro, 10)
    del eng, ro, uo

    root = tempfile.mkdtemp(prefix="contact_mesh_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        # ---- (e) the partly broken n=32 interface, cut and resumed
        b32, c32 = elastic3d_contact(n=32, nsteps=NSTEPS_CONTACT32)
        mask = (np.random.default_rng(3).random((32, 32)) > 0.3).astype(
            np.float32)
        full = build(b32, c32, mesh22, mask)
        _check(full.path == "fused_spmd", f"n=32 mesh path: {full.path!r}")
        f32r = full.run()
        u32 = build(b32, c32, None, mask, canon=False).run()
        err32 = _bodies_err(f32r, u32)
        masks_equal("n=32 contact mesh path", f32r, u32)
        _check(err32 < 2e-6, f"n=32 contact mesh vs unsharded: {err32:.3e}")
        part = build(b32, c32, mesh22, mask)
        part.nsteps = CUT_CONTACT32
        part.run()
        state, *_ = _through_file(os.path.join(root, "c32"),
                                  part.state_dict())
        at_cut = state["bonded"]["0"]
        again = build(b32, c32, mesh22)
        again.load_state(state)
        rr = again.run()
        _same_state("n=32 contact mesh resume",
                    [(f"body {k}", rr.bodies[k], f32r.bodies[k])
                     for k in f32r.bodies]
                    + [("mask", rr.bonded[0], f32r.bonded[0])])
        _check((rr.bonded[0][at_cut == 0] == 0).all()
               and rr.bonded[0].mean() < at_cut.mean(),
               "n=32 contact mesh resume: a restored broken cell healed, or "
               "the interface did not break further")
        print(f"n=32 contact on 2x2 from a partly broken mask: vs unsharded "
              f"{err32:.3e}, masks equal; bond mean {mask.mean():.4f} at the "
              f"start, {at_cut.mean():.4f} at the cut {CUT_CONTACT32}, "
              f"{rr.bonded[0].mean():.4f} at {NSTEPS_CONTACT32} steps; the "
              f"resume equal to the uninterrupted run, no broken cell healed")

        # ---- (f) the 2x2 run of (a) at 100 steps cut at an odd step, and
        # an unsharded engine's checkpoint resumed on the mesh
        part = build(b100, mesh=mesh22)
        part.nsteps = CUT_MESH
        part.run()
        state, t_save, t_restore = _through_file(os.path.join(root, "a"),
                                                 part.state_dict())
        again = build(b100, mesh=mesh22)
        again.load_state(state)
        rr = again.run()
        _same_state(f"contact mesh resume at {CUT_MESH}",
                    [(f"body {k}", rr.bodies[k], r100.bodies[k])
                     for k in r100.bodies]
                    + [("mask", rr.bonded[0], r100.bonded[0])])
        part = build(b100, canon=False)
        part.nsteps = CUT_MESH
        part.run()
        state, *_ = _through_file(os.path.join(root, "u"), part.state_dict())
        again = build(b100, mesh=mesh22)
        again.load_state(state)
        ru = again.run()
        erru = _bodies_err(ru, u100)
        _check(erru < 2e-6, f"unsharded checkpoint resumed on the mesh: "
               f"{erru:.3e}")
        masks_equal("unsharded checkpoint resumed on the mesh", ru, u100)
        print(f"contact mesh path cut at {CUT_MESH} of {NSTEPS_MESH_CMP} "
              f"(save {t_save:.3f} s, restore {t_restore:.3f} s): equal to "
              f"the uninterrupted 2x2 run; an unsharded checkpoint at "
              f"{CUT_MESH} resumed on 2x2: {erru:.3e} from the unsharded run "
              f"(limit 2e-6), masks equal")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------ multi-process paths

#: phase 19: two ranks of a gloo group on cuda:0, one mesh row (two
#: shards) a rank; the 3D fused and per-sweep runs and the 2D run, each
#: against the same run in one process
NSTEPS_MP, NSTEPS_MP_SWEEP = 50, 25
#: seconds a rank may take, and waits for the other in an exchange
MP_TIMEOUT = 420


def _mp_cases():
    """(tag, task, mesh dim, mesh shape) of phase 19's runs."""
    from gcm_tpu_torch.scenarios import get_scenario

    explosion = get_scenario("elastic3d_explosion", n=N_MAIN,
                             nsteps=NSTEPS_MP)
    return (("a", explosion, 3, (2, 2)),
            ("b", dataclasses.replace(
                explosion, kernel="sweep", time=dataclasses.replace(
                    explosion.time, nsteps=NSTEPS_MP_SWEEP)), 3, (2, 2)),
            ("c", get_scenario("elastic2d_viscoelastic", n=N_2D,
                               nsteps=NSTEPS_MP), 2, None))


def _short(task, n=2):
    return dataclasses.replace(task, time=dataclasses.replace(task.time,
                                                              nsteps=n))


def _mp_mesh(dim, shape, devices, ranks=None):
    from gcm_tpu_torch.parallel.sharding import domain_mesh

    return domain_mesh(dim, devices, shape, ranks)


def _mp_spawn(workdir, backend, flag="--multiproc-rank"):
    """Run the two ranks (this script with ``flag``: ``--multiproc-rank``
    for phase 19, ``--multiproc-contact-rank`` for phase 20) at a free local
    port; each writes its log under ``workdir``. Fails unless both exit 0
    within MP_TIMEOUT; stops both either way."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ)
    if backend == "gloo":      # both ranks on cuda:0
        env["CUDA_VISIBLE_DEVICES"] = env.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    procs, logs = [], []
    try:
        for rank in (0, 1):
            log = open(os.path.join(workdir, f"rank{rank}_{backend}.log"),
                       "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, str(rank),
                 coord, workdir, backend],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        for p in procs:
            p.wait(timeout=max(MP_TIMEOUT - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        with open(os.path.join(workdir, f"rank{rank}_{backend}.log")) as f:
            text = f.read()
        print(f"  rank {rank} ({backend}), exit {p.returncode}:")
        for line in text.splitlines():
            print(f"    {line}")
        _check(p.returncode == 0, f"multi-process rank {rank} ({backend}) "
               f"exited {p.returncode}")
    return coord


def multiproc_paths(counts, result):
    """Phase 19: each path of ``_mp_cases`` run by two ranks on cuda:0
    under gloo (the slabs between the ranks through host memory) equals the
    same run in one process bit for bit; (a) also under 2e-6 of the
    unsharded fused run. With two or more cards, (a) runs again under NCCL,
    one rank a card."""
    import shutil
    import tempfile

    from gcm_tpu_torch.engine import Engine

    dev = torch.device("cuda", 0)
    refs = {}
    for tag, task, dim, shape in _mp_cases():
        mesh = _mp_mesh(dim, shape, [dev] * 4)
        Engine(_short(task), mesh=mesh).run()
        refs[tag] = Engine(task, mesh=mesh).run()
        print(f"one-process ({tag}) {task.name} {task.grid.shape} "
              f"kernel={refs[tag].kernel} on {mesh.shape} shards of cuda:0 "
              f"x {task.time.nsteps} steps: "
              f"{refs[tag].points_per_second:.6g} points/s")
        if tag == "a":
            unsharded = Engine(task, device=dev).run()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="multiproc_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        _mp_spawn(root, "gloo")
        with open(os.path.join(root, "gloo.json")) as f:
            got = json.load(f)
        for tag, task, dim, shape in _mp_cases():
            u = np.load(os.path.join(root, f"{tag}_u.npy"))
            tr = np.load(os.path.join(root, f"{tag}_traces.npy"))
            _check(np.array_equal(u, refs[tag].u)
                   and np.array_equal(tr, refs[tag].traces),
                   f"two ranks ({tag}) differ from one process: max "
                   f"|difference| {np.abs(u - refs[tag].u).max():.3e}, "
                   f"traces {np.abs(tr - refs[tag].traces).max():.3e}")
            g = got[tag]
            idle = ("not measured" if g["idle_share"] is None
                    else f"{g['idle_share']:.4f}")
            print(f"two ranks ({tag}) {task.name} {task.grid.shape} "
                  f"kernel={refs[tag].kernel} x {task.time.nsteps} steps "
                  f"under gloo, both on cuda:0: {g['points_per_s']:.6g} "
                  f"points/s (one process "
                  f"{refs[tag].points_per_second:.6g}); state and traces "
                  f"equal to the one-process run bit for bit; launches a "
                  f"rank {g['launches']}; cross-rank exchange "
                  f"{g['exchange_host_ms']:.4f} host ms a step (median of "
                  f"20), {g['exchange_share']:.4f} of the loop's wall; "
                  f"device idle share {idle} (traced, both ranks' busy "
                  f"time over the wall)")
        err = _np_err(np.load(os.path.join(root, "a_u.npy")), unsharded.u)
        _check(err < 2e-6, f"two ranks (a) vs unsharded fused: {err:.3e}")
        print(f"two ranks (a) vs the unsharded fused run: normalized error "
              f"{err:.3e} (limit 2e-6)")
        for name, entry in got["kernels"].items():
            result[name].update({f"multiproc_{k}": v
                                 for k, v in entry.items()})
        if torch.cuda.device_count() >= 2:
            _mp_nccl(root, refs["a"])
        else:
            print("nccl: not run (1 card)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _mp_nccl(root, want):
    """(a) by two ranks under NCCL, one a card (cuda:0 and cuda:1),
    against ``want``, its one-process run."""
    _mp_spawn(root, "nccl")
    with open(os.path.join(root, "nccl.json")) as f:
        g = json.load(f)["a"]
    u = np.load(os.path.join(root, "a_u.npy"))
    tr = np.load(os.path.join(root, "a_traces.npy"))
    _check(np.array_equal(u, want.u) and np.array_equal(tr, want.traces),
           f"two ranks (a) under NCCL differ from one process: max "
           f"|difference| {np.abs(u - want.u).max():.3e}")
    print(f"nccl: two ranks (a), one a card: {g['points_per_s']:.6g} "
          f"points/s (one process on one card {want.points_per_second:.6g})"
          f", state and traces equal to the one-process run bit for bit; "
          f"launches a rank {g['launches']}; cross-rank exchange "
          f"{g['exchange_host_ms']:.4f} host ms a step (median of 20), "
          f"{g['exchange_share']:.4f} of the loop's wall")


def _mp_timed_steps(eng, calls, n):
    """Host wall ms of ``n`` untraced steps of ``eng`` and the host ms of
    the exchange in each (``calls`` collects them)."""
    calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        calls.append(0.0)
        eng._one_step_mesh(eng.u, eng.aux, i % eng.nsteps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _mp_worker(rank, coord, workdir, backend):
    """One rank of phase 19: the runs of ``_mp_cases`` on its mesh row,
    their launches, exchange host ms and idle share; rank 0 saves the
    gathered states and traces. On gloo, rank 1 then holds rows 4, 6a, 6b
    and 6c on its own shard blocks, with the slabs rank 0 sent, against
    their plain versions and times them."""
    import torch.distributed as dist

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.ops import _build
    from gcm_tpu_torch.ops.fused_spmd import fused_spmd_2d
    from gcm_tpu_torch.parallel import fused_spmd as pfs
    from gcm_tpu_torch.parallel import halo, multihost

    _check(multihost.initialize(coord, 2, rank, backend=backend,
                                timeout=MP_TIMEOUT), "no process group")
    _build.load()
    dev = multihost.local_devices()[0]
    info = multihost.process_info()
    _check(info["process_count"] == 2 and info["global_devices"] == 2,
           f"process info {info}")
    print(f"rank {rank}: {backend} on {dev} ({torch.cuda.get_device_name(dev)}"
          f"), {info}", flush=True)
    counts = Counts()
    out, kernels = {}, {}
    calls = []

    def timed(fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            calls[-1] += (time.perf_counter() - t0) * 1e3
            return r
        return wrapper

    cases = _mp_cases() if backend == "gloo" else _mp_cases()[:1]
    for tag, task, dim, shape in cases:
        devs = ([dev] * 4 if backend == "gloo"
                else [torch.device("cuda", r) for r in (0, 0, 1, 1)])
        mesh = _mp_mesh(dim, shape, devs, ranks=(0, 0, 1, 1))
        Engine(_short(task), mesh=mesh).run()
        eng = Engine(task, mesh=mesh)
        dist.barrier()
        counts.zero()
        res = eng.run()
        launched = counts.read()
        want = {"a": dict(fused_spmd_interior=2 * task.time.nsteps,
                          fused_spmd_ring=2 * task.time.nsteps),
                "b": dict(sweep_stage=3 * 2 * task.time.nsteps),
                "c": dict(fused_spmd_2d=2 * 2 * task.time.nsteps)}[tag]
        counts.expect(f"rank {rank} ({tag})", launched, **want)
        if tag == "c":
            _check(fused_spmd_2d.ring_launches == 2 * task.time.nsteps,
                   f"rank {rank} (c): {fused_spmd_2d.ring_launches} ring "
                   "launches")
        if rank == 0:
            np.save(os.path.join(workdir, f"{tag}_u.npy"), res.u)
            np.save(os.path.join(workdir, f"{tag}_traces.npy"), res.traces)
        # the exchange inside the step loop: the slab exchange's call and
        # wait (fused), the halo exchange of each sweep (per-sweep)
        real = (pfs.SlabExchange.__call__, pfs.SlabExchange.wait,
                halo.halo_exchange)
        pfs.SlabExchange.__call__ = timed(real[0])
        pfs.SlabExchange.wait = timed(real[1])
        halo.halo_exchange = timed(real[2])
        dist.barrier()      # rank 0 saved the states: start together
        try:
            loop_ms = _mp_timed_steps(eng, calls, 20)
        finally:
            (pfs.SlabExchange.__call__, pfs.SlabExchange.wait,
             halo.halo_exchange) = real
        steps = 20 if tag != "b" else 10

        def run_steps(n=steps):
            for i in range(n):
                eng._one_step_mesh(eng.u, eng.aux, i % eng.nsteps)

        dist.barrier()
        wall, busy = _device_busy(run_steps)
        walls = multihost.all_gather_object((wall, busy))
        # two processes on one card take turns on it (no MPS), so the
        # card is busy for the sum of the ranks' busy times
        idle = (None if any(b is None for _, b in walls) or backend != "gloo"
                else 1 - sum(b for _, b in walls) / max(w for w, _ in walls))
        out[tag] = dict(
            points_per_s=res.points_per_second,
            launches={k: v for k, v in launched.items() if v},
            exchange_host_ms=float(np.median(calls)),
            exchange_share=sum(calls) / loop_ms, loop_ms=loop_ms,
            idle_share=idle, traced_wall_ms=wall, busy_ms=busy)
        print(f"rank {rank} ({tag}): {out[tag]}", flush=True)
        if backend == "gloo":
            kernels.update(_mp_hold(rank, tag, eng, launched))
        del eng, res
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(workdir, f"{backend}.json"), "w") as f:
            json.dump(dict(out, kernels=multihost.all_gather_object(
                kernels)[1]), f)
    else:
        multihost.all_gather_object(kernels)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _mp_hold(rank, tag, eng, launched):
    """Rows 4, 6a, 6b, 6c on rank 1's first shard of the path ``tag``,
    with its halo slabs from rank 0's shards (every rank takes part in the
    exchange): each against its plain version under 2e-6 a step and timed
    (rank 1; rank 0 waits). Returns the kernels' ``multiproc_*`` keys."""
    import torch.distributed as dist

    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import exchange_slabs
    from gcm_tpu_torch.parallel.halo import halo_exchange

    task, mesh, model = eng.task, eng.mesh, eng.model
    r, k = stencil_radius(task.order), 2
    h, order, bc = task.grid.h, task.order, task.borders
    where = f"rank 1's shard {k} of the two-rank path ({tag})"
    if tag == "b":
        ext = halo_exchange(eng.u, mesh, "sx", 1, r)[k]
    else:
        slabs = exchange_slabs(eng.u, mesh, r, dim=model.dim)[k]
    out = {}
    if rank == 1:
        if tag == "a":
            entries, _ = _spmd_kernels_on_shard(
                f"{where}, ", model, eng.u, eng._carry, mesh, k, eng.dt, h,
                order, bc, (0, 1, 2), slabs=slabs)
            for name, e in entries.items():
                out[name] = dict(e, launches=launched[name])
        elif tag == "b":
            out["sweep_stage"] = dict(
                _sweep_on_block(f"{where} (x halo from rank 0)", model, ext,
                                eng._carry[k]["ax0"].mat, eng.dt, h, 0,
                                order), launches=launched["sweep_stage"])
        else:
            out["fused_spmd_2d"] = dict(
                _spmd_2d_on_shard(where, eng, k, slabs)[0],
                launches=launched["fused_spmd_2d"])
        for name, e in out.items():
            print(f"{name} on {where}: {e}", flush=True)
    dist.barrier()
    return out


# ------------------------------------------- the contact path across ranks

#: phase 20: two ranks of a gloo group on cuda:0, one mesh row (two shards)
#: a rank, each run against the same run in one process on the same mesh:
#: the contact bodies of phase 13 (with two receivers on shard edges of the
#: upper body) fused on 2x2 for NSTEPS_MPC steps, per-sweep on 2x2 and in
#: the canonical order on sx=4 for NSTEPS_MPC_SHORT; the partly broken n=32
#: interface of phase 18 through run_with_outputs (snapshots every 16,
#: checkpoints every 8) for NSTEPS_CONTACT32 steps, cut at CUT_CONTACT32;
#: the 3D explosion fused on 2x2 through run_with_outputs (a vz snapshot
#: and a checkpoint every EVERY_MPC_OUT), cut at EVERY_MPC_OUT and resumed
#: to NSTEPS_MPC_OUT, against its uninterrupted run()
NSTEPS_MPC, NSTEPS_MPC_SHORT = 100, 50
NSTEPS_MPC_OUT, EVERY_MPC_OUT = 20, 10


def _mpc_cases():
    """(tag, bodies, contacts, mesh) of phase 20's contact runs (a)-(c)."""
    from gcm_tpu_torch.scenarios import elastic3d_contact
    from gcm_tpu_torch.task import DetectorSpec

    bodies, contacts = elastic3d_contact(n=N_CONTACT, nsteps=NSTEPS_MPC)
    L = 1000.0
    bodies = {k: dataclasses.replace(t, kernel="fused")
              for k, t in bodies.items()}
    bodies["upper"] = dataclasses.replace(
        bodies["upper"], detectors=DetectorSpec(points=(
            (L / 2, L / 2, 0.0), (0.1 * L, 0.9 * L, 50.0))))
    short = dataclasses.replace(bodies["upper"].time,
                                nsteps=NSTEPS_MPC_SHORT)

    def with_(**kw):
        return {k: dataclasses.replace(t, **kw) for k, t in bodies.items()}

    return (("a", bodies, contacts, "2x2"),
            ("b", with_(kernel="sweep", time=short), contacts, "2x2"),
            ("c", with_(time=short), contacts, "sx4"))


def _mpc_engine(bodies, contacts, mesh, ranks=None, mask=None,
                devices=None):
    """The contact engine on the shards of ``mesh`` ("2x2" or "sx4",
    ``ranks``: its shards' ranks) on ``devices`` (default: all on cuda:0),
    canonical_layout=True as the CLI asks it, from the bond mask ``mask``
    (default: intact)."""
    from gcm_tpu_torch.convert import bonded_from_numpy
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.parallel.sharding import DomainMesh

    devices = [torch.device("cuda", 0)] * 4 if devices is None else devices
    m = (_mp_mesh(3, (2, 2), devices, ranks) if mesh == "2x2"
         else DomainMesh(tuple(devices), (4,), ("sx",), ranks))
    eng = MultiBodyEngine(bodies, contacts, mesh=m, canonical_layout=True)
    if mask is not None:
        eng.bonded = bonded_from_numpy({0: mask}, device=eng.device)
    return eng


def _mpc_flat(res):
    """A multi-body result's bodies, bond masks and traces (or a single
    body's state and traces) by name."""
    if hasattr(res, "bodies"):
        out = {f"body_{k}": v for k, v in res.bodies.items()}
        out.update({f"bonded_{k}": v for k, v in res.bonded.items()})
        out.update({f"traces_{k}": v for k, v in (res.traces or {}).items()})
        return out
    return {"u": res.u, "traces": res.traces}


def _digest(arrays):
    import hashlib

    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def _mask32():
    return (np.random.default_rng(3).random((32, 32)) > 0.3).astype(
        np.float32)


def _mpc_contact32():
    """The partly broken n=32 interface's bodies and contacts."""
    from gcm_tpu_torch.scenarios import elastic3d_contact

    bodies, contacts = elastic3d_contact(n=32, nsteps=NSTEPS_CONTACT32)
    return {k: dataclasses.replace(t, kernel="fused")
            for k, t in bodies.items()}, contacts


def _mpc_explosion():
    """(e)'s task: the 3D explosion with a vz snapshot every
    EVERY_MPC_OUT steps."""
    from gcm_tpu_torch.scenarios import get_scenario
    from gcm_tpu_torch.task import SnapshotSpec

    return dataclasses.replace(
        get_scenario("elastic3d_explosion", n=N_MAIN, nsteps=NSTEPS_MPC_OUT),
        kernel="fused",
        snapshots=SnapshotSpec(every=EVERY_MPC_OUT, fields=("vz",)))


def _mpc_outputs(root, ranks=None):
    """(d) and (e) through run_with_outputs under ``root``: (d)
    uninterrupted, each cut and resumed from its checkpoint directory
    (every rank reads the file; (d)'s cut at an odd step is saved from
    ``state_dict`` by the writing rank). Returns ``({tag: flat result}``
    for "d_full", "d_resumed", "d_at_cut", "e_full" (``run()`` without
    outputs), "e_resumed" and "e_host_copies", ``{tag: points/s}`` of
    (d)'s uninterrupted run and (e)'s resumed one)."""
    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.parallel.multihost import files_written, writes_files
    from gcm_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    b32, c32 = _mpc_contact32()

    def d_engine():
        return _mpc_engine(b32, c32, "2x2", ranks, _mask32())

    def d_out(eng, where):
        return eng.run_with_outputs(os.path.join(root, where),
                                    snapshot_every=16, checkpoint_every=8)

    full = d_out(d_engine(), "d_full")
    out, rates = {"d_full": _mpc_flat(full)}, {"d": full.points_per_second}
    part = d_engine()
    _check(part.path == "fused_spmd", f"(d) path {part.path!r}")
    part.nsteps = CUT_CONTACT32
    d_out(part, "d_cut")
    ckdir = os.path.join(root, "d_cut", "checkpoints")
    state = part.state_dict()
    if writes_files(part.mesh):
        save_checkpoint(ckdir, CUT_CONTACT32, state)
    files_written(part.mesh)
    again = d_engine()
    again.load_state(restore_checkpoint(ckdir))
    out["d_resumed"] = _mpc_flat(d_out(again, "d_cut"))
    out["d_at_cut"] = {"bonded_0": np.asarray(state["bonded"]["0"])}

    task = _mpc_explosion()
    mesh = _mp_mesh(3, (2, 2), [torch.device("cuda", 0)] * 4, ranks)

    def e_out(eng, where):
        return eng.run_with_outputs(os.path.join(root, where),
                                    checkpoint_every=EVERY_MPC_OUT)

    # the uninterrupted run without outputs: its state and traces are what
    # the resumed run must give
    out["e_full"] = _mpc_flat(Engine(task, mesh=mesh).run())
    part = Engine(task, mesh=mesh)
    part.nsteps = EVERY_MPC_OUT
    e_out(part, "e_cut")
    again = Engine(task, mesh=mesh)
    again.load_state(restore_checkpoint(os.path.join(root, "e_cut",
                                                     "checkpoints")))
    resumed = e_out(again, "e_cut")
    out["e_resumed"], rates["e"] = (_mpc_flat(resumed),
                                    resumed.points_per_second)
    out["e_host_copies"] = {"part": np.asarray(part.host_copies),
                            "again": np.asarray(again.host_copies)}
    return out, rates


def _same_files(tag, got_root, want_root):
    """Fail unless the two trees hold the same files: ``.npz`` with equal
    arrays (a zip member records its write time), every other file with
    equal bytes. Returns the number of files."""
    def tree(root):
        return {os.path.relpath(os.path.join(d, n), root):
                os.path.join(d, n) for d, _, ns in os.walk(root) for n in ns}

    got, want = tree(got_root), tree(want_root)
    _check(sorted(got) == sorted(want),
           f"{tag}: files {sorted(got)} against {sorted(want)}")
    for rel, path in got.items():
        if rel.endswith(".npz"):
            with np.load(path) as a, np.load(want[rel]) as b:
                _check(sorted(a.files) == sorted(b.files) and all(
                    np.array_equal(a[k], b[k]) for k in a.files),
                    f"{tag}: {rel} holds other arrays")
        else:
            with open(path, "rb") as a, open(want[rel], "rb") as b:
                _check(a.read() == b.read(), f"{tag}: {rel} differs")
    return len(got)


def multiproc_contact_paths(counts, result):
    """Phase 20: the contact runs (a)-(c) and the outputs (d), (e) by two
    ranks on cuda:0 under gloo, each against the same run in one process on
    the same mesh bit for bit; the two-rank checkpoints resume in one
    process exactly. With two or more cards, (f): (a)-(c) again under
    NCCL, a card a rank (``_mpc_nccl``)."""
    import shutil
    import tempfile

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.utils.checkpoint import restore_checkpoint

    t0 = time.perf_counter()
    refs = _mpc_refs()
    root = tempfile.mkdtemp(prefix="multiproc_contact_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        t_refs, t0 = time.perf_counter() - t0, time.perf_counter()
        one = os.path.join(root, "one")
        outs, one_rates = _mpc_outputs(one)
        torch.cuda.empty_cache()
        ranks_dir = os.path.join(root, "ranks")
        os.makedirs(ranks_dir)
        t_outs, t0 = time.perf_counter() - t0, time.perf_counter()
        _mp_spawn(ranks_dir, "gloo", "--multiproc-contact-rank")
        t_ranks, t0 = time.perf_counter() - t0, time.perf_counter()
        with open(os.path.join(ranks_dir, "gloo.json")) as f:
            got = json.load(f)
        for tag, want in list(refs.items()) + [
                (k, (v, None, None)) for k, v in outs.items()]:
            want = want[0]
            with np.load(os.path.join(ranks_dir, f"{tag}.npz")) as z:
                arrays = {k: z[k] for k in z.files}
            _check(sorted(arrays) == sorted(want),
                   f"two ranks ({tag}): {sorted(arrays)}")
            for k, w in want.items():
                _check(np.array_equal(arrays[k], w),
                       f"two ranks ({tag}) {k} differs from one process: max "
                       f"|difference| {np.abs(arrays[k] - w).max():.3e}")
            for r in (0, 1):
                _check(got["digests"][r][tag] == _digest(want),
                       f"rank {r} ({tag}) differs from one process")
        for tag, bodies, _, mesh in _mpc_cases():
            g = got[tag]
            idle = ("not measured" if g["idle_share"] is None
                    else f"{g['idle_share']:.4f}")
            print(f"two ranks ({tag}) contact {g['path']} on {mesh} x "
                  f"{bodies['upper'].time.nsteps} steps under gloo, both on "
                  f"cuda:0: {g['points_per_s']:.6g} points/s on rank 0 (one "
                  f"process {refs[tag][1]:.6g}); bodies, masks and traces of "
                  f"both ranks equal to the one-process run bit for bit (bond"
                  f" mean {refs[tag][0]['bonded_0'].mean():.6f}); launches a "
                  f"rank {g['launches']}; cross-rank contact fixup on rank 0 "
                  f"{g['fixup_host_ms']:.4f} host ms a step (median of 20), "
                  f"{g['fixup_share']:.4f} of the loop's wall; device idle "
                  f"share {idle} (traced, both ranks' busy time over the "
                  "wall)")
        # (d): no broken cell heals across the resume
        start, at_cut = _mask32(), outs["d_at_cut"]["bonded_0"]
        end = outs["d_full"]["bonded_0"]
        _check((at_cut <= start).all() and (end <= at_cut).all()
               and end.mean() < at_cut.mean(),
               "(d): a broken cell healed, or the interface did not break "
               "further after the cut")
        for tag in ("d", "e"):
            for k, w in outs[f"{tag}_full"].items():
                _check(np.array_equal(outs[f"{tag}_resumed"][k], w),
                       f"({tag}) resumed {k} differs from the uninterrupted "
                       "run")
        nfiles = sum(_same_files(f"two ranks ({w})", os.path.join(
            ranks_dir, w), os.path.join(one, w)) for w in (
                "d_full", "d_cut", "e_cut"))
        # the two ranks' checkpoints at the cuts resume in one process
        b32, c32 = _mpc_contact32()
        eng = _mpc_engine(b32, c32, "2x2")
        eng.load_state(restore_checkpoint(os.path.join(
            ranks_dir, "d_cut", "checkpoints"), step=CUT_CONTACT32))
        _same_state("(d) two-rank checkpoint resumed in one process", [
            (k, v, outs["d_full"][k])
            for k, v in _mpc_flat(eng.run()).items()])
        task = _mpc_explosion()
        eng = Engine(task, mesh=_mp_mesh(3, (2, 2),
                                         [torch.device("cuda", 0)] * 4))
        eng.load_state(restore_checkpoint(os.path.join(
            ranks_dir, "e_cut", "checkpoints"), step=EVERY_MPC_OUT))
        _same_state("(e) two-rank checkpoint resumed in one process", [
            (k, v, outs["e_full"][k])
            for k, v in _mpc_flat(eng.run()).items()])
        print(f"two ranks (d) n=32 contact x {NSTEPS_CONTACT32} through "
              f"run_with_outputs, cut at {CUT_CONTACT32} and resumed on both "
              f"ranks: equal to the uninterrupted run, bond mean "
              f"{start.mean():.4f} at the start, {at_cut.mean():.4f} at the "
              f"cut, {end.mean():.4f} at the end, no broken cell healed; (e) "
              f"{task.name} {task.grid.shape} x {NSTEPS_MPC_OUT} with a "
              f"snapshot and a checkpoint every {EVERY_MPC_OUT}, cut at "
              f"{EVERY_MPC_OUT} and resumed: equal (host copies "
              f"{outs['e_host_copies']['part'].tolist()} + "
              f"{outs['e_host_copies']['again'].tolist()}); {nfiles} files "
              f"equal to the one-process run's (one checkpoint file a step); "
              f"the two-rank checkpoints of (d) and (e) resume in one process"
              f" bit for bit; run_with_outputs on two ranks (d) "
              f"{got['rates']['d']:.6g}, (e) resumed {got['rates']['e']:.6g}"
              f" points/s (one process {one_rates['d']:.6g}, "
              f"{one_rates['e']:.6g})")
        print(f"phase 20: one-process runs {t_refs:.1f} s, one-process "
              f"outputs {t_outs:.1f} s, two ranks {t_ranks:.1f} s, the "
              f"comparisons {time.perf_counter() - t0:.1f} s")
        # the kernels held on rank 1's shard, beside rank 0's rate, fixup
        # and idle share of their path, as printed above
        for name, entry in got["kernels"].items():
            g = got["b" if name == "sweep_stage" else "a"]
            entry = dict(entry, points_per_s=g["points_per_s"],
                         fixup_host_ms=g["fixup_host_ms"],
                         fixup_host_share=g["fixup_share"],
                         idle_share=g["idle_share"])
            result[name].update({f"multiproc_contact_{k}": v
                                 for k, v in entry.items()})
        if torch.cuda.device_count() >= 2:
            _mpc_nccl(root, refs)
        else:
            print("nccl: contact not run (1 card)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _mpc_refs():
    """Phase 20's contact runs (a)-(c) in one process on cuda:0: ``{tag:
    (flat result, points/s, path)}``."""
    refs = {}
    for tag, bodies, contacts, mesh in _mpc_cases():
        _mpc_engine({k: _short(t) for k, t in bodies.items()}, contacts,
                    mesh).run()
        eng = _mpc_engine(bodies, contacts, mesh)
        res = eng.run()
        refs[tag] = (_mpc_flat(res), res.points_per_second, eng.path)
        print(f"one-process ({tag}) contact 2 x {N_CONTACT}x{N_CONTACT}x"
              f"{N_CONTACT // 2} {eng.path} on {mesh} shards of cuda:0 x "
              f"{res.nsteps} steps: {res.points_per_second:.6g} points/s")
        del eng, res
    torch.cuda.empty_cache()
    return refs


def _mpc_nccl(root, refs):
    """(f): phase 20's contact runs (a)-(c) by two ranks under NCCL, one a
    card (cuda:0 and cuda:1), each against ``refs[tag]``, its one-process
    run on cuda:0 (flat result, points/s, path): both ranks' bodies, bond
    masks and traces bit for bit."""
    work = os.path.join(root, "nccl")
    os.makedirs(work)
    _mp_spawn(work, "nccl", "--multiproc-contact-rank")
    with open(os.path.join(work, "nccl.json")) as f:
        got = json.load(f)
    for tag, bodies, _, mesh in _mpc_cases():
        want, rate, path = refs[tag]
        with np.load(os.path.join(work, f"{tag}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        _check(sorted(arrays) == sorted(want),
               f"nccl ({tag}): {sorted(arrays)}")
        for k, w in want.items():
            _check(np.array_equal(arrays[k], w),
                   f"nccl ({tag}) {k} differs from one process: max "
                   f"|difference| {np.abs(arrays[k] - w).max():.3e}")
        for r in (0, 1):
            _check(got["digests"][r][tag] == _digest(want),
                   f"nccl rank {r} ({tag}) differs from one process")
        g = got[tag]
        _check(g["path"] == path, f"nccl ({tag}): path {g['path']!r}")
        idle = ("not measured" if g["idle_share"] is None else ", ".join(
            f"cuda:{r} {v:.4f}" for r, v in enumerate(g["idle_share"])))
        print(f"nccl: two ranks ({tag}) contact {g['path']} on {mesh} x "
              f"{bodies['upper'].time.nsteps} steps, one card a rank: "
              f"{g['points_per_s']:.6g} points/s on rank 0 (one process on "
              f"cuda:0 {rate:.6g}); bodies, masks and traces of both ranks "
              f"equal to the one-process run bit for bit; launches a rank "
              f"{g['launches']}; cross-rank contact fixup on rank 0 "
              f"{g['fixup_host_ms']:.4f} host ms a step (median of 20), "
              f"{g['fixup_share']:.4f} of the loop's wall; idle share by "
              f"card (traced) {idle}")
    return got


def _mpc_worker(rank, coord, workdir, backend):
    """One rank of phase 20: the contact runs (a)-(c) on its mesh row, their
    launches, cross-rank fixup host ms and idle share, then the outputs (d),
    (e) under ``workdir``; rank 0 saves every result, each rank its
    digests. Rank 1 then holds rows 6a and 6b on its shard of (a)'s lower
    body and row 4 on its x-halo-extended block of (b)'s, with the slabs
    rank 0 sent, against their plain versions and times them."""
    import torch.distributed as dist

    import gcm_tpu_torch.solver.multi as smulti
    from gcm_tpu_torch.ops import _build
    from gcm_tpu_torch.parallel import multihost
    from gcm_tpu_torch.parallel.faces import ShardedFaces

    _check(multihost.initialize(coord, 2, rank, backend=backend,
                                timeout=MP_TIMEOUT), "no process group")
    _build.load()
    counts = Counts()
    out, kernels, digests = {}, {}, {}
    ranks = (0, 0, 1, 1)
    #: gloo: both ranks on cuda:0; NCCL: one card a rank
    devs = (None if backend == "gloo"
            else [torch.device("cuda", r) for r in ranks])

    def save(tag, arrays):
        digests[tag] = _digest(arrays)
        if rank == 0:
            np.savez(os.path.join(workdir, f"{tag}.npz"), **arrays)

    calls = []

    def timed(fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            calls[-1] += (time.perf_counter() - t0) * 1e3
            return r
        return wrapper

    for tag, bodies, contacts, mesh in _mpc_cases():
        _mpc_engine({k: _short(t) for k, t in bodies.items()}, contacts,
                    mesh, ranks, devices=devs).run()
        eng = _mpc_engine(bodies, contacts, mesh, ranks, devices=devs)
        nsteps = eng.nsteps
        want = {"a": dict(fused_spmd_interior=4 * nsteps,
                          fused_spmd_ring=4 * nsteps),
                "b": dict(sweep_stage=12 * nsteps),
                "c": dict(fused_spmd_interior=4 * nsteps,
                          fused_spmd_ring=4 * nsteps)}[tag]
        path = {"a": "fused_spmd", "b": "sweep_spmd",
                "c": "fused_canonical_spmd"}[tag]
        _check(eng.path == path, f"rank {rank} ({tag}): path {eng.path!r}")
        dist.barrier()
        counts.zero()
        res = eng.run()
        launched = counts.read()
        counts.expect(f"rank {rank} ({tag})", launched, **want)
        save(tag, _mpc_flat(res))
        # the cross-rank contact fixup inside the step loop: the fused
        # forms' face-row phase; the per-sweep form's face gathers, contact
        # solves and row write-backs
        names = ([(smulti, "apply_contact_fixups")] if tag != "b" else
                 [(smulti, "apply_contact_post"), (ShardedFaces, "faces"),
                  (ShardedFaces, "put_face")])
        real = [getattr(o, n) for o, n in names]
        for (o, n), fn in zip(names, real):
            setattr(o, n, timed(fn))
        calls.clear()
        dist.barrier()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            us, bonded, auxs = eng.us, eng.bonded, eng.auxs
            for i in range(20):
                calls.append(0.0)
                us, bonded, auxs = eng._one_step(us, bonded, auxs,
                                                 i % eng.nsteps)
            torch.cuda.synchronize()
            loop_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for (o, n), fn in zip(names, real):
                setattr(o, n, fn)
        dist.barrier()
        wall, busy = _device_busy(_multi_steps(eng, 20 if tag != "b"
                                               else 10))
        walls = multihost.all_gather_object((wall, busy))
        # gloo: the ranks take turns on cuda:0, busy for the sum of their
        # busy times; NCCL: each rank's card on its own
        idle = (None if any(b is None for _, b in walls)
                else 1 - sum(b for _, b in walls) / max(w for w, _ in walls)
                if backend == "gloo" else [1 - b / w for w, b in walls])
        out[tag] = dict(
            path=eng.path, points_per_s=res.points_per_second,
            launches={k: v for k, v in launched.items() if v},
            fixup_host_ms=float(np.median(calls)),
            fixup_share=sum(calls) / loop_ms, loop_ms=loop_ms,
            idle_share=idle, traced_wall_ms=wall, busy_ms=busy)
        print(f"rank {rank} ({tag}): {out[tag]}", flush=True)
        if tag in ("a", "b") and backend == "gloo":
            kernels.update(_mpc_hold(rank, tag, eng, launched))
        del eng, res
        torch.cuda.empty_cache()
    if backend == "gloo":
        outs, out["rates"] = _mpc_outputs(workdir, ranks)
        for tag, arrays in outs.items():
            save(tag, arrays)
    gathered = multihost.all_gather_object((digests, kernels))
    if rank == 0:
        with open(os.path.join(workdir, f"{backend}.json"), "w") as f:
            json.dump(dict(out, digests=[d for d, _ in gathered],
                           kernels=gathered[1][1]), f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _mpc_hold(rank, tag, eng, launched):
    """Rows 6a and 6b ((a)) or 4 ((b)) on rank 1's first shard of the lower
    body, which holds the source (the wave reaches the upper body only
    after about 60 steps), with its halo slabs from rank 0's shards (every
    rank takes part in the exchange): each against its plain version under
    2e-6 a step and timed (rank 1; rank 0 waits). Fails if the shard or
    what rank 0 sent is all zero, where any kernel would agree. Returns the
    kernels' ``multiproc_contact_*`` keys (without the prefix)."""
    import torch.distributed as dist

    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import exchange_slabs
    from gcm_tpu_torch.parallel.halo import halo_exchange

    mesh, model, k, body = eng.mesh, eng.model, 2, "lower"
    r, us = stencil_radius(eng.order), eng.us[body]
    where = (f"rank 1's shard {k} of the lower body on the two-rank contact"
             f" path ({tag})")
    if tag == "b":
        ext = halo_exchange(us, mesh, "sx", 1, r)[k]
    else:
        slabs = exchange_slabs(us, mesh, r)[k]
    out = {}
    if rank == 1:
        i, j = mesh.coords(k)
        _check(mesh.ranks[k] == 1 and mesh.ranks[mesh.index(i - 1, j)] == 0,
               f"({tag}): shard {k} is not rank 1's, or its x-low "
               "neighbour not rank 0's")
        # the x-low halo is shard 0's, which rank 0 sent
        own, sent = ((ext[:, r:-r], ext[:, :r]) if tag == "b"
                     else (us[k], slabs[0]))
        for what, t in (("the block", own), ("the slab rank 0 sent", sent)):
            _check(bool(t.abs().amax() > 0),
                   f"{where}: {what} is all zero, so the kernel check "
                   "could not fail")
        print(f"{where}: max |u| {own.abs().amax().item():.6g} on the "
              f"block, {sent.abs().amax().item():.6g} in the x-low slab "
              "from rank 0", flush=True)
        if tag == "a":
            entries, _ = _spmd_kernels_on_shard(
                f"{where}, ", model, us, eng._mstacks[body], mesh, k,
                eng.dt, eng.hs[body], eng.order, eng._kernel_bcs[body],
                eng._fwd, slabs=slabs)
        else:
            entries = {"sweep_stage": _sweep_on_block(
                f"{where} (x halo from rank 0)", model, ext,
                eng._sweep_mats[body][k]["ax0"].mat, eng.dt,
                eng.hs[body], 0, eng.order)}
        for name, e in entries.items():
            out[name] = dict(e, launches=launched[name])
            print(f"{name} on {where}: {out[name]}", flush=True)
    dist.barrier()
    return out


def _spmd_canonical_vs_plain(meshes):
    """Both SPMD kernels against their plain versions in the canonical
    orders under a mesh, (2, 0, 1) and (1, 0, 2), on the cases of
    ``SPMD_CANON_CASES`` (``_spmd_steps_vs_plain``)."""
    worst, nk = _spmd_steps_vs_plain(np.random.default_rng(18), [
        (shape, meshes[m], order, axes)
        for shape, m, order, axes in SPMD_CANON_CASES])
    print(f"fused_spmd_interior/ring in the canonical orders (2, 0, 1) and "
          f"(1, 0, 2) on 2x2, 4x1 and sx=4 shards: {nk} launches over "
          f"{len(SPMD_CANON_CASES)} problems, worst normalized error "
          f"{worst:.3e} (limit 2e-6); every sharded step vs the unsharded "
          "plain step under 2e-6")


# ------------------------------------------------------------------- bench

def _bench_bounds(model, shape, contact_shape, order, n_simplex, k_simplex,
                  sc_nodes, k_sc):
    """Phase 21: the most points/s each rate of the bench's line could
    read: the points of a step over the bounds of the launches it makes
    (rows 1, 2, 4 and 5 of the kernel table, their bytes and operations as
    ``_bound`` counts them)."""
    def simplex_ms(n_nodes, k):
        flops = n_nodes * sum(len(st.pairs) * (8 * k + 20)
                              for st in model.stages) / 3
        return _bound(B_SIMPLEX * n_nodes, flops)[0]

    npts = int(np.prod(shape))
    nbody = int(np.prod(contact_shape))
    flops = _step_flops(model, order, npts)
    fused = _bound(B_FUSED3 * npts, flops)[0]
    per_ms = {
        "jnp_points_per_s": (npts, fused),
        "pallas_points_per_s": (npts, 3 * _bound(B_SWEEP * npts,
                                                 flops / 3)[0]),
        "value": (npts, fused),
        "visco_points_per_s": (npts, _bound((B_FUSED3 + 8) * npts,
                                            flops)[0]),
        "contact_points_per_s": (2 * nbody, 2 * _bound(
            B_FUSED3 * nbody, _step_flops(model, order, nbody))[0]),
        "simplex_points_per_s": (n_simplex[0], 3 * simplex_ms(
            n_simplex[0], k_simplex)),
        "simplex_points_per_s_n65": (n_simplex[1], 3 * simplex_ms(
            n_simplex[1], k_simplex)),
        "simplex_points_per_s_n65_jnp": (n_simplex[1], 3 * simplex_ms(
            n_simplex[1], k_simplex)),
        "simplex_contact_points_per_s": (sum(sc_nodes), 3 * sum(
            simplex_ms(n, k_sc) for n in sc_nodes)),
    }
    return {k: pts / (ms * 1e-3) for k, (pts, ms) in per_ms.items()}


def _bench_simplex_setups(conn):
    """Send the bench's simplex setups, ``{n: (grid, tables, seconds)}``,
    through ``conn``: host work only, run in a process of its own
    (``HostSetup``) on one thread at the lowest priority, so that it
    takes no more than a spare core from the phases timed beside it."""
    from gcm_tpu_torch import bench

    os.nice(19)
    torch.set_num_threads(1)
    out = {}
    for n in bench.SIMPLEX_SIZES:
        t0 = time.perf_counter()
        grid, tables = bench.simplex_setup(n)
        out[n] = (grid, tables, time.perf_counter() - t0)
    conn.send(out)
    conn.close()


def _simplex_task_setup(conn):
    """Send phase 8's task and the seconds its mesh took through ``conn``:
    ``simplex3d_layered`` at N_SIMPLEX, whose Delaunay mesh (~50-80 s of
    host) is built in a process of its own (``HostSetup``) beside the
    build."""
    from gcm_tpu_torch.scenarios import get_scenario

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    task = get_scenario("simplex3d_layered", n=N_SIMPLEX)
    conn.send((task, time.perf_counter() - t0))
    conn.close()


def _simplex_contact_setup(conn):
    """Send phase 17's bench configuration, ``(bodies, contacts,
    seconds)``: ``bench.simplex_contact_bodies(N_SC, HALF_SC)``, whose two
    Delaunay meshes (~10-25 s of host) are built in a process of its own
    (``HostSetup``) beside the build."""
    from gcm_tpu_torch.bench import simplex_contact_bodies

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    bodies, contacts = simplex_contact_bodies(N_SC, HALF_SC)
    conn.send((bodies, contacts, time.perf_counter() - t0))
    conn.close()


class HostSetup:
    """Host work that needs no card, run by ``target(conn)`` in a process
    of its own beside the card's phases: the meshes of phases 8 and 17
    from before the build on (``_simplex_task_setup``,
    ``_simplex_contact_setup``), phase 21's simplex setups (the
    bench's 33^3 and 65^3 jittered unit boxes: Delaunay and foot tables,
    ~80 s of host) from phase 3 on (``_bench_simplex_setups``, one thread
    at the lowest priority); ``get`` waits for what it sends (and raises
    if that process died), ``stop`` ends it."""

    def __init__(self, target):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=target, args=(send,), daemon=True)
        self._proc.start()
        send.close()

    def get(self, timeout=900):
        if not self._conn.poll(timeout):
            raise TimeoutError(f"bench setup: nothing after {timeout} s")
        return self._conn.recv()

    def stop(self):
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()


def bench_phase(counts, result, simplex_task, sc_setup, bench_setup):
    """Phase 21: ``gcm_tpu_torch.bench.main`` in this process at
    256x256x128 with every path; its launches and rates held to the
    bench's step counts and the kernels' bounds; then the CLI's ``bench
    --path fused``."""
    import contextlib
    import io

    from gcm_tpu_torch import bench, cli
    from gcm_tpu_torch.models.spec import get_model
    from gcm_tpu_torch.scenarios import elastic3d_contact

    n65 = bench.SIMPLEX_SIZES[1]
    t0 = time.perf_counter()
    built = bench_setup.get()
    t_wait = time.perf_counter() - t0
    bench_setup.stop()
    grid, tables, _ = built[n65]
    # phase 8's mesh is simplex3d_layered's 150 m box of layered media:
    # neither its points nor (another medium, another dt) its tables are the
    # bench's, so the bench's unit boxes and tables were built apart
    same = (simplex_task.grid.points.shape == grid.points.shape
            and np.array_equal(simplex_task.grid.points, grid.points))
    print("bench setup: the jittered unit boxes and their foot tables, "
          "built on the host in a process of its own (one thread, nice 19) "
          "beside phases 3-20: "
          + ", ".join(f"n={n} {sec:.1f} s ({g.npoints} nodes)"
                      for n, (g, _, sec) in built.items())
          + f"; waited {t_wait:.1f} s for them here. Phase 8's mesh "
          f"({simplex_task.name}, points in [0, "
          f"{simplex_task.grid.points.max():.4g}] m) "
          f"{'has the same points' if same else 'has other points'} and "
          f"tables for another medium; the simplex contact bodies and "
          f"tables of phase 17 are reused")
    calls = 1 + bench.REPS
    want = dict(
        fused_step=calls * (bench.K_STEPS + 2 * bench.K_PAIRS),
        sweep_stage=3 * calls * bench.K_STEPS,
        fused_step_slab=2 * calls * 2 * bench.K_PAIRS,
        simplex_sweep=calls * bench.K_PAIRS * (
            6 * len(bench.SIMPLEX_SIZES) + 12))
    lines = []
    counts.zero()
    t0 = time.perf_counter()
    line = bench.main(bench.SHAPE, "best", "cuda",
                      simplex_setups={n: (g, t) for n, (g, t, _)
                                      in built.items()},
                      simplex_contact_setup=sc_setup, out=lines.append)
    t_bench = time.perf_counter() - t0
    launched = counts.read()
    for text in lines[:-1]:
        print(f"  {text}")
    print(f"bench: {lines[-1]}")
    counts.expect("bench", launched, **want)
    _check(json.loads(lines[-1]) == line, "bench: printed line differs")
    _check(re.fullmatch(re.escape(torch.cuda.get_device_name(0))
                        + r", \d+(\.\d+)? W", line["device"]) is not None,
           f"bench device {line['device']!r}: not the card's name and "
           "power limit in W")
    _check(line["contact_path"] == "fused_canonical"
           and line["simplex_path_n65"] == "simplex"
           and line["simplex_contact_path"] == "simplex",
           f"bench paths {line}")
    bodies, _ = elastic3d_contact(n=bench.CONTACT_N)
    body = next(iter(bodies.values()))
    k65 = next(iter(tables.values())).ids.shape[1]
    k_sc = next(iter(sc_setup[2]["a"].values())).ids.shape[1]
    bound = _bench_bounds(
        get_model("elastic3d"), bench.SHAPE, body.grid.shape, body.order,
        [n ** 3 for n in bench.SIMPLEX_SIZES], k65,
        [b.grid.npoints for b in sc_setup[0].values()], k_sc)
    rates = {k: line[k] for k in bound}
    _check(all(np.isfinite(v) and v > 0 for v in rates.values()),
           f"bench rates {rates}")
    for k, v in rates.items():
        print(f"  {k} {v:.6g} points/s, the bound allows {bound[k]:.6g} "
              f"({v / bound[k]:.4f} of it)")
        _check(v <= bound[k], f"bench {k} {v:.6g} above its bound "
               f"{bound[k]:.6g}: a missing synchronize?")
    print(f"bench: {t_bench:.1f} s; launches {launched}")
    for name in ("fused_step", "fused_step_slab", "sweep_stage",
                 "simplex_sweep"):
        result[name]["bench_launches"] = launched[name]

    buf = io.StringIO()
    counts.zero()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--path", "fused"])
    launched = counts.read()
    text = buf.getvalue().strip()
    print(f"bench --path fused (the CLI): {text}")
    one = json.loads(text.splitlines()[-1])
    counts.expect("bench --path fused", launched,
                  fused_step=calls * bench.K_STEPS)
    _check(rc == 0 and one["path"] == "fused" and 0 < one["value"]
           <= bound["value"] and one["device"] == line["device"],
           f"bench --path fused: rc {rc}, line {one}")


# ------------------------------------ one process, a mesh over distinct cards

#: phase 22: one process drives a mesh with one card a shard, as the JAX
#: package runs its own multi-device mode (one process, a mesh over
#: ``jax.devices()``): (a) the 3D fused path of phase 4 on 2x2 cards for
#: NSTEPS_MC steps (strong scaling); (b) elastic3d_explosion at n =
#: N_MC_WEAK, 512x512x256, so that each card holds 256x256x256, for
#: NSTEPS_MC_WEAK (weak scaling); (c) the per-sweep and the folded Maxwell +
#: damage paths on 2x2 and the 2D path on sx=4; (d) the contact forms of
#: phase 18 at n=256 and the partly broken n=32 interface; (e) the CLI's
#: ``--mesh 2,2 --device cuda``. Each run equals bit for bit the same mesh
#: with every shard on cuda:0 (the same launches on the same bytes). With
#: two or three cards, (a) on 2x1 cards and the 2D path on sx=2.
NSTEPS_MC, N_MC_WEAK, NSTEPS_MC_WEAK = 300, 512, 100
NSTEPS_MC_SWEEP, NSTEPS_MC_VISCO, NSTEPS_MC_2D = 50, 50, 300
NSTEPS_MC_CONTACT, NSTEPS_MC_CLI = 100, 20
#: each mesh is first warmed by two steps of its run's task at n =
#: N_MC_WARM (the same kernels on shards with interior tiles), not at full
#: size: a warm engine costs the host as much to build as the run's own
N_MC_WARM = 64


def _sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _busy_by_card(run_steps):
    """(host wall ms, {card: device busy ms}) of ``run_steps()`` under
    torch.profiler: for each card the union of its kernel and copy events,
    overlaps counted once (a card without events is missing)."""
    from torch.profiler import ProfilerActivity, profile

    _sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps()
        _sync_all()
        wall = (time.perf_counter() - t0) * 1e3
    spans = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    return wall, {card: _union_ms(ss) for card, ss in spans.items()}


def _mc_loop(step, n, groups):
    """Host wall ms of ``n`` untraced ``step(i)`` and, for each group of
    ``groups`` ({label: [(owner, name), ...]}, wrapped for the loop only),
    the host ms spent in its functions in each step."""
    calls = {g: [] for g in groups}
    real = {g: [getattr(o, k) for o, k in fns] for g, fns in groups.items()}

    def wrap(fn, g):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                calls[g][-1] += (time.perf_counter() - t0) * 1e3
        return wrapper

    for g, fns in groups.items():
        for (o, k), fn in zip(fns, real[g]):
            setattr(o, k, wrap(fn, g))
    try:
        _sync_all()
        t0 = time.perf_counter()
        for i in range(n):
            for c in calls.values():
                c.append(0.0)
            step(i)
        _sync_all()
        loop = (time.perf_counter() - t0) * 1e3
    finally:
        for g, fns in groups.items():
            for (o, k), fn in zip(fns, real[g]):
                setattr(o, k, fn)
    return loop, calls


def _mc_measure(tag, step, step_ms, cards, groups, n=20):
    """For each group of ``groups`` (``_mc_loop``) the host ms a step of
    its functions (median of ``n`` untraced steps) and their share of the
    loop's wall, then each card's idle share over ``n`` traced steps (1 -
    its busy time over the wall; beside it the busy time a step over the
    untraced step ``step_ms``)."""
    loop, calls = _mc_loop(step, n, groups)
    wall, busy = _busy_by_card(lambda: [step(i) for i in range(n)])
    idle = {c: None if c not in busy else 1 - busy[c] / wall for c in cards}
    est = {c: None if c not in busy else 1 - busy[c] / n / step_ms
           for c in cards}
    host = {g: dict(host_ms=float(np.median(c)), share=sum(c) / loop)
            for g, c in calls.items()}

    def fmt(d):
        return ", ".join(f"cuda:{c} " + ("not measured" if v is None
                                         else f"{v:.4f}")
                         for c, v in d.items())

    spent = "; ".join(f"{g} {h['host_ms']:.4f} host ms a step (median of "
                      f"{n}), {h['share']:.4f} of the loop's wall"
                      for g, h in host.items())
    print(f"  {tag}: {spent} ({loop:.3f} ms for {n} steps); idle share by "
          f"card over {n} traced steps ({wall:.3f} ms): {fmt(idle)}; "
          f"untraced ~{fmt(est)} (step {step_ms:.4f} ms)")
    return dict(host=host, loop_ms=loop, traced_wall_ms=wall,
                idle_share=idle, idle_untraced=est,
                busy_ms={c: busy.get(c) for c in cards})


def _mc_run(tag, make, counts, want):
    """``make()``'s engine run once, the counters zeroed just before and
    read just after: (engine, result, launches)."""
    eng = make()
    counts.zero()
    res = eng.run()
    launched = counts.read()
    counts.expect(tag, launched, **want)
    return eng, res, launched


def _mc_same(tag, got, want):
    """Fail unless two flat results (``_mpc_flat``) are equal bit for
    bit."""
    _check(sorted(got) == sorted(want), f"{tag}: {sorted(got)}")
    for k, w in want.items():
        g = got[k]
        _check(g.shape == w.shape, f"{tag}: {k} of shape {g.shape}, the "
               f"co-resident run's {w.shape}")
        _check(np.array_equal(g, w), f"{tag}: {k} differs from the "
               f"co-resident run, max |difference| {np.abs(g - w).max()}")


def _print_peer_access(n):
    rows = [" ".join("-" if i == j else
                     "y" if torch.cuda.can_device_access_peer(i, j) else "n"
                     for j in range(n)) for i in range(n)]
    print(f"peer access between the {n} cards (row: from, column: to; "
          f"y can, n cannot): " + " | ".join(rows))


def _shard_task(task, block):
    """``task`` on a grid of one shard's extents, same spacing and origin
    (the per-card work of a weak-scaling run, on one card)."""
    return dataclasses.replace(task, grid=dataclasses.replace(
        task.grid, shape=tuple(block)))


def multicard_paths(counts, result):
    """Phase 22: one process, a mesh over distinct cards (see
    NSTEPS_MC): (a)-(e) with four or more cards, (a) and the 2D path on
    two cards with two or three. Every run equals its co-resident run bit
    for bit; each run's points/s, exchange host ms a step and share of the
    loop's wall, each card's idle share, and the scaling efficiencies."""
    import shutil
    import tempfile

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.parallel import fused_spmd as pfs
    from gcm_tpu_torch.parallel import halo
    from gcm_tpu_torch.parallel.faces import ShardedFaces
    from gcm_tpu_torch.parallel.sharding import (
        block_shape, domain_mesh, gather_state)
    from gcm_tpu_torch.scenarios import elastic3d_contact, get_scenario
    from gcm_tpu_torch.solver.correctors import (
        DamageCorrector, MaxwellCorrector)
    from gcm_tpu_torch.solver.gcm import cfl_dt
    import gcm_tpu_torch.solver.multi as smulti

    ncard = torch.cuda.device_count()
    if ncard < 2:
        print(f"phase 22: not run ({ncard} card)")
        return
    _print_peer_access(ncard)
    full = ncard >= 4
    nc = 4 if full else 2
    devs = [torch.device("cuda", i) for i in range(nc)]
    dev0 = devs[0]
    cards = list(range(nc))
    shape3 = (2, 2) if full else (2, 1)
    slab = {"slab exchange": [(pfs.SlabExchange, "__call__"),
                              (pfs.SlabExchange, "wait")]}
    out = {}

    def meshes(dim, shape=None):
        return (domain_mesh(dim, devs, shape),
                domain_mesh(dim, [dev0] * nc, shape))

    def single(tag, task, dim, shape, want, warm=None, aux=False):
        """``task`` on distinct cards and co-resident, each mesh first
        warmed by the small task ``warm`` (the same kernels): both runs,
        equal bit for bit (state, traces and, with ``aux``, the damage).
        Returns (engine, result, launches, co-resident engine and
        result)."""
        mesh, co = meshes(dim, shape)
        for m in (mesh, co) if warm is not None else ():
            Engine(warm, mesh=m).run()
        eng, res, launched = _mc_run(tag, lambda: Engine(task, mesh=mesh),
                                     counts, want)
        _check(np.isfinite(res.u).all() and np.abs(res.u).max() > 0,
               f"{tag}: state not finite or zero")
        got = _mpc_flat(res)
        if aux:
            got["damage"] = gather_state(eng.aux["damage"], mesh, lead=0,
                                         device="cpu").numpy()
        ref = Engine(task, mesh=co)
        rres = ref.run()
        want_flat = _mpc_flat(rres)
        if aux:
            want_flat["damage"] = gather_state(ref.aux["damage"], co, lead=0,
                                               device="cpu").numpy()
        _mc_same(f"{tag} on {mesh.shape} cards", got, want_flat)
        return eng, res, launched, ref, rres

    def measure(tag, step, ref_step, npts, res, rres, groups, n=20):
        """``_mc_measure`` of a run on the cards, then of its co-resident
        run on cuda:0 (the same exchange's host ms without copies
        between cards)."""
        m = _mc_measure(tag, step, npts / res.points_per_second * 1e3,
                        cards, groups, n)
        m["co_resident"] = _mc_measure(
            f"{tag} every shard on cuda:0", ref_step,
            npts / rres.points_per_second * 1e3, [0], groups, n)
        return m

    def one_step(eng):
        return lambda i: eng._one_step_mesh(eng.u, eng.aux, i % eng.nsteps)

    def multi_step(eng):
        st = [eng.us, eng.bonded, eng.auxs]

        def step(i):
            st[:] = eng._one_step(*st, i % eng.nsteps)
        return step

    def step_npts(task):
        return int(np.prod(task.grid.shape))

    def report(tag, task, res, rres, m, extra=""):
        print(f"{tag} {task.name} {task.grid.shape} kernel={res.kernel} on "
              f"{nc} cards ({'x'.join(map(str, m))}) x {res.nsteps} steps: "
              f"{res.points_per_second:.6g} points/s (all shards on cuda:0 "
              f"{rres.points_per_second:.6g}); state and traces equal to "
              f"the co-resident run bit for bit{extra}")

    # ---- (a) strong scaling: the 3D fused path of phase 4
    task = get_scenario("elastic3d_explosion", n=N_MAIN, nsteps=NSTEPS_MC)
    eng, res, launched, ref, rres = single(
        "(a)", task, 3, shape3, dict(fused_spmd_interior=nc * NSTEPS_MC,
                                     fused_spmd_ring=nc * NSTEPS_MC),
        warm=get_scenario("elastic3d_explosion", n=N_MC_WARM, nsteps=2))
    one = Engine(task, device=dev0).run()
    err = _np_err(res.u, one.u)
    terr = float(np.abs(res.traces - one.traces).max()
                 / np.abs(one.traces).max())
    _check(err < 2e-6 and terr < 2e-6,
           f"(a) vs the unsharded fused run: err {err:.3e}, traces "
           f"{terr:.3e}")
    eff = res.points_per_second / (nc * one.points_per_second)
    report("(a)", task, res, rres, shape3,
                     f"; vs the unsharded fused run on one card "
                     f"{one.points_per_second:.6g} points/s: normalized "
                     f"error {err:.3e}, traces {terr:.3e} (limit 2e-6); "
                     f"strong-scaling efficiency {eff:.4f}")
    m = measure("(a)", one_step(eng), one_step(ref), step_npts(task), res,
                rres, slab)
    out["a"] = dict(points_per_s=res.points_per_second,
                    co_resident_points_per_s=rres.points_per_second,
                    unsharded_points_per_s=one.points_per_second,
                    strong_efficiency=eff, **m)
    # rows 6a and 6b on the last card's shard, which the source touches
    k = nc - 1
    _check(eng.u[k].device == devs[k] and bool(eng.u[k].abs().amax() > 0),
           f"(a): shard {k} is not on cuda:{k} or is all zero")
    with torch.cuda.device(devs[k]):
        entries, _ = _spmd_kernels_on_shard(
            f"cuda:{k}'s ", eng.model, eng.u, eng._carry, eng.mesh, k,
            eng.dt, task.grid.h, task.order, task.borders, (0, 1, 2))
    for name, e in entries.items():
        result[name].update({f"multicard_{key}": v for key, v in
                             dict(e, launches=launched[name],
                                  points_per_s=res.points_per_second,
                                  card=k).items()})
    del eng, ref, res, rres, one

    # ---- (b) weak scaling: each card a 256x256x256 shard
    if full:
        taskw = get_scenario("elastic3d_explosion", n=N_MC_WEAK,
                             nsteps=NSTEPS_MC_WEAK)
        eng, res, _, ref, rres = single(
            "(b)", taskw, 3, shape3,
            dict(fused_spmd_interior=nc * NSTEPS_MC_WEAK,
                 fused_spmd_ring=nc * NSTEPS_MC_WEAK))
        block = block_shape(eng.mesh, taskw.grid.shape)
        alone = Engine(_shard_task(taskw, block), device=dev0).run()
        eff = res.points_per_second / (nc * alone.points_per_second)
        report("(b)", taskw, res, rres, shape3,
                         f"; one card alone on a {block} shard "
                         f"{alone.points_per_second:.6g} points/s: "
                         f"weak-scaling efficiency {eff:.4f}")
        m = measure("(b)", one_step(eng), one_step(ref), step_npts(taskw),
                    res, rres, slab)
        out["b"] = dict(points_per_s=res.points_per_second,
                        co_resident_points_per_s=rres.points_per_second,
                        shard_alone_points_per_s=alone.points_per_second,
                        weak_efficiency=eff, **m)
        del eng, ref, res, rres, alone
        torch.cuda.empty_cache()

    # ---- (c) the per-sweep, folded and 2D sharded paths
    if full:
        tsw = dataclasses.replace(get_scenario(
            "elastic3d_explosion", n=N_MAIN, nsteps=NSTEPS_MC_SWEEP),
            kernel="sweep")
        eng, res, launched, ref, rres = single(
            "(c) per-sweep", tsw, 3, shape3,
            dict(sweep_stage=3 * nc * NSTEPS_MC_SWEEP),
            warm=dataclasses.replace(get_scenario(
                "elastic3d_explosion", n=N_MC_WARM, nsteps=2),
                kernel="sweep"))
        report("(c) per-sweep", tsw, res, rres, shape3)
        out["c_sweep"] = dict(
            points_per_s=res.points_per_second,
            co_resident_points_per_s=rres.points_per_second,
            **measure("(c) per-sweep", one_step(eng), one_step(ref),
                      step_npts(tsw), res, rres,
                      {"halo exchanges": [(halo, "halo_exchange")]}, 10))
        result["sweep_stage"].update(
            multicard_launches=launched["sweep_stage"],
            multicard_points_per_s=res.points_per_second)
        del eng, ref, res, rres

        def visco(n, nsteps):
            base = get_scenario("elastic3d_layered", n=n, nsteps=nsteps)
            dt6 = cfl_dt(base.material_fields(), base.grid.h,
                         base.time.cfl)
            return dataclasses.replace(base, correctors=(
                MaxwellCorrector(tau=50 * dt6),
                DamageCorrector(threshold=5e5, rate=0.1 / dt6)))

        tv = visco(N_MAIN, NSTEPS_MC_VISCO)
        eng, res, _, ref, rres = single(
            "(c) folded", tv, 3, shape3,
            dict(fused_spmd_interior=nc * NSTEPS_MC_VISCO,
                 fused_spmd_ring=nc * NSTEPS_MC_VISCO),
            warm=visco(N_MC_WARM, 2), aux=True)
        _check(eng._fold_specs is not None and eng._fold_naux == 1,
               "(c) folded: the correctors are not folded")
        report("(c) folded", tv, res, rres, shape3,
                         ", damage too")
        out["c_folded"] = dict(
            points_per_s=res.points_per_second,
            co_resident_points_per_s=rres.points_per_second,
            **measure("(c) folded", one_step(eng), one_step(ref),
                      step_npts(tv), res, rres, slab))
        del eng, ref, res, rres

    t2 = get_scenario("elastic2d_viscoelastic", n=N_2D, nsteps=NSTEPS_MC_2D)
    eng, res, launched, ref, rres = single(
        "(c) 2D", t2, 2, None, dict(fused_spmd_2d=2 * nc * NSTEPS_MC_2D),
        warm=get_scenario("elastic2d_viscoelastic", n=4 * N_MC_WARM,
                          nsteps=2))
    report("(c) 2D", t2, res, rres, (nc,))
    out["c_2d"] = dict(
        points_per_s=res.points_per_second,
        co_resident_points_per_s=rres.points_per_second,
        **measure("(c) 2D", one_step(eng), one_step(ref), step_npts(t2),
                  res, rres, slab))
    result["fused_spmd_2d"].update(
        multicard_launches=launched["fused_spmd_2d"],
        multicard_points_per_s=res.points_per_second)
    del eng, ref, res, rres
    if not full:
        print(f"phase 22: (b), (c) per-sweep and folded, (d) and (e) not "
              f"run ({ncard} cards; they take 2x2)")
        print(f"phase 22: {json.dumps(out)}")
        return

    # ---- (d) contact: the forms of phase 18 at n=256, then n=32 broken
    bodies, contacts = elastic3d_contact(n=N_CONTACT,
                                         nsteps=NSTEPS_MC_CONTACT)
    npts = sum(int(np.prod(t.grid.shape)) for t in bodies.values())

    def sweep_of(b):
        return {k: dataclasses.replace(t, kernel="sweep")
                for k, t in b.items()}

    small, small_contacts = elastic3d_contact(n=N_MC_WARM, nsteps=2)
    per = 2 * nc * NSTEPS_MC_CONTACT
    fused_groups = dict(slab, **{
        "contact fixup": [(smulti, "apply_contact_fixups")]})
    sweep_groups = {
        "halo exchanges": [(halo, "halo_exchange")],
        "contact fixup": [(smulti, "apply_contact_post"),
                          (ShardedFaces, "faces"),
                          (ShardedFaces, "put_face")]}
    for form, b, warm, mesh_of, want, groups in (
            ("fused_spmd", bodies, small, "2x2",
             dict(fused_spmd_interior=per, fused_spmd_ring=per),
             fused_groups),
            ("fused_canonical_spmd", bodies, small, "sx4",
             dict(fused_spmd_interior=per, fused_spmd_ring=per),
             fused_groups),
            ("sweep_spmd", sweep_of(bodies), sweep_of(small), "2x2",
             dict(sweep_stage=3 * per), sweep_groups)):
        def make(devices, b=b, mesh_of=mesh_of):
            return _mpc_engine(b, contacts, mesh_of, devices=devices)

        for d in (devs, [dev0] * 4):
            _mpc_engine(warm, small_contacts, mesh_of, devices=d).run()
        tag = f"(d) {form}"
        eng, res, launched = _mc_run(tag, lambda: make(devs), counts, want)
        _check(eng.path == form, f"{tag}: path {eng.path!r}")
        ref = make([dev0] * 4)
        rres = ref.run()
        _mc_same(f"{tag} on {mesh_of} cards", _mpc_flat(res),
                 _mpc_flat(rres))
        print(f"{tag} contact 2 x {N_CONTACT}x{N_CONTACT}x{N_CONTACT // 2} "
              f"on {mesh_of} cards x {res.nsteps} steps: "
              f"{res.points_per_second:.6g} points/s (all shards on cuda:0 "
              f"{rres.points_per_second:.6g}); bodies, bond masks and "
              f"traces equal to the co-resident run bit for bit (bond mean "
              f"{res.bonded[0].mean():.6f}); launches "
              f"{ {k: v for k, v in launched.items() if v} }")
        out[f"d_{form}"] = dict(
            points_per_s=res.points_per_second,
            co_resident_points_per_s=rres.points_per_second,
            **measure(tag, multi_step(eng), multi_step(ref), npts, res,
                      rres, groups))
        del eng, ref, res, rres
    b32, c32 = _mpc_contact32()
    got32, want32 = (
        _mpc_engine(b32, c32, "2x2", mask=_mask32(), devices=d).run()
        for d in (devs, [dev0] * 4))
    _mc_same("(d) n=32 from a partly broken mask", _mpc_flat(got32),
             _mpc_flat(want32))
    _check(got32.bonded[0].mean() < _mask32().mean(),
           "(d) n=32: the interface did not break further")
    print(f"(d) n=32 contact on 2x2 cards x {got32.nsteps} steps from a "
          f"partly broken mask: equal to the co-resident run bit for bit, "
          f"bond mean {_mask32().mean():.4f} at the start, "
          f"{got32.bonded[0].mean():.4f} at the end")

    # ---- (e) the CLI, one card a shard
    root = tempfile.mkdtemp(prefix="multicard_cli_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        for scenario, key, want_val in (
                ("elastic3d_explosion", "kernel", "fused"),
                ("elastic3d_contact", "path", "fused_spmd")):
            cmd = [sys.executable, "-m", "gcm_tpu_torch", "run", scenario,
                   "--n", str(N_MAIN), "--nsteps", str(NSTEPS_MC_CLI),
                   "--mesh", "2,2", "--device", "cuda", "--outdir",
                   os.path.join(root, scenario)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600, cwd=os.path.dirname(
                                      os.path.abspath(__file__)))
            _check(proc.returncode == 0, f"(e) {' '.join(cmd[1:])} exited "
                   f"{proc.returncode}: {proc.stderr[-2000:]}")
            summary = json.loads(proc.stdout.strip().splitlines()[-1])
            _check(summary[key] == want_val and summary["mesh"] == "2,2"
                   and summary["points_per_second"] > 0,
                   f"(e) {scenario}: {summary}")
            if scenario == "elastic3d_contact":
                _check(summary["launches"] == dict(
                    fused_spmd_interior=8 * NSTEPS_MC_CLI,
                    fused_spmd_ring=8 * NSTEPS_MC_CLI),
                    f"(e) contact launches {summary['launches']}")
            print(f"(e) python -m gcm_tpu_torch {' '.join(cmd[3:])}: "
                  f"{key} {summary[key]}, mesh {summary['mesh']}, "
                  f"{summary['points_per_second']:.6g} points/s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 22: {json.dumps(out)}")


def main() -> int:
    t_start = time.perf_counter()

    def phase(name):
        print(f"[{time.perf_counter() - t_start:.1f} s] {name}", flush=True)
    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.ops import _build
    from gcm_tpu_torch.ops.fused import (
        fused_step, fused_step_2d, fused_step_2d_occupancy,
        fused_step_2d_reference, fused_step_reference,
        fused_step_slab_occupancy)
    from gcm_tpu_torch.ops.sweep import sweep_stage
    from gcm_tpu_torch.scenarios import get_scenario
    from gcm_tpu_torch.solver.correctors import (
        DamageCorrector, MaxwellCorrector)
    from gcm_tpu_torch.solver.gcm import cfl_dt, stage

    # ---- 8's and 17's meshes, in processes of their own from here on
    mesh_setup = HostSetup(_simplex_task_setup)
    contact_mesh_setup = HostSetup(_simplex_contact_setup)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    for line in log.splitlines():
        if line.startswith("nvcc "):
            print(f"  {line}")
    _print_ptxas(log)

    # ---- 21's host setup, in a process of its own from here on
    bench_setup = HostSetup(_bench_simplex_setups)

    # ---- 3. kernel vs plain on the card
    phase("kernels vs plain")
    kernels_vs_plain()
    spmd_kernels_vs_plain()
    slab_kernels_vs_plain()
    counts = Counts()
    result = {}

    # ---- 4. the 3D main path
    phase("3D path")
    task = get_scenario("elastic3d_explosion", n=N_MAIN, nsteps=NSTEPS)
    _warm(task, ("auto", "torch"))
    eng = Engine(task, device="cuda")
    counts.zero()
    res = eng.run()
    launched = counts.read()
    _check(res.kernel == "fused", f"3D path resolved to {res.kernel!r}")
    counts.expect("3D path", launched, fused_step=NSTEPS)
    shape = (eng.model.ncomp,) + task.grid.shape
    _check(res.u.shape == shape and np.isfinite(res.u).all(),
           "final state is not finite or has wrong shape")
    vz_surface = np.abs(res.u[eng.model.comp("vz"), :, :, 0]).max()
    _check(vz_surface > 0, "no motion at the free surface")
    _check(res.traces is not None and np.abs(res.traces).max() > 0,
           "detector traces are zero")
    res_t = Engine(dataclasses.replace(task, kernel="torch"),
                   device="cuda").run()
    path_err = _np_err(res.u, res_t.u)
    _check(path_err < PATH_TOL, f"fused vs torch path: err {path_err:.3e}")
    print(f"3D path {task.name} {task.grid.shape} x {NSTEPS} steps: "
          f"fused {res.points_per_second:.6g} points/s, torch "
          f"{res_t.points_per_second:.6g} points/s; fused vs torch "
          f"normalized error {path_err:.3e} (limit 1e-4); |vz| at z=0 "
          f"{vz_surface:.3e}; {launched['fused_step']} fused_step launches")

    # one step on the path's own state: error and time of both versions
    u3, ms3 = eng.u, eng._mstack
    args = (eng.model, u3, ms3, eng.dt, task.grid.h, task.order,
            task.borders, (0, 1, 2))
    *_, max_abs = _hold_on_path_state("fused_step on the 3D state",
                                      fused_step, fused_step_reference, args)
    ms = _time_ms(lambda: fused_step(*args), 20)
    plain_ms = _time_ms(lambda: fused_step_reference(*args), 5)
    print(f"fused_step at {tuple(u3.shape)}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    npts3 = int(np.prod(task.grid.shape))
    result["fused_step"] = dict(
        launches=launched["fused_step"], max_abs_err=max_abs, ms=ms,
        plain_ms=plain_ms, **_bound_entry(B_FUSED3 * npts3, _step_flops(
            eng.model, task.order, npts3)),
        **_occupancy(fused_step_slab_occupancy(*args)))

    # the per-sweep kernel alone on the 3D path's state, each axis
    sw_ms, sw_plain, sw_err = [], [], 0.0
    for axis in range(3):
        a = (eng.model, u3, eng.mat, eng.dt, task.grid.h, axis, task.order,
             task.borders)
        *_, max_abs = _hold_on_path_state(
            f"sweep_stage on the 3D state, axis {axis}", sweep_stage,
            lambda model, u, mat, *rest: stage(
                model, u, _mat_as(mat, u.dtype), *rest), a)
        sw_err = max(sw_err, max_abs)
        sw_ms.append(_time_ms(lambda: sweep_stage(*a), 20))
        sw_plain.append(_time_ms(lambda: stage(*a), 5))
        print(f"sweep_stage at {tuple(u3.shape)} axis {axis}: kernel "
              f"{sw_ms[-1]:.4f} ms, plain {sw_plain[-1]:.4f} ms")
    del eng, res_t, u3, ms3, args

    # ---- 5. the 2D viscoelastic path
    phase("2D path")
    task2 = get_scenario("elastic2d_viscoelastic", n=N_2D, nsteps=NSTEPS_2D)
    _warm(task2, ("auto", "torch"))
    eng2 = Engine(task2, device="cuda")
    _check(eng2._fold_specs is None, "2D path with a source folded")
    counts.zero()
    res2 = eng2.run()
    launched2 = counts.read()
    _check(res2.kernel == "fused", f"2D path resolved to {res2.kernel!r}")
    counts.expect("2D path", launched2, fused_step_2d=NSTEPS_2D)
    _check(np.isfinite(res2.u).all() and np.isfinite(res2.traces).all(),
           "2D path: state or traces not finite")
    _check(np.abs(res2.traces).max() > 0, "2D path: traces are zero")
    cmp2 = dataclasses.replace(task2, time=dataclasses.replace(
        task2.time, nsteps=NSTEPS_2D_CMP))
    r2f = Engine(cmp2, device="cuda").run()
    r2t = Engine(dataclasses.replace(cmp2, kernel="torch"),
                 device="cuda").run()
    err2 = _np_err(r2f.u, r2t.u)
    _check(err2 < PATH_TOL, f"2D fused vs torch: err {err2:.3e}")
    print(f"2D path {task2.name} {task2.grid.shape} x {NSTEPS_2D} steps: "
          f"fused {res2.points_per_second:.6g} points/s, "
          f"{launched2['fused_step_2d']} fused_step_2d launches, Maxwell "
          f"after the source; receiver |v|max "
          f"{np.abs(res2.traces[:, 0, :2]).max():.4e}; after "
          f"{NSTEPS_2D_CMP} steps fused {r2f.points_per_second:.6g} vs torch "
          f"{r2t.points_per_second:.6g} points/s, normalized error "
          f"{err2:.3e} (limit 1e-4)")
    args2 = (eng2.model, eng2.u, eng2._mstack, eng2.dt, task2.grid.h,
             task2.order, task2.borders, (0, 1))
    *_, max_abs = _hold_on_path_state("fused_step_2d on the 2D state",
                                      fused_step_2d, fused_step_2d_reference,
                                      args2)
    ms2 = _time_ms(lambda: fused_step_2d(*args2), 50)
    plain2 = _time_ms(lambda: fused_step_2d_reference(*args2), 10)
    print(f"fused_step_2d at {tuple(eng2.u.shape)}: kernel {ms2:.4f} ms, "
          f"plain {plain2:.4f} ms")
    # the bf16 stack and two steps a pass on the same state
    ms16 = eng2._mstack.to(torch.bfloat16)
    for tag, stack, seq, nb in (
            ("bf16 K=1", ms16, ((0, 1),), B_FUSED2_BF16),
            ("f32 K=2", eng2._mstack, ((0, 1), (1, 0)), B_FUSED2),
            ("bf16 K=2", ms16, ((0, 1), (1, 0)), B_FUSED2_BF16)):
        a2 = args2[:2] + (stack,) + args2[3:7]
        t = _time_ms(lambda: fused_step_2d(*a2, axes_seq=seq), 50)
        print(f"fused_step_2d {tag} at {tuple(eng2.u.shape)}: kernel "
              f"{t:.4f} ms a launch ({t / len(seq):.4f} a step), bound "
              f"{_bound(nb * eng2.u[0].numel(), 0)[0]:.4f} ms")
    # the per-sweep kernel on the 2D state, each axis
    sw2_ms = []
    for axis in range(2):
        a2 = (eng2.model, eng2.u, eng2.mat, eng2.dt, task2.grid.h, axis,
              task2.order, task2.borders)
        _hold_on_path_state(
            f"sweep_stage on the 2D state, axis {axis}", sweep_stage,
            lambda model, u, mat, *rest: stage(
                model, u, _mat_as(mat, u.dtype), *rest), a2)
        sw2_ms.append(_time_ms(lambda: sweep_stage(*a2), 50))
        n2 = eng2.u[0].numel()
        b2 = _bound(B_SWEEP2 * n2, _step_flops(eng2.model, task2.order, n2)
                    / 2)[0]
        print(f"sweep_stage at {tuple(eng2.u.shape)} axis {axis}: kernel "
              f"{sw2_ms[-1]:.4f} ms, bound {b2:.4f} ms")
    npts2 = int(np.prod(task2.grid.shape))
    result["fused_step_2d"] = dict(
        launches=launched2["fused_step_2d"], max_abs_err=max_abs, ms=ms2,
        plain_ms=plain2, **_bound_entry(B_FUSED2 * npts2, _step_flops(
            eng2.model, task2.order, npts2)),
        **_occupancy(fused_step_2d_occupancy(*args2)))
    del eng2, r2f, r2t, args2

    # ---- 6. the folded corrector path (source-free 3D layered)
    phase("folded corrector path")
    base = get_scenario("elastic3d_layered", n=N_MAIN, nsteps=NSTEPS_VISCO)
    dt = cfl_dt(base.material_fields(), base.grid.h, base.time.cfl)
    task6 = dataclasses.replace(base, correctors=(
        MaxwellCorrector(tau=50 * dt),
        DamageCorrector(threshold=5e5, rate=0.1 / dt)))
    _warm(task6, ("auto", "torch"))
    eng6 = Engine(task6, device="cuda")
    _check(eng6._fold_specs is not None and eng6._fold_naux == 1,
           "source-free visco path did not fold its correctors")
    counts.zero()
    res6 = eng6.run()
    launched6 = counts.read()
    counts.expect("visco path", launched6, fused_step=NSTEPS_VISCO)
    dmg = eng6.aux["damage"].cpu().numpy()
    _check(dmg.max() > 0, "visco path: damage stayed zero")
    eng6t = Engine(dataclasses.replace(task6, kernel="torch"), device="cuda")
    res6t = eng6t.run()
    err6 = _np_err(res6.u, res6t.u)
    dmg_t = eng6t.aux["damage"].cpu().numpy()
    derr6 = float(np.abs(dmg - dmg_t).max() / max(np.abs(dmg_t).max(), 1e-30))
    _check(err6 < PATH_TOL and derr6 < PATH_TOL,
           f"visco folded vs torch: state {err6:.3e}, damage {derr6:.3e}")
    print(f"visco path {task6.name} {task6.grid.shape} x {NSTEPS_VISCO} "
          f"steps, Maxwell + damage folded: fused {res6.points_per_second:.6g}"
          f" points/s, torch (unfolded) {res6t.points_per_second:.6g} "
          f"points/s; normalized error state {err6:.3e}, damage {derr6:.3e} "
          f"(limit 1e-4); damage max {dmg.max():.4g}, damaged share "
          f"{(dmg > 0).mean():.4g}")
    damage = eng6.aux["damage"].unsqueeze(0).contiguous()
    args6 = (eng6.model, eng6.u, eng6._mstack, eng6.dt, task6.grid.h,
             task6.order, task6.borders, (0, 1, 2))
    kw6 = dict(correctors=eng6._fold_specs, aux=damage)
    (_, gaux), (_, waux), _ = _hold_on_path_state(
        "fused_step + folded Maxwell/damage on the visco state", fused_step,
        fused_step_reference, args6, kw6)
    torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)
    ms6 = _time_ms(lambda: fused_step(*args6, **kw6), 20)
    plain6 = _time_ms(lambda: fused_step_reference(*args6, **kw6), 5)
    print(f"fused_step + folded Maxwell/damage at {tuple(eng6.u.shape)}: "
          f"kernel {ms6:.4f} ms, plain {plain6:.4f} ms")
    del eng6, eng6t, gaux, waux, args6, kw6, damage

    # ---- 7. the per-sweep path
    phase("per-sweep path")
    task7 = dataclasses.replace(get_scenario(
        "elastic3d_explosion", n=N_MAIN, nsteps=NSTEPS_SWEEP), kernel="sweep")
    _warm(task7, ("sweep",))
    eng7 = Engine(task7, device="cuda")
    counts.zero()
    res7 = eng7.run()
    launched7 = counts.read()
    _check(res7.kernel == "sweep", f"sweep path resolved to {res7.kernel!r}")
    counts.expect("sweep path", launched7, sweep_stage=3 * NSTEPS_SWEEP)
    res7f = Engine(dataclasses.replace(task7, kernel="fused"),
                   device="cuda").run()
    err7 = _np_err(res7.u, res7f.u)
    _check(err7 < PATH_TOL, f"sweep vs fused path: err {err7:.3e}")
    print(f"sweep path {task7.name} {task7.grid.shape} x {NSTEPS_SWEEP} "
          f"steps: sweep {res7.points_per_second:.6g} points/s, fused "
          f"{res7f.points_per_second:.6g} points/s; normalized error "
          f"{err7:.3e} (limit 1e-4); {launched7['sweep_stage']} sweep_stage "
          f"launches")
    result["sweep_stage"] = dict(
        launches=launched7["sweep_stage"], max_abs_err=sw_err,
        ms=float(np.mean(sw_ms)), plain_ms=float(np.mean(sw_plain)),
        ms_by_axis=sw_ms, ms_2d_by_axis=sw2_ms,
        **_bound_entry(B_SWEEP * npts3, _step_flops(
            eng7.model, task7.order, npts3) / 3))
    del eng7, res7, res7f

    # ---- 8. the simplex path
    phase("simplex path")
    simplex_kernel_vs_plain()
    simplex = simplex_path(counts, result, mesh_setup)

    # ---- 10-11. the sharded paths
    phase("sharded paths")
    sharded_paths(counts, result)

    # ---- 13-14. the contact paths and the pair-fused body
    phase("contact paths")
    contact_paths(counts, result)
    phase("pair-fused path")
    pair_fused_path(counts, result)

    # ---- 15. orthotropic media
    phase("orthotropic kernels vs plain")
    ortho_kernels_vs_plain()
    phase("orthotropic paths")
    ortho_paths(counts, result)

    # ---- 16. outputs and resume
    phase("outputs and resume")
    outputs_and_resume(counts, *simplex)

    # ---- 17. the simplex contact path
    phase("simplex contact path")
    sc_setup = simplex_contact_path(counts, result, contact_mesh_setup)

    # ---- 18. the contact path on a mesh
    phase("contact mesh path")
    contact_mesh_path(counts, result)

    # ---- 19. one run across two processes
    phase("multi-process paths")
    multiproc_paths(counts, result)

    # ---- 20. the contact path and the outputs across two processes
    phase("multi-process contact paths")
    multiproc_contact_paths(counts, result)

    # ---- 21. the benchmark
    phase("bench")
    bench_phase(counts, result, simplex[0], sc_setup, bench_setup)
    del sc_setup

    # ---- 22. one process, a mesh over distinct cards
    phase("multi-card paths")
    multicard_paths(counts, result)

    sources = {
        "fused_step": ("gcm_tpu_torch/csrc/fused_step_slab.cu",
                       "gcm_tpu/ops/pallas_fused.py:1162"),
        "fused_step_slab": ("gcm_tpu_torch/csrc/fused_step_slab.cu",
                            "gcm_tpu/ops/pallas_fused.py:807"),
        "fused_step_slab_k2": ("gcm_tpu_torch/csrc/fused_pair_stream.cuh",
                               "gcm_tpu/ops/pallas_fused.py:807"),
        "fused_step_2d": ("gcm_tpu_torch/csrc/fused_step_2d.cu",
                          "gcm_tpu/ops/pallas_fused.py:1035"),
        "fused_step_2d_k2": ("gcm_tpu_torch/csrc/fused_step_2d.cu",
                             "gcm_tpu/ops/pallas_fused.py:1035"),
        "sweep_stage": ("gcm_tpu_torch/csrc/sweep_stage.cu",
                        "gcm_tpu/ops/pallas_stage.py:366"),
        "simplex_sweep": ("gcm_tpu_torch/csrc/simplex_sweep.cu",
                          "gcm_tpu/ops/pallas_simplex.py:411"),
        "fused_spmd_interior": ("gcm_tpu_torch/csrc/fused_spmd.cu",
                                "gcm_tpu/parallel/fused_spmd.py:230"),
        "fused_spmd_ring": ("gcm_tpu_torch/csrc/fused_spmd.cu",
                            "gcm_tpu/parallel/fused_spmd.py:338"),
        "fused_spmd_2d": ("gcm_tpu_torch/csrc/fused_spmd_2d.cu",
                          "gcm_tpu/parallel/fused_spmd.py:736"),
    }
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **result[name]} for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multiproc-rank"]:   # a rank of phase 19
        sys.exit(_mp_worker(int(sys.argv[2]), *sys.argv[3:6]))
    if sys.argv[1:2] == ["--multiproc-contact-rank"]:   # a rank of phase 20
        sys.exit(_mpc_worker(int(sys.argv[2]), *sys.argv[3:6]))
    sys.exit(main())
