"""``slab_exchange_host_ms`` (ms): host milliseconds a step inside the slab
exchange between shards (its call and its wait), timed around both for the
untraced window's steps (moves ``mesh_points_per_s``)."""

from gcm_bench.harness.reading import host_ms_per_step

WRAP = ["gcm_tpu_torch.parallel.fused_spmd:SlabExchange.__call__",
        "gcm_tpu_torch.parallel.fused_spmd:SlabExchange.wait"]


def read(ctx):
    return host_ms_per_step(ctx, WRAP)
