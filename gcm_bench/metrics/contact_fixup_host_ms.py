"""``contact_fixup_host_ms`` (ms): host milliseconds a step inside the
contact face-row fixups, timed around the function for the untraced
window's steps (moves ``contact_points_per_s``)."""

from gcm_bench.harness.reading import host_ms_per_step

WRAP = ["gcm_tpu_torch.solver.multi:apply_contact_fixups"]


def read(ctx):
    return host_ms_per_step(ctx, WRAP)
