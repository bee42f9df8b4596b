"""``kernel_roofline`` and ``kernel_roofline.<part>``: the least time of a
step's bytes at the card's published memory rate over the busiest card's
busy time a step, in the traced stretch; kernels renamed, fused or split
leave the count as it is (each moves its cell's rate)."""

from gcm_bench.harness.reading import roofline_share


def read(ctx):
    return roofline_share(ctx)
