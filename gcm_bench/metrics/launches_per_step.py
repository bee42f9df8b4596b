"""``launches_per_step`` and ``launches_per_step.<part>``: the device's
kernels, copies and sets in the traced stretch over its steps, the mean
over the cards; an exact count that a CUDA graph or a fused fixup moves
(each moves its cell's rate)."""

from gcm_bench.harness.reading import launches


def read(ctx):
    return launches(ctx)
