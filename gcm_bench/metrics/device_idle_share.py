"""``device_idle_share`` and ``device_idle_share.<part>``: 1 - a traced
step's busy time over a step's wall time in the untraced window, the mean
over the cards the cell uses (each moves its cell's rate)."""

from gcm_bench.harness.reading import idle_share


def read(ctx):
    return idle_share(ctx)
