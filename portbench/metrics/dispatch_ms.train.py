"""Host ms to enqueue one train step on a staged batch, on an empty queue:
the median of the traced run's probes."""

LAYER = "entry"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.loop != "train":
        return None
    return ctx.span_ms("dispatch")
