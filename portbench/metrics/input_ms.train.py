"""Host ms to stage one train batch from the pinned pool, on an empty queue:
the median of the traced run's probes."""

LAYER = "host batch staging"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.loop != "train":
        return None
    return ctx.span_ms("input")
