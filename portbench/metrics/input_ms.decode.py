"""Host ms to stage one batch from the pinned pool (the table check and the
copies' enqueue), on an empty queue: the median of the traced run's
probes."""

LAYER = "host batch staging"
UNIT = "ms"
MOVES = "decode_words_per_s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.loop != "decode_closed":
        return None
    return ctx.span_ms("input")
