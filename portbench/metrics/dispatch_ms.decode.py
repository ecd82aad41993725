"""Host ms to enqueue one batch's decode (forward and decisions; staging
taken out), on an empty queue: the median of the traced run's probes."""

LAYER = "entry"
UNIT = "ms"
MOVES = "decode_words_per_s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.loop != "decode_closed":
        return None
    return ctx.span_ms("dispatch")
