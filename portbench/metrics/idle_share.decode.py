"""1 - (the union of the device's operations / the traced window), in %."""

LAYER = "device"
UNIT = "%"
MOVES = "decode_words_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.loop != "decode_closed":
        return None
    return ctx.idle_share()
