"""The least time of every typed gather-mix-aggregate op in the traced
window (its bytes over 3.35 TB/s or its operations over 67 TFLOP/s,
whichever is larger, from its shapes) over the device time of the kernels
launched inside the op's forward and backward ranges."""

LAYER = "conv and kernels"
UNIT = "%"
MOVES = "decode_words_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.loop != "decode_closed":
        return None
    return ctx.typed_mp_roofline()
