"""The model's operations per batch (every dense layer and x @ W, plus
2 K T C per destination row of each conv; the benchmark's count) times the
window's batches over its seconds, against 67 TFLOP/s (f32 outside the
tensor cores)."""

LAYER = "model"
UNIT = "%"
MOVES = "decode_words_per_s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.loop != "decode_closed":
        return None
    return ctx.mfu()
