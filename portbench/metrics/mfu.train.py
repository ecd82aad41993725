"""Three times the forward's operations per step (the benchmark's count)
times the window's steps over its seconds, against 67 TFLOP/s."""

LAYER = "model"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.loop != "train":
        return None
    return ctx.mfu()
