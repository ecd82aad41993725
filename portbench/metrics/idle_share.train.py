"""1 - (the union of the device's operations / the traced window), in %."""

LAYER = "device"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.loop != "train":
        return None
    return ctx.idle_share()
