"""As typed_mp_roofline.decode, over the train step's forward and backward
ops; none where the step launches no such op."""

LAYER = "conv and kernels"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.loop != "train":
        return None
    return ctx.typed_mp_roofline()
