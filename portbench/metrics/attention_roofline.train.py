"""The least time of the masked attention's forward work in the op trace
(q, k, v read and the output written once over 3.35 TB/s, or 4 d + 5
operations per allowed pair of the code's mask and head over 67 TFLOP/s,
whichever is larger; ``ecct_yardstick.py``) over the device time of the
kernels launched inside the program's ``attention`` spans, in %; none
where the program opens no such span."""

from portbench import ecct_yardstick

LAYER = "attention"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.loop != "train" or ctx.ops is None:
        return None
    return ecct_yardstick.attention_roofline(ctx.ops)
