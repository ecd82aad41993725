"""Device ms per train step of the kernels, copies and memsets launched
inside the program's ``attention`` spans (the code-aware masked attention
alone, not its q, k, v and output maps), from the op trace
(``program_spans.device_ms``); none where the program opens no such
span."""

from portbench import program_spans

LAYER = "attention"
UNIT = "ms"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.loop != "train":
        return None
    return program_spans.device_ms(ctx.ops, "attention")
