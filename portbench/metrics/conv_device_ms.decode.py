"""Device ms per decoded batch of the kernels launched inside the
program's ``conv`` spans (each ``MPConv``'s ``x @ W``, gather-mix-aggregate
and bias; not its BatchNorm), from the op trace
(``program_spans.device_ms``); none where the program opens no such
span."""

from portbench import program_spans

LAYER = "conv and kernels"
UNIT = "ms"
MOVES = "decode_words_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.loop != "decode_closed":
        return None
    return program_spans.device_ms(ctx.ops, "conv")
