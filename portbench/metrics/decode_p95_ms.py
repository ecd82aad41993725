"""The 95th percentile, over every batch the closed loop completed in the
measured window, of the time from a batch's submission to its decisions
on the host.  The loop keeps the card saturated (two batches in flight),
so this tail follows the host's speed from machine to machine; it stands
beside the window's rate, which it moves, and carries no bound."""

import numpy as np

LAYER = "entry"
UNIT = "ms"
MOVES = "decode_words_per_s"
SOURCE = "host_clock"


def read(ctx):
    lat = ctx.window.get("latencies")
    if ctx.loop != "decode_closed" or not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
