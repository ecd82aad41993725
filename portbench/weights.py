"""The weights of a run, made on the card from the seed.

One draw of U(0, 1) for every parameter and statistic at once, from a
``torch.Generator`` on the device, mapped to each entry's range
(``reference.common.init_bounds``) in one more operation: the same seed
gives the same weights, and set-up makes no weight leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.common import init_bounds
from .workers import sub_seeds


def make(specs, seed: int, device) -> tuple:
    """(flat f32 tensor, {name: view of it}) of the configuration's
    parameter tree ``specs``."""
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    bounds = np.array([init_bounds(s) for s in specs], np.float32)
    lo = torch.as_tensor(np.repeat(bounds[:, 0], sizes), device=device)
    hi = torch.as_tensor(np.repeat(bounds[:, 1], sizes), device=device)
    gen = torch.Generator(device=device).manual_seed(
        sub_seeds(seed, "weights", 1)[0])
    u = torch.rand(sum(sizes), generator=gen, device=device)
    flat = lo + (hi - lo) * u
    return flat, views(flat, specs)


def views(flat, specs) -> dict:
    out, at = {}, 0
    for name, shape, _ in specs:
        n = int(np.prod(shape))
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out
