"""fgnn_tpu_torch — the PyTorch/CUDA port of fgnn_tpu for NVIDIA Hopper.

Module names mirror the JAX package (``fgnn_tpu``), which stays the
reference the port is tested against.  The port imports torch and numpy
only: never JAX, and nothing of ``fgnn_tpu``.  Features keep the
``(batch, nodes, channels)`` layout and the filter column layout
``c*T + t`` of the JAX package, so weights carry across unchanged
(``models.from_jax``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``cpu`` is asked
    for.  Raises when CUDA is wanted and missing: never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
