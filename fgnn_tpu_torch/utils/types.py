"""Small CLI helpers (counterpart of ``fgnn_tpu/utils/types.py``)."""

import argparse

_BOOL_WORDS = {
    "yes": True, "true": True, "t": True, "y": True, "1": True,
    "no": False, "false": False, "f": False, "n": False, "0": False,
}


def str2bool(v: str) -> bool:
    """An argparse ``type`` for yes/no flags, case-insensitive."""
    try:
        return _BOOL_WORDS[v.strip().lower()]
    except KeyError:
        raise argparse.ArgumentTypeError(
            f"expected a boolean, got {v!r}") from None
