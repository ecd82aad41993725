"""The typed-edge gather + edge-type mix + K-aggregation forward on Hopper.

Counterpart of ``fgnn_tpu/ops/fused_mp.py``: the CUDA kernel in
``csrc/typed_mp_fwd.cu`` replaces the Pallas TPU kernel
``fgnn_tpu/ops/fused_mp.py:_fwd_kernel`` (NO_EXTENSION mode).  For h
(B, N_src, T, C), a shared table nn_idx (Nd, K) and etype (B, Nd, K, T):

    m[b, d, k, c] = sum_t etype[b, d, k, t] * h[b, nn_idx[d, k], t, c]
    out[b, d, c]  = AGG_k m[b, d, k, c]       (max / sum / mean / softmax)

plus, for max, the first-win argmax over k (strict ``>``, as the TPU
kernel) as uint8.  ``h = x @ W_tmajor`` stays a plain matmul outside.

Bound on the H100: bytes and launches, not operations (f2v at B=256,
C=64 moves about 20 MB, 6 us at 3.35 TB/s, for 38 MFLOP); the kernel
streams each byte once and keeps the per-edge messages in registers.  The
source's header note has the details.

Beside the kernel, as every kernel of the port has them:

* ``typed_gather_mix_agg_plain``: the plain PyTorch version (index gather,
  T-contraction, aggregation with an explicit first-win argmax);
* ``COUNTS``: plain integer counters of kernel launches and plain calls;
* ``typed_gather_mix_agg``: the wrapper.  A CPU tensor goes to the plain
  version, a CUDA tensor to the kernel, or the wrapper raises; nothing
  falls back;
* ``TypedGatherMixAgg``: the ``autograd.Function`` around the wrapper.

The kernel library is built with ``nvcc`` at first use, from the package's
own source, into ``csrc/build/`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

AGGREGATORS = {"max": 0, "sum": 1, "mean": 2, "softmax": 3}
MAX_K = 255  # the argmax is stored as uint8

COUNTS = {"kernel_launches": 0, "plain_calls": 0}

_NO_BWD = ("the backward of the typed-mp forward kernel is not ported yet: "
           "ROADMAP.md, port queue item 1 (fgnn_tpu/ops/fused_mp.py:"
           "_bwd_kernel as this Function's backward)")

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
SOURCE = os.path.join(_CSRC, "typed_mp_fwd.cu")
BUILD_DIR = os.path.join(_CSRC, "build")
LIBRARY = os.path.join(BUILD_DIR, "libtyped_mp_fwd.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib = None


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def build(force: bool = False):
    """Compile ``csrc/typed_mp_fwd.cu`` unless the library is newer than
    the source.  Returns (seconds spent, compiler log)."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, LIBRARY)  # atomic: concurrent builders never see half
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        fn = lib.typed_mp_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _first_win_max(msgs: torch.Tensor):
    """Max over dim 2 with the first maximal k as argmax (strict ``>``)."""
    acc = msgs[:, :, 0]
    am = torch.zeros(acc.shape, dtype=torch.uint8, device=msgs.device)
    for k in range(1, msgs.shape[2]):
        take = msgs[:, :, k] > acc
        acc = torch.where(take, msgs[:, :, k], acc)
        am = am.masked_fill(take, k)
    return acc, am


def typed_gather_mix_agg_plain(h, nn_idx, etype, aggregator: str,
                               gamma: float = 3.0, want_argmax: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    from .typed_mp import aggregate

    hg = h[:, nn_idx.long()]                            # (B, Nd, K, T, C)
    msgs = (hg * etype[..., None]).sum(dim=3)           # (B, Nd, K, C)
    if aggregator == "max":
        out, am = _first_win_max(msgs)
        return (out, am) if want_argmax else out
    return aggregate(msgs, aggregator, gamma)


def check_kernel_args(h, nn_idx, etype, aggregator: str, want_argmax: bool):
    """Raise unless the kernel takes these arguments: one CUDA device, f32
    h (B, N, T, C) and etype (B, Nd, K, T), an int32 shared table (Nd, K)
    with 0 < K <= 255, all contiguous, one of the four aggregators."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if want_argmax and aggregator != "max":
        raise ValueError("the argmax exists for the max aggregator only")
    if h.dim() != 4 or nn_idx.dim() != 2 or etype.dim() != 4:
        raise ValueError(
            f"expected h (B, N, T, C), a shared nn_idx (Nd, K) and etype "
            f"(B, Nd, K, T); got {tuple(h.shape)}, {tuple(nn_idx.shape)}, "
            f"{tuple(etype.shape)}")
    B, N, T, C = h.shape
    Nd, K = nn_idx.shape
    if tuple(etype.shape) != (B, Nd, K, T):
        raise ValueError(f"etype {tuple(etype.shape)} does not match "
                         f"(B, Nd, K, T) = {(B, Nd, K, T)}")
    if min(B, N, T, C, Nd) <= 0 or not 0 < K <= MAX_K:
        raise ValueError(f"unsupported sizes B={B} N={N} T={T} C={C} "
                         f"Nd={Nd} K={K} (0 < K <= {MAX_K})")
    if h.dtype != torch.float32 or etype.dtype != torch.float32 \
            or nn_idx.dtype != torch.int32:
        raise TypeError(f"expected f32 h and etype and an int32 table; got "
                        f"{h.dtype}, {etype.dtype}, {nn_idx.dtype}")
    for name, t in (("h", h), ("nn_idx", nn_idx), ("etype", etype)):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def typed_gather_mix_agg(h, nn_idx, etype, aggregator: str,
                         gamma: float = 3.0, want_argmax: bool = False):
    """out (B, Nd, C) f32 [, argmax (B, Nd, C) uint8 for max].

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  ``nn_idx`` must hold valid rows of h: the kernel does not
    check the indices (``ops.typed_mp.GatherTable`` checks them once, on
    the host)."""
    if h.device.type == "cpu":
        COUNTS["plain_calls"] += 1
        return typed_gather_mix_agg_plain(h, nn_idx, etype, aggregator,
                                          gamma, want_argmax)
    if h.device.type != "cuda":
        raise ValueError(f"no typed-mp forward for device {h.device}")
    check_kernel_args(h, nn_idx, etype, aggregator, want_argmax)
    B, N, T, C = h.shape
    Nd, K = nn_idx.shape
    out = torch.empty((B, Nd, C), dtype=torch.float32, device=h.device)
    am = (torch.empty((B, Nd, C), dtype=torch.uint8, device=h.device)
          if want_argmax else None)
    vec4 = int(C % 4 == 0 and h.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(h.device):
        err = lib.typed_mp_fwd(
            h.data_ptr(), nn_idx.data_ptr(), etype.data_ptr(),
            out.data_ptr(), am.data_ptr() if am is not None else None,
            B, N, Nd, K, T, C, AGGREGATORS[aggregator], float(gamma), vec4,
            torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"typed_mp_fwd kernel launch failed: cudaError "
                           f"{err} (B={B} N={N} Nd={Nd} K={K} T={T} C={C})")
    COUNTS["kernel_launches"] += 1
    return (out, am) if want_argmax else out


class TypedGatherMixAgg(torch.autograd.Function):
    """``typed_gather_mix_agg`` as an autograd node.  The backward (the
    port of ``_bwd_kernel``) comes with the training slice."""

    @staticmethod
    def forward(ctx, h, etype, nn_idx, aggregator, gamma):
        return typed_gather_mix_agg(h, nn_idx, etype, aggregator, gamma)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(_NO_BWD)


def typed_mp_fwd(h, nn_idx, etype, aggregator: str, gamma: float = 3.0):
    """The autograd entry: out (B, Nd, C)."""
    return TypedGatherMixAgg.apply(h, etype, nn_idx, aggregator, float(gamma))
