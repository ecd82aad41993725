"""The typed-edge gather + edge-type mix + K-aggregation on Hopper, forward
and backward.

Counterpart of ``fgnn_tpu/ops/fused_mp.py``: two hand-written CUDA kernels
replace its Pallas TPU kernels, in both of their modes,

* ``csrc/typed_mp_fwd.cu`` for ``_fwd_kernel``.  For h (B, N_src, T, C),
  a shared table nn_idx (Nd, K) and etype (B, Nd, K, T):

      m[b, d, k, c] = sum_t etype[b, d, k, t] * h[b, nn_idx[d, k], t, c]
      out[b, d, c]  = AGG_k m[b, d, k, c]     (max / sum / mean / softmax)

  plus, for max, the first-win argmax over k (strict ``>``, as the TPU
  kernel) as uint8.  NO_EXTENSION runs the first kernel of the port
  (``typed_mp_fwd``) in f32; in bf16 the sample route
  (``typed_mp_fwd_sample``, one block per sample with its whole h in
  shared memory), planned by ``fwd_sample``, and the first kernel where
  the plan refuses it (a sample too wide, C % 8 != 0, a batch too small to
  give every second SM a block).  The DIFF/NEIGHBOR mode has two routes, the staged
  kernel (``typed_mp_fwd_staged``, one block per sample, slab of channels
  and tile of rows out of shared memory), planned by ``fwd_slab`` from the
  shapes alone, and the first kernel where no slab fits; in bf16 the
  staged kernel runs its bf16 design (``fwd_bf16_plan``: etype rounded
  once in shared memory, 8 channels a thread), and ``kept=True`` keeps the
  f32 mode's design for it;
* ``csrc/typed_mp_bwd.cu`` for ``_bwd_kernel``.  From the cotangent g of
  out, the per-edge cotangent ``dm[b, d, k, c]`` (max: g where the argmax
  is k; sum: g; mean: g / K; softmax: g * exp(gamma (m_k - out))), then

      d_etype[b, d, k, t] = sum_c dm[b, d, k, c] * h[b, nn_idx[d, k], t, c]
      dh[b, j, t, c] = sum_{(d, k): nn_idx[d, k] = j} dm[b, d, k, c]
                                                      * etype[b, d, k, t]

  dh walks the transposed table (``GatherTable.src_ptr`` / ``src_edge``),
  so each element is one sum in a fixed order: no atomics, and two runs
  give the same bits.  It has two routes.  The staged kernel
  (``typed_mp_bwd_staged``) runs one block per (sample, slab of channels)
  out of shared memory; ``bwd_slab`` picks the slab from the shapes alone.
  Where no slab fits (N_src in the thousands), the first kernels of the
  port (``typed_mp_bwd``) run instead.  In bf16 the staged kernel forms
  the products of max, sum and mean on the vector path two at a time from
  bf16 pairs (``packed``, ``bwd_packed``), with the bits of its scalar
  products, which ``packed=False`` keeps reachable; softmax and the scalar
  path run the scalar products.  The DIFF/NEIGHBOR mode in bf16 runs its
  design (``typed_mp_bwd_ext``, ``bwd_ext_plan``: the whole of C in tiles
  of destination rows where it fits, single products for max's self rows)
  for max, sum and mean on 16-byte vectors, and the staged kernel in tiles
  of rows (``bwd_ext_tiles``) elsewhere; ``kept=True`` keeps the staged
  kernel with the f32 mode's plan; dh has the same bits on every route.

The DIFF/NEIGHBOR mode (``ext=True``) takes h (B, 2 N, T, C) with two rows
per node, interleaved: the self row 2 n (x_n W_a) and the neighbour row
2 n + 1 (x_n W_b, the sign folded in).  Edge (d, k) reads the sum of rows
2 d and 2 nn_idx[d, k] + 1 wherever NO_EXTENSION reads row nn_idx[d, k];
it needs Nd == N.  Its backward walks ``GatherTable.ext_ptr`` /
``ext_edge``, the same transposed table over the 2 N rows.

Both kernels have an f32 and a bf16 mode, chosen by the dtype of h, as
the TPU kernels' ``mm_dtype_name``.  The bf16 mode rounds where the TPU
kernel's does and nowhere else: h is stored in bf16 (the conv rounds
``x @ W`` once), etype is rounded to bf16 as it is read, messages and
aggregates are f32, and out is rounded once to bf16.  The backward rounds
g (and g / K for mean) to bf16 for max, sum and mean, keeps g and dm f32
for softmax, sums bf16-rounded products dm * hg into the f32 d_etype and
bf16-rounded products dm * bf16(etype) into an f32 dh that is rounded once
to bf16.  The gathered row sum hg of the DIFF/NEIGHBOR mode stays f32: the
TPU kernel's bf16 store of it for softmax (``hg_all``, a VMEM tiling
choice of ``_store_hg``) is not copied.  Softmax's backward needs the f32
log-sum-exp, which a bf16 out no longer holds, so under autograd the bf16
forward also writes it (``want_lse``).  The f32 mode is IEEE f32.

``h = x @ W_tmajor`` stays a plain matmul outside, as does its gradient.
Both kernels are bound by bytes, not operations; the sources' header notes
have the details.

Beside each kernel, as every kernel of the port has them:

* a plain PyTorch version (``typed_gather_mix_agg_plain``,
  ``typed_gather_mix_agg_bwd_plain``);
* plain integer counters of kernel launches and plain calls, one dict per
  kernel and mode (``COUNTS`` and ``BWD_COUNTS`` for NO_EXTENSION,
  ``EXT_COUNTS`` and ``EXT_BWD_COUNTS`` for DIFF/NEIGHBOR; those of the
  staged routes count the staged kernels, ``KEPT_EXT_COUNTS``,
  ``KEPT_BWD_COUNTS`` and ``KEPT_EXT_BWD_COUNTS`` the kept ones); the
  ``bf16_launches`` of each counts the launches of the bf16 mode among
  its ``kernel_launches``; in the bf16 mode ``COUNTS`` counts the sample
  route, ``BWD_COUNTS`` the packed products, ``EXT_COUNTS`` and
  ``EXT_BWD_COUNTS`` the DIFF/NEIGHBOR designs, ``KEPT_BF16_COUNTS``,
  ``KEPT_BF16_BWD_COUNTS``, ``KEPT_BF16_EXT_COUNTS`` and
  ``KEPT_BF16_EXT_BWD_COUNTS`` the kept bf16 routes, each launch under the
  route that ran; ``ROUTES`` maps each route's name to its dict, and
  holds ``NORM_ACT_COUNTS`` too, the norm kernels' (``ops/norm_act.py``,
  whose library ``csrc/norm_act.cu`` is built and launched here with the
  others), and ``CODE_ATTENTION_COUNTS``, the code-aware attention's
  (``ops/code_attention.py``, whose library ``csrc/code_attention.cu`` is
  built and launched here too: its forward and backward kernels, or its
  plain route);
* a wrapper (``typed_gather_mix_agg``, ``typed_gather_mix_agg_bwd``).  A
  CPU tensor goes to the plain version, a CUDA tensor to the kernel, or
  the wrapper raises; nothing falls back.

``TypedGatherMixAgg`` is the ``autograd.Function`` around the two.  The
kernel libraries are built with ``nvcc`` at first use, from the package's
own sources, into ``csrc/build/`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

from ..utils.debug import check_kernel_outputs, nan_checks_on

AGGREGATORS = {"max": 0, "sum": 1, "mean": 2, "softmax": 3}
MAX_K = 255     # the argmax is stored as uint8
MAX_T_BWD = 16  # the backward keeps T partial sums in registers
# the staged kernels on the H100: the shared memory a block may use, the
# backward's slabs of a sample (their partial sums of d_etype are added in
# one pass), and the SMs
SMEM_PER_BLOCK = 232448
MAX_SLABS = 8
SMS = 132

COUNTS = {"kernel_launches": 0, "bf16_launches": 0, "plain_calls": 0}
BWD_COUNTS = {"kernel_launches": 0, "bf16_launches": 0, "plain_calls": 0}
EXT_COUNTS = {"kernel_launches": 0, "bf16_launches": 0, "plain_calls": 0}
EXT_BWD_COUNTS = {"kernel_launches": 0, "bf16_launches": 0,
                  "plain_calls": 0}
KEPT_EXT_COUNTS = {"kernel_launches": 0, "bf16_launches": 0}
# the DIFF/NEIGHBOR forward's kept bf16 staged route (kept=True)
KEPT_BF16_EXT_COUNTS = {"kernel_launches": 0, "bf16_launches": 0}
# the kept backward takes f32 only
KEPT_BWD_COUNTS = {"kernel_launches": 0}
KEPT_EXT_BWD_COUNTS = {"kernel_launches": 0}
# the bf16 mode's kept routes: the first NO_EXTENSION forward kernel, and
# the staged backward with scalar products, per mode (for DIFF/NEIGHBOR
# also with the packed products of kept=True)
KEPT_BF16_COUNTS = {"kernel_launches": 0, "bf16_launches": 0}
KEPT_BF16_BWD_COUNTS = {"kernel_launches": 0, "bf16_launches": 0}
KEPT_BF16_EXT_BWD_COUNTS = {"kernel_launches": 0, "bf16_launches": 0}
# the norms with their activation (ops/norm_act.py): the kernels' launches,
# and every norm that ran in plain PyTorch
NORM_ACT_COUNTS = {"kernel_launches": 0, "plain_calls": 0}
# the code-aware masked attention (ops/code_attention.py): the launches of
# its forward and backward kernels on the card, and its plain route's calls
CODE_ATTENTION_COUNTS = {"kernel_launches": 0, "bwd_launches": 0,
                         "plain_calls": 0}
# every route's counters, under the name the profiles give it
ROUTES = {"typed_mp_fwd": COUNTS,
          "typed_mp_bwd": BWD_COUNTS,
          "typed_mp_fwd_ext": EXT_COUNTS,
          "typed_mp_bwd_ext": EXT_BWD_COUNTS,
          "typed_mp_fwd_ext_kept": KEPT_EXT_COUNTS,
          "typed_mp_bwd_kept": KEPT_BWD_COUNTS,
          "typed_mp_bwd_ext_kept": KEPT_EXT_BWD_COUNTS,
          "typed_mp_fwd_bf16_kept": KEPT_BF16_COUNTS,
          "typed_mp_fwd_ext_bf16_kept": KEPT_BF16_EXT_COUNTS,
          "typed_mp_bwd_bf16_kept": KEPT_BF16_BWD_COUNTS,
          "typed_mp_bwd_ext_bf16_kept": KEPT_BF16_EXT_BWD_COUNTS,
          "norm_act": NORM_ACT_COUNTS,
          "code_attention": CODE_ATTENTION_COUNTS}

KERNELS = ("typed_mp_fwd", "typed_mp_bwd", "norm_act", "code_attention")
_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # h, nn_idx, etype, out, argmax, lse; B N Nd K T C agg; gamma; vec4
    # bf16 ext; stream
    "typed_mp_fwd": [_PTR] * 6 + [_INT] * 7 + [ctypes.c_float] + [_INT] * 3
    + [_PTR],
    # the same with the channels per block in place of ext, then the
    # design and its row tiles
    "typed_mp_fwd_staged": [_PTR] * 6 + [_INT] * 7 + [ctypes.c_float]
    + [_INT] * 5 + [_PTR],
    # the same without vec4 bf16 ext
    "typed_mp_fwd_sample": [_PTR] * 6 + [_INT] * 7 + [ctypes.c_float]
    + [_PTR],
    # g, argmax, h, nn_idx, src_ptr, src_edge, etype, out, dh, d_etype;
    # B N Nd K T C agg; gamma; vec4 ext; stream (f32 only)
    "typed_mp_bwd": [_PTR] * 10 + [_INT] * 7 + [ctypes.c_float] + [_INT] * 2
    + [_PTR],
    # the same with bf16 and packed after ext, then scratch for the slabs'
    # partial sums of d_etype, the channels per block and the tiles of
    # destination rows before the stream
    "typed_mp_bwd_staged": [_PTR] * 10 + [_INT] * 7 + [ctypes.c_float]
    + [_INT] * 4 + [_PTR, _INT, _INT, _PTR],
    # g, argmax, h, nn_idx, src_ptr, src_edge, etype, dh, d_etype; B N K T
    # C agg; the slabs' scratch; channels per block, row tiles; stream
    "typed_mp_bwd_ext": [_PTR] * 9 + [_INT] * 6 + [_PTR, _INT, _INT, _PTR],
    # csrc/norm_act.cu (ops/norm_act.py): x, mean, inv, weight, bias, out;
    # rows; C vec4 act; slope; stream
    "bn_act": [_PTR] * 6 + [ctypes.c_longlong] + [_INT] * 3
    + [ctypes.c_float, _PTR],
    # x, out; B N C; eps; act; slope; stream
    "in_act": [_PTR] * 2 + [_INT] * 3 + [ctypes.c_float, _INT,
                                         ctypes.c_float, _PTR],
    # csrc/code_attention.cu (ops/code_attention.py): q, k, v, out, lse,
    # rows; B H L dh heads-per-block; the strides of b, h, l; scale; bf16;
    # stream
    "code_attn_fwd": [_PTR] * 6 + [_INT] * 5 + [ctypes.c_longlong] * 3
    + [ctypes.c_float, _INT, _PTR],
    # q, k, v, o, dout, lse, dq, dk, dv, rows, cols; then as the forward
    "code_attn_bwd": [_PTR] * 11 + [_INT] * 5 + [ctypes.c_longlong] * 3
    + [ctypes.c_float, _INT, _PTR],
}
_libs = {}


def source(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def library(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def reset_counts() -> None:
    for counts in ROUTES.values():
        for k in counts:
            counts[k] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def sources_mtime(name: str) -> float:
    """The newest modification time of ``csrc/<name>.cu`` and the headers
    in ``csrc/`` that both sources include."""
    headers = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
               if f.endswith(".cuh")]
    return max(os.path.getmtime(f) for f in [source(name), *headers])


def build(names=KERNELS, force: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` for each name whose library is missing or
    older than its source or a shared header (all of them with ``force``),
    one ``nvcc`` per source, all started together.  Returns {name:
    (seconds, compiler log)} for the libraries it built."""
    procs = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name in names:
        lib, src = library(name), source(name)
        if (not force and os.path.exists(lib)
                and os.path.getmtime(lib) >= sources_mtime(name)):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source(name)}:\n{stderr}")
            continue
        os.replace(tmp, library(name))  # atomic: no process sees half a file
        built[name] = (time.perf_counter() - t0, stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def _function(lib: str, name: str):
    """The C entry point ``name`` of ``lib<lib>.so``, built at first use."""
    if name not in _libs:
        build((lib,))
        fn = getattr(ctypes.CDLL(library(lib)), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return _libs[name]


def _launch(lib: str, name: str, device, shape, *args) -> None:
    with torch.cuda.device(device):
        err = _function(lib, name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"(sizes {shape})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _pad16(n: int, esz: int) -> int:
    """n elements of ``esz`` bytes, in bytes, padded to 16 bytes."""
    return -(-n * esz // 16) * 16


def _row_stride(T: int, cs: int, esz: int = 4) -> int:
    """Elements per staged row of a slab of h (``row_stride`` in
    ``csrc/typed_mp_common.cuh``), elements of ``esz`` bytes: rows of one
    type under 128 bytes padded by 16 bytes."""
    return T * cs + (16 // esz if cs * esz < 128 else 0)


def _busiest(fits: list, B: int, C: int) -> int:
    """Both staged kernels' plan: the widest of the slabs ``fits`` (widest
    first) whose (sample, slab) grid gives at least every second SM a
    block, else the widest, or 0 where none fits (the kept route)."""
    busy = [cs for cs in fits if 2 * B * (C // cs) >= SMS]
    return (busy or fits or [0])[0]


# --------------------------------------------------------------------------
# forward


def _first_win_max(msgs: torch.Tensor):
    """Max over dim 2 with the first maximal k as argmax (strict ``>``)."""
    acc = msgs[:, :, 0]
    am = torch.zeros(acc.shape, dtype=torch.uint8, device=msgs.device)
    for k in range(1, msgs.shape[2]):
        take = msgs[:, :, k] > acc
        acc = torch.where(take, msgs[:, :, k], acc)
        am = am.masked_fill(take, k)
    return acc, am


def _gathered(h, idx, ext: bool):
    """The rows each edge reads, (B, Nd, K, T, C): h[nn_idx], or for the
    extensions self row 2 d plus neighbour row 2 nn_idx[d, k] + 1."""
    if not ext:
        return h[:, idx]
    return h[:, 0::2, None] + h[:, 1::2][:, idx]


def _rbf(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and back to f32."""
    return t.to(torch.bfloat16).float()


def _operands(h, etype):
    """(h, etype) in the arithmetic's dtype: for a bf16 h (the bf16 mode)
    both f32, etype rounded to bf16 first; else unchanged."""
    if h.dtype != torch.bfloat16:
        return h, etype
    return h.float(), _rbf(etype)


def typed_gather_mix_agg_plain(h, nn_idx, etype, aggregator: str,
                               gamma: float = 3.0, want_argmax: bool = False,
                               ext: bool = False, want_lse: bool = False):
    """Plain PyTorch version of the forward kernel, on any device: out in
    h's dtype, and with ``want_argmax`` (max) the argmax, with
    ``want_lse`` (softmax) the f32 log-sum-exp (out itself for f32)."""
    from .typed_mp import aggregate

    hx, et = _operands(h, etype)
    hg = _gathered(hx, nn_idx.long(), ext)              # (B, Nd, K, T, C)
    msgs = (hg * et[..., None]).sum(dim=3)              # (B, Nd, K, C)
    if aggregator == "max":
        out, am = _first_win_max(msgs)
    else:
        out, am = aggregate(msgs, aggregator, gamma), None
    lse, out = out, out.to(h.dtype)
    if want_argmax:
        return out, am
    return (out, lse) if want_lse else out


def _check_common(h, nn_idx, etype, aggregator: str, ext: bool = False):
    """Shapes (B, N, T, C), (Nd, K), (B, Nd, K, T); f32 or bf16 h, f32
    etype, an int32 table, 0 < K <= 255, one of the four aggregators; for
    the extensions h has 2 Nd rows."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}")
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
    if h.dtype not in (torch.float32, torch.bfloat16) \
            or etype.dtype != torch.float32 or nn_idx.dtype != torch.int32:
        raise TypeError(f"expected f32 or bf16 h, f32 etype and an int32 "
                        f"table; got {h.dtype}, {etype.dtype}, "
                        f"{nn_idx.dtype}")
    if ext and N != 2 * Nd:
        raise ValueError(f"the DIFF/NEIGHBOR mode needs Nd == N_src and h "
                         f"with 2 rows per node; got Nd={Nd} and {N} rows")


def _check_placed(h, **tensors):
    """Raise unless every tensor lies on h's device and is contiguous."""
    for name, t in {"h": h, **tensors}.items():
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_kernel_args(h, nn_idx, etype, aggregator: str, want_argmax: bool,
                      ext: bool = False):
    """Raise unless the forward kernel takes these arguments: one CUDA
    device, f32 or bf16 h (B, N, T, C), f32 etype (B, Nd, K, T), an int32
    shared table (Nd, K) with 0 < K <= 255, all contiguous, one of the four
    aggregators; for the extensions (``ext``) h (B, 2 Nd, T, C)."""
    _check_common(h, nn_idx, etype, aggregator, ext)
    if want_argmax and aggregator != "max":
        raise ValueError("the argmax exists for the max aggregator only")
    _check_placed(h, nn_idx=nn_idx, etype=etype)


def _fwd_row_stride(T: int, cs: int, esz: int = 4) -> int:
    """Elements per staged row of the forward's slab of h
    (``fwd_row_stride`` in ``csrc/typed_mp_fwd.cu``), elements of ``esz``
    bytes: where a row of one type is under 128 bytes, on the vector path
    (cs % 4 == 0), a multiple of 128 bytes plus cs elements, so that the
    rows one wavefront reads start on distinct bank groups; else the
    backward's."""
    w = 128 // esz  # elements per 128 bytes
    if cs % 4 == 0 and cs < w:
        return -(-T * cs // w) * w + cs
    return _row_stride(T, cs, esz)


def fwd_bytes(rows: int, Nd: int, K: int, T: int, cs: int,
              esz: int = 4, et: bool = False) -> int:
    """Shared memory of one block of the staged forward kernel
    (``csrc/typed_mp_fwd.cu``) over Nd destination rows, each region
    16-byte aligned: its slab of h (rows, T, cs) in rows of
    ``_fwd_row_stride`` elements of ``esz`` bytes (4: f32, 2: bf16), the
    table (Nd K) int32 and, for the bf16 design (``et``), the rows' etype
    (Nd K T) rounded to bf16 and held as f32.  The kept design reads
    etype from global memory; a block of a tile of rows needs less."""
    return (_pad16(rows * _fwd_row_stride(T, cs, esz), esz)
            + 4 * _pad4(Nd * K) + (4 * _pad4(Nd * K * T) if et else 0))


def fwd_slabs(rows: int, Nd: int, K: int, T: int, C: int,
              esz: int = 4) -> list:
    """The slabs the staged forward kernel takes, widest first: divisors of
    C, multiples of 4 channels where C % 4 == 0 (the vector path), that
    fit in a block's shared memory.  Slabs write disjoint channels, so
    their number is not bounded."""
    step = 4 if C % 4 == 0 else 1
    return [cs for cs in range(C, 0, -1)
            if C % cs == 0 and cs % step == 0
            and fwd_bytes(rows, Nd, K, T, cs, esz) <= SMEM_PER_BLOCK]


def fwd_slab(B: int, rows: int, Nd: int, K: int, T: int, C: int,
             aggregator: str, esz: int = 4) -> int:
    """Channels per block of the staged forward kernel for the
    DIFF/NEIGHBOR mode's h (B, rows = 2 Nd, T, C) of ``esz``-byte
    elements, or 0 where no slab fits and the kept kernel runs: the
    backward's rule (``_busiest``).  It reads the shapes alone; the
    kernel's row tiles and lanes per row, on which the bits of a sum, mean
    or softmax depend, come from the shapes too.  ``aggregator`` does not
    change the bytes a block stages."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    return _busiest(fwd_slabs(rows, Nd, K, T, C, esz), B, C)


def checked_fwd_slab(slab, B: int, rows: int, Nd: int, K: int, T: int,
                     C: int, aggregator: str, esz: int = 4) -> int:
    """``slab`` if the staged forward kernel takes it (0, the kept kernel,
    always), ``fwd_slab`` of the shapes for None; raises otherwise."""
    if slab is None:
        return fwd_slab(B, rows, Nd, K, T, C, aggregator, esz)
    nbytes = fwd_bytes(rows, Nd, K, T, slab, esz) if slab > 0 else 0
    if slab and not (0 < slab <= C and C % slab == 0
                     and nbytes <= SMEM_PER_BLOCK):
        raise ValueError(
            f"no forward slab of {slab} channels for C={C}: it must divide "
            f"C and fit {SMEM_PER_BLOCK} bytes (it needs {nbytes})")
    return slab


def sample_bytes(N: int, Nd: int, K: int, T: int, C: int) -> int:
    """Shared memory of one block of the bf16 NO_EXTENSION forward's
    sample route (``sample_bytes`` in ``csrc/typed_mp_fwd.cu``), each region
    16-byte aligned: the sample's h (N, T, C) bf16, its etype rounded to
    bf16 and held as f32 (Nd K T) and the table (Nd K) int32."""
    return _pad16(N * T * C, 2) + 4 * _pad4(Nd * K * T) + 4 * _pad4(Nd * K)


def fwd_sample(B: int, N: int, Nd: int, K: int, T: int, C: int,
               esz: int = 4) -> bool:
    """Whether the NO_EXTENSION forward of h (B, N, T, C) of ``esz``-byte
    elements takes the sample route, from the shapes alone: the bf16 mode,
    whole 16-byte vectors of channels (C % 8 == 0), a whole sample of h in
    a block's shared memory, and at least one block (sample) for every
    second SM; else the kept kernel runs.  ``chip_smoke.py`` times both
    routes at and above that batch."""
    return (esz == 2 and C % 8 == 0 and 2 * B >= SMS
            and sample_bytes(N, Nd, K, T, C) <= SMEM_PER_BLOCK)


def fwd_bf16_slabs(rows: int, Nd: int, K: int, T: int, C: int) -> list:
    """The slabs the bf16 DIFF/NEIGHBOR forward's design takes, widest
    first: divisors of C, multiples of 8 channels where C % 8 == 0 (16-byte
    vectors), else as ``fwd_slabs``, whose block over all Nd rows fits in
    shared memory with the rows' etype (``fwd_bytes`` with ``et``)."""
    step = 8 if C % 8 == 0 else 4 if C % 4 == 0 else 1
    return [cs for cs in range(C, 0, -1)
            if C % cs == 0 and cs % step == 0
            and fwd_bytes(rows, Nd, K, T, cs, 2, True) <= SMEM_PER_BLOCK]


def fwd_bf16_tiles(B: int, Nd: int, C: int, slab: int) -> int:
    """Row tiles of the bf16 DIFF/NEIGHBOR forward's design with ``slab``
    channels a block: the kept design's rule, as many as give every SM a
    block where the (sample, slab) blocks would leave most SMs idle."""
    bs = B * (C // slab)
    return 1 if 2 * bs >= SMS else min(Nd, -(-SMS // bs))


def fwd_bf16_plan(B: int, rows: int, Nd: int, K: int, T: int,
                  C: int) -> tuple:
    """(slab, row tiles) of the bf16 DIFF/NEIGHBOR forward's design
    (``typed_mp_fwd_staged``'s design 1) for h (B, rows = 2 Nd, T, C) bf16,
    from the shapes alone, or (0, 0) where no slab fits: the kept design's
    rule (``_busiest``) over ``fwd_bf16_slabs``."""
    slabs = fwd_bf16_slabs(rows, Nd, K, T, C)
    if not slabs:
        return 0, 0
    cs = _busiest(slabs, B, C)
    return cs, fwd_bf16_tiles(B, Nd, C, cs)


def typed_gather_mix_agg(h, nn_idx, etype, aggregator: str,
                         gamma: float = 3.0, want_argmax: bool = False,
                         ext: bool = False, slab=None,
                         want_lse: bool = False, kept: bool = False):
    """out (B, Nd, C) in h's dtype [, argmax (B, Nd, C) uint8 for max
    with ``want_argmax``, or the f32 log-sum-exp (B, Nd, C) for softmax
    with ``want_lse``: what the backward needs, out itself under f32].

    CPU tensors take the plain version; CUDA tensors launch a kernel or
    raise.  ``nn_idx`` must hold valid nodes of h: the kernel does not
    check the indices (``ops.typed_mp.GatherTable`` checks them once, on
    the host).  ``ext`` selects the DIFF/NEIGHBOR mode, and for it ``slab``
    the staged kernel's channels per block, ``fwd_slab`` of the shapes by
    default; 0 takes the kept kernel (the checks on the card pass it to
    hold and time both routes).  A bf16 h selects the bf16 mode of either
    route.  NO_EXTENSION in the bf16 mode takes the sample route where
    ``fwd_sample`` plans it and h is 16-byte aligned, and ``slab=0`` the
    kept kernel; in f32 it has the kept kernel only.  The DIFF/NEIGHBOR
    mode in bf16 takes the staged kernel's bf16 design
    (``fwd_bf16_plan``; a given ``slab`` keeps its ``fwd_bf16_tiles``), and
    ``kept=True`` the staged kernel's design of the f32 mode with its plan
    (``fwd_slab``), as the bf16 mode first ran it."""
    counts = EXT_COUNTS if ext else COUNTS
    if slab and not ext:
        raise ValueError("the staged forward takes the DIFF/NEIGHBOR mode "
                         "only")
    if kept and not ext:
        raise ValueError("kept selects the DIFF/NEIGHBOR mode's kept bf16 "
                         "staged route")
    if want_lse and aggregator != "softmax":
        raise ValueError("the log-sum-exp exists for softmax only")
    if h.device.type == "cpu":
        counts["plain_calls"] += 1
        return typed_gather_mix_agg_plain(h, nn_idx, etype, aggregator,
                                          gamma, want_argmax, ext, want_lse)
    if h.device.type != "cuda":
        raise ValueError(f"no typed-mp forward for device {h.device}")
    check_kernel_args(h, nn_idx, etype, aggregator, want_argmax, ext)
    B, rows, T, C = h.shape
    Nd, K = nn_idx.shape
    N = rows // 2 if ext else rows
    bf16 = h.dtype == torch.bfloat16
    if kept and not bf16:
        raise ValueError("the kept bf16 staged route takes a bf16 h")
    sample = (not ext and slab is None and h.data_ptr() % 16 == 0
              and fwd_sample(B, N, Nd, K, T, C, h.element_size()))
    design = tiles = 0
    if ext and bf16 and not kept and slab != 0:
        if slab is None:
            slab, tiles = fwd_bf16_plan(B, rows, Nd, K, T, C)
        else:
            tiles = fwd_bf16_tiles(B, Nd, C, slab)
            nbytes = fwd_bytes(rows, -(-Nd // tiles), K, T, slab, 2, True)
            if not (0 < slab <= C and C % slab == 0
                    and nbytes <= SMEM_PER_BLOCK):
                raise ValueError(
                    f"no bf16 forward slab of {slab} channels for C={C}: it "
                    f"must divide C and fit {SMEM_PER_BLOCK} bytes (it "
                    f"needs {nbytes})")
        design = int(slab > 0)
    elif ext:
        slab = checked_fwd_slab(slab, B, rows, Nd, K, T, C, aggregator,
                                h.element_size())
    else:
        slab = 0
    out = torch.empty((B, Nd, C), dtype=h.dtype, device=h.device)
    am = (torch.empty((B, Nd, C), dtype=torch.uint8, device=h.device)
          if want_argmax else None)
    lse = (torch.empty((B, Nd, C), dtype=torch.float32, device=h.device)
           if want_lse and bf16 else None)
    vec4 = int(C % 4 == 0 and slab % 4 == 0 and h.data_ptr() % 16 == 0)
    args = (h.data_ptr(), nn_idx.data_ptr(), etype.data_ptr(),
            out.data_ptr(), _ptr(am), _ptr(lse), B, N, Nd, K, T, C,
            AGGREGATORS[aggregator], float(gamma), vec4, int(bf16))
    if sample:
        _launch("typed_mp_fwd", "typed_mp_fwd_sample", h.device,
                (B, N, Nd, K, T, C), *args[:-2])
    elif slab:
        _launch("typed_mp_fwd", "typed_mp_fwd_staged", h.device,
                (B, N, Nd, K, T, C), *args, slab, design, tiles)
        if bf16 and not design:
            counts = KEPT_BF16_EXT_COUNTS
    else:
        _launch("typed_mp_fwd", "typed_mp_fwd", h.device,
                (B, N, Nd, K, T, C), *args, int(ext))
        if ext:
            counts = KEPT_EXT_COUNTS
        elif bf16:
            counts = KEPT_BF16_COUNTS
    counts["kernel_launches"] += 1
    if bf16:
        counts["bf16_launches"] += 1
    if want_argmax:
        return out, am
    return (out, out if lse is None else lse) if want_lse else out


# --------------------------------------------------------------------------
# backward


def typed_gather_mix_agg_bwd_plain(g, h, nn_idx, etype, aggregator: str,
                                   gamma: float = 3.0, argmax=None,
                                   out=None, ext: bool = False):
    """Plain PyTorch version of the backward kernel, on any device:
    (dh (B, N, T, C) in h's dtype, d_etype (B, Nd, K, T) in etype's) from
    the cotangent g (B, Nd, C).  Max needs the forward's argmax, softmax
    its f32 log-sum-exp ``out`` (``want_lse``; out itself under f32)."""
    B, N, T, C = h.shape
    Nd, K = nn_idx.shape
    idx = nn_idx.long()
    bf16 = h.dtype == torch.bfloat16
    hx, et = _operands(h, etype)
    # the bf16 mode rounds g (max, sum) and g / K (mean) to bf16, and every
    # product that a TPU matmul takes as an operand
    rnd = _rbf if bf16 else (lambda t: t)
    hg = _gathered(hx, idx, ext)                        # (B, Nd, K, T, C)
    gk = g[:, :, None, :].to(hx.dtype)                  # (B, Nd, 1, C)
    if aggregator == "max":
        ks = torch.arange(K, device=g.device).view(1, 1, K, 1)
        dm = torch.where(argmax[:, :, None, :].long() == ks, rnd(gk), 0.0)
    elif aggregator == "sum":
        dm = rnd(gk).expand(B, Nd, K, C)
    elif aggregator == "mean":
        dm = rnd(gk * (1.0 / K)).expand(B, Nd, K, C)
    elif aggregator == "softmax":
        msgs = (hg * et[..., None]).sum(dim=3)          # (B, Nd, K, C)
        dm = gk * torch.exp(gamma * (msgs - out[:, :, None, :]))
    else:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if bf16:
        d_etype = rnd(dm[:, :, :, None, :] * hg).sum(dim=-1)
    else:
        d_etype = torch.einsum("bdkc,bdktc->bdkt", dm, hg)
    per_edge = rnd(dm[:, :, :, None, :] * et[..., None])  # (B, Nd, K, T, C)
    if not ext:
        dh = torch.zeros_like(hx).index_add_(
            1, idx.reshape(-1), per_edge.reshape(B, Nd * K, T, C))
        return dh.to(h.dtype), d_etype.to(etype.dtype)
    # self row 2 d: d's own K edges; neighbour row 2 j + 1: j's in-edges
    dh_nbr = hx.new_zeros(B, N // 2, T, C).index_add_(
        1, idx.reshape(-1), per_edge.reshape(B, Nd * K, T, C))
    dh = torch.stack([per_edge.sum(dim=2), dh_nbr], dim=2)
    return dh.reshape(B, N, T, C).to(h.dtype), d_etype.to(etype.dtype)


def staged_bytes(rows: int, Nd: int, K: int, T: int, cs: int,
                 aggregator: str, esz: int = 4) -> int:
    """Shared memory of one block of the staged backward kernel
    (``csrc/typed_mp_bwd.cu``), each region 16-byte aligned: its slab of h
    (rows, T, cs) in elements of ``esz`` bytes (4: f32, 2: bf16), rows 16
    bytes longer where a row of one type is under 128 bytes; the
    cotangent, f32 dm (Nd K, cs) for softmax, else g (Nd, cs) in h's
    dtype and the argmax (Nd, cs) uint8; the sample's etype (Nd K, T) f32,
    rows padded to a multiple of 4 words (4 more for softmax); the table
    (Nd K) and its transposed form (rows + 1, at most 2 Nd K), int32."""
    E = Nd * K
    softmax = aggregator == "softmax"
    row = _row_stride(T, cs, esz)
    cot = (4 * _pad4(E * cs) if softmax
           else _pad16(Nd * cs, esz) + _pad16(Nd * cs, 1))
    et = _pad4(T) + (4 if softmax else 0)
    return _pad16(rows * row, esz) + cot + 4 * (
        _pad4(E * et) + _pad4(E) + _pad4(rows + 1) + _pad4(2 * E))


def staged_slabs(rows: int, Nd: int, K: int, T: int, C: int,
                 aggregator: str, esz: int = 4) -> list:
    """The slabs the staged backward kernel takes, widest first: divisors
    of C into at most MAX_SLABS parts, multiples of 4 channels where
    C % 4 == 0 (the vector path), that fit in a block's shared memory."""
    step = 4 if C % 4 == 0 else 1
    return [cs for cs in range(C, 0, -1)
            if C % cs == 0 and cs % step == 0 and C // cs <= MAX_SLABS
            and staged_bytes(rows, Nd, K, T, cs, aggregator, esz)
            <= SMEM_PER_BLOCK]


def bwd_slab(B: int, rows: int, Nd: int, K: int, T: int, C: int,
             aggregator: str, esz: int = 4) -> int:
    """Channels per block of the staged backward kernel for h (B, rows, T,
    C) of ``esz``-byte elements, rows = N_src or 2 N_src for the
    extensions, or 0 where no slab fits and the kept kernels run: the
    widest of ``staged_slabs`` whose grid gives at least every second SM a
    block, else the widest.  It reads the shapes alone, so the bits of a
    result depend on the shapes alone."""
    return _busiest(staged_slabs(rows, Nd, K, T, C, aggregator, esz), B, C)


def bwd_packed(C: int, slab: int, aggregator: str, esz: int = 4) -> bool:
    """Whether the staged backward with ``slab`` channels a block forms
    packed bf16 products: the bf16 mode, max, sum or mean (softmax's dm is
    f32), and the vector path (C and the slab multiples of 4; the wrapper
    also asks 16-byte aligned tensors).  Else the scalar products run."""
    return (esz == 2 and aggregator != "softmax" and slab > 0
            and C % 4 == 0 and slab % 4 == 0)


def checked_slab(slab, B: int, rows: int, Nd: int, K: int, T: int, C: int,
                 aggregator: str, esz: int = 4) -> int:
    """``slab`` if the staged kernel takes it (0, the kept kernels, always),
    ``bwd_slab`` of the shapes for None; raises otherwise."""
    if slab is None:
        return bwd_slab(B, rows, Nd, K, T, C, aggregator, esz)
    nbytes = (staged_bytes(rows, Nd, K, T, slab, aggregator, esz)
              if slab else 0)
    if slab and not (0 < slab <= C and C % slab == 0
                     and C // slab <= MAX_SLABS
                     and nbytes <= SMEM_PER_BLOCK):
        raise ValueError(
            f"no staged slab of {slab} channels for C={C}: it must divide C "
            f"into at most {MAX_SLABS} parts and fit {SMEM_PER_BLOCK} bytes "
            f"(it needs {nbytes})")
    return slab


def ext_bwd_bytes(N: int, td: int, K: int, T: int, cs: int) -> int:
    """Shared memory of one block of the bf16 DIFF/NEIGHBOR backward's
    design (``ext_bytes`` in ``csrc/typed_mp_bwd.cu``): ``staged_bytes``'
    layout for max, sum and mean in bf16, with the slab of h cut to the N
    neighbour rows and the tile's ``td`` self rows."""
    E = N * K
    return (_pad16((N + td) * _row_stride(T, cs, 2), 2)
            + _pad16(N * cs, 2) + _pad16(N * cs, 1)
            + 4 * (_pad4(E * _pad4(T)) + _pad4(E) + _pad4(2 * N + 1)
                   + _pad4(2 * E)))


def bwd_ext_tiles(B: int, Nd: int, C: int, slab: int) -> int:
    """Tiles of destination rows of the bf16 DIFF/NEIGHBOR backward's design
    with ``slab`` channels a block: as many as keep every (sample, slab,
    tile) block on an SM of its own, at least 1 and at most Nd."""
    return max(1, min(Nd, SMS // (B * (C // slab))))


def bwd_ext_slabs(B: int, rows: int, Nd: int, K: int, T: int, C: int,
                  aggregator: str) -> list:
    """The slabs the bf16 DIFF/NEIGHBOR backward's design
    (``typed_mp_bwd_ext``) takes for h (B, rows = 2 Nd, T, C), widest
    first: for max, sum and mean, multiples of 8 channels that divide C
    into at most MAX_SLABS parts, 8 times a power of two, whose block with
    its ``bwd_ext_tiles`` fits in shared memory (``ext_bwd_bytes``)."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if aggregator == "softmax" or C % 8:
        return []
    return [cs for cs in range(C, 0, -8)
            if C % cs == 0 and C // cs <= MAX_SLABS
            and (cs // 8) & (cs // 8 - 1) == 0
            and ext_bwd_bytes(Nd, -(-Nd // bwd_ext_tiles(B, Nd, C, cs)), K,
                              T, cs) <= SMEM_PER_BLOCK]


def bwd_ext_plan(B: int, rows: int, Nd: int, K: int, T: int, C: int,
                 aggregator: str) -> tuple:
    """(slab, tiles) of the bf16 DIFF/NEIGHBOR backward's design for h (B,
    rows = 2 Nd, T, C) bf16, from the shapes alone: the widest of
    ``bwd_ext_slabs`` and its ``bwd_ext_tiles`` (the whole of C, where it
    fits, needs no partial sums of d_etype); (0, 0) where it has no slab
    (softmax, C % 8 != 0, a graph too wide), and the staged kernel runs."""
    slabs = bwd_ext_slabs(B, rows, Nd, K, T, C, aggregator)
    if not slabs:
        return 0, 0
    return slabs[0], bwd_ext_tiles(B, Nd, C, slabs[0])


def check_bwd_args(g, h, nn_idx, src_ptr, src_edge, etype, aggregator: str,
                   argmax=None, out=None, ext: bool = False):
    """Raise unless the backward kernel takes these arguments: the forward
    kernel's h, nn_idx and etype with T <= 16; g (B, Nd, C) in h's dtype;
    the transposed table over the N rows of h as int32 src_ptr (N + 1,)
    and src_edge (Nd * K,), or (2 Nd * K,) for the extensions; the uint8
    argmax (B, Nd, C) for max and the f32 log-sum-exp out (B, Nd, C) for
    softmax; all on h's device and contiguous."""
    _check_common(h, nn_idx, etype, aggregator, ext)
    B, N, T, C = h.shape
    Nd, K = nn_idx.shape
    n_edges = Nd * K * (2 if ext else 1)
    if T > MAX_T_BWD:
        raise ValueError(f"the backward kernel takes T <= {MAX_T_BWD}; "
                         f"got T={T}")
    rows = (B, Nd, C)
    if tuple(g.shape) != rows or g.dtype != h.dtype:
        raise ValueError(f"g must be {h.dtype} {rows}, as h; got {g.dtype} "
                         f"{tuple(g.shape)}")
    if tuple(src_ptr.shape) != (N + 1,) or tuple(src_edge.shape) != (
            n_edges,) or src_ptr.dtype != torch.int32 \
            or src_edge.dtype != torch.int32:
        raise ValueError(f"the transposed table is int32 src_ptr "
                         f"({N + 1},) and src_edge ({n_edges},); got "
                         f"{src_ptr.dtype} {tuple(src_ptr.shape)}, "
                         f"{src_edge.dtype} {tuple(src_edge.shape)}")
    extra = {}
    for name, t, dtype, needed in (
            ("argmax", argmax, torch.uint8, aggregator == "max"),
            ("out", out, torch.float32, aggregator == "softmax")):
        if not needed:
            continue
        if t is None or tuple(t.shape) != rows or t.dtype != dtype:
            raise ValueError(f"{aggregator} needs {name} {dtype} {rows}")
        extra[name] = t
    _check_placed(h, g=g, nn_idx=nn_idx, src_ptr=src_ptr,
                  src_edge=src_edge, etype=etype, **extra)


def typed_gather_mix_agg_bwd(g, h, nn_idx, src_ptr, src_edge, etype,
                             aggregator: str, gamma: float = 3.0,
                             argmax=None, out=None, ext: bool = False,
                             slab=None, packed=None, kept: bool = False):
    """(dh (B, N, T, C) in h's dtype, d_etype (B, Nd, K, T) f32).

    CPU tensors take the plain version; CUDA tensors launch a kernel or
    raise.  ``src_ptr``/``src_edge`` must be the transposed table of
    ``nn_idx`` over the rows of h (``GatherTable`` builds both forms once,
    on the host: ``src_*``, and ``ext_*`` for the extensions).  ``slab``
    is the staged kernel's channels per block, ``bwd_slab`` of the shapes
    by default; 0 takes the kept kernels (the checks on the card pass it
    to hold and time both routes).  A bf16 h selects the bf16 mode, which
    the staged kernel alone has: the kept kernels raise ``TypeError``.
    ``packed`` picks the bf16 mode's products: packed bf16 pairs where
    ``bwd_packed`` says they exist and g, h and dh are 16-byte aligned (the
    default), or, with False, the scalar products of the kept bf16 route;
    the two give the same bits.  A launch counts under the route that ran:
    softmax and the scalar path count as the kept route either way.  f32
    has the scalar route only.  The DIFF/NEIGHBOR mode in bf16 takes the
    bf16 design (``typed_mp_bwd_ext``) where ``bwd_ext_plan`` plans it (a
    given ``slab`` of ``bwd_ext_slabs`` keeps its ``bwd_ext_tiles``), and
    the staged kernel elsewhere, with ``kept=True`` and with
    ``packed=False``; dh has the same bits on each, and every launch but
    the design's counts as a kept bf16 route."""
    counts = EXT_BWD_COUNTS if ext else BWD_COUNTS
    if kept and not ext:
        raise ValueError("kept selects the DIFF/NEIGHBOR mode's kept bf16 "
                         "staged route")
    if h.device.type == "cpu":
        counts["plain_calls"] += 1
        return typed_gather_mix_agg_bwd_plain(g, h, nn_idx, etype,
                                              aggregator, gamma, argmax, out,
                                              ext)
    if h.device.type != "cuda":
        raise ValueError(f"no typed-mp backward for device {h.device}")
    check_bwd_args(g, h, nn_idx, src_ptr, src_edge, etype, aggregator,
                   argmax, out, ext)
    B, rows, T, C = h.shape
    Nd, K = nn_idx.shape
    N = rows // 2 if ext else rows
    if aggregator != "max":
        argmax = None
    if aggregator != "softmax":
        out = None
    bf16 = h.dtype == torch.bfloat16
    if packed and not bf16:
        raise ValueError("the packed products exist in the bf16 mode only")
    if kept and not bf16:
        raise ValueError("the kept bf16 staged route takes a bf16 h")
    design = ext and bf16 and not kept and packed is not False
    if (design and all(t.data_ptr() % 16 == 0 for t in (g, h))
            and (argmax is None or argmax.data_ptr() % 8 == 0)):
        plan = (bwd_ext_plan(B, rows, Nd, K, T, C, aggregator)
                if slab is None else
                (slab, bwd_ext_tiles(B, Nd, C, slab))
                if slab in bwd_ext_slabs(B, rows, Nd, K, T, C, aggregator)
                else (0, 0))
        if plan[0]:
            return _bwd_ext(g, h, nn_idx, src_ptr, src_edge, etype,
                            aggregator, argmax, *plan)
    slab = checked_slab(slab, B, rows, Nd, K, T, C, aggregator,
                        h.element_size())
    # elsewhere the design is the staged kernel in tiles of destination
    # rows, where its (sample, slab) blocks leave SMs without a block
    tiles = bwd_ext_tiles(B, Nd, C, slab) if design and slab else 1
    if bf16 and not slab:
        raise TypeError(
            f"the kept backward route (d_etype_kernel, dh_kernel) takes f32 "
            f"only; no staged slab of a bf16 h {tuple(h.shape)} is taken "
            f"here")
    dh = torch.empty_like(h)
    d_etype = torch.empty_like(etype)
    vec4 = int(C % 4 == 0 and slab % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in (g, h, dh))
               and (out is None or out.data_ptr() % 16 == 0)
               and (argmax is None or argmax.data_ptr() % 4 == 0))
    args = (g.data_ptr(), _ptr(argmax), h.data_ptr(), nn_idx.data_ptr(),
            src_ptr.data_ptr(), src_edge.data_ptr(), etype.data_ptr(),
            _ptr(out), dh.data_ptr(), d_etype.data_ptr(), B, N, Nd, K, T, C,
            AGGREGATORS[aggregator], float(gamma), vec4, int(ext))
    if slab:
        part = (etype.new_empty((B, C // slab) + etype.shape[1:])
                if slab < C else None)
        packed = (packed is not False and bool(vec4)
                  and bwd_packed(C, slab, aggregator, h.element_size()))
        _launch("typed_mp_bwd", "typed_mp_bwd_staged", h.device,
                (B, N, Nd, K, T, C), *args, int(bf16), int(packed),
                _ptr(part), slab, tiles)
        if bf16 and ext and tiles == 1:
            counts = KEPT_BF16_EXT_BWD_COUNTS
        elif bf16 and not ext and not packed:
            counts = KEPT_BF16_BWD_COUNTS
    else:
        _launch("typed_mp_bwd", "typed_mp_bwd", h.device,
                (B, N, Nd, K, T, C), *args)
        counts = KEPT_EXT_BWD_COUNTS if ext else KEPT_BWD_COUNTS
    counts["kernel_launches"] += 1
    if bf16:
        counts["bf16_launches"] += 1
    return dh, d_etype


def _bwd_ext(g, h, nn_idx, src_ptr, src_edge, etype, aggregator: str,
             argmax, slab: int, tiles: int):
    """The bf16 DIFF/NEIGHBOR backward's design on checked arguments, with
    ``slab`` channels a block in ``tiles`` tiles of destination rows."""
    B, rows, T, C = h.shape
    Nd, K = nn_idx.shape
    dh = torch.empty_like(h)
    d_etype = torch.empty_like(etype)
    part = (etype.new_empty((B, C // slab) + etype.shape[1:])
            if slab < C else None)
    _launch("typed_mp_bwd", "typed_mp_bwd_ext", h.device,
            (B, rows // 2, Nd, K, T, C), g.data_ptr(), _ptr(argmax),
            h.data_ptr(), nn_idx.data_ptr(), src_ptr.data_ptr(),
            src_edge.data_ptr(), etype.data_ptr(), dh.data_ptr(),
            d_etype.data_ptr(), B, Nd, K, T, C, AGGREGATORS[aggregator],
            _ptr(part), slab, tiles)
    EXT_BWD_COUNTS["kernel_launches"] += 1
    EXT_BWD_COUNTS["bf16_launches"] += 1
    return dh, d_etype


# --------------------------------------------------------------------------
# autograd


class TypedGatherMixAgg(torch.autograd.Function):
    """``typed_gather_mix_agg`` as an autograd node, with
    ``typed_gather_mix_agg_bwd`` as its backward (the port of
    ``_fused``'s custom VJP).  ``for_grad`` says whether a gradient can be
    asked for: only then does the forward write the argmax (max) or the
    f32 log-sum-exp (softmax; out itself under f32) and keep its inputs; a
    decode under ``inference_mode`` runs as without autograd.  ``ext``
    selects the DIFF/NEIGHBOR mode of both kernels.  h is f32 or bf16 and
    etype f32: dh comes back in h's dtype (autograd carries it through the
    conv's cast of h) and d_etype in f32, as ``_fused_bwd`` returns them.
    Under ``utils.debug.nan_debug`` the kernels' outputs are checked for
    NaN, as the dispatcher never sees their writes."""

    @staticmethod
    def forward(ctx, h, etype, nn_idx, src_ptr, src_edge, aggregator, gamma,
                for_grad, ext):
        want_argmax = for_grad and aggregator == "max"
        want_lse = for_grad and aggregator == "softmax"
        res = typed_gather_mix_agg(h, nn_idx, etype, aggregator, gamma,
                                   want_argmax, ext=ext, want_lse=want_lse)
        out, saved = res if want_argmax or want_lse else (res, None)
        check_kernel_outputs("typed_mp_fwd", out)
        if for_grad:
            ctx.aggregator, ctx.gamma, ctx.ext = aggregator, gamma, ext
            ctx.nan_checks = nan_checks_on()
            ctx.save_for_backward(h, etype, nn_idx, src_ptr, src_edge,
                                  saved if want_argmax else None,
                                  saved if want_lse else None)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        h, etype, nn_idx, src_ptr, src_edge, am, out = ctx.saved_tensors
        dh, d_etype = typed_gather_mix_agg_bwd(
            grad_out.to(h.dtype).contiguous(), h, nn_idx, src_ptr, src_edge,
            etype, ctx.aggregator, ctx.gamma, argmax=am, out=out,
            ext=ctx.ext)
        check_kernel_outputs("typed_mp_bwd", dh, d_etype,
                             enabled=ctx.nan_checks or nan_checks_on())
        return dh, d_etype, None, None, None, None, None, None, None


def typed_mp_fwd(h, table, etype, aggregator: str, gamma: float = 3.0,
                 ext: bool = False):
    """The autograd entry over a ``GatherTable``: out (B, Nd, C).  For the
    extensions (``ext``) h holds 2 rows per node and the backward walks the
    table's 2 N-row transposed form."""
    for_grad = torch.is_grad_enabled() and (h.requires_grad
                                            or etype.requires_grad)
    ptr, edge = ((table.ext_ptr, table.ext_edge) if ext
                 else (table.src_ptr, table.src_edge))
    return TypedGatherMixAgg.apply(h, etype, table.idx, ptr, edge,
                                   aggregator, float(gamma), for_grad, ext)
