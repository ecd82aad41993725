"""ctypes bindings of the native LDPC core (``ldpc_core.cpp``), the port's
copy of ``fgnn_tpu/data/ldpc_cpp``.

The shared library is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/`` (rebuilt when the source is newer).  Callers
that can do without it check ``available()`` and take the numpy decoder
of ``data/bp_ref.py`` instead, which gives the same bits.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "build")
_SO_PATH = os.path.join(_BUILD_DIR, "libldpc_core.so")
_SRC = os.path.join(_HERE, "ldpc_core.cpp")

_lock = threading.Lock()
_lib = None
_build_error: Exception | None = None

log = logging.getLogger(__name__)


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC)):
        return _SO_PATH
    # a temporary name per process: concurrent first uses do not write one
    # file together, and the rename is atomic
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO_PATH)
    log.info("built %s", _SO_PATH)
    return _SO_PATH


def get_lib():
    """The loaded library, built first if needed.  Raises the build or
    load error when native support is unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise _build_error
        try:
            lib = ctypes.CDLL(_build())
        except Exception as e:  # no compiler, or a failed build
            _build_error = e
            raise
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ldpc_bp_decode_batch.restype = ctypes.c_int
        lib.ldpc_bp_decode_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i32p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), i32p, i32p,
        ]
        lib.ldpc_encode_batch.restype = None
        lib.ldpc_encode_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except Exception:
        return False


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def bp_decode_batch(graph, bias: np.ndarray, z: np.ndarray | None = None,
                    max_loops: int = 100):
    """Decode a batch natively.  graph: ``data.bp_ref.BPGraph``.

    bias: (B, N) P(bit=1).  Returns (x (B, N) uint8, success (B,) bool,
    iters (B,) int32)."""
    lib = get_lib()
    bias = np.ascontiguousarray(bias, dtype=np.float64)
    if bias.ndim == 1:
        bias = bias[None]
    B, N = bias.shape
    if N != graph.N:
        raise ValueError(f"bias has {N} bits, the graph {graph.N}")
    rd = graph.row_cols.shape[1]
    cd = graph.col_rows.shape[1]
    row_cols = np.ascontiguousarray(graph.row_cols, np.int32)
    col_rows = np.ascontiguousarray(graph.col_rows, np.int32)
    col_slot = np.ascontiguousarray(graph.col_slot, np.int32)
    x = np.zeros((B, N), np.uint8)
    viols = np.zeros(B, np.int32)
    iters = np.zeros(B, np.int32)
    zp = None
    if z is not None:
        z = np.ascontiguousarray(z, np.uint8)
        zp = z.ctypes.data_as(ctypes.c_void_p)
    rc = lib.ldpc_bp_decode_batch(
        N, graph.M, rd, cd, _i32p(row_cols), _i32p(col_rows),
        _i32p(col_slot),
        bias.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), zp, B,
        max_loops, x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i32p(viols), _i32p(iters))
    if rc != 0:
        raise RuntimeError(f"ldpc_bp_decode_batch failed rc={rc}")
    return x, viols == 0, iters


def encode_batch(G: np.ndarray, s: np.ndarray) -> np.ndarray:
    """t = G s mod 2 for a batch.  G: (N, K) uint8, s: (B, K) -> (B, N)."""
    lib = get_lib()
    G = np.ascontiguousarray(G, np.uint8)
    s = np.ascontiguousarray(s, np.uint8)
    if s.ndim == 1:
        s = s[None]
    B, K = s.shape
    N = G.shape[0]
    if G.shape[1] != K:
        raise ValueError(f"G is {G.shape}, the words have {K} bits")
    t = np.zeros((B, N), np.uint8)
    lib.ldpc_encode_batch(
        K, N, G.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), B,
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return t
