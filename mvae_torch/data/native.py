"""ctypes bindings for the C++ host-data engine (``native/host_data.cc``).

Counterpart of ``mvae_tpu/data/native.py``, with its names and ctypes
signatures: IDX(.gz) decode, the deterministic epoch permutation (a
Fisher-Yates shuffle over a seeded ``std::mt19937_64``) and the fused row
gather. The port builds the repo's own source at first use
(``kernels._build.build_host``: ``g++`` with ``native/Makefile``'s flags into
the git-ignored ``mvae_torch/_build/``) instead of loading a library from
``native/``. Where the build raises, ``available()`` is False, every entry
point but ``read_idx_f32`` takes the same numpy fallback as the
reference's, and ``report()`` keeps the failure's message.

The two orders differ: ``data.base.ArrayDataset.epoch_batches`` takes the
native one whenever the engine is available, as the reference does.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..kernels import _build


@functools.cache
def _load() -> tuple[ctypes.CDLL | None, str]:
    """(library, why): the library is None when the build or the load
    raised, and ``why`` then holds that exception's message."""
    try:
        path = _build.build_host()
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError) as err:
        return None, f"{type(err).__name__}: {err}"
    lib.mvae_idx_read_f32.restype = ctypes.c_int
    lib.mvae_idx_read_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    lib.mvae_free.restype = None
    lib.mvae_free.argtypes = [ctypes.c_void_p]
    lib.mvae_permutation.restype = None
    lib.mvae_permutation.argtypes = [ctypes.c_uint64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.mvae_gather_f32.restype = None
    lib.mvae_gather_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float)]
    return lib, f"native/host_data.cc built by g++ as {path.name}"


def available() -> bool:
    return _load()[0] is not None


def report() -> dict:
    """{'active': bool, 'why': str}: the engine's build, or why it failed."""
    lib, why = _load()
    return {"active": lib is not None, "why": why}


def read_idx_f32(path) -> np.ndarray:
    """IDX(.gz) file -> float32 array in [0, 1] by the native decode."""
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native host-data engine unavailable: {why}")
    data_p = ctypes.POINTER(ctypes.c_float)()
    dims = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int()
    rc = lib.mvae_idx_read_f32(str(path).encode(), ctypes.byref(data_p),
                               dims, ctypes.byref(ndim))
    if rc != 0:
        raise IOError(f"native IDX decode failed (rc={rc}) for {path}")
    shape = tuple(dims[i] for i in range(ndim.value))
    n = int(np.prod(shape))
    out = np.ctypeslib.as_array(data_p, shape=(n,)).reshape(shape).copy()
    lib.mvae_free(data_p)
    return out


def permutation(seed: int, n: int) -> np.ndarray:
    lib = _load()[0]
    if lib is None:
        return np.random.default_rng(seed).permutation(n)
    out = np.empty(n, np.int64)
    lib.mvae_permutation(ctypes.c_uint64(seed & (2**64 - 1)), n,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def gather_rows(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """src (n, ...) float32 -> src[indices] by the native fused gather."""
    lib = _load()[0]
    src = np.ascontiguousarray(src, np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    if lib is None:
        return src[indices]
    if len(indices) and (indices.min() < 0 or indices.max() >= len(src)):
        raise IndexError(f"row index out of range for {len(src)} rows")
    row_elems = int(np.prod(src.shape[1:])) if src.ndim > 1 else 1
    dst = np.empty((len(indices),) + src.shape[1:], np.float32)
    lib.mvae_gather_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), row_elems,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(indices), dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return dst
