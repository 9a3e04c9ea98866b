"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers. It
is compiled at first use by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``mvae_torch/_build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. The library is loaded through ``ctypes``; wrappers pass
``data_ptr()`` pointers and ``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import: the CPU-only test box has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]

# Per-source flags. The tail kernel is compiled with --fmad=false: its
# plain version rounds after every multiply and add (one PyTorch op each),
# and a fused multiply-add would change the rounding of the cancellation-free
# Lorentz difference forms by more than the comparison tolerance at large
# hyperbolic radius.
EXTRA_FLAGS = {
    "tail_fwd": ["--fmad=false"],
    "decode_bce": [],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _flags(name: str) -> list[str]:
    return _ARCH + _COMMON + EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, temp .so, log path) or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = BUILD_DIR / f"{name}.ptxas.txt"
    cmd = [nvcc_path(), *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), log


def _finish(name: str, started) -> None:
    proc, tmp, log = started
    output, _ = proc.communicate()
    log.write_text(output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{output}")
    os.replace(tmp, library_path(name))


def build_all() -> dict[str, str]:
    """Compile every kernel source at once (one nvcc per source, started
    together) and return each one's ptxas report (registers, spills)."""
    names = sorted(EXTRA_FLAGS)
    started = {n: _start(n) for n in names}
    for n in names:
        if started[n] is not None:
            _finish(n, started[n])
    reports = {}
    for n in names:
        log = BUILD_DIR / f"{n}.ptxas.txt"
        reports[n] = log.read_text() if log.exists() else ""
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed (process-wide)."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    return ctypes.CDLL(str(library_path(name)))


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {status}")
