"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers. It
is compiled at first use by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``mvae_torch/_build/`` (git-ignored), named by a hash of the
source, of every ``csrc/`` header it includes, and of the flags, so an
edited source or shared header is rebuilt and an unchanged one is loaded
as it is. The library is loaded through ``ctypes``; wrappers pass
``data_ptr()`` pointers and ``torch.cuda.current_stream().cuda_stream``.

The C++ host-data engine of ``native/host_data.cc`` (IDX decode, epoch
permutation, row gather) is built the same way by ``g++`` with the flags of
``native/Makefile`` (``build_host``); ``native/`` itself is only read.

Nothing here runs at import: a machine without ``nvcc`` imports this module
too. Every library is written to a temporary file and renamed into place,
so processes that build the same source at once never load a partial file.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]

def span_layers_flag() -> str:
    """The layer list of the span markers (``csrc/spans.cu``), written once
    in ``utils.profiling.LAYERS``, as the X-macro the source expands."""
    from ..utils.profiling import LAYERS
    return "-DMVAE_SPAN_LAYERS=" + "".join(f"MVAE_SPAN({layer})"
                                          for layer in LAYERS)


# Per-source flags. The tail kernels are compiled with --fmad=false: their
# plain version rounds after every multiply and add (one PyTorch op each),
# and a fused multiply-add would change the rounding of the cancellation-free
# Lorentz difference forms by more than the comparison tolerance at large
# hyperbolic radius. The backward recomputes the forward's intermediates,
# so it takes the same flag to recompute them bit for bit. The IWAE chunk
# reparams run the tiles' draws and are built like them (B5 the
# stereographic tile's, P2 the normal, hyperboloid and vMF tiles'). The
# distance kernels sum a row across a warp, in another order than any plain
# version, but their Gram form cancels to zero at x = y only while the three
# sums of a row are rounded alike and the scalar tail is evaluated as
# written: a contracted tail leaves a residue of ~sqrt(eps) |x| there. The
# roofline probes keep contraction on: the FMA probe has to time FFMA, not
# FMUL + FADD, and the twins price their op volume in fused multiply-adds.
# The span markers take their names from the profiler's layer list. Adam
# is compiled with --fmad=false so that its update rounds as its plain
# version's one op at a time does (its lerp is an explicit fma, as
# PyTorch's).
EXTRA_FLAGS = {
    "tail_fwd": ["--fmad=false"],
    "tail_bwd": ["--fmad=false"],
    "reparam_stereo": ["--fmad=false"],
    "reparam_chunk": ["--fmad=false"],
    "decode_bce": [],
    "train_decode": [],
    "manifold_dist": ["--fmad=false"],
    "roofline_probes": [],
    "spans": [span_layers_flag()],
    "adam": ["--fmad=false"],
}

# native/Makefile's CXXFLAGS and LDFLAGS
HOST_SOURCE = Path(__file__).resolve().parents[2] / "native" / "host_data.cc"
_HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_HOST_LIBS = ["-lz"]

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


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


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (CSRC / inc).exists():
                todo.append(CSRC / inc)
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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


def build_variants(variants: dict, out_dir: Path) -> dict:
    """Compile variants of kernel sources, to measure them: ``variants``
    maps a tag to (source path, flags after ``_ARCH`` and ``_COMMON``); each
    is built into ``out_dir/<tag>.so`` by one nvcc, all started together
    (the source's directory and ``csrc/`` on the include path), and loaded.
    Returns tag -> (library, nvcc's report)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, flags) in variants.items():
        lib = out_dir / f"{tag}.so"
        cmd = [nvcc_path(), *_ARCH, *_COMMON, *flags, "-I",
               str(Path(src).parent), "-I", str(CSRC), "-o", str(lib),
               str(src)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    built = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {tag}:\n{log}")
        built[tag] = (ctypes.CDLL(str(lib)), log)
    return built


def ptxas_lines(report: str) -> list[str]:
    """The lines of an nvcc report that name a kernel or give its
    registers, stack frame and spills."""
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def build_host(source: Path = HOST_SOURCE) -> Path:
    """The host-data engine built from ``source`` by ``g++`` into
    ``_build/``, named by a hash of the source and the flags; compiled only
    when that file is missing. Raises ``RuntimeError`` when the compiler is
    missing or fails (zlib's headers among its inputs)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host-data engine is C++")
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(_HOST_FLAGS + _HOST_LIBS).encode())
    out = BUILD_DIR / f"host_data-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *_HOST_FLAGS, str(source), "-o", tmp,
                           *_HOST_LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


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
