"""Build and load the port's CUDA kernels: one nvcc call per source.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``, in ``msckf_mono_tpu_torch/build/``.
The library name carries a hash of the source and the flags, so an edited
source is rebuilt; an existing library is reused. :func:`build_all` starts
every nvcc at once and waits for all of them.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("psd_gamma", "fast_nms", "klt_level")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str, verbose: bool):
    """Start nvcc for one source into a temporary file; None if built already."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source(name))]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, started, verbose: bool) -> None:
    """Wait for one nvcc; rename its library into place (so a process building
    beside another never loads a half-written library)."""
    proc, tmp, out = started
    try:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
        if verbose and err:
            print(err.strip())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_library(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source's library exists."""
    started = _start(name, verbose)
    if started is not None:
        _finish(name, started, verbose)
    return library_path(name)


def build_all(verbose: bool = False) -> list[Path]:
    """Build every kernel of the port, all nvcc processes at once."""
    started = {name: _start(name, verbose) for name in KERNELS}
    errors = []
    for name, s in started.items():
        if s is None:
            continue
        try:
            _finish(name, s, verbose)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(name) for name in KERNELS]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use. Every library exports
    ``<name>_launch`` (returning a CUDA error code) and ``<name>_error_name``."""
    lib = ctypes.CDLL(str(build_library(name)))
    err = getattr(lib, f"{name}_error_name")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def error_name(name: str, rc: int) -> str:
    return getattr(load(name), f"{name}_error_name")(rc).decode()
