"""Build and load the port's CUDA kernels: one nvcc call per source.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``, in ``msckf_mono_tpu_torch/build/``.
The library name carries a hash of the source and the flags, so an edited
source is rebuilt; an existing library is reused. :func:`build_all` starts
every nvcc at once and waits for all of them. nvcc runs with
``-Xptxas=-v``, and its diagnostics (registers, stack frame and spills of
every kernel instance) are kept beside the library, so :func:`build_all`
returns them whether it built the library now or earlier.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
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


def log_path(name: str) -> Path:
    """nvcc's diagnostics for the library at :func:`library_path`."""
    return library_path(name).with_suffix(".log")


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if built already."""
    if library_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp


def _finish(name: str, started) -> None:
    """Wait for one nvcc; write its diagnostics beside the library, then
    rename the library into place (so a process building beside another
    never loads a half-written library, and a library never lacks its log)."""
    proc, tmp = started
    try:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
        log_tmp = tmp + ".log"
        Path(log_tmp).write_text(err)
        os.replace(log_tmp, log_path(name))
        os.replace(tmp, library_path(name))
    finally:
        for leftover in (tmp, tmp + ".log"):
            if os.path.exists(leftover):
                os.remove(leftover)


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source's library exists."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    return library_path(name)


def build_all() -> dict[str, str]:
    """Build every kernel of the port, all nvcc processes at once, or reuse
    the libraries built before. Returns each source's nvcc diagnostics."""
    started = {name: _start(name) for name in KERNELS}
    errors = []
    for name, s in started.items():
        if s is None:
            continue
        try:
            _finish(name, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: log_path(name).read_text() for name in KERNELS}


def ptxas_usage(log: str) -> list[dict]:
    """Each kernel instance's registers, stack frame (local memory: arrays
    the compiler could not keep in registers), spills and static shared
    memory, from ``nvcc -Xptxas=-v`` diagnostics."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(kernel=m.group(1), registers=None, stack_bytes=None, spill_stores=None,
                       spill_loads=None, smem_bytes=0)
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["smem_bytes"] = int(m.group(1))
    return rows


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use. Every library exports
    ``<name>_launch`` (returning a CUDA error code) and ``<name>_error_name``."""
    lib = ctypes.CDLL(str(build_library(name)))
    err = getattr(lib, f"{name}_error_name")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def on_device(dev):
    """A context that makes ``dev`` the current CUDA device for a launch; a
    no-op when it is already (the common case, and the cheap one on the
    host)."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def error_name(name: str, rc: int) -> str:
    return getattr(load(name), f"{name}_error_name")(rc).decode()
