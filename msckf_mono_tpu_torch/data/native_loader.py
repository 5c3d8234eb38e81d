"""ctypes bindings for the native ingestion runtime (port of ``msckf_mono_tpu/data/native_loader.py``).

The native runtime (``native/loader.cpp``: an mmap'd CSV parser and a
thread-pool image prefetcher that decodes grayscale frames ahead of the
consumer) is built from the repository's source with ``g++`` at first use,
into ``msckf_mono_tpu_torch/build/`` (the library's name carries a hash of
the source and the flags; an existing library is reused). When it cannot be
built or linked (no compiler, no libpng/libjpeg), :func:`available` is False
and every entry point falls back to numpy: ``np.loadtxt`` for the CSVs, the
port's own PNG codec (``data/png.py``) for the images, and a thread pool over
that codec for the prefetcher.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from msckf_mono_tpu_torch.data import png

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "loader.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LIBS = ["-lpng", "-ljpeg", "-lz", "-pthread"]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libnative_loader_{digest[:16]}.so"


def _build() -> Path | None:
    """Compile ``native/loader.cpp`` unless built; None if it cannot be."""
    if not SOURCE.is_file():
        return None
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)       # a process beside this one never loads half a library
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=None)
def _load():
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    c = ctypes
    sigs = {
        "csv_count_rows": ([c.c_char_p], c.c_longlong),
        "csv_parse": ([c.c_char_p, c.POINTER(c.c_double), c.c_longlong, c.c_int], c.c_longlong),
        "csv_parse_i64_col": ([c.c_char_p, c.c_int, c.POINTER(c.c_longlong), c.c_longlong],
                              c.c_longlong),
        "image_decode_gray": ([c.c_char_p, c.POINTER(c.c_uint8), c.c_int, c.c_int], c.c_int),
        "image_probe": ([c.c_char_p, c.POINTER(c.c_int), c.POINTER(c.c_int)], c.c_int),
        "prefetcher_create": ([c.POINTER(c.c_char_p), c.c_longlong, c.c_int, c.c_int, c.c_int,
                               c.c_int], c.c_void_p),
        "prefetcher_get": ([c.c_void_p, c.c_longlong, c.POINTER(c.c_uint8)], c.c_int),
        "prefetcher_destroy": ([c.c_void_p], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def available() -> bool:
    return _load() is not None


def decoder() -> str:
    """Which decoder serves :func:`imread_gray`: the native library or the zlib codec."""
    return "native library (native/loader.cpp)" if available() else "zlib codec (data/png.py)"


def parse_csv(path: str, cols: int) -> np.ndarray:
    """Parse a numeric CSV ('#'-comment lines skipped) into (rows, cols) f64."""
    lib = _load()
    if lib is None:
        return np.atleast_2d(np.loadtxt(path, delimiter=",", comments="#", usecols=range(cols)))
    n = lib.csv_count_rows(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    out = np.empty((n, cols), np.float64)
    got = lib.csv_parse(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, cols)
    if got < 0:
        raise IOError(f"csv parse failed: {path}")
    return out[:got]


def parse_csv_i64_col(path: str, col: int) -> np.ndarray:
    """Parse one CSV column as exact int64 (ns timestamps overflow f64)."""
    lib = _load()
    if lib is None:
        return np.atleast_1d(np.loadtxt(path, delimiter=",", comments="#", usecols=col,
                                        dtype=np.int64, converters={col: lambda s: np.int64(s)}))
    n = lib.csv_count_rows(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    out = np.empty((n,), np.int64)
    got = lib.csv_parse_i64_col(path.encode(), col,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n)
    if got < 0:
        raise IOError(f"csv parse failed: {path}")
    return out[:got]


def imread_gray(path: str, width: int | None = None, height: int | None = None) -> np.ndarray:
    """Decode a grayscale PNG/PGM (or, natively, JPEG) to (H, W) uint8."""
    lib = _load()
    if lib is None:
        img = png.read_gray(path)
        if width is not None and img.shape != (height, width):
            raise IOError(f"{path}: {img.shape[1]}x{img.shape[0]}, expected {width}x{height}")
        return img
    if width is None or height is None:
        w, h = ctypes.c_int(), ctypes.c_int()
        if lib.image_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
            raise IOError(f"cannot decode {path}")
        width, height = w.value, h.value
    out = np.empty((height, width), np.uint8)
    rc = lib.image_decode_gray(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               width, height)
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return out


class ImagePrefetcher:
    """Thread-pool grayscale decoder with bounded lookahead.

    Sequential ``get(i)`` overlaps the decode of frames i+1..i+lookahead with
    the caller's work; random access works too. Native threads when the
    library is available, else Python threads over the zlib codec (zlib and
    numpy release the GIL for most of a decode).
    """

    def __init__(self, paths, width: int, height: int, n_threads: int = 4, lookahead: int = 16):
        self.paths = [os.fspath(p) for p in paths]
        self.width = int(width)
        self.height = int(height)
        self.lookahead = int(lookahead)
        self._lib = _load()
        self._handle = None
        self._pool = None
        self._pending = {}
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._keepalive = arr
            self._handle = self._lib.prefetcher_create(arr, len(self.paths), self.width,
                                                       self.height, n_threads, lookahead)
        elif self.paths:
            self._pool = ThreadPoolExecutor(max_workers=max(1, n_threads))

    def get(self, index: int) -> np.ndarray:
        if self._handle is not None:
            out = np.empty((self.height, self.width), np.uint8)
            rc = self._lib.prefetcher_get(self._handle, index,
                                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if rc != 0:
                raise IOError(f"prefetch decode failed ({rc}): {self.paths[index]}")
            return out
        if self._pool is None:
            return imread_gray(self.paths[index], self.width, self.height)
        for i in range(index, min(index + self.lookahead + 1, len(self.paths))):
            if i not in self._pending:
                self._pending[i] = self._pool.submit(imread_gray, self.paths[i], self.width,
                                                     self.height)
        for i in [i for i in self._pending if i < index]:
            self._pending.pop(i).cancel()
        return self._pending.pop(index).result()

    def __len__(self):
        return len(self.paths)

    def close(self):
        if self._handle is not None:
            self._lib.prefetcher_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._pending.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
