"""Batched PSD gate γ = rᵀS⁻¹r: the hand-written CUDA kernel and its plain version.

Port of ``msckf_mono_tpu/ops/psd_pallas.py``. :func:`gamma_psd` launches the
kernel in ``csrc/psd_gamma.cu`` on a CUDA tensor and takes
:func:`gamma_psd_plain` only for a tensor that lies on the CPU; on a CUDA
tensor it launches the kernel or raises, with no fallback.

The kernel is compiled by ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``). The shared-memory plan lives in the source alone: an
R whose systems do not fit a block's shared memory (R > 120 on an H100) makes
the launcher return an error, and :func:`gamma_psd` raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from msckf_mono_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source("psd_gamma")
BUILD_DIR = cuda_build.BUILD_DIR


def library_path() -> Path:
    return cuda_build.library_path("psd_gamma")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("psd_gamma")
    lib.psd_gamma_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.psd_gamma_launch.restype = ctypes.c_int
    return lib


def gamma_psd_plain(Smat: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """γ = ‖L⁻¹r‖² for S = LLᵀ in plain PyTorch; +inf where S is not PD."""
    L, info = torch.linalg.cholesky_ex(Smat)
    y = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    gamma = torch.sum(y * y, dim=-1)
    return torch.where(info > 0, torch.full_like(gamma, float("inf")), gamma)


def gamma_psd(Smat: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """γ_i = r_iᵀ S_i⁻¹ r_i batched over leading axes.

    Smat: (..., R, R); r: (..., R). Returns (...,). All leading dims are
    flattened into one batch of systems for the kernel. ``gamma_psd.launches``
    counts the kernel's launches.
    """
    R = Smat.shape[-1]
    if Smat.dim() < 2 or Smat.shape[-2] != R or tuple(r.shape) != tuple(Smat.shape[:-1]):
        raise ValueError(f"gamma_psd: shapes {tuple(Smat.shape)} / {tuple(r.shape)} "
                         "are not (..., R, R) / (..., R)")
    if Smat.device.type == "cpu" and r.device.type == "cpu":
        return gamma_psd_plain(Smat, r)
    if Smat.device.type != "cuda" or r.device != Smat.device:
        raise ValueError(f"gamma_psd: tensors on {Smat.device} / {r.device}; "
                         "both must be on the CPU or on one CUDA device")
    if Smat.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"gamma_psd: the kernel takes float32, got {Smat.dtype} / {r.dtype}")
    if not (Smat.is_contiguous() and r.is_contiguous()):
        raise ValueError("gamma_psd: the kernel takes contiguous tensors")
    batch_shape = Smat.shape[:-2]
    n = Smat.numel() // (R * R) if R else 0
    out = torch.empty(batch_shape, dtype=torch.float32, device=Smat.device)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(Smat.device):
        stream = torch.cuda.current_stream(Smat.device).cuda_stream
        rc = lib.psd_gamma_launch(Smat.data_ptr(), r.data_ptr(), out.data_ptr(), n, R, stream)
    if rc != 0:
        raise RuntimeError(f"gamma_psd: kernel launch for n={n}, R={R} failed with CUDA "
                           f"error {rc} ({cuda_build.error_name('psd_gamma', rc)})")
    _GAMMA_PSD.launches += 1
    return out


# The count lives on the function object itself, so a caller that rebinds
# ``psd_cuda.gamma_psd`` to a wrapper of it still counts every launch here.
_GAMMA_PSD = gamma_psd
gamma_psd.launches = 0
