"""Batched PSD gate γ = rᵀS⁻¹r: the hand-written CUDA kernel and its plain version.

Port of ``msckf_mono_tpu/ops/psd_pallas.py``. :func:`gamma_psd` launches the
kernel in ``csrc/psd_gamma.cu`` on a CUDA tensor and takes
:func:`gamma_psd_plain` only for a tensor that lies on the CPU; on a CUDA
tensor it launches the kernel or raises, with no fallback.

The kernel is compiled by ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``). Its launcher picks the variant and shared memory
from R: one thread a system for R <= 4, one warp a system with its rows in
registers for R <= 63, one block a system while its packed triangle fits a
block's shared memory (R <= 338), and above that a device-memory scratch
copy that the wrapper allocates. No R raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from msckf_mono_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source("psd_gamma")
BUILD_DIR = cuda_build.BUILD_DIR


def library_path() -> Path:
    return cuda_build.library_path("psd_gamma")


VARIANTS = ("thread", "warp", "block", "scratch")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``csrc/psd_gamma.cu`` runs systems of one size R, as its launcher
    picks: ``variant`` (one of VARIANTS), ``smem_bytes`` of dynamic shared
    memory a block and ``scratch_bytes`` of device memory a system."""

    variant: str
    smem_bytes: int
    scratch_bytes: int


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("psd_gamma")
    lib.psd_gamma_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    lib.psd_gamma_launch.restype = ctypes.c_int
    lib.psd_gamma_plan.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_longlong)]
    lib.psd_gamma_plan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def launch_plan(R: int) -> LaunchPlan:
    """The launcher's plan for R (asks the built library)."""
    smem, scratch = ctypes.c_int(), ctypes.c_longlong()
    variant = _load().psd_gamma_plan(R, ctypes.byref(smem), ctypes.byref(scratch))
    return LaunchPlan(VARIANTS[variant], smem.value, scratch.value)


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
    scratch_bytes = launch_plan(R).scratch_bytes
    scratch = (torch.empty(n * scratch_bytes // 4, dtype=torch.float32, device=Smat.device)
               if scratch_bytes else None)
    with cuda_build.on_device(Smat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _load().psd_gamma_launch(Smat.data_ptr(), r.data_ptr(), out.data_ptr(), n, R,
                                      scratch.data_ptr() if scratch is not None else None, stream)
    if rc != 0:
        raise RuntimeError(f"gamma_psd: kernel launch for n={n}, R={R}, {launch_plan(R)} failed "
                           f"with CUDA error {rc} ({cuda_build.error_name('psd_gamma', rc)})")
    _GAMMA_PSD.launches += 1
    return out


# The count lives on the function object itself, so a caller that rebinds
# ``psd_cuda.gamma_psd`` to a wrapper of it still counts every launch here.
_GAMMA_PSD = gamma_psd
gamma_psd.launches = 0
