"""Fixed-shape matrix exponential (port of ``msckf_mono_tpu/ops/expm.py``).

The reference computes the 15x15 state-transition matrix with Eigen's Padé
``F.exp()`` every IMU sample (msckf.h:111). ``||F*dt||`` is tiny (dt≈5ms), so
a fixed-order Taylor series with fixed scaling/squaring is accurate to near
machine precision and free of data-dependent control flow.
"""

from __future__ import annotations

import torch


def expm_taylor(a: torch.Tensor, order: int = 12, squarings: int = 2) -> torch.Tensor:
    """exp(a) for square matrices (..., n, n) via scaled Taylor series."""
    n = a.shape[-1]
    x = a * (2.0**-squarings)
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    # Horner evaluation of sum x^k / k!
    result = eye + x / order
    for k in range(order - 1, 0, -1):
        result = eye + torch.matmul(x, result) / k
    for _ in range(squarings):
        result = torch.matmul(result, result)
    return result
