"""Filter initialization variants (port of ``msckf_mono_tpu/core/init.py``).

* ground-truth seeded init (reference datasets/asl_msckf.cpp:151-159);
* standstill self-calibration from averaged IMU readings
  (reference datasets/asl_msckf_no_ground_truth.cpp:141-173): b_g = mean gyro,
  q_IG aligns -g with the mean accel, b_a = q_IG·g + mean accel, p = v = 0.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.msckf.core.types import ImuState, init_imu_state
from portbench.reference.msckf.utils import quat


def standstill_init(omega, acc, valid=None, g=(0.0, 0.0, -9.81),
                    dtype=torch.float32, device="cuda") -> ImuState:
    """omega/acc: (K, 3) or (B, K, 3) standstill readings; valid: (K,) or (B, K)."""
    omega = torch.as_tensor(np.asarray(omega), dtype=dtype, device=device)
    acc = torch.as_tensor(np.asarray(acc), dtype=dtype, device=device)
    if omega.dim() == 2:
        omega, acc = omega[None], acc[None]
    if valid is None:
        valid = torch.ones(omega.shape[:-1], dtype=torch.bool, device=device)
    valid = torch.as_tensor(np.asarray(valid), device=device)
    w = valid.to(dtype).expand(omega.shape[:-1])
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)[..., None]
    gyro_mean = torch.sum(omega * w[..., None], dim=-2) / n
    accel_mean = torch.sum(acc * w[..., None], dim=-2) / n

    g_vec = torch.as_tensor(g, dtype=dtype, device=device).expand(gyro_mean.shape)
    q_IG = quat.from_two_vectors(-g_vec, accel_mean)
    b_a = quat.rotate(q_IG, g_vec) + accel_mean
    return init_imu_state(q_IG=q_IG, b_g=gyro_mean, b_a=b_a, g=g_vec, dtype=dtype, device=device)


def ground_truth_init(p_I_G, q_IG, v_I_G, b_g, b_a, g=(0.0, 0.0, -9.81),
                      dtype=torch.float32, device="cuda") -> ImuState:
    return init_imu_state(q_IG=q_IG, b_g=b_g, v_I_G=v_I_G, b_a=b_a, p_I_G=p_I_G, g=g,
                          dtype=dtype, device=device)
