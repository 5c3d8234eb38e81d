"""Motion gate + LM triangulation of feature tracks: the launcher of the hand-written CUDA kernel.

:func:`triangulate_tracks` launches ``csrc/triangulate.cu`` on CUDA tensors
and raises on anything else it does not take; it is called by
``core/triangulate.triangulate_tracks``, which checks the shapes and takes the
plain version (``check_motion`` and ``initialize_position``) for tensors on
the CPU. The kernel replaces no TPU kernel (the JAX package triangulates in
plain JAX): it replaces the ~1,700 PyTorch operations a call of the plain
version.

The window poses q_CG and p_C_G hold W windows of N slots; the n tracks are
W runs of S = n / W that share one window each, as the filter's window
(B, 1, N, ·) against its tracks (B, S, N, ·). The kernel reads window i // S
for track i and never materialises the expansion. It runs one warp a track
with one window slot a lane, so it takes N <= 32. Its sums run in warp
order, so it agrees with the plain version to rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from msckf_mono_tpu_torch.ops import cuda_build

MAX_SLOTS = 32  # one window slot a lane of a warp


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("triangulate")
    lib.triangulate_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 4)
    lib.triangulate_launch.restype = ctypes.c_int
    return lib


def triangulate_tracks(obs, obs_mask, q_CG, p_C_G, translation_threshold, max_gn_cost_norm,
                       n_iters: int, n_trials: int):
    """Launch the kernel on tracks obs (..., N, 2), obs_mask (..., N) against
    window poses q_CG (..., N, 4), p_C_G (..., N, 3) whose leading axes are a
    leading part of the tracks' (``core/triangulate.triangulate_tracks``
    checks that). Returns (motion_ok (...,), p_f_G (..., 3), tri_ok (...,)).
    ``triangulate_tracks.launches`` counts the launches."""
    tensors = (obs, obs_mask, q_CG, p_C_G)
    dev = obs.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"triangulate_tracks: tensors on {[str(t.device) for t in tensors]}; "
                         "the kernel takes them all on one CUDA device")
    if obs.dtype != torch.float32 or q_CG.dtype != torch.float32 or p_C_G.dtype != torch.float32 \
            or obs_mask.dtype != torch.bool:
        raise TypeError(f"triangulate_tracks: the kernel takes float32 and a bool mask, got "
                        f"{obs.dtype}, {obs_mask.dtype}, {q_CG.dtype}, {p_C_G.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("triangulate_tracks: the kernel takes contiguous tensors")
    lead, N = obs.shape[:-2], obs.shape[-2]
    if N > MAX_SLOTS:
        raise ValueError(f"triangulate_tracks: the kernel takes at most {MAX_SLOTS} window "
                         f"slots, got {N}")
    n, windows = math.prod(lead), q_CG.numel() // (4 * N)
    motion_ok = torch.empty(lead, dtype=torch.bool, device=dev)
    tri_ok = torch.empty(lead, dtype=torch.bool, device=dev)
    p_f_G = torch.empty(tuple(lead) + (3,), dtype=torch.float32, device=dev)
    if n == 0:
        return motion_ok, p_f_G, tri_ok
    if (obs_mask.numel() != n * N or q_CG.numel() != 4 * N * windows
            or p_C_G.numel() != 3 * N * windows or windows == 0 or n % windows):
        raise ValueError(f"triangulate_tracks: {n} tracks of {N} slots do not split over "
                         f"windows q_CG {tuple(q_CG.shape)}, p_C_G {tuple(p_C_G.shape)}")
    with cuda_build.on_device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _load().triangulate_launch(
            obs.data_ptr(), obs_mask.data_ptr(), q_CG.data_ptr(), p_C_G.data_ptr(), n, N,
            n // windows, translation_threshold, max_gn_cost_norm, n_iters, n_trials,
            motion_ok.data_ptr(), p_f_G.data_ptr(), tri_ok.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"triangulate_tracks: kernel launch for n={n}, N={N}, "
                           f"windows={windows} failed with CUDA error {rc} "
                           f"({cuda_build.error_name('triangulate', rc)})")
    _TRIANGULATE_TRACKS.launches += 1
    return motion_ok, p_f_G, tri_ok


# The count lives on the function object (see ops/psd_cuda.py).
_TRIANGULATE_TRACKS = triangulate_tracks
triangulate_tracks.launches = 0
