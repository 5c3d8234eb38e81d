"""Feature triangulation: motion gate + LM in inverse depth.

Port of ``msckf_mono_tpu/core/triangulate.py`` (reference ``checkMotion`` /
``generateInitialGuess`` / ``initializePosition``, msckf.h:980-1323), batched
over arbitrary leading axes (filters x tracks):

* observations arrive as per-window-slot tensors with masks; "first/last
  observation" are argmax-style gathers;
* the LM loops become a Python loop of a fixed ``n_iters`` outer steps, each
  evaluating all ``n_trials`` lambdas at once; the outer early exit
  (delta_norm <= 5e-7) is a carried done mask, never a data-dependent break;
* Huber weighting (eps=0.01) and the validity rules (cheirality in every
  observing view + normalized cost threshold) are the reference's.

Window tensors (q_CG (..., N, 4), p_C_G (..., N, 3)) broadcast against the
track axes of ``obs``.

:func:`triangulate_tracks` runs both on the same tracks: the plain version
(:func:`triangulate_tracks_plain`) on CPU tensors, the hand-written CUDA
kernel (``ops/triangulate_cuda``) on CUDA tensors, with no fallback.
"""

from __future__ import annotations

import torch

from msckf_mono_tpu_torch.ops import triangulate_cuda
from msckf_mono_tpu_torch.ops.linalg import bmm_small, bmv, solve3x3
from msckf_mono_tpu_torch.utils import quat


def first_valid_index(mask):
    return torch.argmax(mask.to(torch.int32), dim=-1)


def last_valid_index(mask):
    n = mask.shape[-1]
    return n - 1 - torch.argmax(torch.flip(mask, dims=[-1]).to(torch.int32), dim=-1)


def _take(x, i):
    """x[..., i, :] for x (..., N, k) and i (...,) -> (..., k)."""
    idx = i[..., None, None].expand(i.shape + (1,) + tuple(x.shape[-1:]))
    return torch.gather(x, -2, idx)[..., 0, :]


def _take_mat(x, i):
    """x[..., i, :, :] for x (..., N, a, b) and i (...,) -> (..., a, b)."""
    idx = i[..., None, None, None].expand(i.shape + (1,) + tuple(x.shape[-2:]))
    return torch.gather(x, -3, idx)[..., 0, :, :]


def _expand_window(obs, q_CG, p_C_G):
    lead = obs.shape[:-2]
    N = obs.shape[-2]
    return q_CG.expand(lead + (N, 4)), p_C_G.expand(lead + (N, 3))


def check_motion(obs, obs_mask, q_CG, p_C_G, translation_threshold):
    """Parallax gate (reference msckf.h:980-1025).

    obs: (..., N, 2), obs_mask: (..., N), window poses broadcastable to
    (..., N, ·). Returns bool (...,).
    """
    q_CG, p_C_G = _expand_window(obs, q_CG, p_C_G)
    N = obs_mask.shape[-1]
    i0 = first_valid_index(obs_mask)
    first_obs = _take(obs, i0)
    # first_cam_pose.linear() = R(q)ᵀ (cam->world)
    R0_T = quat.to_rotmat(_take(q_CG, i0)).transpose(-1, -2)
    d = torch.cat([first_obs, torch.ones_like(first_obs[..., :1])], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    feature_dir = bmv(R0_T, d)                                        # (..., 3)

    t = p_C_G - _take(p_C_G, i0)[..., None, :]                        # (..., N, 3)
    parallel = torch.sum(t * feature_dir[..., None, :], dim=-1)       # (..., N)
    ortho = t - parallel[..., None] * feature_dir[..., None, :]
    ortho_norm = torch.linalg.norm(ortho, dim=-1)
    valid_other = obs_mask & (torch.arange(N, device=obs.device) != i0[..., None])
    max_ortho = torch.amax(torch.where(valid_other, ortho_norm, torch.zeros_like(ortho_norm)), dim=-1)

    count = torch.sum(obs_mask, dim=-1)
    return (count >= 2) & (max_ortho > translation_threshold)


def _relative_poses(obs_mask, q_CG, p_C_G):
    """World->slot poses composed with first-slot cam->world: T_c0_ci.

    Returns A (..., N, 3, 3), t (..., N, 3) with x_ci = A_i x_c0 + t_i, plus
    (A0, t0) = T_c0_w (cam0->world) for mapping the solution back.
    """
    i0 = first_valid_index(obs_mask)
    R_cw = quat.to_rotmat(q_CG).transpose(-1, -2)                     # (..., N, 3, 3)
    A0, t0 = _take_mat(R_cw, i0), _take(p_C_G, i0)
    R_wc = R_cw.transpose(-1, -2)
    A = bmm_small(R_wc, A0[..., None, :, :].expand(R_cw.shape))
    t = bmv(R_wc, t0[..., None, :] - p_C_G)
    return A, t, A0, t0


def _initial_guess(A_last, t_last, z_first, z_last):
    """Two-view linear depth init (reference msckf.h:1126-1145)."""
    m = bmv(A_last, torch.cat([z_first, torch.ones_like(z_first[..., :1])], dim=-1))
    a = torch.stack([m[..., 0] - z_last[..., 0] * m[..., 2],
                     m[..., 1] - z_last[..., 1] * m[..., 2]], dim=-1)
    b = torch.stack([z_last[..., 0] * t_last[..., 2] - t_last[..., 0],
                     z_last[..., 1] * t_last[..., 2] - t_last[..., 1]], dim=-1)
    depth = torch.sum(a * b, dim=-1) / torch.clamp(torch.sum(a * a, dim=-1), min=1e-20)
    return torch.stack([z_first[..., 0] * depth, z_first[..., 1] * depth, depth], dim=-1)


def _total_cost(A, t, obs, obs_mask, x):
    """Masked sum of squared reprojection residuals (msckf.h:1027-1047)."""
    xh = torch.stack([x[..., 0], x[..., 1], torch.ones_like(x[..., 0])], dim=-1)
    h = bmv(A, xh[..., None, :]) + x[..., None, 2:3] * t
    z_hat = h[..., 0:2] / h[..., 2:3]
    e = torch.sum((z_hat - obs) ** 2, dim=-1)
    return torch.sum(torch.where(obs_mask, e, torch.zeros_like(e)), dim=-1)


def _total_cost_multi(A, t, obs, obs_mask, X):
    """Costs for K candidate solutions X (..., K, 3) in one pass -> (..., K)."""
    Xb = X[..., None, None, :, :]                                     # (..., 1, 1, K, 3)
    h = (
        A[..., :, :, 0, None] * Xb[..., 0]
        + A[..., :, :, 1, None] * Xb[..., 1]
        + A[..., :, :, 2, None]
        + t[..., :, :, None] * Xb[..., 2]
    )  # (..., N, 3, K)
    z_hat = h[..., 0:2, :] / h[..., 2:3, :]
    e = torch.sum((z_hat - obs[..., :, :, None]) ** 2, dim=-2)        # (..., N, K)
    return torch.sum(torch.where(obs_mask[..., None], e, torch.zeros_like(e)), dim=-2)


def _accumulate_normal_eqs(A, t, obs, obs_mask, x):
    """Masked Huber-weighted JᵀJ, Jᵀr (msckf.h:1201-1216, 1287-1323)."""
    dtype = x.dtype
    xh = torch.stack([x[..., 0], x[..., 1], torch.ones_like(x[..., 0])], dim=-1)
    h = bmv(A, xh[..., None, :]) + x[..., None, 2:3] * t
    h1, h2, h3 = h[..., 0], h[..., 1], h[..., 2]

    W = torch.cat([A[..., :, :, 0:2], t[..., :, :, None]], dim=-1)    # (..., N, 3, 3)
    J0 = W[..., 0, :] / h3[..., None] - (h1 / (h3 * h3))[..., None] * W[..., 2, :]
    J1 = W[..., 1, :] / h3[..., None] - (h2 / (h3 * h3))[..., None] * W[..., 2, :]
    J = torch.stack([J0, J1], dim=-2)                                 # (..., N, 2, 3)

    z_hat = torch.stack([h1 / h3, h2 / h3], dim=-1)
    r = z_hat - obs                                                   # (..., N, 2)

    e = torch.linalg.norm(r, dim=-1)
    huber_eps = 0.01
    one = torch.ones_like(e)
    w = torch.where(e <= huber_eps, one, huber_eps / (2.0 * torch.clamp(e, min=1e-20)))
    w2 = torch.where(w == 1.0, one, w * w)  # reference applies w² only when w != 1

    m = obs_mask.to(dtype) * w2
    JtJ = torch.einsum("...n,...nki,...nkj->...ij", m, J, J)
    Jtr = torch.einsum("...n,...nki,...nk->...i", m, J, r)
    return JtJ, Jtr


def initialize_position(obs, obs_mask, q_CG, p_C_G, max_gn_cost_norm,
                        n_iters: int = 11, n_trials: int = 11):
    """LM triangulation. Returns (p_f_G (..., 3), is_valid bool (...,)).

    Reference msckf.h:1147-1285 with the same constants: damping 1e-3,
    lambda in [1e-10, 1e12], precision 5e-7. All ``n_trials`` lambdas
    lam·10^k of one outer step are tried at once and the FIRST cost reduction
    is accepted, exactly like the reference's inner do-while; if none
    reduces the cost the solution stays and lambda escalates from the last
    trial. Every track runs all ``n_iters`` outer steps; converged tracks
    are frozen by their done mask.
    """
    dtype = obs.dtype
    dev = obs.device
    q_CG, p_C_G = _expand_window(obs, q_CG, p_C_G)
    A, t, A0, t0 = _relative_poses(obs_mask, q_CG, p_C_G)
    i0 = first_valid_index(obs_mask)
    i1 = last_valid_index(obs_mask)

    p0 = _initial_guess(_take_mat(A, i1), _take(t, i1), _take(obs, i0), _take(obs, i1))
    solution = torch.stack([p0[..., 0] / p0[..., 2], p0[..., 1] / p0[..., 2], 1.0 / p0[..., 2]],
                           dim=-1)
    total_cost = _total_cost(A, t, obs, obs_mask, solution)

    lam = torch.full_like(total_cost, 1e-3)
    done = torch.zeros_like(total_cost, dtype=torch.bool)
    ks = torch.arange(n_trials, device=dev)
    pow10 = 10.0 ** ks.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    for _ in range(n_iters):
        JtJ, Jtr = _accumulate_normal_eqs(A, t, obs, obs_mask, solution)
        lams = torch.clamp(lam[..., None] * pow10, max=1e12)                   # (..., K)
        dampers = lams[..., None, None] * eye3                                  # (..., K, 3, 3)
        deltas = solve3x3(JtJ[..., None, :, :] + dampers, Jtr[..., None, :])    # (..., K, 3)
        cands = solution[..., None, :] - deltas
        costs = _total_cost_multi(A, t, obs, obs_mask, cands)
        reduces = costs < total_cost[..., None]
        any_red = torch.any(reduces, dim=-1)
        first = torch.argmax(reduces.to(torch.int32), dim=-1)
        kacc = torch.where(any_red, first, torch.full_like(first, n_trials - 1))
        solution_n = torch.where(any_red[..., None], _take(cands, kacc), solution)
        cost_n = torch.where(any_red, torch.gather(costs, -1, kacc[..., None])[..., 0], total_cost)
        lam_acc = torch.clamp(torch.gather(lams, -1, kacc[..., None])[..., 0] / 10.0, min=1e-10)
        lam_rej = torch.clamp(lams[..., n_trials - 1] * 10.0, max=1e12)
        lam_n = torch.where(any_red, lam_acc, lam_rej)
        delta_norm = torch.linalg.norm(_take(deltas, kacc), dim=-1)

        solution = torch.where(done[..., None], solution, solution_n)
        total_cost = torch.where(done, total_cost, cost_n)
        lam = torch.where(done, lam, lam_n)
        done = done | (delta_norm <= 5e-7)

    final_position = torch.stack(
        [solution[..., 0] / solution[..., 2], solution[..., 1] / solution[..., 2],
         1.0 / solution[..., 2]], dim=-1)

    # Cheirality in every observing view (msckf.h:1257-1265).
    pos_in_view = bmv(A, final_position[..., None, :]) + t
    cheirality = torch.all(torch.where(obs_mask, pos_in_view[..., 2] > 0,
                                       torch.ones_like(obs_mask)), dim=-1)

    m = torch.sum(obs_mask, dim=-1)
    normalized_cost = total_cost / (2.0 * torch.clamp(m, min=1).to(dtype) ** 2)
    is_valid = cheirality & (normalized_cost <= max_gn_cost_norm) & (m >= 2)

    p_f_G = bmv(A0, final_position) + t0
    return p_f_G, is_valid


def triangulate_tracks_plain(obs, obs_mask, q_CG, p_C_G, translation_threshold,
                             max_gn_cost_norm, n_iters: int = 11, n_trials: int = 11):
    """:func:`check_motion` and :func:`initialize_position` on the same
    tracks. Returns (motion_ok, p_f_G, tri_ok)."""
    motion_ok = check_motion(obs, obs_mask, q_CG, p_C_G, translation_threshold)
    p_f_G, tri_ok = initialize_position(obs, obs_mask, q_CG, p_C_G, max_gn_cost_norm,
                                        n_iters=n_iters, n_trials=n_trials)
    return motion_ok, p_f_G, tri_ok


def _check_tracks(obs, obs_mask, q_CG, p_C_G, n_iters, n_trials):
    """Raise ValueError unless the window poses broadcast over trailing track
    axes: their leading axes, left-padded with ones, equal the tracks' up to
    some axis and are 1 after it."""
    if (obs.dim() < 2 or obs.shape[-1] != 2 or tuple(obs_mask.shape) != tuple(obs.shape[:-1])
            or q_CG.dim() < 2 or q_CG.shape[-1] != 4 or tuple(p_C_G.shape) != tuple(q_CG.shape[:-1]) + (3,)
            or q_CG.shape[-2] != obs.shape[-2]):
        raise ValueError(f"triangulate_tracks: shapes obs {tuple(obs.shape)}, obs_mask "
                         f"{tuple(obs_mask.shape)}, q_CG {tuple(q_CG.shape)}, p_C_G "
                         f"{tuple(p_C_G.shape)} are not (..., N, 2), (..., N), (..., N, 4), "
                         "(..., N, 3)")
    lead, wlead = tuple(obs.shape[:-2]), tuple(q_CG.shape[:-2])
    if len(wlead) > len(lead):
        raise ValueError(f"triangulate_tracks: window axes {wlead} exceed the track axes {lead}")
    wlead = (1,) * (len(lead) - len(wlead)) + wlead
    k = max((i + 1 for i, d in enumerate(wlead) if d != 1), default=0)
    if any(w != t for w, t in zip(wlead[:k], lead[:k])):
        raise ValueError(f"triangulate_tracks: window axes {tuple(q_CG.shape[:-2])} do not "
                         f"broadcast over the trailing axes of the tracks' {lead}")
    if n_iters < 0 or n_trials < 1:
        raise ValueError(f"triangulate_tracks: n_iters {n_iters} < 0 or n_trials {n_trials} < 1")


def triangulate_tracks(obs, obs_mask, q_CG, p_C_G, translation_threshold, max_gn_cost_norm,
                       n_iters: int = 11, n_trials: int = 11):
    """Motion gate and LM triangulation of tracks (obs (..., N, 2), obs_mask
    (..., N)) against window poses (q_CG (..., N, 4), p_C_G (..., N, 3), which
    broadcast over trailing track axes). Returns (motion_ok (...,), p_f_G
    (..., 3), tri_ok (...,)) as :func:`triangulate_tracks_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    raises on what it does not take (not float32 with a bool mask, not
    contiguous, on two devices, more than 32 window slots)."""
    _check_tracks(obs, obs_mask, q_CG, p_C_G, n_iters, n_trials)
    if all(t.device.type == "cpu" for t in (obs, obs_mask, q_CG, p_C_G)):
        return triangulate_tracks_plain(obs, obs_mask, q_CG, p_C_G, translation_threshold,
                                        max_gn_cost_norm, n_iters, n_trials)
    return triangulate_cuda.triangulate_tracks(obs, obs_mask, q_CG, p_C_G, translation_threshold,
                                               max_gn_cost_norm, n_iters, n_trials)
