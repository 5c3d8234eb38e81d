"""Measurement Jacobians, nullspace projection, gating, and the EKF update.

Port of ``msckf_mono_tpu/core/update.py`` (reference ``calcResidual`` /
``calcMeasJacobian`` / ``gatingTest`` / ``measurementUpdate``,
msckf.h:905-978, 1103-1124, 1325-1423):

* Per-track observations are gathered in compacted order (valid slots
  first). Householder QR preserves exact zero rows, so each track's projected
  rows are contiguous: the first ``2m-3`` carry all information.
* The Mahalanobis gate's γ = rᵀS⁻¹r runs through ``ops/psd_cuda.gamma_psd``
  (the hand-written CUDA kernel on the card).
* Staged tracks are processed in chunks; their gated rows are compacted into
  a fixed ``max_update_rows`` budget in chunk order, with the overflow
  counted.
* Measurement noise defaults to isotropic σ² = u_var_prime;
  ``FilterConfig.use_anisotropic_r`` gives the reference's exact projected
  R_o = blockdiag_tracks(A_jᵀ diag(u_var', v_var') A_j) as
  σu²I + (σv²-σu²)·(VVᵀ ⊙ same-track), with V the projected v-row indicator
  columns and per-row track ids.
* ``FilterConfig.use_qr_compression`` runs the reference's QR "T_H"
  compression of the stacked rows (msckf.h:1343-1366) with zero-row masking
  (:func:`compress_rows`); QR is ``torch.linalg.qr``.
* Joseph-form covariance correction + symmetrization (msckf.h:1394-1403).
"""

from __future__ import annotations

import torch

from msckf_mono_tpu_torch.core import triangulate
from msckf_mono_tpu_torch.core.types import FilterState, StagedTracks
from msckf_mono_tpu_torch.core.window import gather_rows, stable_order
from msckf_mono_tpu_torch.ops import psd_cuda
from msckf_mono_tpu_torch.ops.linalg import bmm_small, bmv, null_project_3
from msckf_mono_tpu_torch.utils import quat
from msckf_mono_tpu_torch.utils.chi2 import chi2_gate_table
from msckf_mono_tpu_torch.utils.config import MsckfConfig


def track_projected_rows(obs, obs_mask, p_f_G, window, g, config: MsckfConfig,
                         m_cap: int | None = None):
    """Nullspace-projected measurement rows for a batch of tracks.

    obs: (..., N, 2), obs_mask: (..., N), p_f_G: (..., 3); the window poses
    ``window.q_CG`` (..., N, 4), ``window.p_C_G`` (..., N, 3) and gravity g
    (..., 3) broadcast against the track axes. Returns (H_o (..., 2M-3, D),
    r_o (..., 2M-3), rows_valid (..., 2M-3), V) with M = min(m_cap, N)
    (M = N when ``m_cap`` is None — the exact path). Mirrors
    msckf.h:905-978 including the per-observation observability constraint
    A - A·u(uᵀu)⁻¹uᵀ.

    A track with m <= m_cap observations is exact; beyond that the newest-slot
    observations are dropped (callers count the lost rows in row_overflow).

    V is None unless ``filter.use_anisotropic_r``: then it is the
    (..., 2M-3, M) projection of the v-row indicator columns, so the track's
    projected noise A_jᵀ diag(u_var', v_var') A_j (msckf.h:411-431) is
    σu²·I + (σv²-σu²)·V Vᵀ.
    """
    dtype = obs.dtype
    dev = obs.device
    N = obs_mask.shape[-1]
    M = N if m_cap is None else max(2, min(int(m_cap), N))
    lead = obs.shape[:-2]
    q_CG = window.q_CG.expand(lead + (N, 4))
    p_C_G = window.p_C_G.expand(lead + (N, 3))

    # Observations with near-zero depth produce unbounded Jacobians that could
    # sneak garbage through the gate; drop them like a lost observation,
    # BEFORE sorting so the zero rows of H_f stay contiguous at the bottom.
    depth_all = bmv(quat.to_rotmat(q_CG), p_f_G[..., None, :] - p_C_G)[..., 2]
    eff_mask = obs_mask & (depth_all > 1e-2)

    order = stable_order(~eff_mask)[..., :M]                          # (..., M)
    m = torch.clamp(torch.sum(eff_mask, dim=-1), max=M)
    valid = torch.arange(M, device=dev) < m[..., None]                # (..., M)

    def sel(x):
        idx = order[..., None].expand(order.shape + x.shape[-1:])
        return torch.gather(x, -2, idx)

    q, p, z = sel(q_CG), sel(p_C_G), sel(obs)

    R = quat.to_rotmat(q)                                             # (..., M, 3, 3)
    dp = p_f_G[..., None, :] - p
    p_f_C = bmv(R, dp)
    X, Y = p_f_C[..., 0], p_f_C[..., 1]
    Z = torch.where(valid, p_f_C[..., 2], torch.ones_like(p_f_C[..., 2]))
    Z = torch.where(torch.abs(Z) > 1e-8, Z, torch.ones_like(Z))

    inv_z = 1.0 / Z
    zero = torch.zeros_like(inv_z)
    J = torch.stack(
        [
            torch.stack([inv_z, zero, -X * inv_z * inv_z], dim=-1),
            torch.stack([zero, inv_z, -Y * inv_z * inv_z], dim=-1),
        ],
        dim=-2,
    )  # (..., M, 2, 3)

    A = torch.cat([bmm_small(J, quat.skew(p_f_C)), -bmm_small(J, R)], dim=-1)   # (..., M, 2, 6)

    g_b = g[..., None, :].expand(dp.shape)
    u = torch.cat([bmv(R, g_b), bmv(quat.skew(dp), g_b)], dim=-1)     # (..., M, 6)
    uu = torch.sum(u * u, dim=-1, keepdim=True)
    Au = bmv(A, u)                                                    # (..., M, 2)
    H_x6 = A - Au[..., :, None] * (u / torch.clamp(uu, min=1e-20))[..., None, :]
    H_f = -H_x6[..., 3:6]                                             # (..., M, 2, 3)

    r = z - torch.stack([X * inv_z, Y * inv_z], dim=-1)              # (..., M, 2)

    # Zero invalid observation rows (exact zeros are load-bearing for QR).
    vm = valid.to(dtype)
    H_x6 = H_x6 * vm[..., None, None]
    H_f = H_f * vm[..., None, None]
    r = r * vm[..., None]

    # Place each observation's 6-wide block at its slot's columns.
    H_cam = torch.zeros(lead + (M, 2, N, 6), dtype=dtype, device=dev)
    idx = order[..., None, None, None].expand(lead + (M, 2, 1, 6))
    H_cam.scatter_(-2, idx, H_x6[..., None, :])
    H_cam = H_cam.reshape(lead + (2 * M, 6 * N))
    H_f_rows = H_f.reshape(lead + (2 * M, 3))
    r_rows = r.reshape(lead + (2 * M,))

    # Left-nullspace projection of [H_cam | r]. The 15 IMU columns of H_x are
    # identically zero and the projection acts row-wise, so they are
    # prepended after it.
    cols = [H_cam, r_rows[..., None]]
    aniso = config.filter.use_anisotropic_r
    if aniso:
        # v-row indicator columns: row 2i+1 marks observation i's v residual
        ind = (torch.arange(2 * M, device=dev)[:, None]
               == 2 * torch.arange(M, device=dev)[None, :] + 1).to(dtype)
        cols.append(ind.expand(lead + (2 * M, M)))
    Xr = torch.cat(cols, dim=-1)                                      # (..., 2M, 6N+1[+M])
    proj = null_project_3(H_f_rows, Xr)                               # (..., 2M-3, 6N+1[+M])
    R_rows = 2 * M - 3
    rows_valid = torch.arange(R_rows, device=dev) < torch.clamp(2 * m - 3, min=0)[..., None]
    rv = rows_valid.to(dtype)
    H_o = torch.cat(
        [torch.zeros(lead + (R_rows, 15), dtype=dtype, device=dev), proj[..., : 6 * N]], dim=-1
    ) * rv[..., None]
    r_o = proj[..., 6 * N] * rv
    V = proj[..., 6 * N + 1:] * rv[..., None] if aniso else None
    return H_o, r_o, rows_valid, V


def _psd_solve(S, b):
    """Cholesky solve for the S = (·)P(·)ᵀ + σ²I systems, as two triangular
    solves (batched cuBLAS on the card). ``torch.cholesky_solve`` of a batch
    takes MAGMA's batched path on the card, which allocates with cudaMalloc,
    synchronizes the device and fails an assertion inside a CUDA graph
    capture."""
    L, _ = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def gating_test_all(H_all, r_all, P, dof, sigma2, config: MsckfConfig):
    """All staged tracks' Mahalanobis gates (msckf.h:1103-1124), incl. the
    table[dof+1] quirk.

    H_all: (B, S, R, D); r_all: (B, S, R); P: (B, D, D); dof: (B, S) int;
    sigma2: (B,). Returns bool (B, S). ``gating_precision`` is not consulted:
    the gate is full f32 (or the state's dtype) on every device.
    """
    dtype = H_all.dtype
    R = H_all.shape[-2]
    HP = torch.matmul(H_all, P[:, None])                              # (B, S, R, D)
    Smat = torch.matmul(HP, H_all.transpose(-1, -2))
    Smat = Smat + sigma2[:, None, None, None] * torch.eye(R, dtype=dtype, device=H_all.device)
    gamma = psd_cuda.gamma_psd(Smat.contiguous(), r_all.contiguous())
    table = chi2_gate_table(dtype, H_all.device)
    offset = 2 if config.filter.chi2_offbyone else 0
    idx = torch.clamp(dof.long() + offset, 1, table.shape[0] - 1)
    return gamma < table[idx]


def gating_test(H_o, r_o, rows_valid, P, dof, sigma2, config: MsckfConfig):
    """One track per filter: H_o (B, R, D), r_o (B, R), dof (B,)."""
    dof = torch.as_tensor(dof, device=H_o.device).expand(H_o.shape[:1])
    return gating_test_all(H_o[:, None], r_o[:, None], P, dof[:, None], sigma2, config)[:, 0]


def gated_row_stack(obs, obs_mask, p_f, track_ok, window, g, P, sigma2,
                    config: MsckfConfig, m_cap: int | None = None,
                    carry=None, return_carry: bool = False,
                    chunk: int | None = None):
    """Chunked projected-rows + gating + row compaction for S staged tracks.

    obs: (B, S, N, 2), obs_mask: (B, S, N), p_f: (B, S, 3), track_ok: (B, S);
    window: CamWindow (B, N, ·); g: (B, 3); P: (B, D, D); sigma2: (B,).

    The staged-track axis runs in chunks of ``shapes.staged_chunk`` (or
    ``chunk``) through a fixed Python loop. Each chunk's gated rows land in
    the fixed ``max_update_rows`` buffer at row count + cumsum(keep) - 1, in
    chunk order; rows at or beyond the budget are dropped and counted.

    Returns (H (B, R_MAX, D), r (B, R_MAX), gate_ok (B, S), rows_present
    (B, S), n_dropped (B,) int32[, V (B, R_MAX, N), v_track_ids (B, R_MAX)
    when ``use_anisotropic_r``]). ``v_track_ids[b, j]`` is 1 + the staged
    index of the track that produced row j (0 for padding rows), so the
    update can keep the reference's block-diagonal-per-track R_o.
    ``rows_present[b, s]`` is True iff track s contributed at least one
    valid row. ``m_cap`` bounds the per-track
    observation width (rows lost to it on contributing tracks are added to
    ``n_dropped``). ``carry`` chains a second staged set into the SAME row
    buffer; ``return_carry=True`` returns (gate_ok, rows_present, carry)
    instead of the finalized stack. The buffer's width does not depend on
    the cap (V is padded to N columns), so differently-capped calls chain.
    The buffer is sized from ``config.shapes.max_update_rows`` of this call.
    """
    B, S, N, _ = obs.shape
    M = N if m_cap is None else max(2, min(int(m_cap), N))
    R = 2 * M - 3
    D = config.shapes.state_dim
    R_MAX = config.shapes.max_update_rows
    aniso = config.filter.use_anisotropic_r
    W = D + 1 + (N + 1 if aniso else 0)
    C = min(chunk or config.shapes.staged_chunk, S)
    while S % C:
        C -= 1
    n_chunks = S // C
    dtype = obs.dtype
    dev = obs.device

    m_raw = torch.sum(obs_mask, dim=-1, dtype=torch.int32)
    # Gate dof follows the rows actually available (msckf.h:1117).
    dof = torch.clamp(m_raw, max=M) - 1
    cap_lost_all = (torch.clamp(2 * m_raw - 3, min=0)
                    - torch.clamp(2 * torch.clamp(m_raw, max=M) - 3, min=0))

    if carry is None:
        buf = torch.zeros((B, R_MAX + 1, W), dtype=dtype, device=dev)  # row R_MAX: dropped
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        carry = (buf, zi, zi, zi)
    buf, count, total, capped = carry
    buf = buf.clone()
    bidx = torch.arange(B, device=dev)[:, None]
    win_b = window.replace(q_CG=window.q_CG[:, None], p_C_G=window.p_C_G[:, None])
    g_t = g[:, None]

    gates, presents = [], []
    for c in range(n_chunks):
        s = slice(c * C, (c + 1) * C)
        H_c, r_c, rv_c, V_c = track_projected_rows(obs[:, s], obs_mask[:, s], p_f[:, s],
                                                   win_b, g_t, config, m_cap=m_cap)
        gate_c = gating_test_all(H_c, r_c, P, dof[:, s], sigma2, config)
        ok = track_ok[:, s] & gate_c
        rm = rv_c & ok[..., None]                                     # (B, C, R)
        cols = [H_c, r_c[..., None]]
        if aniso:
            # 1-based track ids (0 = padding row); V padded to the buffer's N
            tid = (torch.arange(c * C, (c + 1) * C, device=dev) + 1).to(dtype)
            cols += [torch.nn.functional.pad(V_c, (0, N - M)),
                     tid[None, :, None, None].expand(B, C, R, 1)]
        rows = torch.cat(cols, dim=-1).reshape(B, C * R, W)
        rmf = rm.reshape(B, C * R)
        nv = torch.sum(rmf, dim=1, dtype=torch.int32)
        tgt = count[:, None] + torch.cumsum(rmf, dim=1, dtype=torch.int32) - 1
        tgt = torch.where(rmf & (tgt < R_MAX), tgt, torch.full_like(tgt, R_MAX))
        buf[bidx, tgt.long()] = rows
        count = torch.clamp(count + nv, max=R_MAX)
        present = torch.any(rm, dim=-1)
        n_capped = torch.sum(cap_lost_all[:, s] * (ok & present), dim=1, dtype=torch.int32)
        total = total + nv
        capped = capped + n_capped
        gates.append(gate_c)
        presents.append(present)

    gate_ok = torch.cat(gates, dim=1)
    rows_present = torch.cat(presents, dim=1)
    carry = (buf, count, total, capped)
    if return_carry:
        return gate_ok, rows_present, carry
    H = buf[:, :R_MAX, :D]
    r = buf[:, :R_MAX, D]
    n_dropped = (torch.clamp(total - R_MAX, min=0) + capped).to(torch.int32)
    out = (H, r, gate_ok, rows_present, n_dropped)
    if aniso:
        out = out + (buf[:, :R_MAX, D + 1:D + 1 + N], buf[:, :R_MAX, D + 1 + N])
    return out


def stack_rows(H_all, r_all, row_masks, config: MsckfConfig):
    """Compact valid projected rows from all tracks into the fixed budget.

    H_all: (B, S, R_t, D); r_all: (B, S, R_t); row_masks: (B, S, R_t).
    Returns (H (B, R_MAX, D), r (B, R_MAX), n_dropped (B,) int32): the first
    R_MAX valid rows in track-major order, zero rows after them.
    """
    R_MAX = config.shapes.max_update_rows
    B, S, R_t, D = H_all.shape
    flat_H = H_all.reshape(B, S * R_t, D)
    flat_r = r_all.reshape(B, S * R_t)
    flat_m = row_masks.reshape(B, S * R_t)
    order = stable_order(~flat_m)[:, :R_MAX]
    sel = torch.gather(flat_m, 1, order)
    # a budget beyond the rows takes them all (the JAX slice is then short too)
    H = gather_rows(flat_H, order) * sel[..., None]
    r = torch.gather(flat_r, 1, order) * sel
    n_dropped = torch.clamp(torch.sum(flat_m, dim=1) - R_MAX, min=0).to(torch.int32)
    return H, r, n_dropped


def apply_correction(state: FilterState, deltaX, config: MsckfConfig) -> FilterState:
    """Multiplicative state correction (msckf.h:1375-1391); deltaX (B, D)."""
    N = config.shapes.num_slots
    imu = state.imu
    dq = quat.build_update_quat(deltaX[:, 0:3])
    imu = imu.replace(
        q_IG=quat.mul(dq, imu.q_IG),
        b_g=imu.b_g + deltaX[:, 3:6],
        v_I_G=imu.v_I_G + deltaX[:, 6:9],
        b_a=imu.b_a + deltaX[:, 9:12],
        p_I_G=imu.p_I_G + deltaX[:, 12:15],
    )
    dc = deltaX[:, 15:].reshape(-1, N, 6)
    dq_c = quat.build_update_quat(dc[..., 0:3])
    window = state.window
    window = window.replace(
        q_CG=quat.normalize(quat.mul(dq_c, window.q_CG)),
        p_C_G=window.p_C_G + dc[..., 3:6],
    )
    return state.replace(imu=imu, window=window)


def compress_rows(H, r):
    """QR measurement compression with nonzero-row masking (msckf.h:1343-1366).

    H: (B, rows, D), r: (B, rows). H = Q₁·T_H with T_H the R factor; rows of
    T_H whose largest entry is below 1e-6 of the largest row's are zeroed
    with their r_n entries (the reference drops them). Returns (T_H (B, k, D),
    r_n (B, k)), k = min(rows, D).
    """
    Q, R = torch.linalg.qr(H, mode="reduced")
    r_n = (Q.transpose(-1, -2) @ r[..., None])[..., 0]
    row_norm = torch.amax(torch.abs(R), dim=-1)
    top = torch.clamp(torch.amax(row_norm, dim=-1, keepdim=True), min=1e-30)
    keep = row_norm > 1e-6 * top
    return R * keep[..., None], r_n * keep


def measurement_update(state: FilterState, H, r, sigma2, config: MsckfConfig,
                       V=None, v_track_ids=None) -> FilterState:
    """EKF update (msckf.h:1325-1423): Kalman gain via a Cholesky solve,
    multiplicative correction, Joseph-form covariance.

    H: (B, rows, D), r: (B, rows), sigma2: (B,). With isotropic R = σ²I the
    direct update equals the reference's QR-compressed one; zero padding
    rows contribute exact σ² diagonals and zero gain.
    ``FilterConfig.use_qr_compression`` solves on the compressed rows instead.

    ``V`` (B, rows, N): projected v-row coefficients (anisotropic-R mode).
    The noise is then σu²I + dv·M with M = VVᵀ ⊙ [same track id] and
    dv = σ²·(v_var'/u_var' − 1), the reference's block-diagonal R_o
    (msckf.h:411-431). ``v_track_ids`` (B, rows) gives the per-row track tag;
    without it all rows are one track. With QR compression as well, R_o is
    projected as R_n = Q₁ᵀ R_o Q₁ (msckf.h:1365-1366), keeping the rows of
    T_H that have any nonzero entry (msckf.h:1347) — an exact rule, unlike
    :func:`compress_rows`' relative one.
    """
    dtype = H.dtype
    D = H.shape[-1]
    P = state.P
    s2 = sigma2[:, None, None]
    tr = lambda x: x.transpose(-1, -2)

    if V is not None:
        dv = (sigma2 * (config.v_var_prime / config.u_var_prime - 1.0))[:, None, None]
        Mv = V @ tr(V)
        if v_track_ids is not None:
            Mv = Mv * (v_track_ids[:, :, None] == v_track_ids[:, None, :]).to(dtype)

    if config.filter.use_qr_compression:
        if V is None:
            H, r = compress_rows(H, r)
        else:
            Q, Rq = torch.linalg.qr(H, mode="reduced")
            keep = torch.amax(torch.abs(Rq), dim=-1) > 0.0
            H = Rq * keep[..., None]
            Q1 = Q * keep[:, None, :]
            r = (tr(Q) @ r[..., None])[..., 0] * keep
            Mv = tr(Q1) @ Mv @ Q1

    HP = H @ P
    S_mat = HP @ tr(H) + s2 * torch.eye(H.shape[-2], dtype=dtype, device=H.device)
    if V is not None:
        S_mat = S_mat + dv * Mv
    K = tr(_psd_solve(S_mat, HP))                                     # (B, D, rows)
    deltaX = (K @ r[..., None])[..., 0]

    IKH = torch.eye(D, dtype=dtype, device=H.device) - K @ H
    P_new = IKH @ P @ tr(IKH) + s2 * (K @ tr(K))
    if V is not None:
        P_new = P_new + dv * (K @ Mv @ tr(K))
    P_new = 0.5 * (P_new + tr(P_new))

    state = apply_correction(state, deltaX, config)
    return state.replace(P=P_new)


def marginalize_prep(state: FilterState, staged: StagedTracks, config: MsckfConfig):
    """Motion gate + LM triangulation for the staged tracks (the front half
    of msckf.h:336-449). Returns (p_f_G, track_ok, motion_ok, tri_ok)."""
    fcfg = config.filter
    q_CG = state.window.q_CG[:, None]
    p_C_G = state.window.p_C_G[:, None]

    motion_ok, p_f_G, tri_ok = triangulate.triangulate_tracks(
        staged.obs, staged.obs_mask, q_CG, p_C_G, fcfg.translation_threshold,
        config.max_gn_cost_norm, n_iters=fcfg.lm_iters, n_trials=fcfg.lm_trials,
    )
    motion_ok = motion_ok | (state.num_residualized <= 3)[:, None]
    motion_ok = motion_ok & staged.valid
    # Non-finite points are already rejected; sanitize them so masked-out
    # rows multiply to exact zeros downstream.
    tri_ok = tri_ok & torch.all(torch.isfinite(p_f_G), dim=-1)
    track_ok = motion_ok & tri_ok
    p_f_G = torch.nan_to_num(p_f_G, nan=0.0, posinf=0.0, neginf=0.0)
    return p_f_G, track_ok, motion_ok, tri_ok


def _count(x):
    return torch.sum(x, dim=-1, dtype=torch.int32)


def marginalize_post(state: FilterState, staged: StagedTracks, p_f_G, track_ok,
                     motion_ok, tri_ok, gate_ok, rows_present, n_dropped,
                     config: MsckfConfig) -> FilterState:
    """Diagnostics + map bookkeeping for the staged-track update (the back
    half of msckf.h:336-449)."""
    dtype = state.P.dtype
    d = state.diag
    diag = d.replace(
        row_overflow=d.row_overflow + n_dropped,
        motion_rejects=d.motion_rejects + _count(staged.valid & ~motion_ok),
        triangulation_rejects=d.triangulation_rejects + _count(motion_ok & ~tri_ok),
        gating_rejects=d.gating_rejects + _count(track_ok & ~gate_ok),
        updates_applied=d.updates_applied + torch.any(rows_present, dim=-1).to(torch.int32),
    )
    return state.replace(
        num_residualized=state.num_residualized + _count(track_ok),
        map_pts=torch.where(track_ok[..., None], p_f_G, torch.zeros_like(p_f_G)).to(dtype),
        map_mask=track_ok,
        diag=diag,
    )


def marginalize(state: FilterState, staged: StagedTracks, config: MsckfConfig) -> FilterState:
    """Residualize staged tracks and update (msckf.h:336-449).

    Per staged track: motion gate (skipped for the first 4 residualized
    tracks, msckf.h:354) -> LM triangulation -> projected rows ->
    Mahalanobis gate -> global row stack -> one joint EKF update.
    """
    dtype = state.P.dtype
    sigma2 = state.meas_sigma2.to(dtype)
    p_f_G, track_ok, motion_ok, tri_ok = marginalize_prep(state, staged, config)
    out = gated_row_stack(
        staged.obs, staged.obs_mask, p_f_G, track_ok, state.window, state.imu.g, state.P,
        sigma2, config, m_cap=config.shapes.marg_obs_cap or None,
    )
    H, r, gate_ok, rows_present, n_dropped = out[:5]
    state = measurement_update(state, H, r, sigma2, config, *out[5:])
    return marginalize_post(
        state, staged, p_f_G, track_ok, motion_ok, tri_ok, gate_ok,
        rows_present, n_dropped, config,
    )
