"""Port triangulation, projected rows, gate, row stack and EKF update against the
JAX package, on a mid-sequence state of the default-size synthetic world (f64).

Tolerances: 1e-9 for the update math; ~1e-5 for LM triangulation of long
tracks, whose 5e-7 step-norm stop lets the two implementations stop one
iteration apart (see the tests/test_ref_parity.py docstring). The nullspace
projection is pinned by basis-independent products (HᵀH, Hᵀr, rᵀr), not by
its basis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.core import triangulate as jtri
from msckf_mono_tpu.core import update as jupd
from msckf_mono_tpu.core.types import StagedTracks as JStaged
from msckf_mono_tpu_torch.core import triangulate as ttri
from msckf_mono_tpu_torch.core import update as tupd
from msckf_mono_tpu_torch.core.types import StagedTracks as TStaged
from msckf_mono_tpu_torch.core.types import filter_state_to_numpy

from tests import _torch_port as tp

TOL = 1e-9
JC, TC = tp.configs()
S = 8


@pytest.fixture(scope="module")
def world():
    """State before frame 30 of the default-size world, and 8 staged tracks
    cut from its live tracks (the longest first)."""
    _, _, snaps = tp.port_snapshots(TC, 31, at={30})
    arrays = snaps[30]
    active = arrays["tracks.active"][0]
    lengths = arrays["tracks.obs_mask"][0].sum(-1) * active
    rows = np.argsort(-lengths, kind="stable")[:S]
    assert lengths[rows[-1]] >= 3
    staged = dict(obs=arrays["tracks.obs"][:, rows], obs_mask=arrays["tracks.obs_mask"][:, rows],
                  feature_id=arrays["tracks.feature_id"][:, rows], valid=np.ones((1, S), bool))
    return arrays, staged


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _window(arrays):
    q, p = arrays["window.q_CG"], arrays["window.p_C_G"]
    return q, p


def test_check_motion_and_initialize_position_match_jax(world):
    arrays, _ = world
    q, p = _window(arrays)
    obs, mask = arrays["tracks.obs"][0], arrays["tracks.obs_mask"][0] & arrays["tracks.active"][0][:, None]
    keep = mask.sum(-1) >= 2
    obs, mask = obs[keep], mask[keep]
    assert len(obs) >= 10
    got_m = ttri.check_motion(_t(obs), _t(mask), _t(q), _t(p), TC.filter.translation_threshold)
    want_m = jax.vmap(lambda o, m: jtri.check_motion(o, m, _j(q[0]), _j(p[0]),
                                                      JC.filter.translation_threshold))(_j(obs), _j(mask))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))

    got_p, got_ok = ttri.initialize_position(_t(obs), _t(mask), _t(q), _t(p), TC.max_gn_cost_norm)
    want_p, want_ok = jax.vmap(lambda o, m: jtri.initialize_position(
        o, m, _j(q[0]), _j(p[0]), JC.max_gn_cost_norm))(_j(obs), _j(mask))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lm", [(11, 11), (3, 2)])
def test_initialize_position_schedules_match_jax(world, lm):
    _, staged = world
    arrays = world[0]
    q, p = _window(arrays)
    got_p, got_ok = ttri.initialize_position(_t(staged["obs"]), _t(staged["obs_mask"]), _t(q)[:, None],
                                             _t(p)[:, None], TC.max_gn_cost_norm, *lm)
    want_p, want_ok = jax.vmap(lambda o, m: jtri.initialize_position(
        o, m, _j(q[0]), _j(p[0]), JC.max_gn_cost_norm, *lm))(_j(staged["obs"][0]), _j(staged["obs_mask"][0]))
    np.testing.assert_array_equal(got_ok.numpy()[0], np.asarray(want_ok))
    np.testing.assert_allclose(got_p.numpy()[0], np.asarray(want_p), rtol=1e-5, atol=1e-5)


def _points(world):
    arrays, staged = world
    q, p = _window(arrays)
    p_f, ok = ttri.initialize_position(_t(staged["obs"]), _t(staged["obs_mask"]), _t(q)[:, None],
                                       _t(p)[:, None], TC.max_gn_cost_norm)
    assert bool(ok.all())
    return p_f.numpy()


def _gram(H, r):
    """Basis-independent products of projected rows: HᵀH, Hᵀr, rᵀr."""
    H, r = np.asarray(H), np.asarray(r)
    return (np.swapaxes(H, -1, -2) @ H, np.einsum("...rd,...r->...d", H, r), np.einsum("...r,...r->...", r, r))


def _assert_gram(got, want, tol=TOL):
    for g, w in zip(_gram(*got), _gram(*want)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("m_cap", [None, 6, 2])
def test_track_projected_rows_match_jax(world, m_cap):
    arrays, staged = world
    p_f = _points(world)
    win = tp.port_state(arrays).window
    win_b = win.replace(q_CG=win.q_CG[:, None], p_C_G=win.p_C_G[:, None])
    g = _t(arrays["imu.g"])[:, None]
    H, r, rv, _ = tupd.track_projected_rows(_t(staged["obs"]), _t(staged["obs_mask"]), _t(p_f), win_b, g,
                                         TC, m_cap=m_cap)
    jwin = tp.jax_state(arrays, JC, jnp.float64).window
    jwin0 = jax.tree_util.tree_map(lambda x: x[0], jwin)
    jH, jr, jrv, _ = jax.vmap(lambda o, m, pf: jupd.track_projected_rows(
        o, m, pf, jwin0, _j(arrays["imu.g"][0]), JC, m_cap=m_cap))(
        _j(staged["obs"][0]), _j(staged["obs_mask"][0]), _j(p_f[0]))
    assert H.shape[1:] == jH.shape
    np.testing.assert_array_equal(rv.numpy()[0], np.asarray(jrv))
    _assert_gram((H[0], r[0]), (jH, jr))
    # rows past 2m-3 are exact zeros
    assert np.all(H.numpy()[0][~rv.numpy()[0]] == 0.0)


def _row_stack_inputs(world):
    arrays, staged = world
    p_f = _points(world)
    return arrays, staged, p_f


def _jax_row_stack(arrays, staged, p_f, jc, ok, sets):
    js = tp.jax_state(arrays, jc, jnp.float64)
    j0 = jax.tree_util.tree_map(lambda x: x[0], js)
    sigma2 = j0.meas_sigma2

    def run(obs, mask, pf, okk):
        carry = None
        outs = []
        for i, (lo, hi, cap, chunk) in enumerate(sets):
            last = i == len(sets) - 1
            out = jupd.gated_row_stack(obs[lo:hi], mask[lo:hi], pf[lo:hi], okk[lo:hi], j0.window, j0.imu.g,
                                       j0.P, sigma2, jc, m_cap=cap, carry=carry, return_carry=not last,
                                       chunk=chunk)
            if last:
                return out, outs
            gate, present, carry = out
            outs.append((gate, present))

    return run(_j(staged["obs"][0]), _j(staged["obs_mask"][0]), _j(p_f[0]), _j(ok))


def _port_row_stack(arrays, staged, p_f, tc, ok, sets):
    st = tp.port_state(arrays)
    carry, outs = None, []
    for i, (lo, hi, cap, chunk) in enumerate(sets):
        last = i == len(sets) - 1
        out = tupd.gated_row_stack(_t(staged["obs"])[:, lo:hi], _t(staged["obs_mask"])[:, lo:hi],
                                   _t(p_f)[:, lo:hi], _t(ok)[None, lo:hi], st.window, st.imu.g, st.P,
                                   st.meas_sigma2, tc, m_cap=cap, carry=carry, return_carry=not last,
                                   chunk=chunk)
        if last:
            return out, outs
        gate, present, carry = out
        outs.append((gate, present))


@pytest.mark.parametrize("rows_budget", [192, 40])
def test_gated_row_stack_with_carry_matches_jax(world, rows_budget):
    """Marginalize-style set (cap 6, chunk 2) chained into a prune-style set
    (cap 2, one chunk) through the carry; with a 40-row budget rows overflow."""
    arrays, staged, p_f = _row_stack_inputs(world)
    jc = tp.replace_config(JC, max_update_rows=rows_budget)
    tc = tp.replace_config(TC, max_update_rows=rows_budget)
    ok = np.ones(S, bool)
    ok[3] = False
    sets = [(0, 5, 6, 2), (5, 8, 2, None)]
    (jH, jr, jgate, jpresent, jdrop), jouts = _jax_row_stack(arrays, staged, p_f, jc, ok, sets)
    (H, r, gate, present, drop), outs = _port_row_stack(arrays, staged, p_f, tc, ok, sets)
    np.testing.assert_array_equal(gate.numpy()[0], np.asarray(jgate))
    np.testing.assert_array_equal(present.numpy()[0], np.asarray(jpresent))
    for (g, pr), (jg, jpr) in zip(outs, jouts):
        np.testing.assert_array_equal(g.numpy()[0], np.asarray(jg))
        np.testing.assert_array_equal(pr.numpy()[0], np.asarray(jpr))
    assert int(drop[0]) == int(jdrop)
    if rows_budget == 40:
        assert int(drop[0]) > 0
    _assert_gram((H[0], r[0]), (jH, jr))


def test_gating_test_all_decisions_match_jax(world):
    arrays, staged, p_f = _row_stack_inputs(world)
    st = tp.port_state(arrays)
    win_b = st.window.replace(q_CG=st.window.q_CG[:, None], p_C_G=st.window.p_C_G[:, None])
    H, r, _, _ = tupd.track_projected_rows(_t(staged["obs"]), _t(staged["obs_mask"]), _t(p_f), win_b,
                                        st.imu.g[:, None], TC)
    dof = torch.as_tensor(staged["obs_mask"].sum(-1) - 1)
    # inflate the residuals of half the tracks so both outcomes occur
    scale = torch.ones(S, dtype=torch.float64)
    scale[::2] = 30.0
    r = r * scale[None, :, None]
    for sigma_scale in (1.0, 0.3):
        sigma2 = st.meas_sigma2 * sigma_scale
        got = tupd.gating_test_all(H, r, st.P, dof, sigma2, TC).numpy()[0]
        want = np.asarray(jupd.gating_test_all(_j(H[0]), _j(r[0]), _j(st.P[0]), _j(dof[0]),
                                               _j(sigma2[0]), JC))
        np.testing.assert_array_equal(got, want)
        # gating_test: one track per filter, the same gate
        for s in (0, 1):
            one = tupd.gating_test(H[:, s], r[:, s], None, st.P, dof[0, s], sigma2, TC)
            assert one.shape == (1,)
            assert bool(one[0]) == bool(jupd.gating_test(_j(H[0, s]), _j(r[0, s]), None, _j(st.P[0]),
                                                         int(dof[0, s]), _j(sigma2[0]), JC))
    assert got.any() and not got.all()


def test_measurement_update_and_marginalize_match_jax(world):
    arrays, staged = world
    st = tp.port_state(arrays)
    js = tp.jax_state(arrays, JC, jnp.float64)
    t_staged = TStaged(**{k: _t(v) for k, v in staged.items()})
    j_staged = JStaged(**{k: _j(v) for k, v in staged.items()})
    got = tupd.marginalize(st, t_staged, TC)
    want = jax.vmap(lambda s_, g_: jupd.marginalize(s_, g_, JC))(js, j_staged)
    got_d, want_d = filter_state_to_numpy(got), tp.jax_to_dict(want)
    assert int(got.diag.updates_applied[0]) == int(arrays["diag.updates_applied"][0]) + 1
    for k in want_d:
        if np.issubdtype(want_d[k].dtype, np.floating):
            np.testing.assert_allclose(got_d[k], want_d[k], rtol=1e-6, atol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(got_d[k], want_d[k], err_msg=k)

    # measurement_update alone, on the same stacked rows
    p_f = _points(world)
    H, r, *_ = tupd.gated_row_stack(_t(staged["obs"]), _t(staged["obs_mask"]), _t(p_f),
                                    torch.ones(1, S, dtype=torch.bool), st.window, st.imu.g, st.P,
                                    st.meas_sigma2, TC)
    got_u = tupd.measurement_update(st, H, r, st.meas_sigma2, TC)
    want_u = jax.vmap(lambda s_, h, rr, s2: jupd.measurement_update(s_, h, rr, s2, JC))(
        js, _j(H), _j(r), js.meas_sigma2)
    np.testing.assert_allclose(got_u.P.numpy(), np.asarray(want_u.P), rtol=TOL, atol=1e-12)
    for k in ("q_IG", "p_I_G", "v_I_G", "b_g", "b_a"):
        np.testing.assert_allclose(getattr(got_u.imu, k).numpy(), np.asarray(getattr(want_u.imu, k)),
                                   rtol=TOL, atol=1e-12)
    np.testing.assert_allclose(got_u.window.p_C_G.numpy(), np.asarray(want_u.window.p_C_G), rtol=TOL, atol=1e-12)


@pytest.mark.parametrize("flag", ["use_qr_compression", "use_anisotropic_r"])
def test_unported_update_options_raise(world, flag):
    """The two reference-parity options once raised NotImplementedError; now
    ported, marginalize with each matches the JAX package (tests/
    test_torch_update_qr.py holds them in more detail)."""
    arrays, staged = world
    tc = dataclasses.replace(TC, filter=dataclasses.replace(TC.filter, **{flag: True}))
    jc = dataclasses.replace(JC, filter=dataclasses.replace(JC.filter, **{flag: True}))
    st = tp.port_state(arrays)
    t_staged = TStaged(**{k: _t(v) for k, v in staged.items()})
    got = filter_state_to_numpy(tupd.marginalize(st, t_staged, tc))
    js = tp.jax_state(arrays, jc, jnp.float64)
    j_staged = JStaged(**{k: _j(v) for k, v in staged.items()})
    want = tp.jax_to_dict(jax.vmap(lambda s_, g_: jupd.marginalize(s_, g_, jc))(js, j_staged))
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
