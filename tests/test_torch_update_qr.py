"""The rest of the filter path against the JAX package, on the CPU: the row
stack, QR compression, the anisotropic measurement noise, ``finish`` and the
noise-parameter grid fleet.

Tolerances:

* ``stack_rows``: equal;
* ``compress_rows``: by basis-invariant products (T_HᵀT_H, T_Hᵀr_n, r_nᵀr_n)
  within 1e-9, since the signs of QR factors differ between LAPACK paths;
* ``measurement_update`` with QR compression, the anisotropic R and both:
  f64 within 1e-9, f32 within 2e-5; except both options together in f64 on
  the row stack's own rows, within 1e-6. There the stacked H has fewer
  independent rows than its QR factor (zero IMU columns, padding rows), the
  exact keep rule (msckf.h:1347) keeps the R rows that are roundoff, and
  their directions — different in every LAPACK — enter the update through
  the correlated noise R_n = Q₁ᵀ R_o Q₁: the port and the JAX package differ
  by 2e-8 there. On rows of full rank both options agree within 1e-9;
* ``run_sequence`` at the small shapes with both options on: f64 positions
  within 1e-6 and every Diagnostics counter equal;
* ``finish`` and ``_stage_pass`` on a state with many live tracks (as
  tests/test_finish.py builds it): within 1e-6, collected map points and
  masks equal;
* ``make_grid_fleet`` with zero init sigmas: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.core import filter as jfilter
from msckf_mono_tpu.core import update as jupd
from msckf_mono_tpu.core.init import ground_truth_init as j_gt_init
from msckf_mono_tpu.parallel import montecarlo as jmc
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core import update as tupd
from msckf_mono_tpu_torch.core.init import ground_truth_init as t_gt_init
from msckf_mono_tpu_torch.core.types import filter_state_to_numpy
from msckf_mono_tpu_torch.parallel import montecarlo as tmc

from tests import _torch_port as tp
from tests.test_finish import CFG as FINISH_CFG
from tests.test_finish import _state_with_many_tracks
from tests.test_torch_filter import _jax_run, _seq

CPU = "cpu"
OPTIONS = {"qr": dict(use_qr_compression=True), "aniso": dict(use_anisotropic_r=True),
           "both": dict(use_qr_compression=True, use_anisotropic_r=True)}


def _with(cfg, **filter_kw):
    return dataclasses.replace(cfg, filter=dataclasses.replace(cfg.filter, **filter_kw))


def _t(x, dtype=None):
    t = torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _gram(H, r):
    H, r = np.asarray(H), np.asarray(r)
    return np.swapaxes(H, -1, -2) @ H, np.einsum("...rd,...r->...d", H, r), np.sum(r * r, -1)


# ---- stack_rows, compress_rows ----

def test_stack_rows_matches_jax():
    jc, tc = tp.small_configs()
    rng = np.random.default_rng(0)
    S, R_t, D = 6, 13, tc.shapes.state_dim
    H = rng.normal(size=(S, R_t, D))
    r = rng.normal(size=(S, R_t))
    for budget in (64, 30):          # room for every valid row; and an overflow
        masks = rng.uniform(size=(S, R_t)) < 0.6
        jcb = tp.replace_config(jc, max_update_rows=budget)
        tcb = tp.replace_config(tc, max_update_rows=budget)
        wH, wr, wd = jupd.stack_rows(jnp.asarray(H), jnp.asarray(r), jnp.asarray(masks), jcb)
        gH, gr, gd = tupd.stack_rows(_t(H)[None], _t(r)[None], _t(masks)[None], tcb)
        np.testing.assert_array_equal(gH[0].numpy(), np.asarray(wH))
        np.testing.assert_array_equal(gr[0].numpy(), np.asarray(wr))
        assert int(gd[0]) == int(wd) == max(int(masks.sum()) - budget, 0)


@pytest.mark.parametrize("rows,rank", [(40, 40), (40, 25), (90, 63)])
def test_compress_rows_matches_jax(rows, rank):
    rng = np.random.default_rng(rows + rank)
    D = 63
    H = rng.normal(size=(rows, rank)) @ rng.normal(size=(rank, D))
    H[rows // 3] = 0.0                    # zero rows as the padded buffer has
    r = rng.normal(size=rows)
    T, rn = tupd.compress_rows(_t(H)[None], _t(r)[None])
    wT, wrn = jupd.compress_rows(jnp.asarray(H), jnp.asarray(r))
    assert T.shape[1:] == wT.shape
    kept = int((np.abs(np.asarray(wT)).max(1) > 0).sum())
    assert int((T[0].abs().amax(1) > 0).sum()) == kept <= rank
    for g, w in zip(_gram(T[0], rn[0]), _gram(wT, wrn)):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * max(1.0, np.abs(w).max()))


# ---- measurement_update with the parity options ----

@pytest.fixture(scope="module")
def update_world():
    """A mid-sequence state of the tiny world (before frame 14, 8 slots, 64
    update rows: more rows than state dimensions is the QR path's other
    shape) and up to 8 staged tracks cut from its live tracks of 3 or more
    observations, with their triangulated points."""
    jc, tc = tp.configs(dict(tp.TINY_FILTER), dict(tp.TINY_SHAPES, max_update_rows=64))
    _, _, snaps = tp.port_snapshots(tc, 15, at={14})
    arrays = snaps[14]
    active = arrays["tracks.active"][0]
    lengths = arrays["tracks.obs_mask"][0].sum(-1) * active
    rows = np.argsort(-lengths, kind="stable")[:8]
    rows = rows[lengths[rows] >= 3]
    assert len(rows) >= 4
    staged = dict(obs=arrays["tracks.obs"][:, rows], obs_mask=arrays["tracks.obs_mask"][:, rows])
    st = tp.port_state(arrays)
    from msckf_mono_tpu_torch.core import triangulate

    p_f, ok = triangulate.initialize_position(
        _t(staged["obs"]), _t(staged["obs_mask"]), st.window.q_CG[:, None], st.window.p_C_G[:, None],
        tc.max_gn_cost_norm)
    assert bool(ok.all())
    return jc, tc, arrays, staged, p_f.numpy()


@pytest.mark.parametrize("jdtype,tol", [(jnp.float64, 1e-9), (jnp.float32, 2e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_measurement_update_options_match_jax(update_world, option, jdtype, tol):
    jc, tc, arrays, staged, p_f = update_world
    jc, tc = _with(jc, **OPTIONS[option]), _with(tc, **OPTIONS[option])
    tdt = tp.tdtype(jdtype)
    cast = {k: (v.astype(np.dtype(jdtype)) if np.issubdtype(v.dtype, np.floating) else v)
            for k, v in arrays.items()}
    st = tp.port_state(cast)
    out = tupd.gated_row_stack(_t(staged["obs"], tdt), _t(staged["obs_mask"]), _t(p_f, tdt),
                               torch.ones(1, p_f.shape[1], dtype=torch.bool), st.window, st.imu.g, st.P,
                               st.meas_sigma2, tc)
    H, r = out[0], out[1]
    aniso = tc.filter.use_anisotropic_r
    assert len(out) == (7 if aniso else 5)
    if aniso:
        V, tids = out[5], out[6]
        assert V.shape == (1, tc.shapes.max_update_rows, tc.shapes.num_slots)
        assert set(np.unique(tids.numpy())) <= set(range(p_f.shape[1] + 1)) and int(tids.max()) > 1
    got = tupd.measurement_update(st, H, r, st.meas_sigma2, tc, *out[5:])

    js = tp.jax_state(cast, jc, jdtype)
    extra = [jnp.asarray(x.numpy()) for x in out[5:]]
    want = jax.vmap(lambda s_, h, rr, s2, *vt: jupd.measurement_update(s_, h, rr, s2, jc, *vt))(
        js, jnp.asarray(H.numpy()), jnp.asarray(r.numpy()), js.meas_sigma2, *extra)
    if option == "both" and jdtype == jnp.float64:
        tol = 1e-6        # roundoff rows of a rank-deficient QR; see the module docstring
    scale = np.abs(np.asarray(want.P)).max()
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), rtol=0, atol=tol * scale)
    for k in ("q_IG", "p_I_G", "v_I_G", "b_g", "b_a"):
        np.testing.assert_allclose(getattr(got.imu, k).numpy(), np.asarray(getattr(want.imu, k)),
                                   rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(got.window.p_C_G.numpy(), np.asarray(want.window.p_C_G), rtol=0,
                               atol=tol)
    # the option changed the update (against the isotropic, uncompressed one)
    base = tupd.measurement_update(st, H, r, st.meas_sigma2, _with(tc, use_qr_compression=False))
    if aniso:
        assert not torch.allclose(base.P, got.P, rtol=0, atol=0)


def test_measurement_update_both_options_full_rank_matches_jax(update_world):
    """QR compression with the anisotropic R on rows of full rank: no R row
    is roundoff, so the exact keep rule decides alike in both packages."""
    jc, tc, arrays, _, _ = update_world
    jc, tc = _with(jc, **OPTIONS["both"]), _with(tc, **OPTIONS["both"])
    rng = np.random.default_rng(7)
    rows, D, N = 40, tc.shapes.state_dim, tc.shapes.num_slots
    H = rng.normal(size=(1, rows, D)) * 0.3
    r = rng.normal(size=(1, rows)) * 1e-3
    V = rng.normal(size=(1, rows, N)) * 0.2
    tids = rng.integers(1, 6, size=(1, rows)).astype(np.float64)
    st = tp.port_state(arrays)
    got = tupd.measurement_update(st, _t(H), _t(r), st.meas_sigma2, tc, _t(V), _t(tids))
    js = tp.jax_state(arrays, jc, jnp.float64)
    want = jax.vmap(lambda s_, h, rr, s2, v, t: jupd.measurement_update(s_, h, rr, s2, jc, v, t))(
        js, jnp.asarray(H), jnp.asarray(r), js.meas_sigma2, jnp.asarray(V), jnp.asarray(tids))
    scale = np.abs(np.asarray(want.P)).max()
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), rtol=0, atol=1e-9 * scale)
    for k in ("q_IG", "p_I_G", "v_I_G", "b_g", "b_a"):
        np.testing.assert_allclose(getattr(got.imu, k).numpy(), np.asarray(getattr(want.imu, k)),
                                   rtol=0, atol=1e-9, err_msg=k)


def test_run_sequence_with_both_options_matches_jax():
    jc, tc = tp.small_configs()
    jc, tc = _with(jc, **OPTIONS["both"]), _with(tc, **OPTIONS["both"])
    jseq, tseq = _seq(jc, tc, 26)
    j_final, j_outs = _jax_run(jc, jseq, jnp.float64)
    t_final, t_outs = tfilter.run_sequence(tp.port_initial_state(tc, tseq), tp.port_frames(tseq), tc)
    np.testing.assert_allclose(t_outs.p_I_G[:, 0].numpy(), np.asarray(j_outs.p_I_G), rtol=0, atol=1e-6)
    for k, v in vars(j_final.diag).items():
        assert int(getattr(t_final.diag, k)[0]) == int(v), k
    assert int(t_final.diag.updates_applied[0]) > 0


# ---- finish ----

@pytest.fixture(scope="module")
def finish_world():
    js = _state_with_many_tracks(100)
    arrays = tp.jax_to_dict(js, batched=False)
    jfin, jpts, jmask = jfilter.finish(js, FINISH_CFG, collect_map=True)
    return arrays, tp.jax_to_dict(jfin, batched=False), np.asarray(jpts), np.asarray(jmask)


def test_finish_matches_jax(finish_world):
    arrays, want, jpts, jmask = finish_world
    _, tc = tp.configs()
    got, pts, mask = tfilter.finish(tp.port_state(arrays), tc, collect_map=True)
    n_passes = -(-tc.shapes.max_tracks // tc.shapes.max_staged)
    assert pts.shape == (1, n_passes * tc.shapes.max_staged, 3) and mask.shape == pts.shape[:2]
    np.testing.assert_array_equal(mask[0].numpy(), jmask)
    np.testing.assert_allclose(pts[0].numpy(), jpts, rtol=0, atol=1e-6)
    got = filter_state_to_numpy(got)
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["num_residualized"][0]) == 100
    assert not got["tracks.active"].any()


def test_stage_pass_matches_jax(finish_world):
    arrays, *_ = finish_world
    _, tc = tp.configs()
    jc = FINISH_CFG
    js = tp.jax_state(arrays, jc, jnp.float64)
    j0 = jax.tree_util.tree_map(lambda x: x[0], js)
    w_state, w_staged, w_rem = jfilter._stage_pass(j0, jc)
    g_state, g_staged, g_rem = tfilter._stage_pass(tp.port_state(arrays), tc)
    assert int(g_rem[0]) == int(w_rem) == 100 - tc.shapes.max_staged
    for k, v in vars(w_staged).items():
        np.testing.assert_array_equal(getattr(g_staged, k)[0].numpy(), np.asarray(v), err_msg=k)
    for k, v in vars(w_state.tracks).items():
        np.testing.assert_array_equal(getattr(g_state.tracks, k)[0].numpy(), np.asarray(v), err_msg=k)


def test_finish_empty_passes_are_identity():
    """Nothing eligible: every pass stages nothing and the state is unchanged."""
    _, tc = tp.configs()
    js = _state_with_many_tracks(10, n_obs=FINISH_CFG.filter.min_track_length - 1)
    arrays = tp.jax_to_dict(js, batched=False)
    got = filter_state_to_numpy(tfilter.finish(tp.port_state(arrays), tc))
    for k in arrays:
        if k.startswith(("map_", "tri_map", "pruned")):
            continue
        np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)


# ---- the grid fleet ----

def test_make_grid_fleet_matches_jax():
    jc, tc = tp.small_configs()
    zero = dict(sigma_p=0, sigma_v=0, sigma_theta=0, sigma_bg=0, sigma_ba=0)
    q_scale = np.array([0.5, 1.0, 2.0, 4.0])
    px = np.array([0.5, 1.0, 1.5, 2.0])
    init = dict(**tp.INIT, b_g=[0.002, -0.001, 0.0005], b_a=[0.02, -0.01, 0.015])
    want = jmc.make_grid_fleet(jc, j_gt_init(**init, dtype=jnp.float64), 4, dtype=jnp.float64,
                               q_imu_scale=q_scale, meas_sigma_px=px, **zero)
    got = tmc.make_grid_fleet(tc, t_gt_init(**init, dtype=torch.float64, device=CPU), 4,
                              dtype=torch.float64, device=CPU, q_imu_scale=q_scale,
                              meas_sigma_px=px, **zero)
    got_d, want_d = filter_state_to_numpy(got), tp.jax_to_dict(want)
    for k in want_d:
        np.testing.assert_array_equal(got_d[k], want_d[k], err_msg=k)
    np.testing.assert_allclose(got.meas_sigma2.numpy(), (px / tc.camera.f_u) ** 2, rtol=1e-15)
