"""The triangulation kernel (csrc/triangulate.cu) on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda`` marker
and skips without a card. This file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_triangulate_cuda.py -q

The kernel is held against ``triangulate_tracks_plain`` on the card, on the
call inputs the frame step really makes (recorded from eager runs of the
synthetic world: a 1024-filter fleet at the serving configuration, whose
calls are (1024, 8, 28) and (1024, 16, 28), and one filter on the live
path's sequential updates, (1, 16, 28)), and on edge cases built from them:

* ``motion_ok`` identical;
* ``tri_ok`` identical, except where the plain version's normalised cost
  lies within 1e-4 relative of the limit;
* ``p_f_G``, where both are valid: within 1e-4 of the point's distance or
  1e-5 m on at least 99% of the tracks (at most one track below 100), and
  within 1e-3 of the distance on every one; and no farther from the float64
  plain version than the float32 plain version is (median and 99th
  percentile over 200 tracks or more, 25% slack). Why not every track at 1e-4: the two sum in
  different orders, which flips a rare trial's "cost lowered" decision at a
  few ulp; a rejected sweep raises lambda 1e11-fold, and the track stops
  where it stands. The float32 plain version stops up to 3.5e-3 m (4e-4 of
  the distance) from its float64 solution on such tracks itself.
"""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core import triangulate as ttri
from msckf_mono_tpu_torch.core.init import ground_truth_init
from msckf_mono_tpu_torch.core.types import init_filter_state
from msckf_mono_tpu_torch.data import render, synthetic
from msckf_mono_tpu_torch.interface import VioInterface
from msckf_mono_tpu_torch.ops import cuda_graph, triangulate_cuda
from msckf_mono_tpu_torch.parallel import montecarlo, sharding
from msckf_mono_tpu_torch.utils.config import MsckfConfig, serving_config

pytestmark = pytest.mark.cuda

INIT = dict(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0], v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4])
FLEET_FRAMES, LIVE_FRAMES = 32, 60


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return "cuda"


def _record(run):
    """Run ``run()`` eagerly with every triangulation call's inputs recorded."""
    calls, orig = [], ttri.triangulate_tracks

    def spy(obs, mask, q, p, thr, max_cost, n_iters=11, n_trials=11):
        calls.append(((obs.clone(), mask.clone(), q.clone(), p.clone(), thr, max_cost),
                      dict(n_iters=n_iters, n_trials=n_trials)))
        return orig(obs, mask, q, p, thr, max_cost, n_iters=n_iters, n_trials=n_trials)

    ttri.triangulate_tracks = spy
    try:
        with cuda_graph.disabled():
            run()
    finally:
        ttri.triangulate_tracks = orig
    return calls


@pytest.fixture(scope="module")
def recorded():
    """{"marginalize": [...], "prune": [...], "live": [...]}: the inputs of the
    fleet's calls on its last 3 frames, and of the live path's calls from
    frame 25 on (the window holds 20 states), as (args, kwargs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    B = 1024
    cfg = serving_config(B)
    seq = synthetic.generate(cfg, n_frames=FLEET_FRAMES, seed=0, pixel_noise=0.5)
    imu = ground_truth_init(**INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device="cuda")
    frames = montecarlo.broadcast_frames(synthetic.to_frame_inputs(seq, torch.float32, device="cuda"), B)
    fleet = montecarlo.make_fleet(cfg, imu, B, dtype=torch.float32, device="cuda")
    fleet_calls = _record(lambda: tfilter.run_sequence(fleet, frames, cfg))[-6:]

    lcfg = MsckfConfig()
    lseq = synthetic.generate(lcfg, n_frames=LIVE_FRAMES, seed=1, pixel_noise=0.5)
    limu = ground_truth_init(**INIT, b_g=lseq.b_g, b_a=lseq.b_a, dtype=torch.float32, device="cuda")
    state = init_filter_state(lcfg, limu, dtype=torch.float32, device="cuda")
    lframes = montecarlo.broadcast_frames(synthetic.to_frame_inputs(lseq, torch.float32, device="cuda"), 1)
    live_calls = _record(lambda: tfilter.run_sequence(state, lframes, lcfg))[50:]
    out = {"marginalize": fleet_calls[0::2], "prune": fleet_calls[1::2], "live": live_calls}
    assert [tuple(a[0].shape[:-1]) for a, _ in out["marginalize"]] == [(B, 8, 28)] * 3
    assert [tuple(a[0].shape[:-1]) for a, _ in out["prune"]] == [(B, 16, 28)] * 3
    assert {tuple(a[0].shape[:-1]) for a, _ in out["live"]} == {(1, 16, 28)}
    return out


def _busiest(calls):
    """The recorded call with the most tracks that some slot observes (the
    world's tracks die on some frames only, in every filter at once)."""
    return max(calls, key=lambda c: int(c[0][1].any(-1).sum()))


def normalized_cost(obs, mask, q, p, p_f_G):
    """The plain version's final cost / (2 max(m, 1)^2), recomputed in float64
    from its point."""
    obs, q, p, p_f_G = (x.double() for x in (obs, q, p, p_f_G))
    qe, pe = ttri._expand_window(obs, q, p)
    A, t, A0, t0 = ttri._relative_poses(mask, qe, pe)
    x = (A0.transpose(-1, -2) @ (p_f_G - t0)[..., None])[..., 0]
    sol = torch.stack([x[..., 0] / x[..., 2], x[..., 1] / x[..., 2], 1.0 / x[..., 2]], dim=-1)
    m = mask.sum(-1).clamp(min=1).double()
    return ttri._total_cost(A, t, obs, mask, sol) / (2.0 * m * m)


class Agreement:
    """The kernel against the plain version over one or more calls, pooled."""

    def __init__(self):
        self.d, self.dist, self.e32, self.ek = [], [], [], []

    def add(self, args, kw):
        obs, mask, q, p, thr, max_cost = args
        before = triangulate_cuda.triangulate_tracks.launches
        got = ttri.triangulate_tracks(*args, **kw)
        torch.cuda.synchronize()
        assert triangulate_cuda.triangulate_tracks.launches == before + 1
        want = ttri.triangulate_tracks_plain(*args, **kw)
        _, p64, ok64 = ttri.triangulate_tracks_plain(
            obs.double(), mask, q.double(), p.double(), thr, max_cost, **kw)
        (mk, pk, tk), (mp, pp, tp) = got, want
        assert mk.shape == mp.shape and pk.shape == pp.shape and tk.shape == tp.shape
        assert torch.equal(mk, mp), f"motion_ok differs on {int((mk != mp).sum())} tracks"
        nc = normalized_cost(obs, mask, q, p, pp)
        near = (nc - max_cost).abs() <= 1e-4 * max_cost
        differ = (tk != tp) & ~near
        assert not bool(differ.any()), f"tri_ok differs on {int(differ.sum())} tracks away from the limit"
        both = tk & tp
        self.d.append(torch.linalg.norm(pk - pp, dim=-1)[both].double())
        self.dist.append(torch.linalg.norm(pp, dim=-1)[both].double())
        both64 = both & ok64
        self.e32.append(torch.linalg.norm(pp.double() - p64, dim=-1)[both64])
        self.ek.append(torch.linalg.norm(pk.double() - p64, dim=-1)[both64])
        return got, want

    def check(self, min_valid=1):
        d, dist = torch.cat(self.d), torch.cat(self.dist)
        n = d.numel()
        assert n >= min_valid, f"{n} tracks valid in both"
        if n == 0:
            return
        over = int((d > torch.clamp(1e-4 * dist, min=1e-5)).sum())
        print(f"{n} tracks valid in both: {over} beyond 1e-4 of the distance or 1e-5 m; largest "
              f"{float((d / dist).max()):.3e} of the distance")
        assert over <= max(1, n // 100)
        assert bool(torch.all(d <= torch.clamp(1e-3 * dist, min=1e-5)))
        e32, ek = torch.cat(self.e32), torch.cat(self.ek)
        if ek.numel() < 200:  # too few tracks for the quantiles to mean anything
            return
        qs = torch.tensor([0.5, 0.99], dtype=torch.float64, device=e32.device)
        q32, qk = torch.quantile(e32, qs), torch.quantile(ek, qs)
        print(f"distance from the float64 plain version, median / 99th: plain f32 "
              f"{q32.tolist()}, kernel {qk.tolist()}")
        assert bool(torch.all(qk <= 1.25 * q32 + 1e-7))


@pytest.mark.parametrize("where", ["marginalize", "prune", "live"])
def test_kernel_matches_plain_on_recorded_calls(card, recorded, where):
    """(1024, 8, 28), (1024, 16, 28) and (1, 16, 28): the frame step's calls."""
    agree = Agreement()
    for args, kw in recorded[where]:
        agree.add(args, kw)
    agree.check(min_valid=3)


def _one_track(args, b, s):
    """Track (b, s) of a call as a call of its own: (1, 1, N, ·) tracks on a
    (1, 1, N, ·) copy of its filter's window."""
    obs, mask, q, p = args[:4]
    return [obs[b:b + 1, s:s + 1].clone(), mask[b:b + 1, s:s + 1].clone(),
            q[b:b + 1].clone(), p[b:b + 1].clone()]


def test_edge_cases_match_plain(card, recorded):
    args, kw = _busiest(recorded["marginalize"])
    thr, max_cost = args[4:6]
    _, p_plain, ok = ttri.triangulate_tracks_plain(*args, **kw)
    mask = args[1]
    n_obs = mask.sum(-1)
    # valid tracks with at least 4 observations and a masked slot
    pick = torch.nonzero(ok & (n_obs >= 4) & (n_obs < mask.shape[-1])).tolist()
    assert len(pick) >= 8
    cases, motion, tri = [], [], []

    def add(t, m=None, v=None):
        cases.append(t)
        motion.append(m)
        tri.append(v)

    b, s = pick[0]
    t = _one_track(args, b, s)
    first = int(torch.nonzero(t[1][0, 0])[0])
    t[1][0, 0] = False
    t[1][0, 0, first] = True                      # one observation
    add(t, False, False)
    t = _one_track(args, b, s)
    t[1][0, 0] = False                            # no observation
    add(t, False, False)
    b, s = pick[1]
    t = _one_track(args, b, s)
    t[3][:] = t[3][0, 0, int(torch.nonzero(t[1][0, 0])[0])].clone()
    add(t, False)                                  # every camera at one place: no parallax
    b, s = pick[2]
    t = _one_track(args, b, s)
    seen = torch.nonzero(t[1][0, 0])[:, 0].tolist()
    j = seen[len(seen) // 2]
    # the camera of a middle observation reflected through the point: the
    # same observation, but the point behind it
    t[3][0, 0, j] = 2.0 * p_plain[b, s] - t[3][0, 0, j]
    add(t, None, False)
    for k, value in enumerate((float("nan"), float("inf"))):
        b, s = pick[3 + k]
        t = _one_track(args, b, s)
        j = torch.nonzero(t[1][0, 0])[1, 0]
        t[0][0, 0, j, 0] = value                   # a non-finite observation
        add(t, None, False)
    b, s = pick[5]
    t = _one_track(args, b, s)
    j = torch.nonzero(~t[1][0, 0])[0, 0]
    t[0][0, 0, j, 1] = float("nan")                # NaN in a masked slot
    add(t)
    b, s = pick[6]
    t = _one_track(args, b, s)
    seen = torch.nonzero(t[1][0, 0])[:, 0]
    t[1][0, 0, seen[1:-1]] = False                 # two observations, first and last
    add(t)
    batch = [torch.cat([c[i] for c in cases]).contiguous() for i in range(4)]
    agree = Agreement()
    (mk, pk, tk), _ = agree.add(tuple(batch) + (thr, max_cost), kw)
    mk, tk = mk[:, 0].tolist(), tk[:, 0].tolist()
    for i, (m, v) in enumerate(zip(motion, tri)):
        assert m is None or mk[i] == m, i
        assert v is None or tk[i] == v, i
    agree.check(min_valid=0)


def test_cost_limit_just_above_and_below(card, recorded):
    """A limit halfway between two neighbouring normalised costs near the
    median: the tracks just above and just below it keep their decisions."""
    args, kw = _busiest(recorded["marginalize"])
    _, p_plain, ok = ttri.triangulate_tracks_plain(*args, **kw)
    nc = normalized_cost(*args[:4], p_plain)[ok].sort().values
    i = nc.numel() // 2
    limit = float(0.5 * (nc[i] + nc[i + 1]))
    close = ((nc - limit).abs() <= 1e-2 * limit)
    assert int((nc[close] < limit).sum()) >= 1 and int((nc[close] > limit).sum()) >= 1
    agree = Agreement()
    _, (_, _, t_plain) = agree.add(tuple(args[:5]) + (limit,), kw)
    assert 0 < int(t_plain.sum()) < int(ok.sum())
    agree.check(min_valid=3)


def test_a_replayed_fleet_step_and_a_live_frame_launch_it_twice(card):
    B = 64
    cfg = serving_config(B)
    seq = synthetic.generate(cfg, n_frames=4, seed=0, pixel_noise=0.5)
    imu = ground_truth_init(**INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device=card)
    frames = montecarlo.broadcast_frames(synthetic.to_frame_inputs(seq, torch.float32, device=card), B)
    state = montecarlo.make_fleet(cfg, imu, B, dtype=torch.float32, device=card)
    step = sharding.batched_step(cfg)
    for t in range(4):
        before = triangulate_cuda.triangulate_tracks.launches
        state, _ = step(state, tfilter.frame_at(frames, t))
        assert triangulate_cuda.triangulate_tracks.launches - before == 2, t

    T = 6
    lcfg = MsckfConfig()
    lseq, world = synthetic.generate(lcfg, n_frames=T, seed=0, pixel_noise=0.0, n_landmarks=500,
                                     return_world=True)
    imgs = np.stack([render.render_frame(lcfg, world, i) for i in range(T)])
    vio = VioInterface(lcfg, track_handler_kwargs=dict(max_features=100, window_size=21, max_level=3),
                       device=card)
    vio.initialize_from_ground_truth(**INIT, b_g=lseq.b_g, b_a=lseq.b_a)
    K = lseq.imu_omega.shape[1]
    for i in range(T):
        for k in range(K):
            vio.imu_callback(lseq.imu_omega[i, k], lseq.imu_acc[i, k],
                             float(lseq.time[i]) - (K - 1 - k) * 0.005, dt=float(lseq.imu_dt[i, k]))
        before = triangulate_cuda.triangulate_tracks.launches
        vio.image_callback(imgs[i], float(lseq.time[i]))
        assert triangulate_cuda.triangulate_tracks.launches - before == 2, i
    assert [g.replays for g in vio._live_frame.graphs.values()] == [T - 1]


def test_wrapper_raises_on_card(card):
    obs = torch.zeros(4, 8, 28, 2, device=card)
    mask = torch.ones(4, 8, 28, dtype=torch.bool, device=card)
    q = torch.zeros(4, 1, 28, 4, device=card)
    q[..., 0] = 1.0
    p = torch.zeros(4, 1, 28, 3, device=card)
    before = triangulate_cuda.triangulate_tracks.launches
    with pytest.raises(TypeError):
        ttri.triangulate_tracks(obs.double(), mask, q.double(), p.double(), 0.1, 1e-4)
    with pytest.raises(ValueError):
        wide = torch.zeros(4, 8, 28, 4, device=card)[..., :2]
        ttri.triangulate_tracks(wide, mask, q, p, 0.1, 1e-4)
    with pytest.raises(ValueError):
        ttri.triangulate_tracks(obs, mask.cpu(), q, p, 0.1, 1e-4)
    with pytest.raises(ValueError):  # one window slot a lane: at most 32
        pad = lambda x: torch.cat([x, x[..., :12, :]], dim=-2).contiguous()
        ttri.triangulate_tracks(pad(obs), torch.cat([mask, mask[..., :12]], -1), pad(q), pad(p),
                                0.1, 1e-4)
    assert triangulate_cuda.triangulate_tracks.launches == before
    motion_ok, p_f_G, tri_ok = ttri.triangulate_tracks(obs, mask, q, p, 0.1, 1e-4)
    assert motion_ok.shape == tri_ok.shape == (4, 8) and p_f_G.shape == (4, 8, 3)
    assert not bool(motion_ok.any())  # every camera at one place
