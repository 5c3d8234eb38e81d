"""The triangulation dispatcher ``core/triangulate.triangulate_tracks`` on the CPU.

On CPU tensors it is the plain version, ``core/triangulate``'s
``check_motion`` and ``initialize_position`` on the same inputs, bit for bit
(the kernel itself runs only on the card: tests/test_torch_triangulate_cuda.py):

* at the frame step's three call shapes, (1024, 8, 28), (1024, 16, 28) and
  (1, 16, 28), and with the window poses broadcast in each way it takes;
* shapes it does not take raise ValueError before anything is dispatched;
* ``update.marginalize_prep`` and ``prune.prune_prep`` give what the two
  separate calls they made before gave, bit for bit;
* a fused fleet step and a sequential (live) step each triangulate twice,
  on float32 contiguous inputs with a bool mask: what the kernel takes.
"""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.core import augment as taug
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core import prune as tprune
from msckf_mono_tpu_torch.core import triangulate as ttri
from msckf_mono_tpu_torch.core import update as tupd
from msckf_mono_tpu_torch.ops import triangulate_cuda
from msckf_mono_tpu_torch.utils import quat

from tests import _torch_port as tp

THRESHOLD, MAX_COST = 0.1, (7.0 / 458.654) ** 2


def _tracks(B, S, N, seed, window="filter"):
    """Tracks of random points seen by a window of N cameras along a line:
    obs (B, S, N, 2), a contiguous run of observing slots per track (a few
    tracks see one slot or none), and the window's poses laid out as
    ``window`` says: "filter" (B, 1, N, ·), "shared" (N, ·), "track" (B, S, N, ·)."""
    g = torch.Generator().manual_seed(seed)
    Wb, Ws = {"filter": (B, 1), "shared": (1, 1), "track": (B, S)}[window]
    j = torch.arange(N, dtype=torch.float32)
    p = torch.stack([0.08 * j, 0.05 * torch.sin(0.3 * j), 0.02 * j], -1)
    p = p + 0.01 * torch.randn((Wb, Ws, N, 3), generator=g)
    q = torch.nn.functional.normalize(
        torch.tensor([1.0, 0.0, 0.0, 0.0]) + 0.03 * torch.randn((Wb, Ws, N, 4), generator=g), dim=-1)
    X = torch.randn((B, S, 1, 3), generator=g) * torch.tensor([2.0, 2.0, 1.5]) + torch.tensor([0.0, 0.0, 7.0])
    xc = quat.rotate(q, X - p)
    obs = xc[..., :2] / xc[..., 2:3] + 1e-3 * torch.randn((B, S, N, 2), generator=g)
    start = torch.randint(0, N - 1, (B, S, 1), generator=g)
    length = torch.randint(0, N + 1, (B, S, 1), generator=g)
    mask = (j >= start) & (j < start + length)
    if window == "shared":
        q, p = q[0, 0], p[0, 0]
    return obs.contiguous(), mask.contiguous(), q.contiguous(), p.contiguous()


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("B,S,N,window", [
    (1024, 8, 28, "filter"), (1024, 16, 28, "filter"), (1, 16, 28, "filter"),
    (4, 8, 28, "shared"), (4, 8, 28, "track"), (3, 5, 40, "filter"),
])
def test_wrapper_on_cpu_is_the_plain_version_bit_for_bit(B, S, N, window):
    obs, mask, q, p = _tracks(B, S, N, seed=B + S + N, window=window)
    before = triangulate_cuda.triangulate_tracks.launches
    got = ttri.triangulate_tracks(obs, mask, q, p, THRESHOLD, MAX_COST, n_iters=6, n_trials=5)
    assert triangulate_cuda.triangulate_tracks.launches == before
    want = (ttri.check_motion(obs, mask, q, p, THRESHOLD),
            *ttri.initialize_position(obs, mask, q, p, MAX_COST, n_iters=6, n_trials=5))
    _assert_same(got, want)
    assert got[0].shape == (B, S) and got[1].shape == (B, S, 3)
    # the tracks exercise both outcomes of both gates
    assert 0 < int(got[0].sum()) < B * S or B * S < 64
    assert 0 < int(got[2].sum()) < B * S or B * S < 64


@pytest.mark.parametrize("case", ["obs_width", "mask_shape", "q_width", "p_axes", "slots",
                                  "window_not_leading", "window_more_axes", "no_trials",
                                  "negative_iters"])
def test_wrapper_rejects_shapes_before_dispatch(case, monkeypatch):
    def dispatched(*args, **kw):
        raise AssertionError("the wrapper dispatched inputs it should have refused")

    monkeypatch.setattr(ttri, "triangulate_tracks_plain", dispatched)
    monkeypatch.setattr(triangulate_cuda, "triangulate_tracks", dispatched)
    obs, mask, q, p = _tracks(4, 8, 28, seed=0)
    kw = dict(n_iters=11, n_trials=11)
    if case == "obs_width":
        obs = torch.zeros(4, 8, 28, 3)
    elif case == "mask_shape":
        mask = mask[:, :, :27]
    elif case == "q_width":
        q = torch.zeros(4, 1, 28, 3)
    elif case == "p_axes":
        p = torch.zeros(1, 1, 28, 3)
    elif case == "slots":
        q, p = q[..., :27, :], p[..., :27, :]
    elif case == "window_not_leading":  # varies along the track axis, constant along the filters'
        q, p = torch.zeros(1, 8, 28, 4), torch.zeros(1, 8, 28, 3)
    elif case == "window_more_axes":
        q, p = torch.zeros(2, 4, 1, 28, 4), torch.zeros(2, 4, 1, 28, 3)
    elif case == "no_trials":
        kw["n_trials"] = 0
    else:
        kw["n_iters"] = -1
    with pytest.raises(ValueError):
        ttri.triangulate_tracks(obs, mask, q, p, THRESHOLD, MAX_COST, **kw)


@pytest.fixture(scope="module")
def mid_state():
    """The default-size world with a shortened LM schedule, and its f32 state
    right after augmenting frame 37 (the window holds the 20 states at which
    redundant pruning runs; two prune candidates lack a triangulation)."""
    _, tc = tp.configs(dict(lm_iters=4, lm_trials=3))
    _, frames, snaps = tp.port_snapshots(tc, 38, at={37}, dtype=torch.float32)
    f = tp.frame_arrays(frames, 37)
    state = taug.augment_state(tp.port_state(snaps[37]), torch.as_tensor(f["state_id"]),
                               torch.as_tensor(f["time"]), tc)
    return tc, state


def _parent_pair(cfg):
    """What marginalize_prep and prune_prep called before: the two plain
    functions, with the configuration's thresholds and LM schedule."""
    fcfg = cfg.filter

    def pair(obs, mask, q, p, *args, **kw):
        return (ttri.check_motion(obs, mask, q, p, fcfg.translation_threshold),
                *ttri.initialize_position(obs, mask, q, p, cfg.max_gn_cost_norm,
                                          n_iters=fcfg.lm_iters, n_trials=fcfg.lm_trials))

    return pair


@pytest.mark.parametrize("prep", ["marginalize", "prune"])
def test_prep_equals_the_parents_two_calls(prep, mid_state, monkeypatch):
    cfg, state = mid_state
    if prep == "marginalize":
        state, staged, _ = tfilter._stage_pass(state, cfg)
        assert int(staged.valid.sum()) > 0
        run = lambda: tupd.marginalize_prep(state, staged, cfg)
    else:
        assert int(tprune.find_redundant_slots(state, cfg).sum()) > 0
        run = lambda: tprune.prune_prep(state, cfg)
    got = run()
    monkeypatch.setattr(ttri, "triangulate_tracks", _parent_pair(cfg))
    want = run()
    if prep == "marginalize":
        _assert_same(got, want)
        assert int(got[1].sum()) > 0  # some track triangulated and passed
    else:
        assert got.keys() == want.keys()
        _assert_same([got[k] for k in want], [want[k] for k in want])
        assert int(got["newly_init_tab"].sum()) > 0


@pytest.mark.parametrize("fused", [True, False], ids=["fleet", "live"])
def test_a_step_triangulates_twice_on_kernel_inputs(fused, monkeypatch):
    """Each step calls the wrapper twice, with what the kernel takes on the
    card: float32 contiguous tensors and a bool mask (else it would raise)."""
    _, cfg = tp.small_configs(serving=fused)
    seq = tp.sequence(cfg, 24)
    frames = tp.port_frames(seq, torch.float32)
    state = tp.port_initial_state(cfg, seq, torch.float32)
    calls = []
    orig = ttri.triangulate_tracks

    def spy(obs, mask, q, p, *args, **kw):
        calls.append((obs, mask, q, p))
        return orig(obs, mask, q, p, *args, **kw)

    monkeypatch.setattr(ttri, "triangulate_tracks", spy)
    for t in range(23):
        before = len(calls)
        state, _ = tfilter.step(state, tfilter.frame_at(frames, t), cfg)
        assert len(calls) - before == 2, t
    for obs, mask, q, p in calls:
        assert obs.dtype == q.dtype == p.dtype == torch.float32 and mask.dtype == torch.bool
        assert all(x.is_contiguous() for x in (obs, mask, q, p))


def test_kernel_launcher_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only; the plain version is the
    dispatcher's to run."""
    obs, mask, q, p = _tracks(2, 4, 28, seed=3)
    before = triangulate_cuda.triangulate_tracks.launches
    with pytest.raises(ValueError):
        triangulate_cuda.triangulate_tracks(obs, mask, q, p, THRESHOLD, MAX_COST, 11, 11)
    assert triangulate_cuda.triangulate_tracks.launches == before
