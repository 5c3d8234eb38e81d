"""The γ-gate CUDA kernel (csrc/psd_gamma.cu) on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda`` marker
and skips without a card. This file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_psd_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up.)
"""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core.init import ground_truth_init
from msckf_mono_tpu_torch.core.types import init_filter_state
from msckf_mono_tpu_torch.data import synthetic
from msckf_mono_tpu_torch.ops import psd_cuda
from msckf_mono_tpu_torch.parallel.montecarlo import broadcast_frames
from msckf_mono_tpu_torch.utils.config import FilterConfig, MsckfConfig, ShapeConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return "cuda"


def _make_systems(rng, n, R):
    """As tests/test_psd_pallas.py::_make_systems: S = XXᵀ/R + 1e-5 I, r ~ N(0, I)."""
    X = rng.normal(size=(n, R, R + 4))
    S = np.einsum("nij,nkj->nik", X, X) / R + np.eye(R) * 1e-5
    return S.astype(np.float32), rng.normal(size=(n, R)).astype(np.float32)


@pytest.mark.parametrize("R,n", [(1, 49152), (2, 333), (3, 1000), (13, 7), (41, 8192),
                                 (53, 300), (64, 50)])
def test_kernel_matches_plain_on_card(card, R, n):
    S, r = _make_systems(np.random.default_rng(R), n, R)
    S[1] = -np.eye(R, dtype=np.float32)
    S, r = torch.as_tensor(S, device=card), torch.as_tensor(r, device=card)
    before = psd_cuda.gamma_psd.launches
    got = psd_cuda.gamma_psd(S, r)
    torch.cuda.synchronize()
    assert psd_cuda.gamma_psd.launches == before + 1
    want = psd_cuda.gamma_psd_plain(S, r)
    assert torch.isposinf(got[1])
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-3, atol=0)


def test_kernel_flattens_leading_dims(card):
    S, r = _make_systems(np.random.default_rng(5), 24, 9)
    S, r = torch.as_tensor(S, device=card), torch.as_tensor(r, device=card)
    flat = psd_cuda.gamma_psd(S, r)
    nested = psd_cuda.gamma_psd(S.reshape(2, 3, 4, 9, 9), r.reshape(2, 3, 4, 9))
    assert nested.shape == (2, 3, 4)
    assert torch.equal(nested.reshape(-1), flat)


def test_kernel_rejects_wrong_dtype_layout_and_size(card):
    S = torch.eye(4, device=card).expand(3, 4, 4)
    r = torch.ones(3, 4, device=card)
    with pytest.raises(ValueError):
        psd_cuda.gamma_psd(S, r)
    with pytest.raises(TypeError):
        psd_cuda.gamma_psd(S.double().contiguous(), r.double())
    with pytest.raises(ValueError):
        psd_cuda.gamma_psd(S.contiguous(), r.cpu())
    torch.testing.assert_close(psd_cuda.gamma_psd(S.contiguous(), r),
                               torch.full((3,), 4.0, device=card))
    # No size is refused: R = 121, which the warp-a-system design could not
    # fit, runs (one block a system).
    torch.testing.assert_close(
        psd_cuda.gamma_psd(2.0 * torch.eye(121, device=card)[None], torch.ones(1, 121, device=card)),
        torch.full((1,), 60.5, device=card))


@pytest.mark.parametrize("R,n", [(121, 40), (345, 3)])
def test_kernel_takes_any_size(card, R, n):
    """R = 121 (one block a system) and R = 345, beyond one block's shared
    memory (the device-memory scratch variant), against the plain version."""
    assert psd_cuda.launch_plan(R).variant == ("block" if R == 121 else "scratch")
    S, r = _make_systems(np.random.default_rng(R), n, R)
    S[1] = -np.eye(R, dtype=np.float32)
    S, r = torch.as_tensor(S, device=card), torch.as_tensor(r, device=card)
    got = psd_cuda.gamma_psd(S, r)
    torch.cuda.synchronize()
    want = psd_cuda.gamma_psd_plain(S, r)
    assert torch.isposinf(got[1])
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-3, atol=0)


def test_launch_plan_fits_every_R(card):
    """Every R in 1..400 gets a variant whose blocks fit this card's shared
    memory a block, or the device-memory scratch variant; the boundaries are
    the ones the source states."""
    limit = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", 232448)
    seen = set()
    for R in range(1, 401):
        plan = psd_cuda.launch_plan(R)
        seen.add(plan.variant)
        assert plan.smem_bytes <= limit
        assert (plan.scratch_bytes > 0) == (plan.variant == "scratch")
        assert plan.variant not in ("thread", "scratch") or plan.smem_bytes == 0
    assert seen == set(psd_cuda.VARIANTS)
    assert [psd_cuda.launch_plan(R).variant for R in (1, 4, 5, 41, 63, 64, 338, 339)] == \
        ["thread", "thread", "warp", "warp", "warp", "block", "block", "scratch"]


def test_kernel_uses_only_the_lower_triangle(card):
    S, r = _make_systems(np.random.default_rng(6), 64, 41)
    S, r = torch.as_tensor(S, device=card), torch.as_tensor(r, device=card)
    upper = torch.triu(torch.ones(41, 41, dtype=torch.bool, device=card), diagonal=1)
    nan_upper = S.masked_fill(upper, float("nan"))
    assert torch.equal(psd_cuda.gamma_psd(nan_upper, r), psd_cuda.gamma_psd(S, r))


def test_step_on_card_goes_through_the_kernel(card):
    """The tiny serving configuration on the card: the gate is the kernel's
    (two launches a frame) and the trajectory follows the same run on the CPU."""
    cfg = MsckfConfig(
        filter=FilterConfig(max_cam_states=6, min_track_length=3, max_track_length=6,
                            fused_updates=True, gating_precision="high"),
        shapes=ShapeConfig(num_slots=8, max_tracks=16, max_staged=4, max_staged_prune=8,
                           max_update_rows=32, max_features_per_frame=8, imu_per_frame=4,
                           prune_obs_cap=2, marg_obs_cap=6, prune_chunk=8, staged_chunk=4),
    )
    seq = synthetic.generate(cfg, n_frames=30, seed=3, pixel_noise=0.5)
    out = {}
    for dev in ("cpu", card):
        imu = ground_truth_init(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0], v_I_G=[0.0, 1.75, 0.28],
                                b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device=dev)
        state = init_filter_state(cfg, imu, dtype=torch.float32, device=dev)
        frames = broadcast_frames(synthetic.to_frame_inputs(seq, torch.float32, device=dev), 1)
        before = psd_cuda.gamma_psd.launches
        final, outs = tfilter.run_sequence(state, frames, cfg)
        out[dev] = (outs.p_I_G[:, 0].cpu().numpy(), int(final.num_residualized[0]),
                    psd_cuda.gamma_psd.launches - before)
    assert out["cpu"][2] == 0 and out[card][2] == 2 * 30
    assert out[card][1] == out["cpu"][1] > 0
    np.testing.assert_allclose(out[card][0], out["cpu"][0], rtol=0, atol=1e-3)
