"""The port's γ gate (ops/psd_cuda.py) against the Pallas kernel it replaces.

On the CPU ``gamma_psd`` runs its plain version; it is held against
``psd_pallas.gamma_psd(..., interpret=True)`` on the three cases of
tests/test_psd_pallas.py (rtol 2e-3, f32). The CUDA kernel itself runs only
on a card: tests/test_torch_psd_cuda.py and chip_smoke.py hold it against
the plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msckf_mono_tpu.ops import psd_pallas
from msckf_mono_tpu_torch.ops import psd_cuda


def _make_systems(rng, batch_shape, R):
    n = int(np.prod(batch_shape))
    X = rng.normal(size=(n, R, R + 4))
    S = np.einsum("nij,nkj->nik", X, X) / R + np.eye(R) * 1e-5
    r = rng.normal(size=(n, R))
    return (S.reshape(*batch_shape, R, R).astype(np.float32),
            r.reshape(*batch_shape, R).astype(np.float32))


def _both(S, r):
    want = np.asarray(psd_pallas.gamma_psd(jnp.asarray(S), jnp.asarray(r), interpret=True))
    got = psd_cuda.gamma_psd(torch.as_tensor(S), torch.as_tensor(r)).numpy()
    return got, want


def test_gamma_plain_matches_pallas_interpret():
    S, r = _make_systems(np.random.default_rng(0), (4, 32), 53)
    got, want = _both(S, r)
    assert got.shape == (4, 32)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_gamma_plain_nonmultiple_batch():
    S, r = _make_systems(np.random.default_rng(1), (7,), 13)
    got, want = _both(S, r)
    assert got.shape == (7,)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_gamma_plain_indefinite_lane_is_inf():
    S, r = _make_systems(np.random.default_rng(2), (4,), 8)
    S[1] = -np.eye(8, dtype=np.float32)
    got, want = _both(S, r)
    ok = np.array([0, 2, 3])
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-3)
    assert got[1] == np.inf
    assert not (want[1] < 1e30)  # both gates fail closed


def test_gamma_plain_f64_matches_dense_solve():
    S, r = _make_systems(np.random.default_rng(3), (2, 5), 41)
    S, r = S.astype(np.float64), r.astype(np.float64)
    got = psd_cuda.gamma_psd(torch.as_tensor(S), torch.as_tensor(r)).numpy()
    want = np.einsum("...r,...r->...", r, np.linalg.solve(S, r[..., None])[..., 0])
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_gamma_cpu_uses_plain_and_counts_no_launch():
    S, r = _make_systems(np.random.default_rng(4), (3,), 5)
    before = psd_cuda.gamma_psd.launches
    got = psd_cuda.gamma_psd(torch.as_tensor(S), torch.as_tensor(r))
    plain = psd_cuda.gamma_psd_plain(torch.as_tensor(S), torch.as_tensor(r))
    assert torch.equal(got, plain)
    assert psd_cuda.gamma_psd.launches == before


def test_gamma_rejects_bad_shapes():
    with pytest.raises(ValueError):
        psd_cuda.gamma_psd(torch.zeros(3, 4, 5), torch.zeros(3, 4))
    with pytest.raises(ValueError):
        psd_cuda.gamma_psd(torch.zeros(3, 4, 4), torch.zeros(3, 5))


def test_shared_memory_plan():
    """The plan lives in the kernel's source and binds only the kernel: on the
    CPU an R above the kernel's limit (R > 120) takes the plain version."""
    S, r = _make_systems(np.random.default_rng(5), (2,), 121)
    S, r = S.astype(np.float64), r.astype(np.float64)
    got = psd_cuda.gamma_psd(torch.as_tensor(S), torch.as_tensor(r)).numpy()
    want = np.einsum("...r,...r->...", r, np.linalg.solve(S, r[..., None])[..., 0])
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert "kWarpsPerBlock" in psd_cuda.SOURCE.read_text()
    assert psd_cuda.library_path().parent == psd_cuda.BUILD_DIR
    assert psd_cuda.SOURCE.exists()
