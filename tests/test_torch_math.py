"""Port math leaves against the JAX package: config, quat, linalg, expm, chi2 (f64)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from msckf_mono_tpu.ops import expm as jexpm
from msckf_mono_tpu.ops import linalg as jlinalg
from msckf_mono_tpu.utils import chi2 as jchi2
from msckf_mono_tpu.utils import config as jcfg
from msckf_mono_tpu.utils import quat as jquat
from msckf_mono_tpu_torch.ops import expm as texpm
from msckf_mono_tpu_torch.ops import linalg as tlinalg
from msckf_mono_tpu_torch.utils import chi2 as tchi2
from msckf_mono_tpu_torch.utils import config as tcfg
from msckf_mono_tpu_torch.utils import quat as tquat

TOL = 1e-10


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_config_copy_matches_jax_config():
    assert dataclasses.asdict(tcfg.MsckfConfig()) == dataclasses.asdict(jcfg.MsckfConfig())
    assert dataclasses.asdict(tcfg.EUROC_CONFIG) == dataclasses.asdict(jcfg.EUROC_CONFIG)
    j, t = jcfg.MsckfConfig(), tcfg.MsckfConfig()
    for name in ("u_var_prime", "v_var_prime", "max_gn_cost_norm", "redundancy_angle",
                 "redundancy_distance"):
        assert getattr(t, name) == getattr(j, name)
    assert t.q_imu_diag() == j.q_imu_diag()
    assert t.initial_imu_covar_diag() == j.initial_imu_covar_diag()
    assert t.shapes.state_dim == j.shapes.state_dim


def _quat_cases(rng):
    q, q2 = _unit_quats(rng, 6), _unit_quats(rng, 6)
    v, v2 = rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
    rot = np.array(jquat.to_rotmat(jnp.asarray(q)))
    dt = np.full((6,), 0.005)
    return {
        "skew": (v,), "normalize": (rng.normal(size=(6, 4)),), "conjugate": (q,),
        "mul": (q, q2), "to_rotmat": (q,), "rotate": (q, v), "from_rotmat": (rot,),
        "from_two_vectors": (v, v2), "angular_distance": (q, q2),
        "build_update_quat": (0.1 * v,), "omega_mat_jpl": (v,),
        "integrate_rk5": (q, v, dt),
    }


@pytest.mark.parametrize("name", sorted(_quat_cases(np.random.default_rng(0))))
def test_quat_matches_jax(name):
    args = _quat_cases(np.random.default_rng(0))[name]
    want = getattr(jquat, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tquat, name)(*(torch.as_tensor(a) for a in args))
    _close(got, want)


def test_quat_from_two_vectors_antiparallel():
    a = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    want = jquat.from_two_vectors(jnp.asarray(a), jnp.asarray(-a))
    got = tquat.from_two_vectors(torch.as_tensor(a), torch.as_tensor(-a))
    _close(got, want)


def test_solve3x3_bmv_bmm_small_match_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(5, 3, 3))
    A = X @ np.swapaxes(X, -1, -2) + np.eye(3)
    b = rng.normal(size=(5, 3))
    Bm = rng.normal(size=(5, 3, 4))
    _close(tlinalg.solve3x3(torch.as_tensor(A), torch.as_tensor(b)),
           jlinalg.solve3x3(jnp.asarray(A), jnp.asarray(b)))
    _close(tlinalg.bmv(torch.as_tensor(A), torch.as_tensor(b)),
           jlinalg.bmv(jnp.asarray(A), jnp.asarray(b)))
    _close(tlinalg.bmm_small(torch.as_tensor(A), torch.as_tensor(Bm)),
           jlinalg.bmm_small(jnp.asarray(A), jnp.asarray(Bm)))
    _close(tlinalg.solve3x3(torch.as_tensor(A), torch.as_tensor(b)), np.linalg.solve(A, b[..., None])[..., 0])


@pytest.mark.parametrize("n_valid", [4, 7, 10])
def test_null_project_3_pinned_by_nullspace_and_invariants(n_valid):
    """Pinned by what any nullspace basis shares, not by the basis: the projected
    H_f vanishes, and XᵀΠX (Π the projector onto the left nullspace) matches."""
    rng = np.random.default_rng(n_valid)
    n, W = 10, 6
    H_f = rng.normal(size=(2, n, 3))
    X = rng.normal(size=(2, n, W))
    H_f[:, n_valid:] = 0.0
    X[:, n_valid:] = 0.0
    got = tlinalg.null_project_3(torch.as_tensor(H_f), torch.as_tensor(X)).numpy()
    assert got.shape == (2, n - 3, W)
    proj_hf = tlinalg.null_project_3(torch.as_tensor(H_f), torch.as_tensor(H_f)).numpy()
    np.testing.assert_allclose(proj_hf, 0.0, atol=1e-12)
    # exact zero rows stay exactly zero (row compaction relies on it)
    assert np.all(got[:, n_valid - 3:] == 0.0)
    want = np.stack([np.asarray(jlinalg.null_project_3(jnp.asarray(H_f[b]), jnp.asarray(X[b])))
                     for b in range(2)])
    inv_got = np.swapaxes(got, -1, -2) @ got
    inv_want = np.swapaxes(want, -1, -2) @ want
    _close(inv_got, inv_want)
    Pi = np.eye(n) - H_f @ np.linalg.pinv(H_f)
    _close(inv_got, np.swapaxes(X, -1, -2) @ Pi @ X, 1e-9)


def test_expm_taylor_matches_jax_and_scipy():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 15, 15)) * 0.05
    got = texpm.expm_taylor(torch.as_tensor(a)).numpy()
    _close(got, jexpm.expm_taylor(jnp.asarray(a)))
    _close(got, np.stack([scipy.linalg.expm(x) for x in a]), 1e-12)


def test_chi2_table_and_threshold_match_jax():
    _close(tchi2.chi2_gate_table(torch.float64), jchi2.chi2_gate_table(jnp.float64), 0.0)
    for dof in (1, 5, 39, 254):
        for quirk in (True, False):
            assert float(tchi2.gate_threshold(dof, reproduce_offbyone=quirk, dtype=torch.float64)) == \
                float(jchi2.gate_threshold(dof, reproduce_offbyone=quirk, dtype=jnp.float64))
    dofs = np.array([0, 3, 300])
    got = tchi2.gate_threshold(torch.as_tensor(dofs), dtype=torch.float64).numpy()
    want = np.asarray(jchi2.gate_threshold(jnp.asarray(dofs), dtype=jnp.float64))
    _close(got, want, 0.0)
