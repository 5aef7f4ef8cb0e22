"""Parity of the PyTorch port's small ops with the JAX package on the CPU:
lie algebra, closed-form eigh3, the moment segment-sum's plain version,
deskew and the velocity estimator. Same numpy inputs through both; JAX in
x64 (tests/conftest.py), torch in float64 unless stated."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from madicp_tpu.models.vel_estimator import estimate_velocity as jax_estimate_velocity
import madicp_tpu.ops.deskew as jax_deskew
import madicp_tpu.ops.lie as jax_lie
from madicp_tpu.ops.eigh3 import eigh3 as jax_eigh3
from madicp_tpu.ops.constants import SMOOTHING_T
from madicp_tpu.ops.tree import _segsum_moments_pallas
from madicp_tpu_torch.kernels.segsum import counter, segsum_moments, segsum_moments_ref
from madicp_tpu_torch.models.vel_estimator import VelEstimator, estimate_velocity
import madicp_tpu_torch.ops.deskew as pt_deskew
import madicp_tpu_torch.ops.lie as pt_lie
from madicp_tpu_torch.ops.eigh3 import eigh3

torch.set_num_threads(2)


def _pt(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(t):
    return t.detach().cpu().numpy()


def _rotvecs(rng):
    """Rotation vectors covering the regular, small-angle and theta~pi
    branches of exp/log (the cases of tests/test_lie.py)."""
    w = rng.normal(size=(40, 3))
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * rng.uniform(
        1e-4, np.pi - 1e-3, size=(40, 1)
    )
    small = np.array([[1e-6, -2e-6, 5e-7], [0.0, 0.0, 0.0]])
    axes = np.array([[1.0, 0, 0], [0, 1.0, 0], [0.57735, 0.57735, 0.57735]])
    near_pi = axes * (np.pi - 1e-9)
    return np.concatenate([w, small, near_pi])


@pytest.mark.parametrize("fn", ["skew", "exp_so3", "exp_se3_split"])
def test_lie_maps_match_jax(rng, fn):
    w = _rotvecs(rng)
    if fn == "exp_se3_split":
        w = np.concatenate([rng.normal(size=w.shape), w], axis=1)
    want = np.asarray(getattr(jax_lie, fn)(jnp.asarray(w)))
    got = _np(getattr(pt_lie, fn)(_pt(w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_log_so3_matches_jax_all_branches(rng):
    w = _rotvecs(rng)
    R = np.concatenate(
        [Rotation.from_rotvec(w).as_matrix(), np.eye(3)[None]], axis=0
    )
    want = np.asarray(jax_lie.log_so3(jnp.asarray(R)))
    got = _np(pt_lie.log_so3(_pt(R)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_euler_and_se3_helpers_match_jax(rng):
    R = Rotation.from_rotvec(rng.normal(size=(20, 3)) * 0.5).as_matrix()
    t = rng.normal(size=(20, 3))
    pts = rng.normal(size=(20, 11, 3))
    np.testing.assert_allclose(
        _np(pt_lie.euler_xyz(_pt(R))),
        np.asarray(jax_lie.euler_xyz(jnp.asarray(R))), atol=1e-12,
    )
    T_j = jax_lie.se3_matrix(jnp.asarray(R), jnp.asarray(t))
    T_t = pt_lie.se3_matrix(_pt(R), _pt(t))
    np.testing.assert_allclose(_np(T_t), np.asarray(T_j), atol=1e-12)
    np.testing.assert_allclose(
        _np(pt_lie.se3_inverse(T_t)), np.asarray(jax_lie.se3_inverse(T_j)),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        _np(pt_lie.se3_apply(T_t, _pt(pts))),
        np.asarray(jax_lie.se3_apply(T_j, jnp.asarray(pts))), atol=1e-12,
    )


def _sym_batches(rng):
    B = rng.normal(size=(200, 3, 3))
    sym = (B + np.swapaxes(B, -1, -2)) / 2
    pts = rng.normal(size=(50, 100, 3)) * np.array([1.0, 0.5, 0.01])
    cov = np.einsum("bni,bnj->bij", pts, pts) / 100
    return np.concatenate([sym, cov])


def test_eigh3_matches_jax_with_sign(rng):
    """Eigenvalues at 1e-12; away from degenerate spectra the eigenvectors
    agree WITH sign at 1e-9 (the sign picks every node's split side)."""
    A = _sym_batches(rng)
    ev_j, vec_j = map(np.asarray, jax_eigh3(jnp.asarray(A)))
    ev_t, vec_t = map(_np, eigh3(_pt(A)))
    np.testing.assert_allclose(ev_t, ev_j, rtol=0, atol=1e-12)
    gaps = np.diff(np.linalg.eigvalsh(A), axis=-1).min(-1)
    sep = gaps > 1e-6 * np.abs(A).max(axis=(-1, -2))
    assert sep.sum() > 200
    np.testing.assert_allclose(vec_t[sep], vec_j[sep], rtol=0, atol=1e-9)


def test_eigh3_degenerate_spectra():
    """The checks of tests/test_eigh3.py on degenerate spectra, plus
    agreement with JAX's canonical basis choice."""
    A = np.stack([
        np.zeros((3, 3)), np.eye(3), np.diag([1.0, 1.0, 2.0]),
        np.diag([0.0, 1.0, 1.0]), np.diag([5.0, 5.0, 5.0]),
        np.diag([0.0, 0.0, 3.0]),
    ])
    d = np.array([0.3, -0.1, 0.2])
    A = np.concatenate([A, np.outer(d, d)[None]])
    evals, evecs = map(_np, eigh3(_pt(A)))
    np.testing.assert_allclose(evals, np.linalg.eigvalsh(A), atol=1e-7)
    gram = np.einsum("...ki,...kj->...ij", evecs, evecs)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(3), gram.shape), atol=1e-9)
    # rank one: the largest eigenvector is the cluster direction
    np.testing.assert_allclose(evals[-1, :2], 0.0, atol=1e-12)
    np.testing.assert_allclose(
        abs(evecs[-1, :, 2] @ d / np.linalg.norm(d)), 1.0, atol=1e-7
    )
    ev_j, vec_j = map(np.asarray, jax_eigh3(jnp.asarray(A)))
    np.testing.assert_allclose(evals, ev_j, atol=1e-12)
    np.testing.assert_allclose(evecs, vec_j, atol=1e-9)


def test_eigh3_float32(rng):
    B = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = (B + np.swapaxes(B, -1, -2)) / 2
    evals, evecs = map(_np, eigh3(_pt(A, torch.float32)))
    assert evals.dtype == np.float32
    np.testing.assert_allclose(
        evals, np.linalg.eigvalsh(A.astype(np.float64)), atol=2e-5
    )
    gram = np.einsum("...ki,...kj->...ij", evecs, evecs)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(3), gram.shape), atol=1e-5)


def _segsum_case(dtype):
    rng = np.random.default_rng(5)
    N, sz = 4096, 64
    d = rng.normal(0, 2.0, (N, 3)).astype(dtype)
    idx = rng.integers(0, sz, N).astype(np.int32)
    idx[rng.random(N) < 0.1] = sz  # dropped rows
    return d, idx, sz


def test_segsum_plain_matches_pallas_kernel_f32():
    """The plain version against the TPU kernel it replaces, run in
    interpret mode: f32 reassociation tolerance (sum orders differ)."""
    d, idx, sz = _segsum_case(np.float32)
    want = np.asarray(_segsum_moments_pallas(
        jnp.asarray(d), jnp.asarray(idx), sz, interpret=True))
    got = _np(segsum_moments_ref(torch.from_numpy(d), torch.from_numpy(idx), sz))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-3)


def test_segsum_wrapper_matches_add_at_f64():
    """On CPU tensors the wrapper takes the plain version; f64 against
    np.add.at, with negative and >= sz ids dropped."""
    d, idx, sz = _segsum_case(np.float64)
    idx[:7] = -3
    before = counter.launches
    got = _np(segsum_moments(torch.from_numpy(d), torch.from_numpy(idx), sz))
    assert counter.launches == before  # no launch
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    mom = np.stack([x, y, z, x * x, x * y, x * z, y * y, y * z, z * z,
                    np.ones_like(x)], axis=1)
    keep = (idx >= 0) & (idx < sz)
    want = np.zeros((sz, 10))
    np.add.at(want, idx[keep], mom[keep])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def _deskew_case(rng, n=2000):
    pts = rng.normal(size=(n, 3)) * np.array([20.0, 20.0, 2.0])
    pts[5:9] = pts[4]  # azimuth ties: the traversal order is observable
    T_prev = np.eye(4)
    T_now = np.eye(4)
    T_now[:3, :3] = Rotation.from_rotvec([0.01, -0.02, 0.05]).as_matrix()
    T_now[:3, 3] = [0.8, 0.1, -0.02]
    valid = rng.random(n) > 0.05
    return pts, T_prev, T_now, valid


@pytest.mark.parametrize("mode", ["reference", "binned"])
def test_deskew_matches_jax(rng, mode):
    pts, T_prev, T_now, valid = _deskew_case(rng)
    want = np.asarray(jax_deskew.deskew_cloud(
        jnp.asarray(pts), jnp.asarray(T_prev), jnp.asarray(T_now), 10.0,
        valid=jnp.asarray(valid), mode=mode))
    got = _np(pt_deskew.deskew_cloud(
        _pt(pts), _pt(T_prev), _pt(T_now), 10.0,
        valid=torch.from_numpy(valid), mode=mode))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    if mode == "reference":
        az = np.arctan2(pts[:, 1], pts[:, 0])
        b_j = np.asarray(jax_deskew._bins_reference(jnp.asarray(az), jnp.asarray(valid)))
        b_t = _np(pt_deskew._bins_reference(_pt(az), torch.from_numpy(valid)))
        np.testing.assert_array_equal(b_t, b_j)


def _random_traj(rng, n):
    poses = [np.eye(4)]
    for _ in range(n - 1):
        d = np.eye(4)
        d[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
        d[:3, 3] = rng.normal(size=3) * 0.3
        poses.append(poses[-1] @ d)
    return poses


@pytest.mark.parametrize("n", [1, 2, 4, 10, 13])
def test_estimate_velocity_matches_jax(rng, n):
    W = SMOOTHING_T
    poses = _random_traj(rng, n)
    traj = np.tile(np.eye(4), (W, 1, 1))
    traj[W - min(n, W):] = np.stack(poses[-W:])
    v0 = rng.normal(size=6) * 0.1
    want = np.asarray(jax_estimate_velocity(
        jnp.asarray(v0), jnp.asarray(traj), jnp.asarray(n), 0.1))
    got = _np(estimate_velocity(_pt(v0), _pt(traj), n, 0.1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    est = VelEstimator(sensor_hz=10.0, device="cpu")
    est.init(v0)
    est.set_odometry(poses)
    np.testing.assert_allclose(est.one_round(), want, atol=1e-12)
