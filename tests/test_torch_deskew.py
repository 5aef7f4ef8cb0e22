"""The deskew sweep of the PyTorch port: K12 (``kernels/deskew.py``, the
bin motions, the bins, the apply and the step's select) and its entries
in ``ops/deskew.py``, on skewed sweeps of ``utils/fixtures.py``.

On the CPU: the explicit-order bin motions against the JAX package's
``_bin_times_and_motion`` (at rest, straight, turning, every near-pi
sub-branch, a batch), the explicit-order plain version against its
``deskew_cloud`` at 1e-9 in float64 (both modes, bins exactly), its
batched branch against the JAX function run once a sequence, the
dispatching entries against the plain version bit for bit (a sequence
with ``do`` False, an all-invalid one), the window the kernel's prefix
minimum reads and the steps of the advance its table of motions rests
on, a CPU ``Fleet`` with deskew on against one ``Pipeline`` a sequence,
and the sweep fixture itself. Tests marked ``cuda`` hold K12 to its
plain version on the card bit for bit (the motions of every pose case,
ties in azimuth, ragged tiles, the do/valid select, draw and column
order, B = 1 to 4), and skip without one. JAX is imported by the CPU
tests only, so a machine with a card needs none."""

import dataclasses
import math

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from madicp_tpu_torch.kernels import deskew as k12
from madicp_tpu_torch.models.pipeline import Pipeline, PipelineConfig
from madicp_tpu_torch.ops import deskew as ops_deskew
from madicp_tpu_torch.ops.constants import CHUNKS
from madicp_tpu_torch.parallel import Fleet
from madicp_tpu_torch.utils.fixtures import SweepDrive, _exp_so3, skewed_sweep, spinning_scan

torch.set_num_threads(2)

MODES = ("reference", "binned")
MOTIONS = ("rest", "straight", "turning", "near_pi")
# the plain motions against the JAX function: float64 within 1e-12 (a few
# ulps of the entries, which are at most 1 and 0.3 m); float32 within
# 1e-6 (two orders of summation and libm against XLA's trig, a few ulps)
MOTION_ATOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _pose(rotvec, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = _exp_so3(np.asarray(rotvec, dtype=np.float64)), t
    return T


# relative rotations of pi: about z, y and x reach log_so3's three near-pi
# sub-branches (R33, R22, R11 not -1 in turn), about (1, 1, 1) the first
# with every diagonal entry -1/3; from the identity, so the trace is -1
# to the last bit in float32 too
NEAR_PI = [(_pose([0.0, 0.0, 0.0], [1.0, 2.0, 3.0]), _pose([0.0, 0.0, math.pi], [1.2, 2.0, 3.0])),
           (np.eye(4), _pose([0.0, math.pi, 0.0], [0.1, 0.0, 0.0])),
           (np.eye(4), _pose([math.pi, 0.0, 0.0], [0.1, 0.0, 0.0])),
           (np.eye(4), _pose(np.full(3, math.pi / math.sqrt(3.0)), [0.0, 0.3, 0.0]))]


def motion_poses(kind: str, B: int, seed: int = 0) -> tuple:
    """``(T_prev, T_now)`` (B, 4, 4) of a pose case: a sensor ``at rest``
    (the Taylor branch of log_so3, exp_so3's small branch at every bin), a
    ``straight`` line (no rotation, 0.3 m a scan), the drive's true
    ``turning`` poses, or a relative rotation ``near_pi`` (sequence b
    takes :data:`NEAR_PI` ``[b]``; one sequence takes the x sub-branch)."""
    T_prev, T_now = np.zeros((B, 4, 4)), np.zeros((B, 4, 4))
    for b in range(B):
        d = drive(seed + b)
        T_prev[b] = d.truth(2 + b)
        if kind == "rest":
            T_now[b] = T_prev[b]
        elif kind == "straight":
            T_now[b] = T_prev[b] @ _pose([0.0, 0.0, 0.0], [0.3, 0.02 * b, 0.0])
        elif kind == "turning":
            T_now[b] = d.truth(3 + b)
        else:
            T_prev[b], T_now[b] = NEAR_PI[2 if B == 1 else b % len(NEAR_PI)]
    return T_prev, T_now


def room_world(rng, n: int = 6000) -> np.ndarray:
    """Ground and walls in both orientations in a 24 m square: x and y
    translation both observable."""
    parts = [rng.uniform([-12, -12, -0.02], [12, 12, 0.02], (n // 3, 3))]
    for i, c in enumerate((-11.0, -4.0, 3.0, 11.0)):
        m = n // 12
        parts.append(rng.uniform([-12, c - 0.02, 0], [12, c + 0.02, 3], (m, 3)))
        parts.append(rng.uniform([c + 0.5 * i - 0.02, -12, 0], [c + 0.5 * i + 0.02, 12, 3],
                                 (m, 3)))
    return np.concatenate(parts)


def drive(seed=0, hz=10.0, v=(3.0, 0.4, 0.0), w=(0.0, 0.0, 0.2), points=3000, rest=0):
    return SweepDrive(room_world(np.random.default_rng(seed)), hz, v, w, points,
                      min_range=0.7, max_range=120.0, rest=rest, seed=seed)


def sweep_case(seed, n_invalid=0):
    """(points, T_prev, T_now, valid) of scan 3 of a skewed drive, float64:
    the true scan-end poses, ``n_invalid`` points masked out, and two
    runs of equal azimuths (the traversal's tie order is observable)."""
    d = drive(seed)
    pts = d.sweep(3, np.float64)
    pts[11:15] = pts[10] * np.array([[1.0], [2.0], [0.5], [3.0]])  # same azimuth
    pts[40:43] = pts[39]
    valid = np.ones(len(pts), bool)
    valid[np.random.default_rng(seed).choice(len(pts), n_invalid, replace=False)] = False
    return pts, d.truth(2), d.truth(3), valid


@pytest.fixture(scope="module")
def jax_deskew():
    """The JAX package's deskew module, on the CPU with x64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import madicp_tpu.ops.deskew as jax_deskew

    return jax_deskew


def _jax_cloud(jax_deskew, pts, T_prev, T_now, hz, valid, mode):
    import jax.numpy as jnp

    return np.asarray(jax_deskew.deskew_cloud(jnp.asarray(pts), jnp.asarray(T_prev),
                                              jnp.asarray(T_now), hz, valid=jnp.asarray(valid),
                                              mode=mode))


def _jax_bins(jax_deskew, pts, valid, mode):
    import jax.numpy as jnp

    az = jnp.arctan2(jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 0]))
    if mode == "binned":
        return np.asarray(jax_deskew._bins_pure(az))
    return np.asarray(jax_deskew._bins_reference(az, jnp.asarray(valid)))


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax_on_a_skewed_sweep(jax_deskew, mode):
    """deskew_cloud (the explicit order) against the JAX function at 1e-9,
    float64, and every point's bin exactly."""
    pts, T_prev, T_now, valid = sweep_case(1, n_invalid=150)
    got = ops_deskew.deskew_cloud(*(torch.from_numpy(a) for a in (pts, T_prev, T_now)), 10.0,
                                  valid=torch.from_numpy(valid), mode=mode).numpy()
    np.testing.assert_allclose(got, _jax_cloud(jax_deskew, pts, T_prev, T_now, 10.0, valid,
                                               mode), rtol=0, atol=1e-9)
    bins = k12.sweep_bins(torch.from_numpy(pts), torch.from_numpy(valid), mode).numpy()
    np.testing.assert_array_equal(bins, _jax_bins(jax_deskew, pts, valid, mode))
    assert len(np.unique(bins)) > 100  # the sweep spans the bins


@pytest.mark.parametrize("mode", MODES)
def test_batched_branch_matches_jax_per_sequence(jax_deskew, mode):
    """A batch of three clouds, each with its own poses, masks
    and sweep, against the JAX function run once a sequence."""
    cases = [sweep_case(s, n_invalid=n) for s, n in ((2, 0), (3, 400), (4, 2999))]
    pts, T_prev, T_now, valid = (np.stack(a) for a in zip(*cases))
    got = ops_deskew.deskew_cloud(*(torch.from_numpy(a) for a in (pts, T_prev, T_now)), 10.0,
                                  valid=torch.from_numpy(valid), mode=mode).numpy()
    for b in range(3):
        np.testing.assert_allclose(
            got[b], _jax_cloud(jax_deskew, pts[b], T_prev[b], T_now[b], 10.0, valid[b], mode),
            rtol=0, atol=1e-9)
    bins = k12.sweep_bins(torch.from_numpy(pts), torch.from_numpy(valid), mode).numpy()
    for b in range(3):
        np.testing.assert_array_equal(bins[b], _jax_bins(jax_deskew, pts[b], valid[b], mode))


def _jax_motion(jax_deskew, T_prev, T_now, hz, np_dtype):
    import jax.numpy as jnp

    R, t = jax_deskew._bin_times_and_motion(jnp.asarray(T_prev.astype(np_dtype)),
                                            jnp.asarray(T_now.astype(np_dtype)), hz, np_dtype)
    return np.asarray(R), np.asarray(t)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["rest", "straight", "turning", "near_pi_z", "near_pi_y",
                                  "near_pi_x", "near_pi_diagonal", "batch"])
def test_bin_motions_match_jax(jax_deskew, dtype, case):
    """The explicit-order bin motions (``bin_motion_plain``) against the
    JAX package's ``_bin_times_and_motion`` (:data:`MOTION_ATOL`), each
    pose case on the branches it is meant to reach; ``batch``: three
    sequences (turning, at rest, straight) at once against the JAX
    function run once a sequence."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    if case == "batch":
        pairs = [motion_poses(k, 1, seed=s) for k, s in (("turning", 4), ("rest", 5),
                                                          ("straight", 6))]
        T_prev, T_now = (np.concatenate(a) for a in zip(*pairs))
    elif case.startswith("near_pi"):
        i = ("z", "y", "x", "diagonal").index(case.split("_")[-1])
        T_prev, T_now = (a[None] for a in NEAR_PI[i])
    else:
        T_prev, T_now = motion_poses(case, 1)
    t = lambda a: torch.as_tensor(a.astype(np_dtype))  # noqa: E731
    R, tr = k12.bin_motion_plain(t(T_prev), t(T_now), torch.full((), 20.0, dtype=dtype))
    assert R.shape == (len(T_prev), CHUNKS, 3, 3) and tr.shape == (len(T_prev), CHUNKS, 3)
    for b in range(len(T_prev)):
        R_j, t_j = _jax_motion(jax_deskew, T_prev[b], T_now[b], 20.0, np_dtype)
        np.testing.assert_allclose(R[b].numpy(), R_j, rtol=0, atol=MOTION_ATOL[dtype])
        np.testing.assert_allclose(tr[b].numpy(), t_j, rtol=0, atol=MOTION_ATOL[dtype])
    # the branches each case reaches, from the relative rotation in float64
    R_rel = np.swapaxes(T_prev[:, :3, :3], 1, 2) @ T_now[:, :3, :3]
    tr3 = np.trace(R_rel, axis1=1, axis2=2) - 3.0
    t_k = -1.0 / 20.0 + np.arange(CHUNKS) / 20.0 / (CHUNKS - 1)
    theta_sq = (np.linalg.norm(Rotation.from_matrix(R_rel).as_rotvec(), axis=1)[:, None]
                * 20.0 * t_k) ** 2
    if case in ("rest", "straight"):  # the Taylor branch; I + W at every bin
        assert np.all(tr3 >= -1e-7) and np.all(theta_sq < 1e-8)
    elif case in ("turning", "batch"):  # the regular branch; both exp branches
        assert tr3[0] < -1e-7 and (theta_sq[0] < 1e-8).any() and (theta_sq[0] >= 1e-8).any()
    else:  # near pi, on the sub-branch of the diagonal entry that is not -1
        assert np.all(tr3 + 4.0 < 1e-10)
        d = np.diagonal(R_rel[0])
        sub = 2 if abs(d[2] + 1.0) > 1e-5 else 1 if abs(d[1] + 1.0) > 1e-5 else 0
        assert sub == {"z": 2, "y": 1, "x": 0, "diagonal": 2}[case.split("_")[-1]]


def test_the_prefix_minimum_needs_only_the_last_chunks_positions():
    """The kernel's premise (``csrc/deskew.cu``): with every ``c_i`` in
    ``[0, CHUNKS - 1]``, ``min_{i <= j} (c_i - i)`` is the minimum over the
    window ``[j - CHUNKS + 1, j]``, so a tile of sorted positions needs its
    own keys and the ``CHUNKS`` before it (no pass over the tiles before),
    for any ``c`` in that range, sorted (a sweep) or not."""
    rng = np.random.default_rng(0)
    n, tile = 40_000, 256
    runs = np.repeat(rng.integers(0, 60, 2000), rng.integers(1, 50, 2000))[:n]
    for c in (np.minimum(np.cumsum(runs > 50), CHUNKS - 1), np.sort(rng.integers(0, CHUNKS, n)),
              rng.integers(0, CHUNKS, n)):
        v = c - np.arange(len(c))
        want = np.minimum.accumulate(v)
        got = np.empty_like(v)
        for f in range(0, len(v), tile):
            carry = v[max(0, f - CHUNKS):f].min(initial=np.iinfo(v.dtype).max)
            got[f:f + tile] = np.minimum(carry, np.minimum.accumulate(v[f:f + tile]))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed,n_invalid", [(1, 0), (2, 2000)])
def test_the_advance_moves_at_most_one_bin_a_position(seed, n_invalid):
    """The kernel's premise for its table of motions (``csrc/deskew.cu``):
    along the reference's traversal the bin never falls and rises by at
    most one a position, so a tile of 256 sorted positions covers one run
    of at most 256 bins; on a sweep with a wide azimuth gap too."""
    pts, _, _, valid = sweep_case(seed, n_invalid=n_invalid)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    pts = pts[(az < 0.5) | (az > 1.5)]  # a gap of ~60 bins
    valid = valid[:len(pts)]
    keys, order = k12.sweep_order(k12.azimuth(torch.from_numpy(pts)), torch.from_numpy(valid))
    k = k12.reference_bins(keys, order)[torch.flip(order, dims=(-1,))].numpy()
    step = np.diff(k)
    assert step.min() >= 0 and step.max() <= 1 and k[-1] > k[0]


def _batch(dtype=torch.float64, seeds=(5, 6, 7), n_invalid=(0, 300, 3000)):
    """A batch of three sweeps and their poses: points, valid (the last
    sequence all invalid), T_prev, T_now."""
    cases = [sweep_case(s, n_invalid=n) for s, n in zip(seeds, n_invalid)]
    pts, T_prev, T_now, valid = (torch.from_numpy(np.stack(a)) for a in zip(*cases))
    return pts.to(dtype), valid, T_prev.to(dtype), T_now.to(dtype)


@pytest.mark.parametrize("mode", MODES)
def test_dispatch_on_the_cpu_is_the_plain_version(mode):
    """deskew_sweep and the step's deskew_scan on CPU tensors return the
    plain version's bits; a sequence with ``do`` False and every invalid
    point pass through unchanged; K12's counter stands still."""
    pts, valid, T_prev, T_now = _batch()
    do = torch.tensor([True, False, True])
    hz = torch.full((), 10.0, dtype=pts.dtype)
    before = k12.counter.launches
    got = k12.deskew_sweep(pts, valid, do, T_prev, T_now, hz, mode)
    want, bins = k12.deskew_sweep_plain(pts, valid, do, T_prev, T_now, hz, mode,
                                        return_bins=True)
    assert torch.equal(got, want) and k12.counter.launches == before
    assert torch.equal(ops_deskew.deskew_scan(pts, valid, do, T_prev, T_now, 10.0, mode), want)
    assert torch.equal(ops_deskew.deskew_scan(pts, valid, do, T_prev, T_now, hz, mode), want)
    keys, order = k12.sweep_order(k12.azimuth(pts), valid)
    assert torch.equal(k12.deskew_sweep_plain(pts, valid, do, T_prev, T_now, hz, mode, keys,
                                              order), want)
    keep = ~(do[:, None] & valid)
    assert torch.equal(got[keep], pts[keep]) and keep[1].all() and keep[2].all()
    moved = ops_deskew.deskew_cloud(pts, T_prev, T_now, 10.0, valid=valid, mode=mode)
    assert torch.equal(got[~keep], moved[~keep]) and not torch.equal(got[0], pts[0])
    assert bins.shape == valid.shape and int(bins.min()) >= 0 and int(bins.max()) < CHUNKS


def test_the_apply_is_the_explicit_order():
    """apply_motion forms ((R_c0 x + R_c1 y) + R_c2 z) + t_c: the same bits
    as the scalar order in numpy, float32."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 30
    R = rng.normal(size=(CHUNKS, 3, 3)).astype(np.float32)
    t = rng.normal(size=(CHUNKS, 3)).astype(np.float32)
    bins = rng.integers(0, CHUNKS, 500)
    got = k12.apply_motion(torch.from_numpy(pts), torch.from_numpy(bins), torch.from_numpy(R),
                           torch.from_numpy(t)).numpy()
    Rp, tp = R[bins], t[bins]
    want = np.stack([((Rp[:, c, 0] * pts[:, 0] + Rp[:, c, 1] * pts[:, 1])
                      + Rp[:, c, 2] * pts[:, 2]) + tp[:, c] for c in range(3)], axis=1)
    assert np.array_equal(got, want)


def test_argument_checks():
    pts, valid, T_prev, T_now = _batch()
    hz = torch.full((), 10.0, dtype=pts.dtype)
    do = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError):
        k12.deskew_sweep(pts, valid, do, T_prev, T_now, hz, "bogus")
    with pytest.raises(ValueError):
        k12.deskew_sweep(pts[0], valid[0], do[:1], T_prev[:1], T_now[:1], hz, "binned")
    with pytest.raises(TypeError):
        k12.deskew_sweep(pts, valid, do, T_prev.float(), T_now, hz, "binned")
    with pytest.raises(TypeError):
        k12.deskew_sweep(pts, valid, do, T_prev, T_now, hz.float(), "binned")
    with pytest.raises(TypeError):
        k12.deskew_sweep(pts, valid.int(), do, T_prev, T_now, hz, "binned")
    with pytest.raises(ValueError):
        k12.deskew_sweep(pts, valid, do[:2], T_prev, T_now, hz, "reference")
    with pytest.raises(ValueError):
        k12.deskew_sweep(pts, valid, do, T_prev[:, :3], T_now, hz, "reference")
    with pytest.raises(ValueError):
        k12.deskew_sweep(pts, valid, do, T_prev, T_now, hz[None], "reference")
    with pytest.raises(ValueError):
        ops_deskew.deskew_cloud(pts[0], T_prev[0], T_now[0], 10.0, mode="bogus")


# ---------------------------------------------------------------- fixture --
def test_a_static_sweep_is_the_world_seen_from_its_pose():
    """With no motion the sweep is the world in the sensor frame exactly,
    and mapping it back by the pose gives the world."""
    d = drive(8)
    world, pose = d.world[:2000], d.pose(4)
    sweep = skewed_sweep(world, pose, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 10.0)
    assert np.array_equal(sweep, spinning_scan(world, pose))
    np.testing.assert_allclose(sweep @ pose[:3, :3].T + pose[:3, 3], world, rtol=0, atol=1e-12)
    rest = drive(8, rest=2)
    assert np.array_equal(rest.sweep(1), rest.static_scan(1))
    assert np.array_equal(rest.truth(1), np.eye(4)) and not np.allclose(rest.truth(2), np.eye(4))


@pytest.mark.parametrize("hz", [10.0, 20.0])
def test_deskew_with_the_true_velocity_undoes_the_skew(hz):
    """A sweep deskewed with the drive's own velocity (its two scan-end
    poses) lies far closer to the scan-end frame than the raw sweep; at
    20 Hz the skew is half."""
    d = drive(9, hz=hz)
    raw, static = d.sweep(3, np.float64), d.static_scan(3, np.float64)
    err_raw = np.linalg.norm(raw - static, axis=1)
    for mode in MODES:
        out = ops_deskew.deskew_cloud(*(torch.from_numpy(a) for a in
                                        (raw, d.truth(2), d.truth(3))), hz, mode=mode).numpy()
        err = np.linalg.norm(out - static, axis=1)
        assert np.median(err) < 0.05 * np.median(err_raw)
    assert np.median(err_raw) > 0.05 * 10.0 / hz  # 3 m/s: up to 0.3 m a 10 Hz sweep


# ------------------------------------------------------------------ fleet --
FLEET_N, FLEET_DEPTH, FLEET_K = 4096, 10, 3
FLEET_CFG = PipelineConfig(sensor_hz=10.0, num_keyframes=FLEET_K, n_points=FLEET_N,
                           depth=FLEET_DEPTH, max_leaves=2048, max_icp_iterations=6,
                           deskew=True, dtype=torch.float64)
FLEET_PIPE = dict(sensor_hz=10.0, deskew=True, b_max=0.2, rho_ker=0.1, p_th=0.8, b_min=0.1,
                  b_ratio=0.02, num_keyframes=FLEET_K, n_points=FLEET_N, depth=FLEET_DEPTH,
                  max_leaves=2048, max_icp_iterations=6, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_fleet_with_deskew_matches_one_pipeline_per_sequence(mode):
    """A CPU Fleet of two sequences (different speeds, one starting from
    rest) with deskew on equals two single Pipelines at 1e-9, float64:
    the batched step deskews each cloud with its own trajectory."""
    drives = [drive(10, v=(2.0, 0.0, 0.0), w=(0.0, 0.0, 0.3)),
              drive(11, v=(3.0, 0.5, 0.0), w=(0.0, 0.0, -0.2), rest=1)]
    fleet = Fleet(dataclasses.replace(FLEET_CFG, deskew_mode=mode), 2, device="cpu")
    pipes = [Pipeline(**FLEET_PIPE, deskew_mode=mode) for _ in drives]
    for i in range(5):
        clouds = [d.sweep(i, np.float64) for d in drives]
        pts, val = np.zeros((2, FLEET_N, 3)), np.zeros((2, FLEET_N), bool)
        for b, c in enumerate(clouds):
            pts[b, :len(c)], val[b, :len(c)] = c, True
            pipes[b].compute(0.1 * i, c)
        fleet.compute(np.full(2, 0.1 * i), pts, val)
        np.testing.assert_allclose(fleet.poses(), np.stack([p.current_pose() for p in pipes]),
                                   rtol=0, atol=1e-9)
    # the drive follows its truth within half a scan's motion (the naive
    # velocity of the first deskewed scans lags; six GN rounds)
    truth = np.stack([d.truth(4) for d in drives])
    assert np.abs(fleet.poses()[:, :3, 3] - truth[:, :3, 3]).max() < 0.15


# ------------------------------------------------------------------- card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_case(device, dtype, B, N, seed=0, ties=True, motion="turning", column=False):
    """B sweeps of N points on the card (N need not be a multiple of the
    block), padded with invalid zeros past 90% of the last sequence, with
    runs of equal azimuths; with ``column`` each cloud in descending
    azimuth (capture-time) order. The poses of ``motion``
    (:func:`motion_poses`) and the rate (20 Hz)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, N, 3))
    for b in range(B):
        cloud = drive(seed + b, points=min(N, 3000)).sweep(3, np.float64)
        pts[b] = cloud[rng.integers(0, len(cloud), N)] * rng.uniform(0.5, 2.0, (N, 1))
    if ties:  # runs of one azimuth (a scaled copy of a point)
        pts[:, 7:19] = pts[:, 6:7] * np.linspace(0.5, 3.0, 12)[None, :, None]
    if column:
        for b in range(B):
            pts[b] = pts[b][np.argsort(-np.arctan2(pts[b, :, 1], pts[b, :, 0]), kind="stable")]
    valid = np.ones((B, N), bool)
    valid[-1, int(0.9 * N):] = False
    pts[~valid] = 0.0
    valid[:, 3::17] = False  # scattered invalid points keep their values
    T_prev, T_now = motion_poses(motion, B, seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return (t(pts), torch.as_tensor(valid, device=device), t(T_prev), t(T_now),
            torch.full((), 20.0, dtype=dtype, device=device))


def _check_k12(case, mode, do):
    """K12 (``launch``, bins returned) and the dispatching entry against
    the plain version on ``case``, bit for bit; one count a call."""
    pts, valid, T_prev, T_now, hz = case
    keys, order = k12.sweep_order(k12.azimuth(pts), valid) if mode == "reference" else (None,
                                                                                         None)
    before = k12.counter.launches
    got, bins = k12.launch(pts, valid, do, T_prev, T_now, hz, mode, keys, order,
                           return_bins=True)
    torch.cuda.synchronize()
    assert k12.counter.launches == before + 1
    want, want_bins = k12.deskew_sweep_plain(pts, valid, do, T_prev, T_now, hz, mode, keys,
                                             order, return_bins=True)
    assert torch.equal(bins.long(), want_bins)
    assert torch.equal(got, want)
    assert torch.equal(k12.deskew_sweep(pts, valid, do, T_prev, T_now, hz, mode), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,N", [(1, 4095), (3, 1025), (1, 1000), (3, 131072), (2, 3 * 1024)])
def test_k12_matches_the_plain_version_on_cuda(cuda_device, dtype, mode, B, N):
    """K12 against its plain version on the card bit for bit: bins and
    cloud, with ties, a ragged last block, invalid points and a sequence
    with ``do`` False; one count a call."""
    do = torch.ones(B, dtype=torch.bool, device=cuda_device)
    do[B // 2] = B == 1
    _check_k12(_card_case(cuda_device, dtype, B, N, seed=B * N), mode, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("motion", MOTIONS)
@pytest.mark.parametrize("column", [False, True], ids=["draw", "column"])
def test_k12_forms_the_motions_of_the_plain_version_on_cuda(cuda_device, dtype, mode, B, motion,
                                                            column):
    """The motions K12 forms from the poses, on every branch (at rest,
    straight, turning, near pi), bit for bit with the plain version's, in
    draw and column order, with every sequence moving."""
    do = torch.ones(B, dtype=torch.bool, device=cuda_device)
    _check_k12(_card_case(cuda_device, dtype, B, 20_000, seed=B, motion=motion, column=column),
               mode, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_k12_takes_points_off_a_pair_boundary_on_cuda(cuda_device, dtype, mode):
    """Points that start one value past a pair boundary (a view at an odd
    offset) take K12's scalar accesses: still bit for bit."""
    pts, valid, T_prev, T_now, hz = _card_case(cuda_device, dtype, 2, 5000, seed=11)
    flat = torch.empty(pts.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = flat[1:].view(pts.shape)
    shifted.copy_(pts)
    assert shifted.data_ptr() % (2 * pts.element_size()) != 0
    do = torch.ones(2, dtype=torch.bool, device=cuda_device)
    _check_k12((shifted, valid, T_prev, T_now, hz), mode, do)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_k12_replays_its_eager_call_on_cuda(cuda_device, mode):
    """The step's deskew (sort included) captured in a CUDA graph: the
    replay equals the eager call bit for bit, and the capture syncs
    nothing."""
    pts, valid, T_prev, T_now, hz = _card_case(cuda_device, torch.float32, 2, 131072, seed=3)
    do = torch.ones(2, dtype=torch.bool, device=cuda_device)
    call = lambda: ops_deskew.deskew_scan(pts, valid, do, T_prev, T_now, hz, mode)  # noqa: E731
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
