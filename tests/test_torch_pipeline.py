"""The PyTorch port's odometry pipeline against the JAX package on the CPU:
the golden four-walls drive (tests/test_golden.py) in float64 with both
certify settings, the same drive in float32 against the JAX float32
pipeline, and a JAX state carried across mid-drive."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from madicp_tpu.models.pipeline import Pipeline as JaxPipeline
from madicp_tpu_torch.kernels.segsum import counter
from madicp_tpu_torch.models.pipeline import Pipeline, PipelineConfig
from madicp_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden_four_walls.npz"
N_SCANS = 10


def _golden_scans():
    """The scans of tests/test_golden.py::_drive, in order (the room and
    each scan's noise come from one generator, so they are drawn here
    exactly as there)."""
    rng = np.random.default_rng(42)

    def plane(xr, yr, zr, n):
        return np.column_stack(
            [rng.uniform(*xr, n), rng.uniform(*yr, n), rng.uniform(*zr, n)]
        )

    w, h, n = 4.0, 2.0, 1000
    room = np.vstack([
        plane([0, w], [0, 0], [0, h], n),
        plane([0, w], [w, w], [0, h], n),
        plane([0, 0], [0, w], [0, h], n),
        plane([w, w], [0, w], [0, h], n),
        plane([0, w], [0, w], [0, 0], n),
    ])
    scans = []
    for i in range(N_SCANS):
        t = np.array([0.05 * i, 0.02 * i, 0.0])
        yaw = 0.003 * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        scans.append((room - t) @ R + rng.normal(0, 0.001, room.shape))
    return scans


GOLDEN_KW = dict(
    sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8,
    b_min=0.1, b_ratio=0.02, num_keyframes=3,
    n_points=8192, depth=12, max_leaves=4096,
)


def _drive(pipe, scans, start=0):
    poses, ratios = [], []
    for i, scan in enumerate(scans, start=start):
        pipe.compute(0.1 * i, scan)
        poses.append(pipe.current_pose())
        ratios.append(pipe.inlier_ratio())
    return np.stack(poses), np.array(ratios)


@pytest.mark.parametrize("certify", [True, False])
def test_golden_drive_float64(certify):
    """Both schedules reproduce the stored JAX golden trajectory at the
    JAX suite's own tolerance; certified walks fewer descents."""
    golden = np.load(GOLDEN)
    pipe = Pipeline(**GOLDEN_KW, dtype=torch.float64, certify=certify, device="cpu")
    poses, ratios = _drive(pipe, _golden_scans())
    np.testing.assert_allclose(poses, golden["poses"], atol=1e-9)
    np.testing.assert_allclose(ratios, golden["ratios"], atol=1e-9)
    L = pipe._last.n_leaves.item()
    K = int(pipe.state.kf_valid.sum())
    full = 15 * K * L
    assert pipe.descents() < full if certify else pipe.descents() == full


def test_golden_drive_float32_matches_jax():
    """float32 (the shipped dtype), against the JAX float32 pipeline and
    the float64 golden.

    Two float32 implementations cannot agree to the 5e-4 certified-vs-
    plain bound of tests/test_pipeline.py (which compares one
    implementation with itself): on this drive the JAX float32 run
    itself leaves its float64 golden by up to 1.1e-3 — at scan 2 one
    point sits within float32 noise of the root split plane, so the two
    packages' root splits differ by that point and their child means by
    ~1e-3 m. So: the port tracks JAX float32 within 2e-3, is never
    further from the float64 golden than JAX float32 is (+1e-4), and
    meets the ground-truth bounds of tests/test_golden.py."""
    golden = np.load(GOLDEN)["poses"]
    scans = _golden_scans()
    port = Pipeline(**GOLDEN_KW, dtype=torch.float32, device="cpu")
    ref = JaxPipeline(**GOLDEN_KW, dtype=jnp.float32)
    before = counter.launches
    for i, scan in enumerate(scans):
        port.compute(0.1 * i, scan)
        ref.compute(0.1 * i, scan)
        X_t = port.current_pose().astype(np.float64)
        X_j = ref.current_pose().astype(np.float64)
        d = np.abs(X_t - X_j).max()
        assert d < 2e-3, f"scan {i}: port f32 is {d:.2e} from JAX f32"
        err_t = np.abs(X_t - golden[i]).max()
        err_j = np.abs(X_j - golden[i]).max()
        assert err_t <= err_j + 1e-4, f"scan {i}: {err_t:.2e} vs JAX {err_j:.2e}"
        gt = np.array([0.05 * i, 0.02 * i, 0.0])
        assert np.linalg.norm(X_t[:3, 3] - gt) < 5e-3
        assert port.inlier_ratio() > 0.95
    assert port.current_pose().dtype == np.float32
    assert counter.launches == before  # the CPU path never launches


def test_state_from_numpy_continues_a_jax_drive():
    """JAX drives 3 scans; its state converts to the port's; both then
    drive 2 more scans and agree at 1e-9 (float64)."""
    scans = _golden_scans()
    ref = JaxPipeline(**GOLDEN_KW, dtype=jnp.float64)
    for i in range(3):
        ref.compute(0.1 * i, scans[i])
    arrays = {
        name: np.asarray(getattr(ref.state, name).nav if name.endswith("_tree")
                         else getattr(ref.state, name))
        for name in ref.state._fields
    }
    port = Pipeline(**GOLDEN_KW, dtype=torch.float64, device="cpu")
    port.state = state_from_numpy(port.cfg, arrays, "cpu")
    port._initialized = True
    for i in range(3, 5):
        ref.compute(0.1 * i, scans[i])
        port.compute(0.1 * i, scans[i])
        np.testing.assert_allclose(port.current_pose(), ref.current_pose(), atol=1e-9)
        assert port.inlier_ratio() == pytest.approx(ref.inlier_ratio(), abs=1e-12)
        assert port.current_id() == ref.current_id()
        assert port.keyframe_id() == ref.keyframe_id()
    np.testing.assert_allclose(
        port.state.velocity.numpy(), np.asarray(ref.state.velocity), atol=1e-9)
    with pytest.raises(KeyError):
        state_from_numpy(port.cfg, {"X": arrays["X"]}, "cpu")


def test_deskew_drive_matches_jax():
    """A drive with deskew on (the reference mode; both modes are pinned
    op by op in test_torch_ops.py) matches the JAX pipeline at 1e-9."""
    kw = dict(GOLDEN_KW, deskew=True, n_points=4096, depth=10,
              max_leaves=2048, max_icp_iterations=6)
    port = Pipeline(**kw, dtype=torch.float64, device="cpu")
    ref = JaxPipeline(**kw, dtype=jnp.float64)
    for i, scan in enumerate(_golden_scans()[:4]):
        port.compute(0.1 * i, scan[::2])
        ref.compute(0.1 * i, scan[::2])
        np.testing.assert_allclose(port.current_pose(), ref.current_pose(), atol=1e-9)


def test_unported_schedules_raise():
    for kw in (dict(assoc_mode="fast"), dict(certify_compact=64),
               dict(certify_prefix=64)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PipelineConfig(**kw)
    with pytest.raises(ValueError):
        PipelineConfig(assoc_mode="bogus")
    pipe = Pipeline(**GOLDEN_KW, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.compute_batch([0.0], [np.zeros((10, 3))])


def test_realtime_budget_degrades_and_recovers(four_walls):
    """The rolling recalibration (JAX tests/test_pipeline.py, same clock
    script): a slow epoch shrinks the iteration budget, fast ones restore
    it, and a just-changed count is never timed on its first run."""
    p = Pipeline(
        sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8,
        b_min=0.1, b_ratio=0.02, num_keyframes=2, realtime=True,
        n_points=1024, depth=9, max_leaves=512,
        max_icp_iterations=6, realtime_recal_every=1, device="cpu",
    )
    deltas = iter([0.95, 0.003, 0.003, 0.003, 0.003])
    clock = {"t": 0.0, "mid": False}

    def fake_now():
        if clock["mid"]:
            clock["t"] += next(deltas)
        clock["mid"] = not clock["mid"]
        return clock["t"]

    p._now = fake_now
    seen = []
    for i in range(7):
        p.compute(0.1 * i, (four_walls - np.array([0.05 * i, 0.0, 0.0])).astype(np.float32))
        seen.append(p.cfg.max_icp_iterations)
    assert min(seen) == 1
    assert p.cfg.max_icp_iterations == 6
    assert p.current_id() == 7
    assert np.isfinite(p.current_pose()).all()
