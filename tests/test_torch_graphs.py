"""The port's step dispatch on the CPU: the single ``Pipeline`` as a batch
of one in static buffers, with one (masked) promotion path, held to the
JAX package; the captured body (``models/step_graph.py``) held to
``odometry_step``; outputs that no later step changes; ``compute_batch``;
checkpoints across the packages; and assignment to ``Pipeline.state``.

The drive is the four-walls golden drive (tests/test_golden.py) at every
other point, 4096 points, depth 10, 6 rounds, float64, with ``p_th`` =
0.9965: its inlier ratios lie between 0.994 and 0.999, so some scans
promote a keyframe and some do not. The CUDA graphs themselves run only
on a card (the ``cuda`` tests of test_torch_package.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madicp_tpu.models.pipeline import Pipeline as JaxPipeline
from madicp_tpu.utils import checkpoint as jax_checkpoint
from madicp_tpu_torch.models.pipeline import Pipeline, _lift, init_state, odometry_step
from madicp_tpu_torch.models.step_graph import StepGraphs, step_in_place
from madicp_tpu_torch.ops.tree import SearchTree
from madicp_tpu_torch.utils import checkpoint
from test_torch_pipeline import _golden_scans

torch.set_num_threads(2)

KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.9965,
          b_min=0.1, b_ratio=0.02, num_keyframes=3, n_points=4096, depth=10,
          max_leaves=2048, max_icp_iterations=6)
SCHEDULES = {
    "exact": dict(certify=False),
    "certified": dict(),
    "compact": dict(certify_compact=64),
    "prefix": dict(certify_prefix=64),
    "fast": dict(assoc_mode="fast", reassoc_every=2),
}


def _scans():
    return [s[::2] for s in _golden_scans()]


def _port(**kw):
    return Pipeline(**{**KW, **kw}, dtype=torch.float64, device="cpu")


def _tensors(state):
    return [f.nav if isinstance(f, SearchTree) else f for f in state]


def _ring(state):
    """The keyframe ring's valid slots, head and the 8-float blocks of
    its valid slots' rows, as numpy."""
    valid = np.asarray(state.kf_valid)
    blocks = np.asarray(state.kf_tree.nav)[valid].reshape(-1, 8)
    return valid, int(np.asarray(state.kf_head)), blocks


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_single_pipeline_promotes_like_jax(schedule):
    """Per scan: the same promotion decision as the JAX Pipeline (some
    scans promote, some do not), the pose within 1e-9, and the keyframe
    ring's valid slots, head and flags equal, and the positions and
    scalars of its real blocks within 1e-9.

    Directions are eigenvectors, and near-degenerate spectra amplify the
    1-ulp differences of XLA's fused multiply-adds (ROADMAP C8): unreal
    blocks (below a leaf, never read by a descent) are held to 1e-8 as in
    test_torch_tree.py::test_build_tree_matches_jax, and on this drive
    one small leaf's normal differs by 2.4e-8 from its first scan on, so
    real directions are held to 1e-7."""
    port = _port(**SCHEDULES[schedule])
    ref = JaxPipeline(**{**KW, **SCHEDULES[schedule]}, dtype=jnp.float64)
    promoted = []
    for i, scan in enumerate(_scans()):
        port.compute(0.1 * i, scan)
        ref.compute(0.1 * i, scan)
        promoted.append(port.is_map_updated())
        assert promoted[-1] == ref.is_map_updated(), f"scan {i}"
        np.testing.assert_allclose(port.current_pose(), ref.current_pose(), rtol=0, atol=1e-9)
        valid, head, blocks = _ring(port.state)
        want_valid, want_head, want = _ring(ref.state)
        np.testing.assert_array_equal(valid, want_valid)
        assert head == want_head and port.keyframe_id() == ref.keyframe_id()
        np.testing.assert_array_equal(blocks[:, 7], want[:, 7])
        real = want[:, 7] >= 2.0
        pos = [0, 1, 2, 6, 7]
        np.testing.assert_allclose(blocks[real][:, pos], want[real][:, pos], rtol=0, atol=1e-9)
        np.testing.assert_allclose(blocks[real][:, 3:6], want[real][:, 3:6], rtol=0, atol=1e-7)
        np.testing.assert_allclose(blocks[~real], want[~real], rtol=0, atol=1e-8)
    assert any(promoted[1:]) and not all(promoted[1:]), promoted


def _stepped(n):
    pipe = _port()
    for i, scan in enumerate(_scans()[:n]):
        pipe.compute(0.1 * i, scan)
    return pipe


def _copy(state):
    return type(state)(*(SearchTree(nav=f.nav.clone()) if isinstance(f, SearchTree)
                         else f.clone() for f in state))


def test_captured_body_equals_odometry_step_bitwise():
    """The body a graph captures, run eagerly over static buffers, leaves
    in the buffers exactly the state ``odometry_step`` returns and gives
    its output; an output the body returned is unchanged by the next
    step (it aliases no buffer)."""
    pipe = _stepped(3)
    cfg, scans = pipe.cfg, _scans()
    buffers = _copy(_lift(pipe.state))
    pts, val, _ = pipe.stage(scans[3])
    pts, val = pts[None], val[None]
    want_state, want_out = odometry_step(cfg, _copy(buffers), pts, val, None)
    held = _tensors(buffers)
    out = step_in_place(cfg, buffers, pts, val)
    assert all(a is b for a, b in zip(_tensors(buffers), held))  # the same buffers
    for got, want in zip(_tensors(buffers) + list(out), _tensors(want_state) + list(want_out)):
        assert torch.equal(got, want)
    kept = [t.clone() for t in out]
    pts, val, _ = pipe.stage(scans[4])
    step_in_place(cfg, buffers, pts[None], val[None])
    assert not torch.equal(buffers.X, kept[0])  # the buffers moved on
    for t, k in zip(out, kept):
        assert torch.equal(t, k)


def test_pipeline_outputs_outlive_the_next_scan():
    """What the accessors and the last output hand out stays as it was
    after the next scan overwrites the buffers in place."""
    pipe = _stepped(3)
    last, pose, kf_pose = pipe._last, pipe.current_pose(), pipe.keyframe_pose()
    kept = [t.clone() for t in last]
    pipe.compute(0.3, _scans()[3])
    assert not np.array_equal(pipe.current_pose(), pose)
    assert np.array_equal(pose, kept[0].numpy()) and kf_pose.shape == (4, 4)
    for t, k in zip(last, kept):
        assert torch.equal(t, k)


def test_compute_batch_gives_distinct_poses_equal_to_compute():
    """Four scans in one chunk: four distinct poses, bit for bit those of
    four ``compute`` calls."""
    scans, stamps = _scans()[:4], [0.1 * i for i in range(4)]
    seq = _port()
    want = []
    for stamp, scan in zip(stamps, scans):
        seq.compute(stamp, scan)
        want.append(seq.current_pose())
    got = _port().compute_batch(stamps, scans)
    np.testing.assert_array_equal(got, np.stack(want))
    assert len({p.tobytes() for p in got}) == 4


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_of_the_batch_of_one_pipeline_crosses_the_packages(tmp_path, writer):
    """Mid-drive, after promotions, a checkpoint written by one package
    resumes in the other: the next four scans agree at 1e-9 with the
    writer's own, promotions included."""
    scans = _scans()
    src = _port() if writer == "port" else JaxPipeline(**KW, dtype=jnp.float64)
    promoted = []
    for i in range(5):
        src.compute(0.1 * i, scans[i])
        promoted.append(src.is_map_updated())
    assert any(promoted[1:])
    if writer == "port":
        checkpoint.save_pipeline(tmp_path / "ck.npz", src)
        dst = jax_checkpoint.load_pipeline(tmp_path / "ck.npz")
    else:
        jax_checkpoint.save_pipeline(tmp_path / "ck.npz", src)
        dst = checkpoint.load_pipeline(tmp_path / "ck.npz", device="cpu")
    for i in range(5, 9):
        src.compute(0.1 * i, scans[i])
        dst.compute(0.1 * i, scans[i])
        np.testing.assert_allclose(dst.current_pose(), src.current_pose(), rtol=0, atol=1e-9)
        assert dst.is_map_updated() == src.is_map_updated()
        assert (dst.current_id(), dst.keyframe_id()) == (src.current_id(), src.keyframe_id())


def test_assigning_state_takes_effect_on_the_next_step():
    """A state assigned after steps (copied into the static buffers) is
    the one the next scan steps from, bit for bit; the source's later
    steps do not reach it; a state of other shapes is refused."""
    src, dst = _stepped(4), _stepped(2)
    dst.state = src.state
    assert dst.state.X.data_ptr() != src.state.X.data_ptr()
    scan = _scans()[4]
    src.compute(0.4, scan)
    assert not np.array_equal(dst.current_pose(), src.current_pose())
    dst.compute(0.4, scan)
    for a, b in zip(_tensors(dst.state), _tensors(src.state)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="kf_tree"):
        dst.state = _port(num_keyframes=2).state


def test_step_graphs_on_the_cpu_step_eagerly_over_their_buffers():
    """A batch of two in StepGraphs on the CPU: every step is the eager
    body over the same buffers, and equals odometry_step on a copy."""
    pipe = _stepped(2)
    cfg = pipe.cfg
    state = init_state(cfg, "cpu", batch=2)
    graphs = StepGraphs(state, cfg.n_points, cfg.dtype)
    graphs.assign(_copy(type(state)(*(torch.cat([a, a]) if not isinstance(a, SearchTree)
                                      else SearchTree(nav=torch.cat([a.nav, a.nav]))
                                      for a in _lift(pipe.state)))))
    pts, val, _ = pipe.stage(_scans()[2])
    pts, val = torch.stack([pts, pts]), torch.stack([val, val])
    want_state, want_out = odometry_step(cfg, _copy(graphs.state), pts, val, None)
    out = graphs.step(cfg, pts, val)
    assert graphs.state is state and not graphs.captured()
    for got, want in zip(_tensors(state) + list(out), _tensors(want_state) + list(want_out)):
        assert torch.equal(got, want)
