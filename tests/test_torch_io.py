"""The PyTorch port's IO against the JAX package's on the CPU: the ROS1,
ROS2 and MCAP readers on one fake bag (the fakes of
test_rosbag_readers.py), the native loader and the numpy reader, the
prefetcher (the cases of test_native.py), and checkpoints that cross
between the two packages in float64."""

import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_rosbag_readers as fakes
from madicp_tpu.models.pipeline import Pipeline as JaxPipeline
from madicp_tpu.native import loader as jax_loader
from madicp_tpu.utils import checkpoint as jax_checkpoint
from madicp_tpu.utils import rosbag as jax_rosbag
from madicp_tpu_torch.kernels.build import BUILD_DIR, hashed_library
from madicp_tpu_torch.models.pipeline import Pipeline, PipelineState
from madicp_tpu_torch.native import loader
from madicp_tpu_torch.native.prefetch import Prefetcher
from madicp_tpu_torch.utils import checkpoint, rosbag
from madicp_tpu_torch.utils.kitti import KittiReader, read_bin_numpy
from test_rosbag_readers import fake_mcap, fake_rosbags  # noqa: F401  (fixtures)

torch.set_num_threads(2)

READERS = {"ros1": ("Ros1Reader", "b.bag"), "ros2": ("Ros2Reader", "d.db3"),
           "mcap": ("McapReader", "log.mcap")}


@pytest.fixture
def fake_bag(request, tmp_path):
    """(format, directory) of a fake bag of the format under test, its
    dependency installed as a fake module."""
    fmt = request.param
    request.getfixturevalue("fake_mcap" if fmt == "mcap" else "fake_rosbags")
    (tmp_path / READERS[fmt][1]).touch()
    return fmt, tmp_path


def _open(module, fmt, path, **kw):
    return getattr(module, READERS[fmt][0])(path, min_range=0.5, max_range=10.0, **kw)


@pytest.mark.parametrize("fake_bag", list(READERS), indirect=True)
def test_readers_match_the_jax_readers(fake_bag):
    """Both packages' readers give bitwise-equal (stamp, points) items."""
    fmt, path = fake_bag
    with _open(jax_rosbag, fmt, path, topic="/points") as a:
        want = [a[i] for i in range(len(a))]
    with _open(rosbag, fmt, path, topic="/points") as b:
        assert len(b) == len(want) == 2
        got = [b[i] for i in range(len(b))]
    for (ts, pts), (ts_j, pts_j) in zip(got, want):
        assert ts == ts_j
        assert pts.dtype == pts_j.dtype == np.float64
        np.testing.assert_array_equal(pts, pts_j)
    np.testing.assert_allclose(got[0][1], fakes.KEPT, atol=1e-6)


@pytest.mark.parametrize("fake_bag", list(READERS), indirect=True)
def test_reader_errors_match_the_jax_readers(fake_bag):
    """Out-of-order reads and unknown topics raise what the JAX readers
    raise, word for word."""
    fmt, path = fake_bag

    def errors(module):
        out = []
        with _open(module, fmt, path, topic="/points") as r:
            for i in (1, 0, 0):
                try:
                    r[i]
                except IndexError as e:
                    out.append(str(e))
        with pytest.raises(ValueError) as e:
            _open(module, fmt, path, topic="/nope")
        return out + [str(e.value)]

    got = errors(rosbag)
    assert got == errors(jax_rosbag)
    assert "sequential" in got[0] and "next readable index is 1" in got[1]
    assert "/points" in got[2]


@pytest.mark.parametrize("fmt", list(READERS))
def test_reader_missing_dependency_message_matches(fmt, tmp_path):
    if {"rosbags", "mcap"} & set(sys.modules):
        pytest.skip("a real rosbags or mcap is installed")

    def message(module):
        with pytest.raises(ImportError) as e:
            _open(module, fmt, tmp_path, topic="/points")
        return str(e.value)

    got = message(rosbag)
    assert got == message(jax_rosbag)
    assert ("rosbags" if fmt != "mcap" else "mcap") in got


def _write_bins(dirpath, rng, n_files=3, n=5000):
    for i in range(n_files):
        pts = rng.normal(scale=30.0, size=(n, 3))
        pts[::17] = np.nan  # NaN records must be dropped
        pts[::23, :2] = 0.0  # on the z axis: no correction axis
        rec = np.concatenate([pts, rng.random((n, 1))], axis=1).astype(np.float32)
        rec.tofile(dirpath / f"{i:06d}.bin")
    return sorted(dirpath.glob("*.bin"))


@pytest.fixture
def bin_dir(tmp_path, rng):
    _write_bins(tmp_path, rng)
    return tmp_path


@pytest.mark.parametrize("correct", [False, True])
def test_native_loader_matches_the_jax_loader_and_numpy(bin_dir, correct):
    """The port's C++ loader, the JAX package's (the same source) and the
    port's numpy reader are bitwise equal. The JAX numpy reader agrees
    bitwise without the correction; with it, its np.radians(0.205) is one
    ulp off the C++ constant and it scales on-axis points by cos, so it
    is held to the JAX suite's 1e-12 away from the z axis."""
    assert loader.available() and jax_loader.available()
    from madicp_tpu.utils.kitti import apply_vertical_correction as jax_correction

    for f in sorted(bin_dir.glob("*.bin")):
        got = loader.read_bin(f, 2.0, 80.0, apply_correction=correct)
        np.testing.assert_array_equal(got, jax_loader.read_bin(f, 2.0, 80.0, correct))
        np.testing.assert_array_equal(got, read_bin_numpy(f, np.float32, 2.0, 80.0, correct))
        raw = read_bin_numpy(f, np.float32, 2.0, 80.0, False)
        if not correct:
            np.testing.assert_array_equal(got, raw)
            continue
        off_axis = np.any(raw[:, :2] != 0, axis=1)
        assert (~off_axis).any() and np.array_equal(got[~off_axis], raw[~off_axis])
        np.testing.assert_allclose(got[off_axis], jax_correction(raw[off_axis]),
                                   rtol=0, atol=1e-12)


def test_native_library_is_built_outside_the_package():
    assert loader.available()
    so = hashed_library(loader._SRC, loader.GXX_FLAGS)
    assert so.exists() and so.parent == BUILD_DIR
    assert BUILD_DIR.parts[-2:] == ("build", "madicp_tpu_torch")
    assert not list(so.parents[2].joinpath("madicp_tpu_torch", "native").glob("*.so"))


def test_kitti_reader_uses_native(bin_dir):
    r = KittiReader(bin_dir, min_range=2.0, max_range=80.0, sensor_hz=10.0)
    assert r._native is loader
    with r:
        items = list(r)
    assert [ts for ts, _ in items] == pytest.approx([0.1, 0.2, 0.3])
    for (_, pts), f in zip(items, sorted(bin_dir.glob("*.bin"))):
        np.testing.assert_array_equal(pts, read_bin_numpy(f, np.float32, 2.0, 80.0, False))


def test_prefetcher_matches_reader(bin_dir):
    plain = list(KittiReader(bin_dir, 2.0, 80.0, sensor_hz=10.0))
    with Prefetcher(KittiReader(bin_dir, 2.0, 80.0, sensor_hz=10.0)) as pf:
        fetched = list(pf)
    assert len(fetched) == len(plain) == 3
    for (t0, p0), (t1, p1) in zip(plain, fetched):
        assert t0 == t1
        np.testing.assert_array_equal(p0, p1)


def test_prefetcher_propagates_errors():
    class Boom:
        def __iter__(self):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        with Prefetcher(Boom()) as pf:
            list(pf)


def test_prefetcher_early_exit_clean(bin_dir):
    """Breaking out of iteration stops and joins the producer without
    draining the dataset or leaking a blocked thread."""
    pf = Prefetcher(KittiReader(bin_dir, 2.0, 80.0, sensor_hz=10.0), depth=1)
    with pf:
        for _ in pf:
            break
    assert pf._thread is not None and not pf._thread.is_alive()


def test_prefetcher_transform_runs_on_producer():
    """The transform stages items on the producer thread; with
    ``Pipeline.stage`` it pads and copies each scan to the pipeline's
    device there."""
    main_thread = threading.get_ident()
    seen = []
    pipe = Pipeline(**dict(_PIPE_KW, dtype=torch.float64), device="cpu")

    def xf(item):
        seen.append(threading.get_ident())
        return (item[0], *pipe.stage(item[1]))

    items = [(0.1 * i, np.full((5, 3), float(i))) for i in range(5)]
    with Prefetcher(iter(items), transform=xf) as pf:
        out = list(pf)
    assert [ts for ts, *_ in out] == [ts for ts, _ in items]
    for (_, pts, valid, dropped), (_, cloud) in zip(out, items):
        assert pts.shape == (_PIPE_KW["n_points"], 3) and pts.dtype == torch.float64
        np.testing.assert_array_equal(pts[:5].numpy(), cloud)
        assert int(valid.sum()) == 5 and dropped == 0
    assert seen and all(t != main_thread for t in seen)


# --------------------------------------------------------------------------
# checkpoints (float64, one tiny configuration for both packages)

_PIPE_KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8,
                b_min=0.1, b_ratio=0.02, num_keyframes=2,
                n_points=2048, depth=10, max_leaves=1024)


@pytest.fixture(scope="module")
def scans():
    rng = np.random.default_rng(7)
    from conftest import four_walls_cloud

    room = four_walls_cloud(rng, points_per_wall=300)
    return [room - [0.05 * i, 0.02 * i, 0.0] + rng.normal(0, 0.002, room.shape)
            for i in range(6)]


def _port(**kw):
    return Pipeline(**dict(_PIPE_KW, dtype=torch.float64, **kw), device="cpu")


def _jax(**kw):
    return JaxPipeline(**dict(_PIPE_KW, dtype=jnp.float64, **kw))


def _state_arrays(state):
    return [np.asarray(getattr(state, n).nav if n.endswith("_tree") else getattr(state, n))
            for n in state._fields]


def test_port_checkpoint_resumes_bitwise(tmp_path, scans):
    pipe = _port()
    for i in range(3):
        pipe.compute(0.1 * i, scans[i])
    checkpoint.save_pipeline(tmp_path / "ck.npz", pipe)
    resumed = checkpoint.load_pipeline(tmp_path / "ck.npz", device="cpu")
    assert resumed.current_id() == 3 and resumed._initialized
    for i in range(3, 6):
        pipe.compute(0.1 * i, scans[i])
        resumed.compute(0.1 * i, scans[i])
    for a, b in zip(_state_arrays(pipe.state), _state_arrays(resumed.state)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_between_the_packages(tmp_path, scans, writer):
    """A checkpoint written by one package resumes in the other: three
    scans, save, load in the other package, three more scans in both,
    within 1e-9 (float64)."""
    src = _jax() if writer == "jax" else _port()
    for i in range(3):
        src.compute(0.1 * i, scans[i])
    if writer == "jax":
        jax_checkpoint.save_pipeline(tmp_path / "ck.npz", src)
        dst = checkpoint.load_pipeline(tmp_path / "ck.npz", device="cpu")
        assert dst.cfg == _port().cfg
    else:
        checkpoint.save_pipeline(tmp_path / "ck.npz", src)
        dst = jax_checkpoint.load_pipeline(tmp_path / "ck.npz")
        assert dst.cfg == _jax().cfg
    assert dst.current_id() == 3 and dst.realtime == src.realtime
    for want, got in zip(_state_arrays(src.state), _state_arrays(dst.state)):
        np.testing.assert_array_equal(want, got)
    for i in range(3, 6):
        src.compute(0.1 * i, scans[i])
        dst.compute(0.1 * i, scans[i])
        np.testing.assert_allclose(dst.current_pose(), src.current_pose(), rtol=0, atol=1e-9)
        assert dst.inlier_ratio() == pytest.approx(src.inlier_ratio(), abs=1e-12)
        assert (dst.current_id(), dst.keyframe_id()) == (src.current_id(), src.keyframe_id())


def test_background_save_holds_the_state_as_of_the_save(tmp_path, scans, monkeypatch):
    """The step updates the rings in place, and on the CPU ``.cpu()`` is
    the same storage: the writer, held back until the next step has
    run, still writes the state as of the save."""
    pipe = _port()
    for i in range(3):
        pipe.compute(0.1 * i, scans[i])
    before = [a.copy() for a in _state_arrays(pipe.state)]
    stepped = threading.Event()
    savez = np.savez

    def late_savez(*a, **k):
        assert stepped.wait(60)
        savez(*a, **k)

    monkeypatch.setattr(np, "savez", late_savez)
    writer = checkpoint.save_pipeline(tmp_path / "ck.npz", pipe, background=True)
    assert isinstance(writer, threading.Thread)
    pipe.compute(0.3, scans[3])
    stepped.set()
    writer.join(60)
    assert not writer.is_alive()
    ring = PipelineState._fields.index("fr_tree")
    assert not np.array_equal(before[ring], _state_arrays(pipe.state)[ring])  # in place
    with np.load(tmp_path / "ck.npz") as z:
        for i, want in enumerate(before):
            np.testing.assert_array_equal(z[f"leaf_{i}"], want)


@pytest.mark.parametrize("case", ["config", "realtime_ceiling", "schedule"])
def test_checkpoint_preserves_config(tmp_path, scans, case):
    """The cases of test_checkpoint_eval.py: the config, the realtime
    ceiling and cadence, and the association schedule survive a save and
    load; the config also reads back in the JAX package."""
    kw = {"config": {},
          "realtime_ceiling": dict(realtime=True, max_icp_iterations=9,
                                   realtime_recal_every=5),
          "schedule": dict(assoc_mode="fast", reassoc_every=5, reassoc_backup=3)}[case]
    pipe = _port(**kw)
    pipe.compute(0.0, scans[0])
    if case == "realtime_ceiling":  # a post-spike state: the budget shrunk
        pipe.cfg = dataclasses.replace(pipe.cfg, max_icp_iterations=2)
    checkpoint.save_pipeline(tmp_path / "ck.npz", pipe)
    resumed = checkpoint.load_pipeline(tmp_path / "ck.npz", device="cpu")
    assert resumed.cfg == pipe.cfg and resumed.realtime == pipe.realtime
    assert (resumed._rt_its_max, resumed._rt_every) == (pipe._rt_its_max, pipe._rt_every)
    if case == "realtime_ceiling":
        assert resumed.cfg.max_icp_iterations == 2 and resumed._rt_its_max == 9
        assert resumed._rt_every == 5
    j = jax_checkpoint.load_pipeline(tmp_path / "ck.npz")
    want = dataclasses.asdict(pipe.cfg)
    got = dataclasses.asdict(j.cfg)
    assert str(want.pop("dtype")).split(".")[-1] == np.dtype(got.pop("dtype")).name
    assert got == want
    assert (j._rt_its_max, j._rt_every, j.realtime) == (
        pipe._rt_its_max, pipe._rt_every, pipe.realtime)
