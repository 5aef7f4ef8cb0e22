"""The PyTorch port's apps against the JAX package's on the CPU: the
evaluator, the two demos, the visualizer under the fake open3d of
test_visualizer.py, and the CLI on ROS1 and MCAP bags (the fakes of
test_rosbag_readers.py) and through a checkpoint and resume."""

import json
import time

import numpy as np
import pytest
import torch

import test_rosbag_readers as fakes
from madicp_tpu.apps import evaluate as jax_evaluate
from madicp_tpu_torch.apps import cli, evaluate, mad_registration, nn_search
from madicp_tpu_torch.utils.config import DATASET_CONFIGS, dump_yaml
from madicp_tpu_torch.utils.trajectory import load_kitti_poses, save_kitti_poses
from test_checkpoint_eval import _trajectory
from test_rosbag_readers import fake_mcap, fake_rosbags  # noqa: F401  (fixtures)
from test_visualizer import fake_o3d  # noqa: F401  (fixture)
from tests_fixtures_helper import synthetic_room_scans

torch.set_num_threads(2)


@pytest.mark.parametrize("step,lengths,align", [
    (1.0, None, True), (1.01, None, True), (1.01, [5.0, 10.0], False)])
def test_evaluate_matches_jax(tmp_path, capsys, step, lengths, align):
    """Both packages score a drifting trajectory alike: the same numbers
    and the same JSON line."""
    save_kitti_poses(tmp_path / "gt.txt", _trajectory(250, step=1.0, yaw_rate=0.001))
    save_kitti_poses(tmp_path / "est.txt", _trajectory(250, step=step, yaw_rate=0.001))
    paths = (tmp_path / "est.txt", tmp_path / "gt.txt")
    got = evaluate.evaluate(*paths, align=align, lengths=lengths)
    assert got == jax_evaluate.evaluate(*paths, align=align, lengths=lengths)
    argv = ["--estimate", str(paths[0]), "--ground-truth", str(paths[1]), "--json"]
    argv += ["--no-align"] if not align else []
    argv += ["--segment-lengths", *map(str, lengths)] if lengths else []
    capsys.readouterr()
    assert evaluate.main(argv) == 0
    line = capsys.readouterr().out
    assert jax_evaluate.main(argv) == 0
    assert line == capsys.readouterr().out
    assert json.loads(line)["poses"] == 250
    missing = ["--estimate", str(tmp_path / "nope.txt"), "--ground-truth", str(paths[1])]
    assert evaluate.main(missing) == jax_evaluate.main(missing) == -1


def test_nn_search_demo_matches_every_point_to_itself():
    """The error is exactly the float32 rounding of the cloud (each point
    matched itself), as in the JAX demo."""
    from madicp_tpu.apps import nn_search as jax_nn_search
    from madicp_tpu_torch.utils.fixtures import generate_four_walls_pointcloud

    err = nn_search.main(points_per_wall=200, seed=42, device="cpu")
    np.random.seed(42)
    cloud = generate_four_walls_pointcloud(points_per_wall=200)
    rounding = np.sum(np.linalg.norm(cloud.astype(np.float32).astype(np.float64) - cloud,
                                     axis=1))
    assert err == rounding == jax_nn_search.main(points_per_wall=200, seed=42)


def test_mad_registration_demo_matches_jax():
    """The reference demo configuration recovers identity within the JAX
    test's 5e-3, and the port's estimate is within 1e-5 of the JAX demo's
    (both float32, from the same guess)."""
    from madicp_tpu.apps import mad_registration as jax_mad_registration

    T = mad_registration.main(points_per_wall=1000, seed=42, device="cpu")
    np.testing.assert_allclose(T, np.eye(4), atol=5e-3)
    np.testing.assert_allclose(T, jax_mad_registration.main(points_per_wall=1000, seed=42),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(mad_registration._euler_xyz_matrix(0.1, 0.1, 0.1),
                               jax_mad_registration._euler_xyz_matrix(0.1, 0.1, 0.1),
                               rtol=0, atol=1e-15)


def _normalised(log):
    """The recorded open3d calls with geometry objects replaced by their
    drawn state, comparable across the two packages."""
    def norm(v):
        if hasattr(v, "ctor_args"):
            return ("geometry", type(v).__name__, *(norm(getattr(v, a, None)) for a in (
                "points", "lines", "colors", "color", "transform_applied", "radius")))
        if isinstance(v, np.ndarray):
            return ("array", v.dtype.str, v.shape, v.tobytes())
        if isinstance(v, (list, tuple)):
            return tuple(norm(x) for x in v)
        if callable(v):
            return ("callback", v.__name__)
        return v

    return [(name, norm(args), tuple(sorted((k, norm(x)) for k, x in kw.items())))
            for name, args, kw in log]


def test_visualizer_records_the_jax_calls(fake_o3d):
    """The same scene, marker and trajectory calls as the JAX visualizer
    on the same inputs."""
    from madicp_tpu.utils.visualizer import Visualizer as JaxVisualizer
    from madicp_tpu_torch.utils.visualizer import Visualizer

    rng = np.random.default_rng(0)
    frames = []
    for i in range(4):
        pose = np.eye(4)
        pose[:3, 3] = [0.1 * i, 0.02 * i, 0.0]
        promoted = i % 2 == 0
        frames.append((rng.normal(size=(50, 3)),
                       rng.normal(size=(80, 3)) if promoted else None,
                       pose, pose if promoted else None))

    def drive(cls):
        fake_o3d.clear()
        v = cls("test")
        assert v.enabled
        for frame in frames:
            v.update(*frame)
        v.close()
        assert len(v._traj_pts) == 4 and len(v._kf_poses) == 2
        return _normalised(fake_o3d)

    got = drive(Visualizer)
    assert got == drive(JaxVisualizer)
    names = [n for n, _, _ in got]
    assert names.count("create_sphere") == 2 and "destroy_window" in names


def test_visualizer_runs_headless_without_open3d(capsys):
    from madicp_tpu_torch.utils.visualizer import Visualizer

    v = Visualizer()
    assert not v.enabled and "headless" in capsys.readouterr().out
    v.update(np.zeros((3, 3)), None, np.eye(4), np.eye(4))
    v.close()
    assert len(v._traj_pts) == len(v._kf_poses) == 1


def test_mad_registration_viz_draws_match_lines(fake_o3d, monkeypatch):
    """The JAX test's checks on the port: one line set of match lines a
    ICP iteration, each from a moved point to its match."""
    monkeypatch.setattr(time, "sleep", lambda s: None)
    T = mad_registration.main(points_per_wall=60, seed=42, viz=True, device="cpu")
    np.testing.assert_allclose(T, np.eye(4), atol=5e-3)
    names = [n for n, _, _ in fake_o3d]
    assert names.count("remove_geometry") == mad_registration.MAX_ITERATIONS - 1
    line_sets = [a[0] for n, a, _ in fake_o3d
                 if n == "add_geometry" and getattr(a[0], "lines", None) is not None]
    assert len(line_sets) == mad_registration.MAX_ITERATIONS
    n = 60 * 5
    assert line_sets[-1].ctor_args[1]["points"].shape == (2 * n, 3)
    np.testing.assert_array_equal(line_sets[-1].ctor_args[1]["lines"][0], [0, n])
    assert "run" in names and "destroy_window" in names


# --------------------------------------------------------------------------
# the CLI

CLI_SIZE = ["--n-points", "2048", "--depth", "11", "--device", "cpu", "--noviz"]


@pytest.fixture(scope="module")
def room():
    scans, _ = synthetic_room_scans(np.random.default_rng(42), n_scans=4,
                                    n_points=1000, step=0.05)
    return scans


@pytest.fixture(scope="module")
def kitti_run(room, tmp_path_factory):
    """The scans as a KITTI .bin directory, a dataset config (identity
    extrinsics, topic /points) and the CLI's estimate of the directory."""
    d = tmp_path_factory.mktemp("kitti")
    (d / "seq").mkdir()
    for i, s in enumerate(room):
        rec = np.zeros((len(s), 4), np.float32)
        rec[:, :3] = s
        rec.tofile(d / "seq" / f"{i:06d}.bin")
    cfg = d / "ds.cfg"
    dump_yaml(DATASET_CONFIGS["vbr_os0"], cfg)
    cfg.write_text(cfg.read_text().replace("/ouster/points", "/points"))
    assert cli.main(["--data-path", str(d / "seq"), "--estimate-path", str(d / "out"),
                     "--dataset-config", str(cfg), *CLI_SIZE]) == 0
    return d, cfg, load_kitti_poses(d / "out" / "estimate.txt")


@pytest.mark.parametrize("fmt", ["ros1", "mcap"])
def test_cli_reads_bags_end_to_end(request, tmp_path, monkeypatch, room, kitti_run, fmt):
    """A bag of the scans gives the KITTI directory's trajectory, bit for
    bit: after the reader, both paths see the same float64 points."""
    _, cfg, want = kitti_run
    msgs = [fakes.make_pc2_msg(s, stamp_s=0.1 * (i + 1)) for i, s in enumerate(room)]
    if fmt == "ros1":
        bags = request.getfixturevalue("fake_rosbags")
        bags.RECORDS = [("/other", 5, fakes.make_pc2_msg(room[0][:10]))] + [
            ("/points", int(1e8) * (i + 1), m) for i, m in enumerate(msgs)]
        (tmp_path / "seq.bag").touch()
    else:
        request.getfixturevalue("fake_mcap")
        monkeypatch.setattr(fakes, "_MCAP_MSGS", msgs)
        (tmp_path / "seq.mcap").touch()
    out = tmp_path / "out"
    assert cli.main(["--data-path", str(tmp_path), "--estimate-path", str(out),
                     "--dataset-config", str(cfg), *CLI_SIZE]) == 0
    got = load_kitti_poses(out / "estimate.txt")
    assert got.shape == (4, 4, 4)
    np.testing.assert_array_equal(got, want)


def test_cli_checkpoint_resume_matches_uninterrupted(tmp_path, kitti_run, monkeypatch, capsys):
    """The scenario of test_apps.py::test_cli_checkpoint_resume:
    interrupted at 3 scans with the checkpoint at scan 2, then resumed;
    the resume truncates the extra pose and the trajectory is bit for bit
    the uninterrupted one's. The resume stages only the scans it runs,
    and each run prints its wall-clock rate after its first scan."""
    from madicp_tpu_torch.models.pipeline import Pipeline

    d, cfg, want = kitti_run
    base = ["--data-path", str(d / "seq"), "--estimate-path", str(tmp_path),
            "--dataset-config", str(cfg), *CLI_SIZE]
    assert cli.main(base + ["--checkpoint-every", "2", "--max-scans", "3"]) == 0
    assert "\n2 scans after the first in " in capsys.readouterr().out
    assert (tmp_path / "pipeline.ckpt.npz").exists()
    assert len(open(tmp_path / "estimate.txt").readlines()) == 3
    staged = []
    stage = Pipeline.stage
    monkeypatch.setattr(Pipeline, "stage", lambda self, pts: staged.append(1) or stage(self, pts))
    assert cli.main(base + ["--resume"]) == 0
    assert len(staged) == 2  # scans 3 and 4; scans 1 and 2 are skipped unstaged
    assert "\n1 scans after the first in " in capsys.readouterr().out
    got = load_kitti_poses(tmp_path / "estimate.txt")
    assert got.shape == (4, 4, 4)
    np.testing.assert_array_equal(got, want)
