"""The port's fleet across processes on the CPU, two ranks launched by
``python -m torch.distributed.run --standalone --nproc-per-node 2`` (gloo
over loopback TCP), against one process.

Float64, with this file run as the ranks' script (``_worker``):

- ``seq=2``: four sequences split over two ranks equal the one-process
  fleet at 1e-9 on both ranks;
- ``seq=1, kf=2``: one sequence whose two-keyframe ring is split over
  two ranks (one all-reduce a GN round) equals the unsharded
  ``Pipeline`` at 1e-9 on every rank, in plain, certified, fast and
  prefix;
- ``shard_points``: the scan's tree build split too, at 1e-6 (partial
  sums reassociate).

And ``fleet_eval`` itself (float32, as it runs) on two ranks with the
ring split, every rank within the certified float32 bound of one
process.

Sizes are those of tests/distributed_worker.py (512 points, depth 10, 2
keyframes, 3 scans). The ranks import no JAX. The rank jobs run in one
launch, every job in turn in one process group, whose poses the tests
share (computed once for every pytest-xdist worker: ``torch_shared``).

Rank script: python -m torch.distributed.run --standalone --nproc-per-node 2 \\
    tests/test_torch_distributed.py <job|all> <out_dir>
"""

import functools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_worker import DEPTH, N_POINTS, N_SCANS, N_SEQ, NUM_KF, make_scans
from madicp_tpu_torch.apps import fleet_eval
from madicp_tpu_torch.models.pipeline import Pipeline, PipelineConfig
from madicp_tpu_torch.utils.config import DatasetConfig, MADParams, dump_yaml
from madicp_tpu_torch.utils.trajectory import load_kitti_poses
from torch_shared import shared_arrays

REPO = Path(__file__).resolve().parents[1]
# the worker's scans are one cloud moved (inlier ratio 1): above 1 every
# scan promotes, so rank 1's ring slot is written at scan 1, read at scan 2
P_TH = 1.01
PIPE_KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=P_TH,
               b_min=0.1, b_ratio=0.02, num_keyframes=NUM_KF, n_points=N_POINTS,
               depth=DEPTH, max_leaves=N_POINTS)
SCHEDULES = {
    "plain": dict(certify=False),
    "certified": {},
    "fast": dict(assoc_mode="fast", reassoc_every=2),
    "prefix": dict(certify_prefix=64),
}
# job -> (seq axis, kf axis, sequences, shard_points, schedule)
JOBS = {"seq": (2, 1, N_SEQ, False, "certified"),
        "kf+points": (1, 2, 1, True, "certified"),
        **{f"kf-{s}": (1, 2, 1, False, s) for s in SCHEDULES}}
F32_BOUND_M = 5e-4  # certified f32 divergence bound (tests/test_pipeline.py:368)


def scans() -> np.ndarray:
    """(N_SCANS, N_SEQ, N_POINTS, 3) float32: the worker's scans in no
    order, as a sensor gives them (every leaf then has points on both
    ranks of a split cloud)."""
    _, points, _ = make_scans()
    rng = np.random.default_rng(3)
    points = np.stack([[scan[rng.permutation(N_POINTS)] for scan in seqs]
                       for seqs in points])
    return points.astype(np.float32)


def config(schedule: str, dtype=torch.float64) -> PipelineConfig:
    return PipelineConfig(**PIPE_KW, dtype=dtype, **SCHEDULES[schedule])


def drive_fleet(cfg, n_seq, mesh=None, shard_points=False) -> np.ndarray:
    """(N_SCANS, n_seq, 4, 4) poses of a fleet over the first ``n_seq``
    sequences."""
    from madicp_tpu_torch.parallel.fleet import Fleet

    fleet = Fleet(cfg, n_seq, mesh=mesh, shard_points=shard_points, device="cpu")
    points, poses = scans()[:, :n_seq], []
    for i in range(N_SCANS):
        fleet.compute(np.full(n_seq, 0.1 * i), points[i],
                      np.ones(points.shape[1:3], bool))
        poses.append(fleet.poses())
    return np.stack(poses)


def _worker(job: str, out: Path) -> None:
    """One rank of ``job`` (every job of :data:`JOBS` in turn for
    ``all``): writes its poses to ``out/<job>.rank<r>.npy``."""
    from madicp_tpu_torch.parallel import distributed
    from madicp_tpu_torch.parallel.mesh import make_mesh

    topo = distributed.initialize(device="cpu")
    try:
        assert topo["process_count"] == 2 and topo["backend"] == "gloo", topo
        for name in JOBS if job == "all" else [job]:
            seq, kf, n_seq, shard_points, schedule = JOBS[name]
            poses = drive_fleet(config(schedule), n_seq, make_mesh(kf=kf, seq=seq),
                                shard_points)
            np.save(out / f"{name}.rank{topo['process_index']}.npy", poses)
    finally:
        distributed.shutdown()
    assert "jax" not in sys.modules, "a rank imported JAX"


def _torchrun(*args) -> str:
    """``args`` on two ranks; their standard output."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@functools.lru_cache(maxsize=None)
def _all_jobs() -> dict:
    """{"<job>.rank<r>": poses} of every job of :data:`JOBS`, from one
    launch of two ranks."""
    with tempfile.TemporaryDirectory() as out:
        _torchrun(__file__, "all", out)
        return {f"{job}.rank{r}": np.load(Path(out) / f"{job}.rank{r}.npy")
                for job in JOBS for r in range(2)}


def _run_job(job: str, request) -> list:
    """Every rank's poses of ``job``."""
    got = shared_arrays(request, "test_torch_distributed_jobs", _all_jobs)
    return [got[f"{job}.rank{r}"] for r in range(2)]


def _pipeline_poses(schedule: str):
    """The unsharded port Pipeline on sequence 0, float64."""
    pipe = Pipeline(**PIPE_KW, dtype=torch.float64, device="cpu", **SCHEDULES[schedule])
    poses, promoted = [], []
    for i, scan in enumerate(scans()[:, 0]):
        pipe.compute(0.1 * i, scan)
        poses.append(pipe.current_pose())
        promoted.append(pipe.is_map_updated())
    return np.stack(poses), promoted


def test_seq_sharded_fleet_matches_one_process(request):
    want = drive_fleet(config("certified"), N_SEQ)
    for got in _run_job("seq", request):
        np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_kf_sharded_step_matches_pipeline_on_every_rank(request, schedule):
    want, promoted = _pipeline_poses(schedule)
    assert promoted[1], "scan 1 must promote into the slot rank 1 holds"
    for got in _run_job(f"kf-{schedule}", request):
        np.testing.assert_allclose(got[:, 0], want, atol=1e-9)


def test_points_sharded_build_matches_pipeline(request):
    want, _ = _pipeline_poses("certified")
    for got in _run_job("kf+points", request):
        np.testing.assert_allclose(got[:, 0], want, atol=1e-6)


def test_fleet_eval_on_two_ranks_matches_one_process(tmp_path):
    """The CLI's own launch: ``-m madicp_tpu_torch.apps.fleet_eval`` with
    the ring split over two ranks; every rank's ``estimate`` file within
    the float32 bound of the one-process run."""
    seq = tmp_path / "seq0"
    seq.mkdir()
    for i, scan in enumerate(scans()[:, 0]):
        np.concatenate([scan, np.ones((N_POINTS, 1), np.float32)], axis=1).tofile(
            seq / f"{i:06d}.bin")
    eye = tuple(tuple(float(x) for x in r) for r in np.eye(4))
    dump_yaml(DatasetConfig(min_range=0.0, max_range=100.0, sensor_hz=10.0,
                            deskew=False, lidar_to_base=eye), tmp_path / "dataset.yaml")
    dump_yaml(MADParams(p_th=P_TH), tmp_path / "mad.yaml")
    args = ["--data-paths", str(seq), "--dataset-config", str(tmp_path / "dataset.yaml"),
            "--mad-icp-params", str(tmp_path / "mad.yaml"), "--num-keyframes", str(NUM_KF),
            "--n-points", str(N_POINTS), "--depth", str(DEPTH),
            "--max-leaves", str(N_POINTS), "--device", "cpu", "--json"]
    stdout = _torchrun("-m", "madicp_tpu_torch.apps.fleet_eval", *args,
                       "--estimate-path", str(tmp_path / "two"),
                       "--seq-axis", "1", "--kf-axis", "2")
    summary = json.loads(stdout.strip().splitlines()[-1])
    assert summary["processes"] == 2 and summary["backend"] == "gloo"
    assert fleet_eval.main(args + ["--estimate-path", str(tmp_path / "one")]) == 0
    want = load_kitti_poses(tmp_path / "one" / "seq0" / "estimate.txt")
    for name in ("estimate.txt", "estimate.rank1.txt"):
        got = load_kitti_poses(tmp_path / "two" / "seq0" / name)
        assert got.shape == want.shape == (N_SCANS, 4, 4)
        np.testing.assert_allclose(got, want, atol=F32_BOUND_M)


if __name__ == "__main__":
    _worker(sys.argv[1], Path(sys.argv[2]))
