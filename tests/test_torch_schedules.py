"""The port's fast, compact and prefix schedules, ``compute_batch`` and the
bench entry point on the CPU.

The schedules run the same scans through the JAX ``Pipeline`` and the
port's, in float64, at the size of tests/test_pipeline.py::
test_compute_batch_matches_sequential (2048 points, depth 10, 6 rounds, 2
keyframes, ``synthetic_room_scans``). ``compute_batch`` is held to the
port's own sequential ``compute`` bit for bit (its JAX counterpart is a
``lax.scan`` over the same step, which test_pipeline.py holds to
sequential JAX); the bench runs at a tiny configuration.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madicp_tpu_torch.models.pipeline as pipeline_mod
from madicp_tpu.models.pipeline import Pipeline as JaxPipeline
from madicp_tpu_torch import bench
from madicp_tpu_torch.models.pipeline import Pipeline
from tests_fixtures_helper import synthetic_room_scans

torch.set_num_threads(2)

KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8,
          b_min=0.1, b_ratio=0.02, num_keyframes=2, n_points=2048, depth=10,
          max_icp_iterations=6)


def _scans(n=6):
    return synthetic_room_scans(np.random.default_rng(42), n_scans=n, step=0.06)[0]


def _drive(pipe):
    poses, descents, ratios = [], [], []
    for i, scan in enumerate(_scans()):
        pipe.compute(0.1 * i, scan)
        poses.append(pipe.current_pose())
        descents.append(pipe.descents())
        ratios.append(pipe.inlier_ratio())
    return np.stack(poses), descents, ratios


def _port(**sched):
    return _drive(Pipeline(**{**KW, **sched}, dtype=torch.float64, device="cpu"))


@functools.lru_cache(maxsize=None)
def _port_cached(certify: bool):
    return _port(certify=certify)


def _jax(**sched):
    return _drive(JaxPipeline(**{**KW, **sched}, dtype=jnp.float64))


@pytest.mark.parametrize("sched", [
    dict(reassoc_every=2, reassoc_backup=0),
    dict(reassoc_every=2, reassoc_backup=6),
    dict(max_icp_iterations=1),
], ids=["every2", "every2-warm6", "one-round"])
def test_fast_schedule_matches_jax(sched):
    """Per scan: pose within 1e-8 of the JAX fast schedule, the same
    (static) descent count and the same inlier ratio."""
    poses, descents, ratios = _port(assoc_mode="fast", **sched)
    j_poses, j_descents, j_ratios = _jax(assoc_mode="fast", **sched)
    np.testing.assert_allclose(poses, j_poses, rtol=0, atol=1e-8)
    assert descents == j_descents
    assert ratios == j_ratios


@pytest.fixture
def buffered_calls(monkeypatch):
    """The ``need`` masks of every association call whose queries are a
    buffer followed by a full sweep, (K, U + L)."""
    seen = []
    real = pipeline_mod.associate_ring

    def spy(nav, depth, pts, need, **kw):
        seen.append(need.clone())
        return real(nav, depth, pts, need, **kw)

    monkeypatch.setattr(pipeline_mod, "associate_ring", spy)
    return seen


def _branches(calls, U, L):
    """(buffer entries descended, sweep entries descended) over the
    calls of a drive with a (K, U + L) buffer."""
    calls = [n for n in calls if n.shape[1] == U + L]
    assert calls, "no buffered association call"
    return sum(int(n[:, :U].sum()) for n in calls), sum(int(n[:, U:].sum()) for n in calls)


@pytest.mark.parametrize("knob", ["certify_compact", "certify_prefix"])
@pytest.mark.parametrize("U", [16, 512])
def test_certified_variants_match_jax_and_plain_exact(knob, U, buffered_calls):
    """compact and prefix certified: per-scan pose within 1e-9 of the JAX
    run of the same schedule and of the port's plain exact, the JAX
    inlier ratios; compact walks the port's certified descents, prefix
    the JAX prefix schedule's. At U = 16 keyframes overflow the buffer;
    at U = 512 the buffer takes them: both branches run."""
    poses, descents, ratios = _port(**{knob: U})
    L = Pipeline(**KW, device="cpu").cfg.leaves_cap
    in_buf, in_sweep = _branches(buffered_calls, U, L)
    assert in_sweep > 0 if U == 16 else in_buf > 0
    j_poses, j_descents, j_ratios = _jax(**{knob: U})
    exact, exact_descents, _ = _port_cached(False)
    np.testing.assert_allclose(poses, j_poses, rtol=0, atol=1e-9)
    np.testing.assert_allclose(poses, exact, rtol=0, atol=1e-9)
    assert ratios == j_ratios
    if knob == "certify_compact":
        assert descents == _port_cached(True)[1]
    else:
        assert descents == j_descents
    assert 0 < sum(descents) < sum(exact_descents)


def test_compute_batch_matches_sequential_compute():
    """A chunk from the first scan, and a chunk after two single scans,
    give the sequential drive's poses bit for bit; the accessors hold the
    chunk's last scan and the dropped points sum over the chunk."""
    clouds = _scans(5)
    clouds[3] = np.concatenate([clouds[3], clouds[3][:700]])  # 2200 > 2048 points
    stamps = [0.1 * i for i in range(5)]
    seq = Pipeline(**KW, dtype=torch.float64, device="cpu")
    poses = []
    for stamp, cloud in zip(stamps, clouds):
        seq.compute(stamp, cloud)
        poses.append(seq.current_pose())
    poses = np.stack(poses)

    chunk = Pipeline(**KW, dtype=torch.float64, device="cpu")
    got = chunk.compute_batch(stamps, clouds)
    assert got.shape == (5, 4, 4)
    np.testing.assert_allclose(got, poses, rtol=0, atol=0)
    assert chunk.current_id() == seq.current_id() == 5
    assert chunk.inlier_ratio() == seq.inlier_ratio()
    assert chunk.keyframe_id() == seq.keyframe_id()
    assert chunk.points_dropped() == 2200 - 2048
    assert chunk._rt_scans == 5

    later = Pipeline(**KW, dtype=torch.float64, device="cpu")
    for stamp, cloud in zip(stamps[:2], clouds[:2]):
        later.compute(stamp, cloud)
    np.testing.assert_allclose(later.compute_batch(stamps[2:], clouds[2:]), poses[2:],
                               rtol=0, atol=0)
    np.testing.assert_allclose(later.state.velocity.numpy(), seq.state.velocity.numpy(),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        later.compute_batch([0.0, 0.1], clouds[:1])


def test_compute_batch_refuses_uncalibrated_realtime():
    p = Pipeline(**KW, realtime=True, device="cpu")
    with pytest.raises(RuntimeError, match="realtime"):
        p.compute_batch([0.0, 0.1], _scans(2))
    assert p.current_id() == 0


@pytest.mark.parametrize("spec,want,name", [
    ("exact", dict(certify=False), "exact"),
    ("certified", dict(certify=True), "certified"),
    ("compact", dict(certify=True, certify_compact=4096), "compact:4096"),
    ("compact:64", dict(certify=True, certify_compact=64), "compact:64"),
    ("prefix", dict(certify=True, certify_prefix=8192), "prefix:8192"),
    ("fast", dict(assoc_mode="fast", reassoc_every=7), "fast"),
    ("fast:3", dict(assoc_mode="fast", reassoc_every=3), "fast"),
])
def test_bench_schedule_specs(spec, want, name):
    """bench.py's spec grammar, and the headline name of the config each
    spec selects."""
    kw = bench.schedule_kwargs(spec)
    assert {k: kw[k] for k in want} == want
    assert bench.default_schedule_name(pipeline_mod.PipelineConfig(**kw)) == name


def test_bench_rejects_unknown_specs():
    for spec in ("bogus", "exact:3", "certified:2"):
        with pytest.raises(SystemExit):
            bench.schedule_kwargs(spec)


def test_bench_runs_on_the_cpu_and_prints_its_json_line(monkeypatch, capsys):
    """The bench entry point at a tiny configuration on ``--device cpu``,
    one window: its last line carries bench.py's keys, every default
    schedule, each window's rate and their median."""
    for name, value in dict(BENCH_N_POINTS=2048, BENCH_DEPTH=8, BENCH_KEYFRAMES=2,
                            BENCH_MAX_LEAVES=256, BENCH_WARMUP=1, BENCH_STEPS=1,
                            BENCH_WINDOWS=1).items():
        monkeypatch.setenv(name, str(value))
    monkeypatch.delenv("BENCH_SCHEDULES", raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "baseline", "schedule", "dtype",
            "n_descents", "schedules"} <= set(line)
    assert line["metric"] == "odometry_scans_per_sec" and line["unit"] == "scans/s"
    assert line["schedule"] == "certified" and line["dtype"] == "float32"
    assert line["vs_baseline"] == pytest.approx(line["value"] / 10.0)
    assert list(line["schedules"]) == ["certified", "exact", "prefix:8192", "compact:4096",
                                       "fast"]
    for spec, r in line["schedules"].items():
        assert len(r["windows"]) == 1 and r["median_scans_per_sec"] == r["windows"][0] > 0
        assert r["descents"] > 0 and r["descent_queries_per_scan"] >= r["descents"]
    assert line["n_descents"] == line["schedules"]["certified"]["descents"]
