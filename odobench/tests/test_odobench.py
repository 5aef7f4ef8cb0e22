"""CPU tests of the benchmark's harness (``python -m pytest odobench/tests``).

The tests that need a card are marked ``cuda`` and decide inside the
test whether one is there. Small cells for the CPU are written into a
temporary copy of the benchmark's folder, beside a ``BENCHMARK.json`` of
their own: the same code paths as the cells of the repository's
``BENCHMARK.json``, at sizes the CPU runs in seconds.
"""

from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from odobench import costs, reference, run, trace, traffic
from odobench.loader import ROOT, Loader

REPO = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "madicp_tpu"}

TINY_ASSUMED = dict(scan_points=6000, n_points=8192, depth=10, max_leaves=0)
TINY_LIMITS = dict(reference_scans=6, tie_margin=0.001,
                   limits=dict(trans_gap_m=0.05, rot_gap_rad=0.01, ratio_gap=0.05,
                               promote_mismatches=0, step_gap_mean_m=0.05))


def tiny_bench(tmp_path: Path, loop: str = "cli", config: str = "kitti_hdl64") -> Loader:
    """A copy of the benchmark's folder with one small cell, ``tiny.cell``
    (4 keyframes, 6,000 points a scan; three sequences in the fleet)."""
    root = tmp_path / "odobench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / f"{config}.json").read_text())
    cfg["num_keyframes"] = 4
    cfg["assumed"].update(TINY_ASSUMED)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traf = dict(loop=loop, sequences=3 if loop == "fleet" else 1, speed_m_s=3.0, lap_scans=300,
                world=dict(density=0.3, margin_m=30, wall_spacing_m=10, wall_height_m=6))
    (root / "traffic" / "tiny.json").write_text(json.dumps(traf))
    (root / "limits" / "tiny.cell.json").write_text(json.dumps(TINY_LIMITS))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny.cell", config="tiny", traffic="tiny", chips=1,
                                   why="a small cell for the CPU"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return Loader(root)


def tiny_run(loader: Loader, **kw) -> dict:
    torch.manual_seed(0)
    return run.run_cell("tiny.cell", 2**31 + 11, 0.2, False, device="cpu", loader=loader, **kw)


# ------------------------------------------------------------- the layout --
def test_every_cell_finds_its_files_by_name():
    loader = Loader()
    bench = loader.benchmark()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (REPO / c["file"]).resolve() == ROOT / "configs" / f"{c['name']}.json"
        assert loader.config(c["name"])["source"] == c["source"]
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        assert loader.traffic(w["traffic"])["loop"] in ("cli", "fleet")
        limits = loader.limits(w["name"])
        assert limits["reference_scans"] >= 1 and limits["limits"]
        for trace_on in (False, True):
            for m in loader.metrics(w["name"], trace_on):
                assert callable(loader.reader(m["name"]))
    layers = {lay for _, lay in loader.kernel_layers()}
    assert layers == {"deskew", "build", "association", "terms", "tail"}
    assert bench["command"] == ["python3", "-m", "odobench"] and bench["paths"] == ["odobench"]


def test_new_files_add_a_configuration_cell_metric_and_kernel_layer(tmp_path):
    loader = tiny_bench(tmp_path)
    root = loader.root
    (root / "metrics" / "host.scan_count.py").write_text(
        "def read(run):\n    return float(run.scans)\n")
    (root / "kernels" / "zz_probe.json").write_text(
        json.dumps({"pattern": "probe_only_kernel", "layer": "probe"}))
    bench = loader.benchmark()
    bench["per_layer"].append(dict(name="host.scan_count", unit="scans", better="higher",
                                   source="program_counter", layer="host API",
                                   moves="scans_per_s", workloads=["tiny.cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny_run(loader)
    names = [m["name"] for m in loader.metrics("tiny.cell", True)]
    assert "host.scan_count" in names
    assert loader.reader("host.scan_count")(out["run"]) == out["run"].scans > 0
    assert ("probe" in {lay for _, lay in loader.kernel_layers()})
    assert "host.scan_count" not in [m["name"] for m in loader.metrics("kitti.cli", True)]


# ------------------------------------------------------------ the metrics --
def synthetic_run(latency_ms, window_s):
    r = run.Run("w", {}, 1)
    r.latency_ms, r.window_s, r.scans = list(latency_ms), window_s, len(latency_ms)
    return r


def test_rate_is_every_scan_over_the_whole_window_and_p95_every_scan():
    # 95 scans of 2 ms, then a stall: 5 scans of 400 ms. The window holds
    # them all (2.19 s): the rate is not the best chunk's 500 scans/s, and
    # the tail holds the stall.
    lat = [2.0] * 95 + [400.0] * 5
    r = synthetic_run(lat, window_s=sum(lat) / 1e3)
    rate = Loader().reader("scans_per_s")(r)
    assert rate == pytest.approx(100 / 2.19)
    p95 = Loader().reader("scan_latency_p95_ms")(r)
    assert p95 == pytest.approx(np.percentile(lat, 95)) and p95 > 2.0


def test_idle_share_is_taken_against_the_sub_windows_own_wall_time():
    window = (1000.0, 1100.0)
    records = [("a_kernel", 950.0, 990.0),       # in the padding: left out
               ("a_kernel", 1010.0, 1020.0),
               ("b_kernel", 1015.0, 1030.0),     # overlaps: the union counts
               ("Memcpy HtoD (Pageable -> Device)", 1040.0, 1050.0),
               ("a_kernel", 1095.0, 1120.0)]     # clipped at the window's end
    assert trace.busy_us(records, window) == pytest.approx(35.0)
    r = run.Run("w", {}, 1)
    r.trace = {"device": records, "spans": [], "window": window}
    assert Loader().reader("device.idle_pct")(r) == pytest.approx(65.0)
    gaps = trace.idle_gaps(records, [("odobench.current_pose", 1050.0, 1095.0)], window)
    assert gaps[0] == ["odobench.current_pose", pytest.approx(45e-6)]


def test_layers_place_the_programs_kernels_by_name():
    pats = Loader().kernel_layers()
    place = lambda n: trace.classify([(n, 0.0, 1.0)], pats)  # noqa: E731
    assert place("void (anonymous namespace)::warp_kernel<float, true>(float const*)") == {
        "build": 1.0}
    assert place("void (anonymous namespace)::nodes_stage_kernel<float>(float const*)") == {
        "build": 1.0}
    assert place("void (anonymous namespace)::descend_merge_kernel<float, true>(Args)") == {
        "association": 1.0}
    assert place("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8_cublas") == {
        "association": 1.0}
    assert place("void (anonymous namespace)::tail_kernel<float>(In, Out)") == {"tail": 1.0}
    assert place("void at::native::elementwise_kernel<128, 2>(int)") == {None: 1.0}
    assert place("Memcpy DtoD (Device -> Device)") == {}


# --------------------------------------------------------------- traffic --
@pytest.mark.parametrize("config,traf", [("kitti_hdl64", "kitti_seq_drive"),
                                         ("mulran_os1", "mulran_seq_drive")])
def test_the_lap_closes(config, traf):
    loader = Loader()
    c, t = loader.config(config), loader.traffic(traf)
    drive = traffic.make_drive(c, t, 5)
    S = drive.S
    assert np.allclose(np.linalg.matrix_power(drive.step, S), np.eye(4), atol=1e-9)
    assert np.allclose(drive.pose(S), drive.pose(0)) and np.allclose(drive.truth(S), np.eye(4))
    step = np.linalg.solve(drive.truth(S - 1), np.linalg.matrix_power(drive.step, S))
    assert np.allclose(step, drive.step, atol=1e-9)  # no jump where the lap wraps


def test_scans_come_from_the_seed():
    c, t = Loader().config("kitti_hdl64"), Loader().traffic("kitti_seq_drive")
    t = dict(t, world=dict(t["world"], density=0.3))
    c = dict(c, assumed=dict(c["assumed"], scan_points=5000))
    a = traffic.make_drive(c, t, 2**31 + 3)
    b = traffic.make_drive(c, t, 2**31 + 3)
    assert torch.equal(a.scan(7, "cpu"), b.scan(7, "cpu"))
    assert not torch.equal(a.scan(7, "cpu"), a.scan(8, "cpu"))


# --------------------------------------------------------- frozen copies --
def test_frozen_copies_equal_their_originals():
    from madicp_tpu_torch.probes.build_levels import call_cost
    from madicp_tpu_torch.utils import fixtures, timing

    a = traffic.two_orientation_world(np.random.default_rng(4), 2)
    assert np.array_equal(a, fixtures.two_orientation_world(np.random.default_rng(4), 2))
    w = np.random.default_rng(1).normal(size=(5, 3))
    assert np.allclose(traffic.exp_so3(w), fixtures._exp_so3(w), atol=1e-15)
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = fixtures._exp_so3(np.array([0.1, -0.2, 0.3])), [1.0, 2.0, 0.5]
    pts = a[:2000]
    got = traffic.skewed_sweep(torch.as_tensor(pts), torch.as_tensor(pose), [3.0, 0.2, 0.0],
                               [0.0, 0.05, 0.2], 10.0)
    want = fixtures.skewed_sweep(pts, pose, [3.0, 0.2, 0.0], [0.0, 0.05, 0.2], 10.0)
    assert np.allclose(got.numpy(), want, atol=1e-10)
    assert costs.H100_BYTES_PER_S == timing.H100_BYTES_PER_S
    assert costs.H100_PEAK_FLOPS == timing.H100_PEAK_FLOPS
    assert costs.bound_ms(3e9, 1e12, "float32") == timing.bound_ms(3e9, 1e12, "float32")[0]
    # the build's bytes and operations from the reference's level counts
    # equal the original's sum over a recorded build (float64, where the
    # two trees are the same)
    from madicp_tpu_torch.probes.build_levels import record_build

    depth = 10
    cloud = a[:6000] - a[:6000].mean(0)

    def original(N):
        p = torch.zeros((N, 3), dtype=torch.float64)
        p[:6000] = torch.as_tensor(cloud)
        valid = torch.arange(N) < 6000
        _, _, calls, moments = record_build(p, valid, depth=depth, b_max=0.2, b_min=0.1)
        nbytes = sum(call_cost(c, 8)[0] for c in calls)
        flops = sum(call_cost(c, 8)[1] for c in calls)
        for d, _, table in moments:
            nbytes += d.shape[0] * (3 * 8 + 4) + table.shape[0] * 10 * 8
            flops += d.shape[0] * costs.SEGSUM_FLOPS_PER_POINT
        return nbytes, flops

    nbytes, flops = unpadded_cost = original(6000)
    padded_bytes, padded_flops = original(8192)
    saved = reference.EIG_EPS, reference.EIG_TOL, reference.TIE_TOL
    reference.EIG_EPS, reference.EIG_TOL, reference.TIE_TOL = 1e-12, 1e-6, 1e-9
    try:
        stats = reference.build_tree(torch.as_tensor(cloud), depth, 0.2, 0.1)["stats"]
    finally:
        reference.EIG_EPS, reference.EIG_TOL, reference.TIE_TOL = saved
    # the copy counts a cloud's points, the original every row of the
    # call's arrays: on a cloud without padding they agree
    assert costs.build_cost(stats, 1, "float64") == (nbytes, flops)
    assert unpadded_cost < (padded_bytes, padded_flops)


# ----------------------------------------------------------- the imports --
def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "reference.py").read_text())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert imported <= {"__future__", "math", "time", "dataclasses", "torch"}
    code = ("import sys, odobench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"madicp_tpu_torch"})


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    tiny_bench(tmp_path)
    code = ("import sys, json; sys.path.insert(0, %r); from odobench.loader import Loader; "
            "from odobench import run; "
            "out = run.run_cell('tiny.cell', 3, 0.2, False, device='cpu', "
            "loader=Loader(%r)); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}))); "
            "print(json.dumps(out['forbidden']))") % (str(REPO), str(tmp_path / "odobench"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    loaded, found = set(json.loads(out[-2])), json.loads(out[-1])
    # whole top-level names: the port's own name begins with the JAX package's
    assert "madicp_tpu_torch" in loaded and "odobench" in loaded
    assert not loaded & FORBIDDEN and found == []


def test_the_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "madicp_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "madicp_tpu", types.ModuleType("madicp_tpu"))
    assert run.forbidden_modules() == ["jax", "madicp_tpu"]


def test_without_a_card_or_the_program_a_run_fails_and_prints_no_result(tmp_path):
    cmd = [sys.executable, "-m", "odobench", "--workload", "kitti.cli", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    got = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and got.stdout == ""
    # a checkout of the benchmark's own files alone holds no program to run
    shutil.copytree(ROOT, tmp_path / "odobench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    got = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and got.stdout == ""


# ----------------------------------------------- the check and its faults --
def test_a_sound_small_run_is_correct(tmp_path):
    out = tiny_run(tiny_bench(tmp_path))
    assert run.is_correct(out["check"]["numbers"]), out["check"]["numbers"]
    assert out["run"].scans >= 6 and out["check"]["nonfinite_window_poses"] == 0


def _state_unchanged(monkeypatch):
    from madicp_tpu_torch.models import step_graph

    real = step_graph.step_in_place

    def frozen(cfg, state, points, valid, timer=None, **kw):
        saved = [t.clone() for t in step_graph._tensors(state)]
        out = real(cfg, state, points, valid, timer, **kw)
        for d, s in zip(step_graph._tensors(state), saved):
            d.copy_(s)
        return out

    monkeypatch.setattr(step_graph, "step_in_place", frozen)


def _answer_altered(monkeypatch):
    from madicp_tpu_torch.models.pipeline import Pipeline
    from madicp_tpu_torch.parallel.fleet import Fleet

    shift = np.zeros((4, 4))
    shift[0, 3] = 0.1
    real_pose, real_poses = Pipeline.current_pose, Fleet.poses
    monkeypatch.setattr(Pipeline, "current_pose", lambda self: real_pose(self) + shift)
    monkeypatch.setattr(Fleet, "poses", lambda self: real_poses(self) + shift)


def _flag_flipped(monkeypatch):
    from madicp_tpu_torch.models.pipeline import Pipeline
    from madicp_tpu_torch.parallel.fleet import Fleet

    real_flag, real_compute = Pipeline.is_map_updated, Fleet.compute

    def compute(self, stamps, points, valid):
        out = real_compute(self, stamps, points, valid)
        return out._replace(map_updated=~out.map_updated)

    monkeypatch.setattr(Pipeline, "is_map_updated", lambda self: not real_flag(self))
    monkeypatch.setattr(Fleet, "compute", compute)


def _half_batch(monkeypatch):
    from madicp_tpu_torch.parallel.fleet import Fleet

    real = Fleet.compute

    def half(self, stamps, points, valid):
        valid = np.array(valid)
        valid[len(valid) // 2:] = False  # the second half of the sequences left out
        return real(self, stamps, points, valid)

    monkeypatch.setattr(Fleet, "compute", half)


@pytest.mark.parametrize("fault,loop,fails", [
    (_state_unchanged, "cli", "step_gap_mean_m"), (_answer_altered, "cli", "trans_gap_m"),
    (_flag_flipped, "cli", "promote_mismatches"), (_state_unchanged, "fleet", "step_gap_mean_m"),
    (_answer_altered, "fleet", "trans_gap_m"), (_flag_flipped, "fleet", "promote_mismatches"),
    (_half_batch, "fleet", "trans_gap_m")])
def test_a_fault_in_the_timed_path_fails_the_check(tmp_path, monkeypatch, fault, loop, fails):
    loader = tiny_bench(tmp_path, loop=loop)
    fault(monkeypatch)
    out = tiny_run(loader)
    numbers = out["check"]["numbers"]
    assert not run.is_correct(numbers), numbers
    value, limit = numbers[fails]
    assert value > limit, numbers


def test_window_steps_are_held_to_the_drives_motion():
    drive = traffic.make_drive(Loader().config("kitti_hdl64"),
                               Loader().traffic("kitti_seq_drive"), 3)
    D = drive.step
    poses = np.stack([[drive.truth(k), drive.truth(k + 9)] for k in range(290, 320)])
    got = run.step_gaps(poses, D)  # across the wrap
    assert got["step_gap_m"] == pytest.approx(0.0, abs=1e-9)
    assert got["step_rot_rad"] == pytest.approx(0.0, abs=1e-7)
    bumped = poses.copy()
    bumped[12, 1, 1, 3] += 0.01  # one pose of one sequence 1 cm off: two steps show it
    got = run.step_gaps(bumped, D)
    assert got["step_gap_m"] == pytest.approx(0.01, rel=1e-6) and got["step_gap_at"] in (11, 12)
    assert got["step_gap_mean_m"] == pytest.approx(0.02 / (29 * 2), rel=1e-6)
    frozen = poses.copy()
    frozen[20:] = frozen[19]  # the state left unchanged: a scan's whole motion
    assert run.step_gaps(frozen, D)["step_gap_m"] == pytest.approx(np.linalg.norm(D[:3, 3]))
    lost = poses.copy()
    lost[5, 0, 0, 0] = np.nan
    assert run.step_gaps(lost, D)["step_gap_m"] == run.NO_POSE_M


@pytest.mark.cuda
def test_the_control_fails_the_check_on_the_card(tmp_path):
    """kitti.cli's drive and its limit of the translation gap at half its
    widths: the program passes, the reference in float32 with TF32
    matmuls (the control) fails. (The cell's other limits were read at the
    cell's own size; at the cell's size the control fails this one.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is float32 with TF32 matmuls")
    from odobench import control

    loader = tiny_bench(tmp_path)
    root = loader.root
    cfg = json.loads((root / "configs" / "kitti_hdl64.json").read_text())
    cfg["num_keyframes"] = 8
    cfg["assumed"].update(scan_points=60000, n_points=65536, depth=15, max_leaves=0)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    shutil.copy(root / "traffic" / "kitti_seq_drive.json", root / "traffic" / "tiny.json")
    limits = json.loads((root / "limits" / "kitti.cli.json").read_text())
    (root / "limits" / "tiny.cell.json").write_text(json.dumps(dict(limits, reference_scans=10)))
    lim = limits["limits"]["trans_gap_m"]
    sound = control.readings("tiny.cell", 4, 1.0, "sound", loader=loader)
    assert sound["trans_gap_m"] <= lim, sound
    for seed in (1, 2, 3):
        got = control.readings("tiny.cell", seed, 1.0, "control", loader=loader)
        assert got["trans_gap_m"] > lim, got


def test_limits_lie_between_the_readings_they_were_set_from():
    for w in Loader().benchmark()["workloads"]:
        limits = Loader().limits(w["name"])
        for name, lim in limits["limits"].items():
            got = limits["readings"][name]
            if got.get("exact"):  # a count that sound runs never make: the limit is 0
                assert lim == got["sound_max"] == 0, (w["name"], name)
                continue
            lo, hi = got["sound_max"], got["control_min"]
            assert hi >= 3 * lo and lo < lim < hi, (w["name"], name)
        assert math.isfinite(limits["tie_margin"])
