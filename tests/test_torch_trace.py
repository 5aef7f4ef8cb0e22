"""The program's trace (``utils/timing.py``): spans and counters inside the
port.

On the CPU the stamps read the host's clock through the same calls and
records as on the card: traced and untraced steps agree bit for bit;
each scan's record has every layer's span, the layers tile its step;
host spans sit under their parents with their scan; the counters are the
step's own; with the trace off nothing is recorded. The ``cuda`` tests
(``python -m pytest tests/test_torch_trace.py -m cuda --noconftest -q``
on the card) hold the graphed path: one replay a traced scan, the
untraced graph free of stamps, monotonic stamps, and the trace's clock
against the profiler's. No JAX: every test here runs in seconds.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from madicp_tpu_torch.models.pipeline import Pipeline, PipelineConfig
from madicp_tpu_torch.parallel.fleet import Fleet
from madicp_tpu_torch.utils import timing
from madicp_tpu_torch.utils.timing import PHASES, STEP_SPAN, Trace, layer_ms

torch.set_num_threads(2)

KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8, b_min=0.1,
          b_ratio=0.02, num_keyframes=3, n_points=4096, depth=10, max_icp_iterations=3,
          dtype=torch.float64)
SCHEDULES = {
    "exact": dict(certify=False),
    "certified": dict(),
    "compact": dict(certify_compact=64),
    "prefix": dict(certify_prefix=64),
    "fast": dict(assoc_mode="fast", reassoc_every=2),
}
N_SCANS = 6
SLACK_NS = 20_000  # the clocks' agreement the benchmark holds every scan to


def world(step: int, seq: int = 0, n: int = 2500) -> np.ndarray:
    """A scan of a ground and walls in both orientations, seen from x =
    0.2 m a step (each sequence its own draw)."""
    rng = np.random.default_rng([seq, step])
    k = n // 5
    ground = np.c_[rng.uniform(-15, 15, (k, 2)), np.full(k, -1.5)]
    walls = []
    for c in (-8.0, 8.0):
        u, z = rng.uniform(-8, 8, k), rng.uniform(-1.5, 3, k)
        walls.append(np.c_[np.full(k, c), u, z])
        walls.append(np.c_[u, np.full(k, c + 0.5 * seq), z])
    pts = np.concatenate([ground] + walls)
    pts[:, 0] -= 0.2 * step
    return pts


def pipe(device="cpu", **kw):
    return Pipeline(**{**KW, **kw}, device=device)


def drive(p, n=N_SCANS):
    """Each scan's pose, inlier ratio, map flag, descents and leaves."""
    got = []
    for i in range(n):
        p.compute(0.1 * i, world(i))
        got.append((p.current_pose(), p.inlier_ratio(), p.is_map_updated(), p.descents(),
                    int(p._last.n_leaves)))
    return got


def fleet_drive(f, n=N_SCANS):
    got = []
    for i in range(n):
        clouds = [world(i, s) for s in range(f.n_seq)]
        pts = np.zeros((f.n_seq, f.cfg.n_points, 3))
        val = np.zeros((f.n_seq, f.cfg.n_points), bool)
        for s, c in enumerate(clouds):
            pts[s, :len(c)], val[s, :len(c)] = c, True
        kv = f.states.kf_valid.sum(-1).tolist()
        out = f.compute(None, pts, val)
        got.append((f.poses(), out.inlier_ratio.numpy().copy(), out.map_updated.numpy().copy(),
                    out.n_descents.tolist(), out.n_leaves.tolist(), kv))
    return got


@pytest.fixture(scope="module")
def pipe_runs():
    """An untraced and a traced pipeline over the same scans, and the
    traced one's drained records."""
    plain, traced = pipe(), pipe()
    traced.trace = Trace("cpu")
    kv = []

    def counted(p):
        out = []
        for i in range(N_SCANS):
            kv.append(int(p.state.kf_valid.sum()))
            p.compute(0.1 * i, world(i))
            out.append((p.current_pose(), p.inlier_ratio(), p.is_map_updated(), p.descents(),
                        int(p._last.n_leaves)))
        return out

    return drive(plain), counted(traced), traced.trace.drain(), kv


@pytest.fixture(scope="module")
def fleet_runs():
    cfg = PipelineConfig(**KW)
    plain, traced = Fleet(cfg, 2, device="cpu"), Fleet(cfg, 2, device="cpu")
    traced.trace = Trace("cpu")
    return fleet_drive(plain), fleet_drive(traced), traced.trace.drain()


@pytest.fixture(scope="module")
def deskew_run():
    p = pipe(deskew=True)
    p.trace = Trace("cpu")
    drive(p)
    return p.trace.drain()


def traced_steps(drained) -> int:
    return sum(1 for s in drained["spans"] if s["name"] == STEP_SPAN)


def steps_of(drained) -> dict:
    """{scan: (the madicp.step span, its layer spans in order)}."""
    by_id = {s["id"]: s for s in drained["spans"]}
    out = {}
    for s in drained["spans"]:
        if s["name"] == STEP_SPAN:
            out[s["scan"]] = (s, [])
    for s in drained["spans"]:
        if s["where"] == "device" and s["name"] != STEP_SPAN:
            step = by_id[s["parent"]]
            assert step["name"] == STEP_SPAN and step["scan"] == s["scan"]
            out[s["scan"]][1].append(s)
    return out


def assert_tiles(step, layers):
    """The layers run back to back from the step's start to its end."""
    assert layers and layers[0]["start_ns"] == step["start_ns"]
    assert layers[-1]["end_ns"] == step["end_ns"]
    for a, b in zip(layers, layers[1:]):
        assert a["end_ns"] == b["start_ns"] and a["name"] != b["name"]
    assert all(s["end_ns"] >= s["start_ns"] for s in layers)
    assert sum(s["end_ns"] - s["start_ns"] for s in layers) == step["end_ns"] - step["start_ns"]


# ----------------------------------------------------------- bit for bit --
def test_traced_pipeline_steps_bit_for_bit_as_untraced(pipe_runs):
    plain, traced, _, _ = pipe_runs
    for (p, r, f, d, _), (q, s, g, e, _) in zip(plain, traced):
        assert np.array_equal(p, q) and r == s and f == g and d == e


def test_traced_fleet_steps_bit_for_bit_as_untraced(fleet_runs):
    plain, traced, _ = fleet_runs
    for a, b in zip(plain, traced):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------- layers --
@pytest.mark.parametrize("run", ["pipeline", "fleet", "deskew"])
def test_every_scan_has_every_layer_tiling_its_step(request, run):
    drained = {"pipeline": lambda: request.getfixturevalue("pipe_runs")[2],
               "fleet": lambda: request.getfixturevalue("fleet_runs")[2],
               "deskew": lambda: request.getfixturevalue("deskew_run")}[run]()
    steps = steps_of(drained)
    assert sorted(steps) == list(range(1, N_SCANS + 1))  # the state's seq after each step
    want = set(PHASES) if run == "deskew" else set(PHASES) - {"deskew"}
    for scan, (step, layers) in steps.items():
        assert_tiles(step, layers)
        names = [s["name"] for s in layers]
        if scan == 1:  # the bootstrap: the build and the tail
            assert names == ["build", "tail"]
            continue
        assert set(names) == want
        # the prediction and the tail around the rounds, one association
        # and one terms span a round
        lead = ["deskew", "build"] if run == "deskew" else ["build"]
        assert names == lead + ["tail"] + ["assoc", "terms"] * KW["max_icp_iterations"] + [
            "tail"]
    assert drained["lost"] == 0


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_every_schedule_stamps_association_and_terms(schedule):
    p = pipe(**SCHEDULES[schedule])
    p.trace = Trace("cpu")
    drive(p, 3)
    steps = steps_of(p.trace.drain())
    for scan in (2, 3):
        step, layers = steps[scan]
        assert_tiles(step, layers)
        names = [s["name"] for s in layers]
        assert names[:2] == ["build", "tail"] and names[-1] == "tail"
        assert {"assoc", "terms"} == set(names[2:-1]) and names[2] == "assoc"


def test_layer_totals_sum_the_device_spans(pipe_runs):
    drained = pipe_runs[2]
    totals = layer_ms(drained)
    assert list(totals) == list(PHASES) and totals["deskew"] == 0.0
    steps = steps_of(drained)
    assert traced_steps(drained) == len(steps) == N_SCANS
    whole = sum(s["end_ns"] - s["start_ns"] for s, _ in steps.values()) / 1e6
    assert sum(totals.values()) == pytest.approx(whole, rel=1e-12)


# ------------------------------------------------------------ host spans --
PARENTS = {"madicp.stage.wait": "madicp.stage", "madicp.stage.pad": "madicp.stage",
           "madicp.copy_in": ("madicp.stage", "madicp.compute"),
           "madicp.replay": "madicp.compute", "madicp.clone_out": "madicp.compute",
           "madicp.pose.wait": "madicp.pose"}


@pytest.mark.parametrize("run", ["pipeline", "fleet"])
def test_host_spans_sit_under_their_parents_with_their_scan(request, run):
    drained = request.getfixturevalue({"pipeline": "pipe_runs", "fleet": "fleet_runs"}[run])[2]
    by_id = {s["id"]: s for s in drained["spans"]}
    host = [s for s in drained["spans"] if s["where"] == "host"]
    names = {s["name"] for s in host}
    want = {"madicp.compute", "madicp.replay", "madicp.copy_in", "madicp.pose",
            "madicp.pose.wait"}
    assert want <= names
    if run == "pipeline":
        assert {"madicp.stage", "madicp.stage.pad"} <= names
    for s in host:
        assert s["scan"] in range(1, N_SCANS + 1)
        if s["parent"] is None:
            assert s["name"] in ("madicp.stage", "madicp.compute", "madicp.pose")
            continue
        parent = by_id[s["parent"]]
        assert parent["name"] in np.atleast_1d(PARENTS[s["name"]])
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
        assert parent["scan"] == s["scan"]
    # each step lies inside the host span that enqueued it, and ends
    # before the read of its pose does
    waits = {s["scan"]: s for s in host if s["name"] == "madicp.pose.wait"}
    for step, _ in steps_of(drained).values():
        replay = by_id[step["parent"]]
        assert replay["name"] == "madicp.replay" and replay["scan"] == step["scan"]
        assert step["start_ns"] >= replay["start_ns"] - SLACK_NS
        assert step["end_ns"] <= waits[step["scan"]]["end_ns"] + SLACK_NS


def test_compute_batch_keeps_every_scans_record():
    p = pipe()
    p.compute(0.0, world(0))
    p.trace = Trace("cpu")
    poses = p.compute_batch([0.1 * i for i in range(1, 5)], [world(i) for i in range(1, 5)])
    assert poses.shape == (4, 4, 4)
    drained = p.trace.drain()
    steps = steps_of(drained)
    assert sorted(steps) == [2, 3, 4, 5]
    for step, layers in steps.values():
        assert_tiles(step, layers)
    stages = sorted((s["start_ns"], s["scan"]) for s in drained["spans"]
                    if s["name"] == "madicp.stage")
    assert [scan for _, scan in stages] == [2, 3, 4, 5]  # staged in order, each its scan's
    pose = [s for s in drained["spans"] if s["name"] == "madicp.pose"]
    assert len(pose) == 1 and pose[0]["scan"] == 5


def test_a_step_whose_slot_is_overwritten_before_a_read_is_counted_lost(monkeypatch):
    monkeypatch.setattr(timing, "SLOTS", 2)
    p = pipe()
    p.compute(0.0, world(0))
    p.trace = Trace("cpu")
    p.compute_batch([0.1 * i for i in range(1, 6)], [world(i) for i in range(1, 6)])
    drained = p.trace.drain()
    assert drained["lost"] == 3 and sorted(steps_of(drained)) == [5, 6]


# -------------------------------------------------------------- counters --
def test_the_counters_are_the_steps_own(pipe_runs, fleet_runs):
    _, traced, drained, kv = pipe_runs
    counters = {c["scan"]: c for c in drained["counters"]}
    for i, (_, _, _, descents, leaves) in enumerate(traced):
        c = counters[i + 1]
        assert c["n_descents"] == [descents] and c["n_leaves"] == [leaves]
        assert c["valid_keyframes"] == [kv[i]]
    assert any(c["n_descents"][0] > 0 for c in counters.values())
    _, got, drained = fleet_runs
    counters = {c["scan"]: c for c in drained["counters"]}
    for i, (_, _, _, descents, leaves, kv) in enumerate(got):
        c = counters[i + 1]
        assert c["n_descents"] == descents and c["n_leaves"] == leaves
        assert c["valid_keyframes"] == kv


def test_the_counters_carry_the_terms_kernels_walk(pipe_runs, fleet_runs):
    """Each sequence's walked leaf slots a round are its keyframes times
    its valid leaves (the terms kernels' bound), out of its keyframes
    times the leaf slots."""
    K, L = KW["num_keyframes"], PipelineConfig(**KW).leaves_cap
    for runs in (pipe_runs, fleet_runs):
        for c in runs[2]["counters"]:
            assert c["terms_walked"] == [K * n for n in c["n_leaves"]]
            assert c["terms_slots"] == [K * L] * len(c["n_leaves"])
            assert all(0 < n < L for n in c["n_leaves"])


# ------------------------------------------------------------------- off --
def test_with_the_trace_off_nothing_is_recorded():
    assert isinstance(timing.phase(None, "build"), type(timing.stepping(None, None)))
    with timing.phase(None, "build") as x, timing.host_span(None, "madicp.stage") as y:
        assert x is None and y is None
    p = pipe()
    drive(p, 3)
    assert p.trace is None and p._graphs.stamps is None
    p.trace = trace = Trace("cpu")
    p.compute(0.3, world(3))
    p.current_pose()
    p.trace = None
    p.compute(0.4, world(4))
    p.current_pose()
    drained = trace.drain()
    assert [s["scan"] for s in drained["spans"] if s["name"] == STEP_SPAN] == [4]
    assert {s["scan"] for s in drained["spans"]} == {4}
    assert trace.drain()["spans"] == []  # drained once


def test_the_mesh_step_stamps_its_phases_too():
    import socket

    from madicp_tpu_torch.parallel import distributed
    from madicp_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"localhost:{port}", 1, 0, backend="gloo", device="cpu")
    try:
        f = Fleet(PipelineConfig(**KW), 2, mesh=make_mesh(kf=1, seq=1), device="cpu")
        f.trace = Trace("cpu")
        fleet_drive(f, 3)
        steps = steps_of(f.trace.drain())
    finally:
        distributed.shutdown()
    assert sorted(steps) == [1, 2, 3]
    for step, layers in steps.values():
        assert_tiles(step, layers)
    assert {s["name"] for s in steps[3][1]} == set(PHASES) - {"deskew"}


def test_the_cli_profile_writes_the_drained_spans(tmp_path, monkeypatch):
    """--profile switches the program's trace on and writes its records
    beside the profiler's trace (the profiler itself is stubbed: the
    CLI's --profile test of test_torch_package.py runs it)."""
    from madicp_tpu_torch.apps import cli

    class Stub:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text("{}")

    monkeypatch.setattr(cli, "_profiler", lambda device: Stub())
    (tmp_path / "seq").mkdir()
    for i in range(3):
        rec = np.zeros((1200, 4), np.float32)
        rec[:, :3] = world(i, n=1200)
        rec.tofile(tmp_path / "seq" / f"{i:06d}.bin")
    rc = cli.main(["--data-path", str(tmp_path / "seq"), "--estimate-path", str(tmp_path / "o"),
                   "--dataset-config", "kitti", "--device", "cpu", "--n-points", "2048",
                   "--depth", "9", "--noviz", "--profile", str(tmp_path / "p")])
    assert rc == 0 and (tmp_path / "p" / "trace.json").exists()
    spans = json.loads((tmp_path / "p" / "spans.json").read_text())
    assert traced_steps(spans) == 3
    stages = {s["scan"] for s in spans["spans"] if s["name"] == "madicp.stage"}
    assert stages == {1, 2, 3}  # staged by the prefetcher's thread, each its scan's


def test_host_spans_are_marked_for_an_active_profiler():
    from torch.profiler import ProfilerActivity, profile

    trace = Trace("cpu")
    with trace.span("madicp.pose"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("madicp.compute"), trace.span("madicp.replay"):
            pass
    names = {e.name for e in prof.events()}
    assert {"madicp.compute", "madicp.replay"} <= names and "madicp.pose" not in names
    assert [s["name"] for s in trace.drain()["spans"]] == ["madicp.pose", "madicp.replay",
                                                         "madicp.compute"]


# ---------------------------------------------------------------- on card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stamps are a kernel there)")
    return torch.device("cuda")


CARD_KW = dict(n_points=16384, depth=12, max_icp_iterations=6, dtype=torch.float32)


def card_pipe(device):
    p = pipe(device, **CARD_KW)
    for i in range(3):  # the bootstrap, the warm-up, the capture
        p.compute(0.1 * i, world(i, n=10000))
    return p


@pytest.mark.cuda
def test_a_traced_scan_is_one_replay_on_cuda(cuda_device, monkeypatch):
    p = card_pipe(cuda_device)
    p.trace = Trace(cuda_device)
    p.compute(0.3, world(3, n=10000))  # captures the traced graph
    replays = []
    real = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda g: (replays.append(g), real(g))[1])
    outs = {}
    for i in range(4, 8):
        kv = int(p.state.kf_valid.sum())
        p.compute(0.1 * i, world(i, n=10000))
        p.current_pose()
        outs[i + 1] = (p.descents(), int(p._last.n_leaves), kv)
    assert len(replays) == 4
    drained = p.trace.drain()
    steps = steps_of(drained)
    assert sorted(steps) == list(range(4, 9))
    for step, layers in steps.values():
        assert_tiles(step, layers)
    for c in drained["counters"]:  # the counts kernel's against the step's own
        if c["scan"] in outs:
            got = (c["n_descents"][0], c["n_leaves"][0], c["valid_keyframes"][0])
            assert got == outs[c["scan"]]


@pytest.mark.cuda
def test_the_untraced_graph_has_no_stamp_on_cuda(cuda_device):
    """The traced graph is the untraced one plus a stamp at each phase
    boundary, the step's end and the counts; a process that never traces
    neither builds nor loads the stamp library."""
    p = card_pipe(cuda_device)
    (_, untraced, launches), = p._graphs.captured().values()
    p.trace = Trace(cuda_device)
    p.compute(0.3, world(3, n=10000))
    (_, traced, traced_launches), = p._graphs.captured(traced=True).values()
    layout = p._graphs._graphs[(p.cfg, True)].layout
    assert traced == untraced + len(layout) + 2 and launches == traced_launches
    code = ("import numpy as np, torch\n"
            "from madicp_tpu_torch.kernels import build\n"
            "from madicp_tpu_torch.models.pipeline import Pipeline\n"
            "p = Pipeline(10.0, False, 0.2, 0.1, 0.8, 0.1, 0.02, 3, n_points=16384, depth=12,\n"
            "             max_icp_iterations=6, device='cuda')\n"
            "rng = np.random.default_rng(0)\n"
            "for i in range(4):\n"
            "    p.compute(0.1 * i, rng.uniform(-20, 20, (10000, 3)))\n"
            "p.current_pose()\n"
            "print(len(p._graphs.captured()), 'stamp' in build._loaded)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["1", "False"]


@pytest.mark.cuda
def test_stamps_are_monotonic_on_cuda(cuda_device):
    p = card_pipe(cuda_device)
    p.trace = Trace(cuda_device)
    p.compute_batch([0.1 * i for i in range(3, 9)], [world(i, n=10000) for i in range(3, 9)])
    drained = p.trace.drain()
    steps = sorted(steps_of(drained).values(), key=lambda s: s[0]["scan"])
    assert len(steps) == 6 and drained["lost"] == 0
    last = None
    for step, layers in steps:
        assert_tiles(step, layers)
        assert all(s["end_ns"] > s["start_ns"] for s in layers)
        assert last is None or step["start_ns"] >= last
        last = step["end_ns"]


@pytest.mark.cuda
def test_the_trace_clock_agrees_with_the_profilers_on_cuda(cuda_device):
    """Over profiled traced steps, the time from a host span to a stamp,
    as the trace records it, within 20 us of the profiler's. The host
    side is the median over every host span that both record (a span's
    start jitters by tens of microseconds under the profiler's own
    ``record_function``); the device side is each stamp against the
    profiler's record of its kernel, paired in order."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from madicp_tpu_torch.kernels.stamp import KERNEL_NAMES

    p = card_pipe(cuda_device)
    p.trace = Trace(cuda_device)
    p.compute(0.3, world(3, n=10000))
    p.current_pose()
    p.trace.drain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(4, 7):
            p.compute(0.1 * i, world(i, n=10000))
            p.current_pose()
        torch.cuda.synchronize()
    spans = p.trace.drain()["spans"]
    events = prof.events()
    host = []
    for name in ("madicp.stage", "madicp.compute", "madicp.replay", "madicp.pose",
                 "madicp.pose.wait"):
        ours = sorted(s["start_ns"] / 1e3 for s in spans if s["name"] == name)
        theirs = sorted(e.time_range.start for e in events
                        if e.name == name and e.device_type == DeviceType.CPU)
        assert len(ours) == len(theirs) == 3
        host += [b - a for a, b in zip(ours, theirs)]
    offset = statistics.median(host)
    ours = sorted({t / 1e3 for s in spans if s["where"] == "device"
                   for t in (s["start_ns"], s["end_ns"])})
    theirs = sorted(e.time_range.start for e in events
                    if e.device_type == DeviceType.CUDA and KERNEL_NAMES[0] in e.name)
    if len(theirs) != len(ours):
        pytest.skip(f"the profiler kept {len(theirs)} of {len(ours)} stamp records")
    gaps = [b - a - offset for a, b in zip(ours, theirs)]
    print(f"stamps against the profiler's: median {statistics.median(gaps):.2f} us, "
          f"largest {max(gaps, key=abs):.2f} us")
    assert all(abs(g) < 20.0 for g in gaps), gaps
