"""Package-level checks of the PyTorch port: no JAX at import, no silent
CPU fallback, the import-time precision pins, kernel dispatch and build
guards, and the KITTI CLI end to end on the CPU. Tests marked ``cuda``
hold the CUDA kernel to its plain version and skip without a card."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import madicp_tpu_torch  # noqa: F401  (pins the matmul precision)
from madicp_tpu_torch.apps import cli
from madicp_tpu_torch.kernels import build, scatter_probe, segsum
from madicp_tpu_torch.models.nn import MADtree
from madicp_tpu_torch.models.pipeline import Pipeline, icp_rounds
from madicp_tpu_torch.models.registration import MADicp
from madicp_tpu_torch.models.vel_estimator import VelEstimator
from madicp_tpu_torch.ops.tree import build_tree, get_leaves
from test_visualizer import fake_o3d  # noqa: F401  (fixture)

# keeps a test process that runs many JAX pipeline tests under the kernel's
# limit on memory mappings; only processes that collect this file load it
# (see xla_map_guard.py for running a JAX test file alone)
pytest_plugins = ["xla_map_guard"]

REPO = Path(__file__).resolve().parents[1]
PIPE_KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8,
               b_min=0.1, b_ratio=0.02, num_keyframes=2)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "import madicp_tpu_torch, madicp_tpu_torch.ops, madicp_tpu_torch.models\n"
        "import madicp_tpu_torch.kernels, madicp_tpu_torch.utils.convert\n"
        "import madicp_tpu_torch.apps.cli, chip_smoke\n"
        "import madicp_tpu_torch.kernels.scatter_probe\n"
        "import madicp_tpu_torch.probes.scatter_probe\n"
        "import madicp_tpu_torch.probes.segsum_levels\n"
        "import madicp_tpu_torch.probes.build_levels\n"
        "import madicp_tpu_torch.probes.profile_windows\n"
        "import madicp_tpu_torch.bench\n"
        "import madicp_tpu_torch.models.schedules_experimental\n"
        "import madicp_tpu_torch.native, madicp_tpu_torch.native.loader\n"
        "import madicp_tpu_torch.native.prefetch\n"
        "import madicp_tpu_torch.utils.checkpoint, madicp_tpu_torch.utils.rosbag\n"
        "import madicp_tpu_torch.utils.pointcloud2, madicp_tpu_torch.utils.fixtures\n"
        "import madicp_tpu_torch.utils.visualizer, madicp_tpu_torch.apps.evaluate\n"
        "import madicp_tpu_torch.apps.nn_search, madicp_tpu_torch.apps.mad_registration\n"
        "import madicp_tpu_torch.parallel, madicp_tpu_torch.parallel.mesh\n"
        "import madicp_tpu_torch.parallel.fleet, madicp_tpu_torch.parallel.sharded_icp\n"
        "import madicp_tpu_torch.parallel.distributed, madicp_tpu_torch.apps.fleet_eval\n"
        "bad = [m for m in sys.modules if m in ('jax', 'madicp_tpu')\n"
        "       or m.startswith(('jax.', 'madicp_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    """With no CUDA device, every entry point raises unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for make in (lambda: Pipeline(**PIPE_KW), lambda: MADicp(), lambda: MADtree(),
                 lambda: VelEstimator(10.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert Pipeline(**PIPE_KW, device="cpu").device.type == "cpu"


def test_import_pins_float32_matmuls_and_warns_when_lowered():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.warns(RuntimeWarning, match="TF32"):
            Pipeline(**PIPE_KW, device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def test_segsum_dispatch_and_argument_checks():
    """CPU tensors take the plain version without counting a launch; any
    other non-CUDA device is refused; the build never falls back when
    nvcc is missing."""
    d = torch.randn(16, 3)
    idx = torch.zeros(16, dtype=torch.int32)
    before = segsum.counter.launches
    out = segsum.segsum_moments(d, idx, 1)
    assert segsum.counter.launches == before
    torch.testing.assert_close(out[0, 9], torch.tensor(16.0))
    with pytest.raises(ValueError, match="unsupported device"):
        segsum.segsum_moments(d.to("meta"), idx.to("meta"), 1)


def _probe_inputs(name: str, n: int, m: int, seed: int = 0):
    """(idx (1, n) with dropped ids on both sides, values in the layout
    of the wrapper ``name``)."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(-2, m + 3, (1, n)).astype(np.int32))
    shape = {"onehot_segsum": (16, n), "fused_moments": (n, 3)}.get(name, (n, 16))
    return idx, torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("name", list(scatter_probe.launches))
def test_probe_wrapper_dispatch_and_argument_checks(name):
    """CPU tensors take the plain version without counting a launch; the
    arguments are checked on every device, and any other non-CUDA
    device is refused."""
    wrap, plain = getattr(scatter_probe, name), getattr(scatter_probe, f"{name}_ref")
    idx, x = _probe_inputs(name, 64, 8)
    before = dict(scatter_probe.launches)
    torch.testing.assert_close(wrap(idx, x, 8), plain(idx, x, 8), rtol=0, atol=0)
    torch.testing.assert_close(wrap(idx[0], x, 8), plain(idx, x, 8), rtol=0, atol=0)
    assert scatter_probe.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        wrap(idx.to("meta"), x.to("meta"), 8)
    with pytest.raises(TypeError, match="float32"):
        wrap(idx, x.double(), 8)
    with pytest.raises(TypeError, match="int32"):
        wrap(idx.long(), x, 8)
    with pytest.raises(ValueError, match="want values"):
        wrap(idx[:, 1:], x, 8)
    with pytest.raises(ValueError, match="1 <= M"):
        wrap(idx, x, 0)
    if name == "onehot_segsum":
        with pytest.raises(ValueError, match="mode"):
            wrap(idx, x, 8, "tf32")
    if name == "rmw_segsum":
        with pytest.raises(ValueError, match="Mq must be"):
            wrap(idx, x, scatter_probe.RMW_MAX_ROWS + 1)


def test_kernel_build_requires_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    # the library name follows the source and flags
    p = build.library_path("segsum_moments")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libsegsum_moments_")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


SCHEDULES = {
    "exact": dict(certify=False),
    "certified": dict(),
    "compact": dict(certify_compact=64),
    "prefix": dict(certify_prefix=64),
    "fast": dict(assoc_mode="fast", reassoc_every=2, reassoc_backup=6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_icp_rounds_never_syncs_the_host_on_cuda(cuda_device, schedule):
    """Every schedule's GN rounds run with no host synchronisation: a
    keyframe ring of two room scans, a third scan's leaves, 6 rounds
    under ``set_sync_debug_mode("error")``."""
    rng = np.random.default_rng(5)
    walls = [rng.uniform([0, 0, 0], [4, 0.01, 2], (600, 3)),
             rng.uniform([0, 0, 0], [0.01, 4, 2], (600, 3)),
             rng.uniform([0, 3.99, 0], [4, 4, 2], (600, 3)),
             rng.uniform([0, 0, 0], [4, 4, 0.01], (600, 3))]
    room = np.concatenate(walls)
    pipe = Pipeline(**PIPE_KW, n_points=4096, depth=10, max_leaves=1024,
                    max_icp_iterations=6, dtype=torch.float64, device=cuda_device,
                    **SCHEDULES[schedule])
    for i in range(2):
        pipe.compute(0.1 * i, room - [0.05 * i, 0.02 * i, 0.0])
    pts, valid, _ = pipe.stage(room - [0.1, 0.04, 0.0])
    tree, _ = build_tree(pts, valid, depth=10, b_max=0.2, b_min=0.1)
    leaves = get_leaves(tree, pipe.cfg.leaves_cap)
    kf_valid_f = pipe.state.kf_valid.to(torch.float64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        X, H, matched, n_desc = icp_rounds(pipe.cfg, pipe.state.kf_tree, kf_valid_f,
                                           leaves.pts, leaves.valid, pipe.state.X)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(X).all() and matched.any() and int(n_desc) > 0


def _rooms(shifts):
    """Two-room scans of the sync tests: the room seen from each shift."""
    rng = np.random.default_rng(5)
    walls = [rng.uniform([0, 0, 0], [4, 0.01, 2], (600, 3)),
             rng.uniform([0, 0, 0], [0.01, 4, 2], (600, 3)),
             rng.uniform([0, 3.99, 0], [4, 4, 2], (600, 3)),
             rng.uniform([0, 0, 0], [4, 4, 0.01], (600, 3))]
    room = np.concatenate(walls)
    return [room - np.asarray(s) for s in shifts]


def _fleet_inputs(cfg, scans, device):
    pts = np.zeros((len(scans), cfg.n_points, 3))
    val = np.zeros((len(scans), cfg.n_points), bool)
    for b, s in enumerate(scans):
        pts[b, :len(s)], val[b, :len(s)] = s, True
    return (torch.as_tensor(pts, dtype=cfg.dtype, device=device),
            torch.as_tensor(val, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_fleet_step_never_syncs_the_host_on_cuda(cuda_device, schedule):
    """A B = 2 fleet step (build, rounds, masked per-sequence promotion,
    ring writes) runs with no host synchronisation: two scans, then the
    third step on staged inputs under ``set_sync_debug_mode("error")``."""
    from madicp_tpu_torch.models.pipeline import PipelineConfig, odometry_step
    from madicp_tpu_torch.parallel import Fleet

    cfg = PipelineConfig(**PIPE_KW, n_points=4096, depth=10, max_leaves=1024,
                         max_icp_iterations=6, dtype=torch.float64, **SCHEDULES[schedule])
    fleet = Fleet(cfg, 2, device=cuda_device)
    for i in range(2):
        fleet.compute(None, *_fleet_inputs(cfg, _rooms([[0.05 * i, 0, 0],
                                                        [0.2 * i, 0.02 * i, 0]]), cuda_device))
    pts, val = _fleet_inputs(cfg, _rooms([[0.1, 0, 0], [0.4, 0.04, 0]]), cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, out = odometry_step(cfg, fleet.states, pts, val, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.pose.shape == (2, 4, 4) and torch.isfinite(out.pose).all()
    assert bool(out.n_descents.gt(0).all())


@pytest.mark.cuda
def test_kf_hook_issues_on_nccl_on_cuda(cuda_device):
    """A fleet on a (1, 1) mesh of a one-rank NCCL group runs its
    keyframe all-reduces for real and tracks the fleet without a mesh."""
    import socket

    from madicp_tpu_torch.models.pipeline import PipelineConfig
    from madicp_tpu_torch.parallel import Fleet, distributed, make_mesh
    from madicp_tpu_torch.parallel.sharded_icp import counter

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    topo = distributed.initialize(f"localhost:{port}", 1, 0, backend="nccl",
                                  device=cuda_device)
    try:
        assert topo["backend"] == "nccl"
        cfg = PipelineConfig(**PIPE_KW, n_points=4096, depth=10, max_leaves=1024,
                             dtype=torch.float64)
        sharded = Fleet(cfg, 2, mesh=make_mesh(kf=1, seq=1), device=cuda_device)
        plain = Fleet(cfg, 2, device=cuda_device)
        before = counter.all_reduces
        for i in range(3):
            inputs = _fleet_inputs(cfg, _rooms([[0.05 * i, 0, 0], [0.2 * i, 0, 0]]),
                                   cuda_device)
            sharded.compute(None, *inputs)
            plain.compute(None, *inputs)
        # two scans of 15 rounds, (H, b) each, matched and the count once
        assert counter.all_reduces - before == 2 * (15 + 2)
        np.testing.assert_allclose(sharded.poses(), plain.poses(), atol=1e-9)
    finally:
        distributed.shutdown()


GRAPH_KW = dict(PIPE_KW, n_points=4096, depth=10, max_leaves=1024, max_icp_iterations=6,
                dtype=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_graphed_pipeline_matches_eager_on_cuda(cuda_device, schedule):
    """A Pipeline replays one captured graph a scan from its second
    odometry scan on, and its poses stay within 1e-9 (float64) of an
    eager twin that runs the captured body directly (#1's double atomics
    order sums differently from run to run); the segment-sum counter
    advances depth + 1 a replayed scan."""
    from madicp_tpu_torch.models.step_graph import step_in_place

    graphed = Pipeline(**GRAPH_KW, device=cuda_device, **SCHEDULES[schedule])
    eager = Pipeline(**GRAPH_KW, device=cuda_device, **SCHEDULES[schedule])
    for i, scan in enumerate(_rooms([[0.05 * i, 0.02 * i, 0] for i in range(6)])):
        pts, val, _ = graphed.stage(scan)
        before = segsum.counter.launches
        graphed.compute_device(0.1 * i, pts, val)
        launches = segsum.counter.launches - before
        if i == 0:
            eager.compute_device(0.0, pts, val)
        else:
            step_in_place(eager.cfg, eager._graphs.state, pts[None], val[None])
        assert launches == GRAPH_KW["depth"] + 1
        np.testing.assert_allclose(graphed.current_pose(), eager.current_pose(),
                                   rtol=0, atol=1e-9)
        assert len(graphed._graphs.captured()) == (i >= 2)


@pytest.mark.cuda
def test_graphed_fleet_matches_eager_on_cuda(cuda_device):
    """A B = 2 fleet replays its graph from the second odometry scan on;
    every sequence stays within 1e-9 of an eager twin's, and what a step
    returned is unchanged by the next."""
    from madicp_tpu_torch.models.pipeline import PipelineConfig
    from madicp_tpu_torch.models.step_graph import step_in_place
    from madicp_tpu_torch.parallel import Fleet

    cfg = PipelineConfig(**GRAPH_KW)
    graphed, eager = Fleet(cfg, 2, device=cuda_device), Fleet(cfg, 2, device=cuda_device)
    kept = []
    for i in range(5):
        inputs = _fleet_inputs(cfg, _rooms([[0.05 * i, 0, 0], [0.2 * i, 0.02 * i, 0]]),
                               cuda_device)
        out = graphed.compute(None, *inputs)
        kept.append((out, [t.clone() for t in out]))
        if i == 0:
            eager.compute(None, *inputs)
        else:
            step_in_place(cfg, eager.states, *inputs)
        np.testing.assert_allclose(graphed.poses(), eager.poses(), rtol=0, atol=1e-9)
    for out, copy in kept:
        assert all(torch.equal(t, c) for t, c in zip(out, copy))
    assert len(graphed._graphs.captured()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gn_solve_and_logdet_replay_in_a_cuda_graph(cuda_device, dtype):
    """The step's 6x6 solve (``linalg.solve_ex``) and log-determinant
    (``linalg.slogdet``) capture, and a replay on new inputs equals the
    eager call bit for bit (an empty and a singular system included)."""
    from madicp_tpu_torch.ops.icp_core import neg_logdet, solve_gn

    def systems(seed):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(4, 6, 6))
        H = A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(6)
        H[2] = 0.0  # empty: zeros
        H[3, :, 5] = H[3, 5, :] = 0.0  # singular
        return (torch.as_tensor(H, dtype=dtype, device=cuda_device),
                torch.as_tensor(rng.normal(size=(4, 6)), dtype=dtype, device=cuda_device))

    H, b = systems(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solve_gn(H, b), neg_logdet(H)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dx, nld = solve_gn(H, b), neg_logdet(H)
    for seed in (1, 2):
        H2, b2 = systems(seed)
        H.copy_(H2)
        b.copy_(b2)
        graph.replay()
        assert torch.equal(dx, solve_gn(H2, b2)) and torch.equal(nld, neg_logdet(H2))
        assert torch.equal(dx[2], torch.zeros_like(dx[2]))


FLAGSHIP_N, FLAGSHIP_DEPTH, H100_SMS = 131072, 16, 132


@pytest.mark.parametrize("level", range(FLAGSHIP_DEPTH + 1))
def test_segsum_plan_fills_the_card_at_the_flagship_levels(level):
    """The host plan of each flagship level (n = 131072 into 2^level
    nodes on an H100's 132 SMs): every grid fills the SMs as far as its
    work allows, at most two launches a level, a workspace of 2 + 10 sz
    doubles. Forcing a path the level cannot take gives None."""
    sz = 1 << level
    pl = segsum.plan(FLAGSHIP_N, sz, H100_SMS)
    assert pl.path == ("warp" if sz <= segsum.WARP_MAX_NODES else
                       "sort" if FLAGSHIP_N >= segsum.CONTENDED_POINTS * sz else "point")
    assert pl.blocks >= H100_SMS
    assert pl.launches <= 2 and pl.launches == 1 + (10 * sz > segsum.TICKET_MAX_ENTRIES)
    if pl.round_blocks:
        assert pl.round_blocks >= min(H100_SMS, -(-10 * sz // segsum.THREADS))
    assert pl.workspace == 2 + 10 * sz
    assert pl.threads % 32 == 0
    if pl.tile:
        assert pl.tile * pl.blocks >= FLAGSHIP_N > pl.tile * (pl.blocks - 1)
    for path in segsum.PATHS:
        forced = segsum.plan(FLAGSHIP_N, sz, H100_SMS, path)
        admissible = {"point": True, "sort": sz <= segsum.SORT_MAX_NODES,
                      "warp": 80 * sz <= segsum.MAX_SMEM}[path]
        assert (forced is not None) == admissible
        if forced is not None:
            assert forced.path == path
    with pytest.raises(ValueError, match="path must be"):
        segsum.plan(FLAGSHIP_N, sz, H100_SMS, "slab")


def _segsum_inputs(n: int, sz: int, ids: str = "spread", seed: int = 0):
    """(d (n, 3) float64, idx (n,) int32): ``ids`` "spread" draws ids in
    [-2, sz + 2) (both sides drop), "negative" in [-sz - 2, 0) and sz
    (every id drops, negatives most), "dropped" sz .. sz + 6 (every id
    drops)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 3, (n, 3))
    lo, hi = {"spread": (-2, sz + 2), "negative": (-sz - 2, 1),
              "dropped": (sz, sz + 7)}[ids]
    idx = rng.integers(lo, hi, n)
    if ids == "negative":
        idx = np.where(idx == 0, sz, idx)
    return torch.from_numpy(d), torch.from_numpy(idx.astype(np.int32))


def _segsum_held_twice(cuda_device, d, idx, sz, dtype):
    """The kernel twice on the card against the plain version in float64:
    rtol 1e-5/atol 5e-3 in float32 (atomic sum order, one rounding),
    1e-9 in float64; one launch counted a call, and the workspace left
    zeroed for the next call."""
    dc, ic = d.to(dtype).to(cuda_device), idx.to(cuda_device)
    want = segsum.segsum_moments_ref(dc.cpu().double(), idx, sz)
    tol = dict(rtol=1e-5, atol=5e-3) if dtype == torch.float32 else dict(rtol=1e-9, atol=1e-9)
    for _ in range(2):
        before = segsum.counter.launches
        got = segsum.segsum_moments(dc, ic, sz)
        torch.cuda.synchronize()
        assert segsum.counter.launches == before + 1
        torch.testing.assert_close(got.cpu().double(), want, **tol)
        assert all(not ws.any() for ws in segsum._workspaces.values())
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sz", [1, 32, 33, 512, 513, 1024, 1025, 65536])
def test_segsum_kernel_matches_plain_on_cuda(cuda_device, dtype, sz):
    """Each path of the kernel at and around its boundaries at n = 131072:
    warp tables (sz <= 32), the block sort (33-1024), one atomic a point
    and column (1025 up), the last block rounding (sz <= 512) or a
    second kernel (513 up); ids drop on both sides."""
    d, idx = _segsum_inputs(131072, sz, seed=sz)
    _segsum_held_twice(cuda_device, d, idx, sz, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,sz,ids", [
    (131072, 8, "dropped"),  # warp path, every id out of range
    (131072, 1024, "dropped"),  # sort path and the rounding kernel
    (131072, 65536, "dropped"),  # one atomic a point
    (131072, 256, "negative"),  # negative ids only
    (131072 - 5, 1, "spread"),  # ragged: the last warp step of the last block
    (131072 - 5, 300, "spread"),  # ragged tile of the sort path
    (131072 - 5, 4096, "spread"),  # ragged grid of the point path
    (2**22 - 5, 8, "spread"),  # contended: ~5e5 points a node, 2048 blocks
    (2**22 - 5, 131072, "spread"),  # uncontended: ~32 points a node
])
def test_segsum_kernel_at_its_edges_on_cuda(cuda_device, dtype, n, sz, ids):
    """Empty tables, negative ids, ragged point counts and N = 2^22 - 5 on
    a contended and an uncontended level, both dtypes, each twice."""
    d, idx = _segsum_inputs(n, sz, ids, seed=n + sz)
    want = _segsum_held_twice(cuda_device, d, idx, sz, dtype)
    assert bool(want.any()) != (ids != "spread")


@pytest.mark.cuda
@pytest.mark.parametrize("sz", [16, 1024, 65536])
def test_segsum_kernel_replays_in_a_cuda_graph(cuda_device, sz):
    """A warm call captured in a CUDA graph and replayed three times gives
    the plain version's sums each time: no allocation or host work at
    replay, and every replay leaves the workspace zeroed for the next."""
    d, idx = _segsum_inputs(131072, sz, seed=7)
    dc, ic = d.float().to(cuda_device), idx.to(cuda_device)
    want = segsum.segsum_moments_ref(dc.cpu().double(), idx, sz)
    segsum.segsum_moments(dc, ic, sz)  # sizes the workspace
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = segsum.segsum_moments(dc, ic, sz)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu().double(), want, rtol=1e-5, atol=5e-3)
        assert all(not ws.any() for ws in segsum._workspaces.values())


def _probe_kernel_case(cuda_device, name, m, *args):
    """The wrapper ``name`` on the card at the probe's N (less 5, so the
    last 16-point chunk is ragged), its launch counted once."""
    idx, x = _probe_inputs(name, 131072 - 5, m, seed=m)
    before = scatter_probe.launches[name]
    got = getattr(scatter_probe, name)(idx.to(cuda_device), x.to(cuda_device), m, *args)
    torch.cuda.synchronize()
    assert scatter_probe.launches[name] == before + 1
    return idx, x, got.cpu()


def _held_twice(call, want, **tol):
    """``call()`` twice, each against the float64 sums ``want`` at ``tol``:
    the second call finds the workspace as the first left it, zeroed."""
    for _ in range(2):
        got = call()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu().double(), want, **tol)
        assert all(not ws.any() for ws in scatter_probe._workspaces.values())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", scatter_probe.MODES)
@pytest.mark.parametrize("m", [64, 100, 1024, 4096, 16384])
def test_onehot_segsum_kernel_matches_plain_on_cuda(cuda_device, mode, m):
    """Every mode is the one float32 scatter (shared tables combined over
    clusters at m = 64 and 100, a ragged m; vector atomics and a
    transposing second kernel from 1024) against the float64 sums at the
    probe's tolerance, atol 1e-3 (float32 sum order); twice, with the
    workspace left zeroed."""
    idx, x, got = _probe_kernel_case(cuda_device, "onehot_segsum", m, mode)
    want = scatter_probe.segsum16_ref(idx, x.double().T, m).T
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-3)
    idx, x = idx.to(cuda_device), x.to(cuda_device)
    _held_twice(lambda: scatter_probe.onehot_segsum(idx, x, m, mode), want, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", scatter_probe.MODES)
@pytest.mark.parametrize("m", [8, 2048, 16384])
def test_onehot_segsum_kernel_holds_at_large_n_on_cuda(cuda_device, mode, m):
    """At N = 2^22 - 5 every accumulator keeps its float32 sums short:
    shared tables with more blocks than two an SM (m = 8, ~5e5 terms an
    entry), with the largest table (2048) and vector atomics (16384, ~256
    terms). Held to the float64 sums at atol 1e-3 plus one float32 ulp of
    the sum, which the float32 output cannot beat where the sums are
    large; twice, with the workspace left zeroed."""
    n = 2**22 - 5
    idx, x = (t.to(cuda_device) for t in _probe_inputs("onehot_segsum", n, m, seed=m))
    want = scatter_probe.segsum16_ref(idx, x.double().T, m).T
    _held_twice(lambda: scatter_probe.onehot_segsum(idx, x, m, mode), want.cpu(),
                rtol=2.0**-23, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 64, 100, 4096, 16384])
def test_fused_moments_kernel_matches_plain_on_cuda(cuda_device, m):
    """The moment columns formed in the kernel and scattered (per-block
    shared tables combined in double at m = 8, 64 and 100, vector atomics
    into the output at 4096 and 16384) against the float64 sums at atol
    1e-3; the workspace is left zeroed for the next call."""
    idx, d, got = _probe_kernel_case(cuda_device, "fused_moments", m)
    want = scatter_probe.segsum16_ref(idx, scatter_probe.moment_columns16(d.double()), m)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-3)
    assert all(not ws.any() for ws in scatter_probe._workspaces.values())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2048, 4096, 16384])
def test_fused_moments_kernel_holds_at_large_n_on_cuda(cuda_device, m):
    """At N = 2^22 - 5 every accumulator keeps its float32 sums short:
    shared tables with more blocks than two an SM (m = 8, ~3e5 terms an
    entry) and with 264 (2048), double atomics past the shared table
    (4096, ~1000 terms an entry) and vector atomics (16384, ~256). Held to
    the float64 sums at atol 1e-3 plus one float32 ulp of the sum, which
    the float32 output cannot beat where the sums are large."""
    n = 2**22 - 5
    idx, d = (t.to(cuda_device) for t in _probe_inputs("fused_moments", n, m, seed=m))
    got = scatter_probe.fused_moments(idx, d, m)
    want = scatter_probe.segsum16_ref(idx, scatter_probe.moment_columns16(d.double()), m)
    torch.testing.assert_close(got.double(), want, rtol=2.0**-23, atol=1e-3)
    assert all(not ws.any() for ws in scatter_probe._workspaces.values())


@pytest.mark.cuda
def test_rmw_segsum_kernel_is_bitwise_in_order_on_cuda(cuda_device):
    """Row order, float32: bit for bit the in-order plain loop."""
    idx, vals = _probe_inputs("rmw_segsum", 8192, 256, seed=3)
    got = scatter_probe.rmw_segsum(idx.to(cuda_device), vals.to(cuda_device), 256)
    assert torch.equal(got.cpu(), scatter_probe.rmw_segsum_ref(idx, vals, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("q,mq,drop_all", [
    (1000, 256, False),  # Q not a multiple of 32
    (3 * 8192 + 77, 1, False),  # ragged last pass; one run of 24653 rows
    (8192, 64, True),  # every id out of range
    (4099, scatter_probe.RMW_MAX_ROWS, False),  # the largest table admitted
])
def test_rmw_segsum_kernel_is_bitwise_at_its_edges_on_cuda(cuda_device, q, mq, drop_all):
    """Bit for bit the in-order plain loop where the kernel's passes,
    staging batches and blocks of 16 ids are ragged, full or empty."""
    rng = np.random.default_rng(q)
    ids = rng.integers(-2, mq + 3, q)
    if drop_all:
        ids = np.where(rng.random(q) < 0.5, -1 - ids % 7, mq + ids % 7)
    idx = torch.from_numpy(ids.astype(np.int32))
    vals = torch.from_numpy(rng.normal(0, 1, (q, 16)).astype(np.float32))
    before = scatter_probe.launches["rmw_segsum"]
    got = scatter_probe.rmw_segsum(idx.to(cuda_device), vals.to(cuda_device), mq)
    torch.cuda.synchronize()
    assert scatter_probe.launches["rmw_segsum"] == before + 1
    want = scatter_probe.rmw_segsum_ref(idx, vals, mq)
    assert torch.equal(got.cpu(), want)
    assert bool(want.any()) != drop_all


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 4096])
def test_scatter_segsum_kernel_matches_plain_on_cuda(cuda_device, m):
    """Shared tables over many clusters (m = 256) and vector atomics
    (m = 4096) against the float64 sums at atol 1e-3."""
    idx, vals, got = _probe_kernel_case(cuda_device, "scatter_segsum", m)
    want = scatter_probe.segsum16_ref(idx, vals.double(), m)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("q,mq,drop_all", [
    (8192, 256, False),  # the probe's shape: memset and vector atomics
    (8195, 256, False),  # the same with Q not a multiple of 32
    (3 * 8192 + 77, 1, False),  # one table row: shared tables, the ticket
    (8192, 256, True),  # every id out of range, vector atomics
    (8192, 16, True),  # every id out of range, shared tables
])
def test_scatter_segsum_kernel_at_its_edges_on_cuda(cuda_device, q, mq, drop_all):
    """Each accumulator of the unordered segment sum against the float64
    sums at atol 1e-3, twice, with the workspace left zeroed; the caller
    never zeroes the output, so dropped ids must still give 0."""
    rng = np.random.default_rng(q + mq)
    ids = rng.integers(-2, mq + 3, q)
    if drop_all:
        ids = np.where(rng.random(q) < 0.5, -1 - ids % 7, mq + ids % 7)
    idx = torch.from_numpy(ids.astype(np.int32))
    vals = torch.from_numpy(rng.normal(0, 1, (q, 16)).astype(np.float32))
    want = scatter_probe.segsum16_ref(idx, vals.double(), mq)
    assert bool(want.any()) != drop_all
    idx, vals = idx.to(cuda_device), vals.to(cuda_device)
    before = scatter_probe.launches["scatter_segsum"]
    _held_twice(lambda: scatter_probe.scatter_segsum(idx, vals, mq), want, rtol=0, atol=1e-3)
    assert scatter_probe.launches["scatter_segsum"] == before + 2


def _write_kitti(dirpath: Path, scans):
    dirpath.mkdir(parents=True)
    for i, pts in enumerate(scans):
        rec = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        rec.astype(np.float32).tofile(dirpath / f"{i:06d}.bin")


def test_cli_kitti_end_to_end_on_cpu(tmp_path, four_walls, capsys):
    """The CLI drives a KITTI .bin directory on the CPU and writes one
    KITTI pose line per scan; the recovered motion is the drive's."""
    scans = [four_walls - np.array([1.0 + 0.05 * i, 1.0, 0.0]) for i in range(4)]
    _write_kitti(tmp_path / "seq", scans)
    out = tmp_path / "out"
    rc = cli.main([
        "--data-path", str(tmp_path / "seq"), "--estimate-path", str(out),
        "--dataset-config", "kitti", "--noviz", "--device", "cpu",
        "--n-points", "8192", "--depth", "12", "--max-leaves", "4096",
    ])
    assert rc == 0
    poses = np.loadtxt(out / "estimate.txt").reshape(-1, 3, 4)
    assert poses.shape == (4, 3, 4) and np.isfinite(poses).all()
    # estimate.txt is conjugated by the KITTI extrinsics (x_lidar -> z_base)
    assert abs(poses[-1, 2, 3] - 0.15) < 0.02
    assert "scan      4" in capsys.readouterr().out


@pytest.mark.parametrize("option", ["viz", "resume", "profile", "checkpoint"])
def test_cli_runs_the_options_it_once_refused(request, tmp_path, four_walls, option):
    """The visualizer (under the fake open3d), --resume (no checkpoint
    yet: a fresh start), --profile and --checkpoint-every each run to the
    end and leave their artifact."""
    from madicp_tpu_torch.utils.checkpoint import load_pipeline

    scans = [four_walls - np.array([1.0 + 0.05 * i, 1.0, 0.0]) for i in range(3)]
    _write_kitti(tmp_path / "seq", scans)
    out = tmp_path / "o"
    extra = {"viz": [], "resume": ["--noviz", "--resume"],
             "profile": ["--noviz", "--profile", str(tmp_path / "p")],
             "checkpoint": ["--noviz", "--checkpoint-every", "2"]}[option]
    log = request.getfixturevalue("fake_o3d") if option == "viz" else None
    rc = cli.main(["--data-path", str(tmp_path / "seq"), "--estimate-path", str(out),
                   "--dataset-config", "kitti", "--device", "cpu", "--n-points", "4096",
                   "--depth", "10", "--max-leaves", "2048", *extra])
    assert rc == 0
    assert np.loadtxt(out / "estimate.txt").shape == (3, 12)
    if option == "viz":
        names = [n for n, _, _ in log]
        assert names.count("create_sphere") >= 1 and "destroy_window" in names
    elif option == "profile":
        trace = json.loads((tmp_path / "p" / "trace.json").read_text())
        assert any(e.get("name") == "aten::index_add_" for e in trace["traceEvents"])
    elif option == "checkpoint":
        assert load_pipeline(out / "pipeline.ckpt.npz", device="cpu").current_id() == 2
    else:
        assert not (out / "pipeline.ckpt.npz").exists()


@pytest.mark.cuda
def test_a_host_sync_in_the_step_makes_its_capture_raise_on_cuda(cuda_device, monkeypatch):
    """A step that reads the device from the host cannot be captured: the
    scan that would capture it raises, and no graph is kept (there is no
    silent eager fallback). Last in the file: a failed capture may leave
    torch's capture bookkeeping behind."""
    import madicp_tpu_torch.models.pipeline as pipeline_mod

    real = pipeline_mod.neg_logdet

    def syncing(H):
        float(H.sum())  # a host read
        return real(H)

    pipe = Pipeline(**GRAPH_KW, device=cuda_device)
    scans = _rooms([[0.05 * i, 0.02 * i, 0] for i in range(3)])
    for i in range(2):  # the bootstrap and the warm-up run eagerly
        pipe.compute(0.1 * i, scans[i])
    monkeypatch.setattr(pipeline_mod, "neg_logdet", syncing)
    with pytest.raises(RuntimeError):
        pipe.compute(0.2, scans[2])
    assert not pipe._graphs.captured()
