"""Package-level checks of the PyTorch port: no JAX at import, no silent
CPU fallback, the import-time precision pins, kernel dispatch and build
guards, and the KITTI CLI end to end on the CPU. Tests marked ``cuda``
hold the CUDA kernel to its plain version and skip without a card."""

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
from madicp_tpu_torch.models.pipeline import Pipeline
from madicp_tpu_torch.models.registration import MADicp
from madicp_tpu_torch.models.vel_estimator import VelEstimator

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sz", [1, 32, 512, 4096])
def test_segsum_kernel_matches_plain_on_cuda(cuda_device, dtype, sz):
    """Every path of the kernel (warp-aggregated, shared table, global
    atomics) against the plain version in float64: rtol 1e-5/atol 5e-3
    in float32 (atomic sum order), 1e-9 relative in float64."""
    g = torch.Generator().manual_seed(sz)
    n = 131072
    d = (torch.randn(n, 3, generator=g, dtype=torch.float64) * 3).to(dtype)
    idx = torch.randint(-2, sz + 2, (n,), generator=g, dtype=torch.int32)
    before = segsum.counter.launches
    got = segsum.segsum_moments(d.to(cuda_device), idx.to(cuda_device), sz)
    torch.cuda.synchronize()
    assert segsum.counter.launches == before + 1
    want = segsum.segsum_moments_ref(d.double(), idx, sz)
    tol = dict(rtol=1e-5, atol=5e-3) if dtype == torch.float32 else dict(rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(got.cpu().double(), want, **tol)


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


@pytest.mark.parametrize("extra", [[], ["--noviz", "--resume"],
                                   ["--noviz", "--profile", "p"],
                                   ["--noviz", "--checkpoint-every", "5"]])
def test_cli_refuses_unported_options(tmp_path, capsys, extra):
    (tmp_path / "seq").mkdir()
    rc = cli.main(["--data-path", str(tmp_path / "seq"), "--estimate-path",
                   str(tmp_path / "o"), "--dataset-config", "kitti",
                   "--device", "cpu", *extra])
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().err
