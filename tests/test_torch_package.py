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
from madicp_tpu_torch.kernels import build, segsum
from madicp_tpu_torch.models.nn import MADtree
from madicp_tpu_torch.models.pipeline import Pipeline
from madicp_tpu_torch.models.registration import MADicp
from madicp_tpu_torch.models.vel_estimator import VelEstimator

REPO = Path(__file__).resolve().parents[1]
PIPE_KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8,
               b_min=0.1, b_ratio=0.02, num_keyframes=2)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "import madicp_tpu_torch, madicp_tpu_torch.ops, madicp_tpu_torch.models\n"
        "import madicp_tpu_torch.kernels, madicp_tpu_torch.utils.convert\n"
        "import madicp_tpu_torch.apps.cli, chip_smoke\n"
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
