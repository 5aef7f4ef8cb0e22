"""``Pipeline.stage``: a cloud to the device at the static shape.

On CUDA the rows cross once, unpadded, from a page-locked buffer that
torch's caching host allocator reuses, and the padding and the mask are
made on the card; on the CPU the rows are written straight into the
staged tensor. Both share the row fill (``fill_rows``) and the mask, and
both must stage what the pipeline's earlier host pad staged, bit for bit:
:func:`host_pad` is that pad, kept here as the oracle. The ``cuda`` tests
(``python -m pytest tests/test_torch_stage.py -m cuda --noconftest -q`` on
the card) hold the reuse of the buffers: clouds staged back to back, a
chunk staged before any of its steps, a producer thread staging ahead of
the steps, and the ``madicp.stage.wait`` span. No JAX.
"""

import numpy as np
import pytest
import torch

from madicp_tpu_torch.models.pipeline import Pipeline
from madicp_tpu_torch.native.prefetch import Prefetcher
from madicp_tpu_torch.utils.timing import Trace

torch.set_num_threads(2)

KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8, b_min=0.1,
          b_ratio=0.02, num_keyframes=3, max_icp_iterations=3)
N_CPU = 1024


def host_pad(points, N, dtype):
    """The pipeline's host pad before the page-locked stage: a zeroed
    (N, 3) array of the configuration's dtype with the cloud's first N
    rows, the mask, and the points beyond N."""
    points = np.asarray(points)
    n = points.shape[0]
    n_dropped = max(0, n - N)
    if n > N:
        points = points[:N]
        n = N
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    pts = np.zeros((N, 3), dtype=np_dtype)
    pts[:n] = points
    valid = np.zeros(N, bool)
    valid[:n] = True
    return pts, valid, n_dropped


def cloud(n, seed, dtype=np.float32):
    """``n`` points drawn from ``seed`` in float64 (digits past float32's),
    cast to ``dtype``."""
    return (np.random.default_rng(seed).normal(size=(n, 3)) * 37.0).astype(dtype)


# case: (configuration dtype, the cloud for a capacity of N points)
CASES = {
    "n_below_N": (torch.float32, lambda N: cloud(N // 3, 1)),
    "n_equals_N": (torch.float32, lambda N: cloud(N, 2)),
    "n_above_N": (torch.float32, lambda N: cloud(N + 77, 3)),
    "n_zero": (torch.float32, lambda N: cloud(0, 4)),
    "float64_into_float32": (torch.float32, lambda N: cloud(N // 2, 5, np.float64)),
    "float64_configuration": (torch.float64, lambda N: cloud(N - 5, 6, np.float64)),
    "non_contiguous_view": (torch.float32,
                            lambda N: cloud(2 * N + 8, 7, np.float64)[::2, [2, 0, 1]]),
}


def assert_staged(staged, points, N, dtype, device):
    """``staged`` is :func:`host_pad`'s result, bit for bit, on ``device``."""
    pts, valid, n_dropped = staged
    want_pts, want_valid, want_dropped = host_pad(points, N, dtype)
    assert pts.device.type == torch.device(device).type == valid.device.type
    assert pts.dtype == dtype and pts.shape == (N, 3) and pts.is_contiguous()
    assert valid.dtype == torch.bool and valid.shape == (N,)
    got = pts.cpu().numpy()
    assert got.dtype == want_pts.dtype
    bits = np.uint64 if got.dtype == np.float64 else np.uint32
    np.testing.assert_array_equal(got.view(bits), want_pts.view(bits))
    np.testing.assert_array_equal(valid.cpu().numpy(), want_valid)
    assert n_dropped == want_dropped


def pipe(device, dtype=torch.float32, **kw):
    return Pipeline(**{**KW, "n_points": N_CPU, "depth": 8, **kw}, dtype=dtype, device=device)


@pytest.mark.parametrize("case", list(CASES))
def test_stage_is_the_host_pad_bit_for_bit(case):
    """Every case of the fill, after a full cloud was staged on the same
    pipeline (a row of it showing through would fail): the rows the
    cloud has, converted as numpy converts, zeros after, the mask below
    n, the points past the capacity counted."""
    dtype, make = CASES[case]
    p = pipe("cpu", dtype)
    first = cloud(N_CPU, 99)
    p.stage(first)
    points = make(N_CPU)
    if case == "non_contiguous_view":
        assert not points.flags.c_contiguous
    assert_staged(p.stage(points), points, N_CPU, dtype, "cpu")


# ---------------------------------------------------------------- on card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the page-locked path runs only there)")
    return torch.device("cuda")


CARD_KW = dict(n_points=16384, depth=12, max_icp_iterations=6)


def world(step: int, n: int = 10000) -> np.ndarray:
    """A scan of a ground and walls in both orientations, seen from x =
    0.2 m a step."""
    rng = np.random.default_rng(step)
    k = n // 5
    ground = np.c_[rng.uniform(-15, 15, (k, 2)), np.full(k, -1.5)]
    walls = []
    for c in (-8.0, 8.0):
        u, z = rng.uniform(-8, 8, k), rng.uniform(-1.5, 3, k)
        walls.append(np.c_[np.full(k, c), u, z])
        walls.append(np.c_[u, np.full(k, c), z])
    pts = np.concatenate([ground] + walls)
    pts[:, 0] -= 0.2 * step
    return pts


def scan_by_scan(device, scans):
    """Each scan's pose from :meth:`Pipeline.compute`, the host waiting
    for the device after every scan."""
    p = pipe(device, **CARD_KW)
    poses = []
    for i, s in enumerate(scans):
        p.compute(0.1 * i, s)
        poses.append(p.current_pose())
    return np.stack(poses)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stages_back_to_back_read_back_intact_on_cuda(cuda_device, dtype):
    """Every case's cloud and full clouds between them, staged with no
    synchronisation while the stream is held back by a sleeping kernel:
    the copies wait behind it, so a buffer reused before its copy ran
    would show in what was staged. The allocator holds the staged
    tensors' memory from a first pass (a fresh ``cudaMalloc`` may wait
    for the device, which would let the sleep end too early)."""
    N = 131072
    p = Pipeline(**KW, n_points=N, depth=16, dtype=dtype, device=cuda_device)
    clouds = []
    for _ in range(3):
        for case, (case_dtype, make) in CASES.items():
            if case_dtype == dtype or case == "float64_into_float32":
                clouds += [make(N), cloud(N, len(clouds) + 50)]
    warm = [p.stage(c) for c in clouds]
    del warm
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s on the card: the copies queue behind it
    staged = [p.stage(c) for c in clouds]
    for s, c in zip(staged, clouds):
        assert_staged(s, c, N, dtype, cuda_device)


@pytest.mark.cuda
def test_compute_batch_staged_ahead_equals_scan_by_scan_on_cuda(cuda_device):
    """A chunk stages all its clouds before it enqueues a step; its poses
    equal those of a pipeline fed one scan at a time, bit for bit."""
    scans = [world(i) for i in range(10)]
    want = scan_by_scan(cuda_device, scans)
    p = pipe(cuda_device, **CARD_KW)
    p.compute(0.0, scans[0])
    got = p.compute_batch([0.1 * i for i in range(1, 10)], scans[1:])
    np.testing.assert_array_equal(got, want[1:])


@pytest.mark.cuda
def test_a_producer_thread_staging_ahead_equals_scan_by_scan_on_cuda(cuda_device):
    """As the CLI's default loop: a ``Prefetcher`` stages from its thread
    while the steps run, and the consumer reads no pose until the end, so
    the producer runs as far ahead as its queue lets it."""
    scans = [world(i) for i in range(12)]
    want = scan_by_scan(cuda_device, scans)
    p = pipe(cuda_device, **CARD_KW)
    poses = []
    items = ((0.1 * i, s) for i, s in enumerate(scans))
    with Prefetcher(items, transform=lambda it: (it[0], *p.stage(it[1]))) as staged:
        for item in staged:
            p.compute_device(*item)
            poses.append(p._last.pose)  # the step's own: no later step changes it
    got = torch.stack(poses).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_stage_wait_is_recorded_once_a_traced_stage_on_cuda(cuda_device):
    """On the card every stage waits for its buffer inside ``madicp.stage``,
    before the fill and the copy, with its scan."""
    p = pipe(cuda_device, **CARD_KW)
    p.trace = Trace(cuda_device)
    for i in range(3):
        p.compute(0.1 * i, world(i))
        p.current_pose()
    p.compute_batch([0.1 * i for i in range(3, 7)], [world(i) for i in range(3, 7)])
    spans = p.trace.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    stages = [s for s in spans if s["name"] == "madicp.stage"]
    waits = [s for s in spans if s["name"] == "madicp.stage.wait"]
    assert len(stages) == len(waits) == 7
    for w in waits:
        parent = by_id[w["parent"]]
        assert parent["name"] == "madicp.stage" and parent["scan"] == w["scan"]
        kids = sorted((s["start_ns"], s["name"]) for s in spans
                      if s["parent"] == parent["id"])
        assert [name for _, name in kids] == ["madicp.stage.wait", "madicp.stage.pad",
                                              "madicp.copy_in"]
