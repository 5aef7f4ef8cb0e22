"""The MAD-tree build's kernels of the PyTorch port: the node math (K9,
``kernels/build_nodes.py``) and the per-point pass and leaf pick (K8,
``kernels/build_points.py``), the body of ``ops/tree.py::build_tree``.

On the CPU: ``build_tree`` (every level through the plain versions)
against the JAX package's ``build_tree``, cloud by cloud of a batch of two
with padding rows and a depth cap that forces leaves, float64 at the
tolerances of ``tests/test_torch_tree.py`` and float32 at its bound; the
plain functions driven level by level rebuild that tree bit for bit; the
plain ``eigh3`` against the JAX package's on random, spherical, planar,
line and repeated-eigenvalue spectra; the order-preserving keys; the
wrappers' dispatch and argument checks. Tests marked ``cuda`` hold each
kernel to its plain version on the card bit for bit at every level, the
built tree to the plain versions' build on the same moments, and a CUDA
graph's replay to the eager build, and skip without a card. JAX is
imported by the CPU tests only, so a machine with a card needs none:
``python -m pytest tests/test_torch_build_kernels.py -m cuda --noconftest``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from madicp_tpu_torch.kernels import build_nodes as bn
from madicp_tpu_torch.kernels import build_points as bp
from madicp_tpu_torch.kernels import segsum
from madicp_tpu_torch.ops.eigh3 import eigh3
from madicp_tpu_torch.ops.tree import build_tree, tree_arena_size
from madicp_tpu_torch.probes import build_levels

REPO = Path(__file__).resolve().parents[1]
BUILD_KW = dict(b_max=0.2, b_min=0.1)
DEPTH = 8  # 256 leaves at most for ~2300 points: the cap forces leaves


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's tree module and eigh3, on the CPU with x64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import madicp_tpu.ops.tree as jax_tree
    from madicp_tpu.ops.eigh3 import eigh3 as jax_eigh3

    return jax_tree, jax_eigh3


def scene(rng, n: int, n_valid: int):
    """A room (floor, four walls) with a box and scattered clutter:
    ``n_valid`` points, padded to ``n`` with finite invalid rows."""
    k = n_valid // 8
    parts = [
        rng.uniform([0, 0, 0], [6, 5, 0.02], (2 * k, 3)),
        rng.uniform([0, 0, 0], [6, 0.02, 2.5], (k, 3)),
        rng.uniform([0, 4.98, 0], [6, 5, 2.5], (k, 3)),
        rng.uniform([0, 0, 0], [0.02, 5, 2.5], (k, 3)),
        rng.uniform([5.98, 0, 0], [6, 5, 2.5], (k, 3)),
        rng.uniform([2, 2, 0], [2.6, 2.4, 0.9], (k, 3)),
    ]
    pts = np.concatenate(parts + [rng.uniform([0, 0, 0], [6, 5, 2.5], (n_valid - 7 * k, 3))])
    rng.shuffle(pts)
    out = np.concatenate([pts, rng.uniform(-1, 1, (n - n_valid, 3))])
    valid = np.arange(n) < n_valid
    return out, valid


def batch(B: int, n: int, seed: int = 0):
    """(B, n, 3) points and (B, n) valid masks: cloud b has n - 37 (b + 1)
    valid points, the rest padding."""
    rng = np.random.default_rng(seed)
    clouds = [scene(rng, n, n - 37 * (b + 1)) for b in range(B)]
    return np.stack([c[0] for c in clouds]), np.stack([c[1] for c in clouds])


_BUILDS: dict = {}


def torch_build(dtype):
    """build_tree of a (2, 2400) batch at DEPTH on the CPU (once a dtype)."""
    if dtype not in _BUILDS:
        pts, valid = batch(2, 2400)
        _BUILDS[dtype] = build_tree(torch.from_numpy(pts).to(dtype), torch.from_numpy(valid),
                                    depth=DEPTH, **BUILD_KW)
    return _BUILDS[dtype]


def _blocks(nav):
    return np.asarray(nav).reshape(-1, 7, 8)


# ------------------------------------------------------------------ CPU --
def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import madicp_tpu_torch.kernels.build_nodes, madicp_tpu_torch.kernels.build_points\n"
            "import madicp_tpu_torch.probes.build_levels\n"
            "bad = [m for m in sys.modules if m in ('jax', 'madicp_tpu')\n"
            "       or m.startswith(('jax.', 'madicp_tpu.'))]\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_build_tree_matches_jax(jax_ref, dtype):
    """Each cloud of a batch of two (with padding rows) against the JAX
    package's build of that cloud: point_leaf and every block's flags
    equal; real blocks within 1e-9 and unreal ones within 1e-8 in float64,
    real blocks within 5e-4 in float32 (tests/test_torch_tree.py's
    bounds). The depth cap makes leaves of the last level's nodes."""
    jax_tree, _ = jax_ref
    import jax
    import jax.numpy as jnp

    pts, valid = batch(2, 2400)
    tree, leaf = torch_build(dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    build = jax.jit(lambda p, v: jax_tree.build_tree(p, v, depth=DEPTH, **BUILD_KW))
    M = tree_arena_size(DEPTH)
    for b in range(2):
        j_tree, j_leaf = build(jnp.asarray(pts[b], jdt), jnp.asarray(valid[b]))
        bj, bt = _blocks(j_tree.nav), _blocks(tree.nav[b].numpy())
        np.testing.assert_array_equal(leaf[b].numpy(), np.asarray(j_leaf))
        np.testing.assert_array_equal(bt[..., 7], bj[..., 7])
        real = bj[..., 7] >= 2.0
        if dtype == torch.float64:
            np.testing.assert_allclose(bt[real], bj[real], rtol=0, atol=1e-9)
            np.testing.assert_allclose(bt[~real], bj[~real], rtol=0, atol=1e-8)
        else:
            np.testing.assert_allclose(bt[real], bj[real], rtol=0, atol=5e-4)
        assert (bt[M // 2:, 0, 7] == 3.0).sum() > 0  # leaves at the depth cap
        assert (leaf[b].numpy()[~valid[b]] == 0).all()


def drive_levels(points, valid, *, depth, b_max, b_min):
    """build_tree's level loop written out over the plain functions:
    ``(arena, leaf_of, frz_dist, near_pos)``."""
    B, N = valid.shape
    M = tree_arena_size(depth)
    pts = points.reshape(B * N, 3)
    d = pts
    idx = torch.where(valid.reshape(-1), torch.arange(B, dtype=torch.int32).repeat_interleave(N),
                      bp.DROP)
    leaf_of = torch.zeros(B * N, dtype=torch.int64)
    frz = torch.full((B * N,), torch.finfo(points.dtype).max, dtype=points.dtype)
    arena = torch.full((B, M, bn.ARENA_COLS), float("nan"), dtype=points.dtype)
    prev = None
    for level in range(depth + 1):
        mom = segsum.segsum_moments_ref(d, idx, B << level)
        prev = bn.build_nodes_plain(mom, prev, arena, level=level, b_max=b_max, b_min=b_min)
        d, idx = bp.build_points_plain(pts, d, idx, leaf_of, frz, prev[0], prev[2],
                                       level=level, depth=depth)
    bn.close_level_plain(prev[1], prev[2], arena, level=depth)
    dmin = bp.pick_dmin_plain(valid, leaf_of.view(B, N), frz.view(B, N), M)
    near = bp.pick_near_plain(valid, leaf_of.view(B, N), frz.view(B, N), dmin, M, N, 0)
    return arena, leaf_of.view(B, N), frz, near


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_levels_rebuild_build_tree(dtype):
    """The plain functions driven level by level give build_tree's tree
    bit for bit: every arena row is written (nothing is left of the NaN
    fill), the representatives are the picked points, point_leaf and the
    nav's own blocks equal."""
    pts, valid = batch(2, 2400)
    points, mask = torch.from_numpy(pts).to(dtype), torch.from_numpy(valid)
    arena, leaf_of, frz, near = drive_levels(points, mask, depth=DEPTH, **BUILD_KW)
    tree, point_leaf = torch_build(dtype)
    assert not arena.isnan().any()
    assert torch.equal(point_leaf, torch.where(mask, leaf_of, 0))
    own = tree.nav[..., 0:8]
    leaf = arena[..., 10] > 0
    assert torch.equal(own[..., 7], leaf.to(dtype) + 2.0 * arena[..., 11])
    assert torch.equal(own[..., 3:6][leaf], arena[..., 6:9][leaf])
    assert torch.equal(own[..., 6][leaf], arena[..., 9][leaf])
    inner = ~leaf & (arena[..., 11] > 0)
    assert torch.equal(own[..., 0:6][inner], arena[..., 0:6][inner])
    B, N = valid.shape
    M = tree_arena_size(DEPTH)
    reps = points.reshape(B * N, 3)[near.clamp(max=B * N - 1)].view(B, M, 3)
    assert torch.equal(own[..., 0:3][leaf], reps[leaf])
    assert bool((near.view(B, M)[leaf] < B * N).all()) and int((frz < 1e3).sum()) == valid.sum()


def _spectra(kind: str, rng, n: int = 64):
    """(n, 3, 3) float64 symmetric matrices Q diag(l) Q^T of one kind."""
    Q = Rotation.random(n, random_state=np.random.RandomState(int(rng.integers(1 << 30))))
    Q = Q.as_matrix()
    lam = {
        "random": np.cumsum(rng.uniform([0.1, 0.3, 0.3], [0.5, 1.0, 1.0], (n, 3)), axis=1),
        "spherical": np.repeat(rng.uniform(0.5, 2.0, (n, 1)), 3, axis=1),
        "planar": np.stack([np.full(n, 1e-9), rng.uniform(0.5, 1.0, n),
                            rng.uniform(1.5, 2.0, n)], axis=1),
        "line": np.stack([np.zeros(n), np.zeros(n), rng.uniform(0.5, 2.0, n)], axis=1),
        "repeated": np.stack([rng.uniform(0.1, 0.4, n), np.ones(n), np.ones(n)], axis=1),
    }[kind]
    A = np.einsum("nij,nj,nkj->nik", Q, lam, Q)
    return (A + np.swapaxes(A, -1, -2)) / 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["random", "spherical", "planar", "line", "repeated"])
def test_eigh3_matches_jax(jax_ref, kind, dtype):
    """Against the JAX package's eigh3, relative to the scale. Separated
    and spherical spectra: eigenvalues at 1e-12 (float64) or 1e-5
    (float32), eigenvectors WITH sign at 1e-9 or 1e-4. A double root
    (line, repeated): the Cardano roots there carry an error of order
    sqrt(eps) (acos near +-1), so eigenvalues at 5e-8 or 1e-3 and the
    canonical basis at 1e-8 or 1e-4. Every basis orthonormal."""
    _, jax_eigh3 = jax_ref
    import jax.numpy as jnp

    A = _spectra(kind, np.random.default_rng(len(kind)))
    if dtype == torch.float32:
        A = A.astype(np.float32)
    ev_j, vec_j = map(np.asarray, jax_eigh3(jnp.asarray(A)))
    ev_t, vec_t = (t.numpy() for t in eigh3(torch.from_numpy(A)))
    assert ev_t.dtype == A.dtype and vec_t.dtype == A.dtype
    scale = np.abs(A).max(axis=(-1, -2))[:, None]
    if kind in ("line", "repeated"):
        tol = (5e-8, 1e-8) if dtype == torch.float64 else (1e-3, 1e-4)
    else:
        tol = (1e-12, 1e-9) if dtype == torch.float64 else (1e-5, 1e-4)
    np.testing.assert_allclose(ev_t / scale, ev_j / scale, rtol=0, atol=tol[0])
    np.testing.assert_allclose(vec_t, vec_j, rtol=0, atol=tol[1])
    gram = np.einsum("...ki,...kj->...ij", vec_t.astype(np.float64), vec_t)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(3), gram.shape),
                               atol=10 * tol[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_float_keys_order_and_invert(dtype):
    """Keys order as the floats do (-0.0 just below +0.0, subnormals,
    the largest values) and decode to the same bits."""
    tiny = torch.finfo(dtype).tiny
    big = torch.finfo(dtype).max
    x = torch.tensor([-big, -1e3, -1.0, -tiny, -tiny / 4, -0.0, 0.0, tiny / 4, tiny, 1.0,
                      1e3, big], dtype=dtype)
    k = bp.float_keys(x)
    assert k.dtype == bp.key_dtype(dtype)
    assert bool((k[1:] > k[:-1]).all())
    back = bp.keys_to_float(k, dtype)
    assert torch.equal(back.view(k.dtype), x.view(k.dtype))
    assert bp.big_key(dtype) == int(k[-1])


def _level_inputs(dtype=torch.float64, B=2, n=600, level=3, depth=6):
    """One recorded level of a small CPU build: the build_nodes and
    build_points calls' inputs at ``level``."""
    pts, valid = batch(B, n, seed=level)
    _, _, calls, _ = build_levels.record_build(
        torch.from_numpy(pts).to(dtype), torch.from_numpy(valid), depth=depth, **BUILD_KW)
    nodes = next(c for c in calls if c.name == "build_nodes" and c.kwargs["level"] == level)
    points = next(c for c in calls if c.name == "build_points" and c.kwargs["level"] == level)
    return nodes, points, calls


def test_build_nodes_dispatch_and_argument_checks():
    """CPU tensors take the plain version and count no launch; wrong
    devices, dtypes and shapes raise on every device."""
    nodes, _, calls = _level_inputs()
    mom, prev, arena = nodes.args
    before = bn.counter.launches
    got = bn.build_nodes(mom, prev, arena.clone(), **nodes.kwargs)
    assert bn.counter.launches == before
    for a, b in zip(got, nodes.results):
        assert torch.equal(a, b)
    kw = nodes.kwargs
    with pytest.raises(ValueError, match="unsupported device"):
        bn.build_nodes(mom.to("meta"), tuple(t.to("meta") for t in prev), arena.to("meta"), **kw)
    with pytest.raises(ValueError, match="different devices"):
        bn.build_nodes(mom.to("meta"), prev, arena, **kw)
    with pytest.raises(TypeError, match="float32/float64"):
        bn.build_nodes(mom.half(), prev, arena.half(), **kw)
    with pytest.raises(TypeError, match="mom is"):
        bn.build_nodes(mom.float(), prev, arena, **kw)
    with pytest.raises(TypeError, match="ext_prev is"):
        bn.build_nodes(mom, (prev[0], prev[1], prev[2].int()), arena, **kw)
    with pytest.raises(ValueError, match="want mom"):
        bn.build_nodes(mom[1:], prev, arena, **kw)
    with pytest.raises(ValueError, match="want arena"):
        bn.build_nodes(mom, prev, arena[..., :11], **kw)
    with pytest.raises(ValueError, match="needs the previous level"):
        bn.build_nodes(mom, None, arena, **kw)
    with pytest.raises(ValueError, match="has no rows"):
        bn.build_nodes(mom, prev, arena[:, :8], **kw)
    close = next(c for c in calls if c.name == "close_level")
    state, ext, arena = close.args
    bn.close_level(state, ext, arena, **close.kwargs)
    assert torch.equal(arena, close.results[0]) and bn.counter.launches == before
    with pytest.raises(ValueError, match="want state"):
        bn.close_level(state[1:], ext, arena, **close.kwargs)


def test_build_points_dispatch_and_argument_checks():
    """CPU tensors take the plain version and count no launch; wrong
    devices, dtypes and shapes raise on every device."""
    _, points, _ = _level_inputs()
    p, d, idx, leaf_of, frz, packA, ext = points.args
    kw = points.kwargs
    before = bp.counter.launches
    args = [t.clone() for t in points.args]
    got = build_levels.results("build_points", bp.build_points(*args, **kw), args)
    assert bp.counter.launches == before
    for a, b in zip(got, points.results):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        bp.build_points(*(t.to("meta") for t in points.args), **kw)
    with pytest.raises(ValueError, match="different devices"):
        bp.build_points(p, d.to("meta"), idx, leaf_of, frz, packA, ext, **kw)
    with pytest.raises(TypeError, match="want float32/float64"):
        bp.build_points(p.half(), d, idx, leaf_of, frz, packA, ext, **kw)
    with pytest.raises(TypeError, match="d is"):
        bp.build_points(p, d.float(), idx, leaf_of, frz, packA, ext, **kw)
    with pytest.raises(TypeError, match="want idx int32"):
        bp.build_points(p, d, idx.long(), leaf_of, frz, packA, ext, **kw)
    with pytest.raises(TypeError, match="keys"):
        bp.build_points(p, d, idx, leaf_of, frz, packA, ext.int(), **kw)
    with pytest.raises(ValueError, match="want points"):
        bp.build_points(p, d[1:], idx, leaf_of, frz, packA, ext, **kw)
    with pytest.raises(ValueError, match="level <= depth"):
        bp.build_points(p, d, idx, leaf_of, frz, packA, ext, level=7, depth=6)


def test_pick_dispatch_and_argument_checks():
    """The leaf pick: CPU tensors take the plain versions and count no
    launch; wrong devices, dtypes and shapes raise on every device."""
    _, _, calls = _level_inputs()
    dmin_call = next(c for c in calls if c.name == "pick_dmin")
    near_call = next(c for c in calls if c.name == "pick_near")
    valid, leaf_of, frz, M = dmin_call.args
    before = bp.counter.launches
    dmin = bp.pick_dmin(valid, leaf_of, frz, M)
    near = bp.pick_near(*near_call.args)
    assert bp.counter.launches == before
    assert torch.equal(dmin, dmin_call.results[0]) and torch.equal(near, near_call.results[0])
    with pytest.raises(ValueError, match="unsupported device"):
        bp.pick_dmin(valid.to("meta"), leaf_of.to("meta"), frz.to("meta"), M)
    with pytest.raises(ValueError, match="different devices"):
        bp.pick_dmin(valid, leaf_of.to("meta"), frz, M)
    with pytest.raises(TypeError, match="want valid bool"):
        bp.pick_dmin(valid.int(), leaf_of, frz, M)
    with pytest.raises(ValueError, match="want valid"):
        bp.pick_dmin(valid, leaf_of[:, 1:], frz, M)
    with pytest.raises(ValueError, match="2\\^k"):
        bp.pick_dmin(valid, leaf_of, frz, M - 1)
    with pytest.raises(ValueError, match="want dmin"):
        bp.pick_near(valid, leaf_of, frz, dmin[1:], M, 600, 0)


# ------------------------------------------------------------------ card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_batch(device, B, n, dtype, seed=0):
    pts, valid = batch(B, n, seed=seed)
    return (torch.from_numpy(pts).to(dtype).to(device), torch.from_numpy(valid).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("depth", [8, 12])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [1000, 4096])
def test_build_kernels_are_bitwise_the_plain_versions_on_cuda(cuda_device, dtype, depth, B, n):
    """Every call of a build on the card (depth + 1 node and point passes,
    the close, the two pick kernels) against its plain version on the same
    inputs: bit for bit (torch.equal); one launch a call of each kernel;
    the plain versions' build on the same moments gives the same nav and
    point_leaf."""
    points, valid = _cuda_batch(cuda_device, B, n, dtype, seed=n + depth)
    before = (bn.counter.launches, bp.counter.launches)
    tree, point_leaf, calls, moments = build_levels.record_build(points, valid, depth=depth,
                                                                 **BUILD_KW)
    torch.cuda.synchronize()
    assert bn.counter.launches - before[0] == depth + 2
    assert bp.counter.launches - before[1] == depth + 3
    report = build_levels.check_calls(calls)
    for kernel, row in report.items():
        assert row["equal"], (kernel, row)
    tree_p, leaf_p = build_levels.replay_build(points, valid, moments, depth=depth, **BUILD_KW)
    assert torch.equal(tree.nav, tree_p.nav) and torch.equal(point_leaf, leaf_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_build_nodes_matches_plain_eigh3_on_cuda(cuda_device, dtype):
    """The node kernel's eigenbasis on every spectrum kind equals the plain
    eigh3 on the card bit for bit: one level of B = 320 one-node clouds
    whose moments are those of the spectra's matrices."""
    rng = np.random.default_rng(3)
    A = np.concatenate([_spectra(k, rng) for k in ("random", "spherical", "planar", "line",
                                                    "repeated")])
    n = len(A)
    k = 50.0
    mom = np.zeros((n, 10))
    mom[:, 3:9] = A[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]] * (k - 1.0)
    mom[:, 9] = k
    mom = torch.from_numpy(mom).to(dtype).to(cuda_device)
    arena = torch.zeros((n, 4, bn.ARENA_COLS), dtype=dtype, device=cuda_device)
    got = bn.build_nodes(mom, None, arena, level=0, **BUILD_KW)
    arena_p = torch.zeros_like(arena)
    want = bn.build_nodes_plain(mom, None, arena_p, level=0, **BUILD_KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(arena, arena_p) and torch.isfinite(got[0]).all()


@pytest.mark.cuda
def test_build_replays_in_a_cuda_graph_on_cuda(cuda_device):
    """A float32 build captured in one CUDA graph and replayed twice
    equals the eager build bit for bit (integer minima, no workspace that
    outlives a call); the node and point kernels' float64 level calls
    replay bit for bit too."""
    points, valid = _cuda_batch(cuda_device, 2, 3000, torch.float32, seed=7)
    eager = build_tree(points, valid, depth=10, **BUILD_KW)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = build_tree(points, valid, depth=10, **BUILD_KW)
    for _ in range(2):
        out[0].nav.zero_()
        out[1].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0].nav, eager[0].nav) and torch.equal(out[1], eager[1])

    p64, v64 = _cuda_batch(cuda_device, 2, 3000, torch.float64, seed=8)
    _, _, calls, _ = build_levels.record_build(p64, v64, depth=10, **BUILD_KW)
    nodes = next(c for c in calls if c.name == "build_nodes" and c.kwargs["level"] == 5)
    pts = next(c for c in calls if c.name == "build_points" and c.kwargs["level"] == 5)
    n_args = build_levels.copy_args(nodes.args)
    p_args = build_levels.copy_args(pts.args)
    torch.cuda.synchronize()
    g2 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g2):
        n_out = bn.build_nodes(*n_args, **nodes.kwargs)
        p_out = bp.build_points(*p_args, **pts.kwargs)
    g2.replay()
    torch.cuda.synchronize()
    # the arena's rows below level 5 hold what its allocation held, NaN too
    got = (build_levels.results("build_nodes", n_out, n_args)
           + build_levels.results("build_points", p_out, p_args))
    for a, b in zip(got, nodes.results + pts.results):
        assert build_levels.compare(a, b)[0]
