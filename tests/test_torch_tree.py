"""Parity of the PyTorch port's MAD-tree and ICP core with the JAX package
on the CPU, float64: build_tree, search_forest, leaves, transform_tree,
terms_from_payload / solve_gn / gn_se3_step, MADicp and MADtree."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

import madicp_tpu.ops.icp_core as jax_icp
import madicp_tpu.ops.tree as jax_tree
from madicp_tpu.models.registration import MADicp as JaxMADicp
from madicp_tpu_torch.kernels.segsum import counter
from madicp_tpu_torch.models.nn import MADtree
from madicp_tpu_torch.models.registration import MADicp
import madicp_tpu_torch.ops.icp_core as pt_icp
import madicp_tpu_torch.ops.tree as pt_tree

torch.set_num_threads(2)

DEPTH = 12


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    """A torch copy of a (possibly read-only JAX-backed) array."""
    return torch.tensor(np.asarray(a))


def _padded(points, pad_to):
    pts = np.zeros((pad_to, 3))
    pts[: len(points)] = points
    valid = np.zeros(pad_to, bool)
    valid[: len(points)] = True
    return pts, valid


@pytest.fixture(scope="module")
def walls_trees():
    """The four-walls fixture (tests/conftest.py) built by both packages
    at depth 12 in float64, with padding rows."""
    from conftest import four_walls_cloud

    pts, valid = _padded(four_walls_cloud(np.random.default_rng(42)), 8192)
    j_tree, j_leaf = jax.jit(
        lambda p, v: jax_tree.build_tree(p, v, depth=DEPTH, b_max=0.2, b_min=0.1)
    )(jnp.asarray(pts), jnp.asarray(valid))
    t_tree, t_leaf = pt_tree.build_tree(
        torch.from_numpy(pts), torch.from_numpy(valid),
        depth=DEPTH, b_max=0.2, b_min=0.1,
    )
    return pts, valid, j_tree, np.asarray(j_leaf), t_tree, _np(t_leaf)


def _blocks(nav):
    return np.asarray(nav).reshape(-1, 7, 8)


def test_build_tree_matches_jax(walls_trees):
    """float64: point_leaf equal, flags equal in every block, and every
    REAL block (interior or leaf) within 1e-9. Unreal blocks — the slots
    below a leaf, which no descent reads (their flags stop it) — carry
    eigenvectors of retired-point clusters, whose near-degenerate
    spectra amplify the 1-ulp differences of XLA's fused multiply-adds
    to a few 1e-9; they are held to 1e-8."""
    _, _, j_tree, j_leaf, t_tree, t_leaf = walls_trees
    bj, bt = _blocks(j_tree.nav), _blocks(_np(t_tree.nav))
    assert bt.shape == bj.shape == (2 ** (DEPTH + 1), 7, 8)
    np.testing.assert_array_equal(t_leaf, j_leaf)
    np.testing.assert_array_equal(bt[..., 7], bj[..., 7])
    real = bj[..., 7] >= 2.0
    np.testing.assert_allclose(bt[real], bj[real], rtol=0, atol=1e-9)
    np.testing.assert_allclose(bt[~real], bj[~real], rtol=0, atol=1e-8)
    assert int(pt_tree.count_leaves(t_tree)) == int(jax_tree.count_leaves(j_tree))


def test_build_tree_float32_matches_jax(walls_trees):
    """float32 on the CPU (every level through the wrapper's plain
    version, no launch): the same leaf of every point and the same flags
    as the JAX float32 build; real blocks within float32 eigenvector
    noise."""
    pts, valid, _, _, _, _ = walls_trees
    j32, j_leaf = jax.jit(
        lambda p, v: jax_tree.build_tree(p, v, depth=DEPTH, b_max=0.2, b_min=0.1)
    )(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    before = counter.launches
    t32, t_leaf = pt_tree.build_tree(
        torch.from_numpy(pts.astype(np.float32)), torch.from_numpy(valid),
        depth=DEPTH, b_max=0.2, b_min=0.1,
    )
    assert counter.launches == before
    assert t32.nav.dtype == torch.float32 and torch.isfinite(t32.nav).all()
    np.testing.assert_array_equal(_np(t_leaf), np.asarray(j_leaf))
    bj, bt = _blocks(j32.nav), _blocks(_np(t32.nav))
    np.testing.assert_array_equal(bt[..., 7], bj[..., 7])
    real = bj[..., 7] >= 2.0
    np.testing.assert_allclose(bt[real], bj[real], rtol=0, atol=5e-4)


def _queries(rng, pts, valid, n=600):
    base = pts[valid][rng.integers(0, valid.sum(), n)]
    return base + rng.normal(0, 0.05, base.shape)


@pytest.mark.parametrize("mode", ["root", "warm"])
def test_search_forest_matches_jax(rng, walls_trees, mode):
    """On the SAME nav table (JAX's build fed to both): ids and blocks
    equal, margins within 1e-12, on a two-tree flat forest with per-query
    base offsets (the pipeline's batched view) and masked queries;
    `warm` restarts from ancestors with n_gathers."""
    pts, valid, j_tree, _, _, _ = walls_trees
    nav = np.asarray(j_tree.nav)
    M = nav.shape[0]
    q = _queries(rng, pts, valid)
    qvalid = rng.random(len(q)) > 0.1
    R = Rotation.from_rotvec([0.0, 0.0, 0.3]).as_matrix()
    t = np.array([0.5, -0.2, 0.1])
    j_moved = jax_tree.transform_tree(j_tree, jnp.asarray(R), jnp.asarray(t))
    t_moved = pt_tree.transform_tree(
        pt_tree.SearchTree(_t(nav)), torch.from_numpy(R),
        torch.from_numpy(t))
    np.testing.assert_allclose(_np(t_moved.nav), np.asarray(j_moved.nav),
                               rtol=0, atol=1e-12)
    forest = _t(np.concatenate([nav, np.asarray(j_moved.nav)]))

    j_kw = dict(return_blocks=True, return_margin=True)
    t_kw = dict(j_kw)
    if mode == "warm":
        ids0 = np.asarray(jax_tree.search_forest(j_tree.nav, jnp.asarray(q), 0, DEPTH))
        j_kw.update(start=jnp.asarray(ids0 >> 4), n_gathers=3)
        t_kw.update(start=_t(ids0 >> 4), n_gathers=3)
    for k, jt in enumerate((j_tree, j_moved)):
        ids_j, blk_j, mar_j = jax_tree.search_forest(
            jt.nav, jnp.asarray(q), 0, DEPTH, valid=jnp.asarray(qvalid), **j_kw)
        base = torch.full((len(q),), k * M, dtype=torch.int64)
        ids_t, blk_t, mar_t = pt_tree.search_forest(
            forest, torch.from_numpy(q), base, DEPTH,
            valid=torch.from_numpy(qvalid), **t_kw)
        np.testing.assert_array_equal(_np(ids_t), np.asarray(ids_j))
        np.testing.assert_array_equal(_np(blk_t), np.asarray(blk_j))
        np.testing.assert_allclose(_np(mar_t), np.asarray(mar_j), rtol=0, atol=1e-12)
    ids_t = pt_tree.search_tree(pt_tree.SearchTree(forest[:M]), torch.from_numpy(q))
    np.testing.assert_array_equal(
        _np(ids_t), np.asarray(jax_tree.search_tree(j_tree, jnp.asarray(q))))


def test_leaves_and_payload_match_jax(walls_trees):
    """get_leaves (with and without capacity overflow) and search_payload
    on the same nav table: bitwise equal."""
    _, _, j_tree, _, _, _ = walls_trees
    t_tree = pt_tree.SearchTree(_t(j_tree.nav))
    for cap in (64, 4096):
        lj = jax_tree.get_leaves(j_tree, cap)
        lt = pt_tree.get_leaves(t_tree, cap)
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    ids = np.arange(0, 8192, 7)
    for a, b in zip(pt_tree.search_payload(t_tree, torch.from_numpy(ids)),
                    jax_tree.search_payload(j_tree, jnp.asarray(ids))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_icp_core_matches_jax(rng, walls_trees):
    """terms_from_payload (batched over keyframes), solve_gn and
    gn_se3_step at 1e-9; neg_logdet and the empty-H solve."""
    _, _, j_tree, _, _, _ = walls_trees
    t_tree = pt_tree.SearchTree(_t(j_tree.nav))
    lj = jax_tree.get_leaves(j_tree, 4096)
    moving = np.asarray(lj.pts) + rng.normal(0, 0.01, (4096, 3))
    mvalid = np.asarray(lj.valid)
    X = np.eye(4)
    X[:3, :3] = Rotation.from_rotvec([0.01, -0.005, 0.02]).as_matrix()
    X[:3, 3] = [0.03, -0.02, 0.01]
    kw = dict(b_max=0.2, b_ratio=0.02, rho_ker=0.1)
    tj = jax_icp.icp_terms(j_tree, jnp.asarray(moving), jnp.asarray(mvalid),
                           jnp.asarray(X), **kw)
    ml = np.ascontiguousarray(moving @ X[:3, :3].T + X[:3, 3])
    _, payload = pt_icp.associate_packed(
        t_tree.nav, 0, DEPTH, torch.from_numpy(ml), _t(mvalid))
    stacked = torch.stack([payload, payload])  # (K=2, L, 8)
    tt = pt_icp.terms_from_payload(
        stacked, _t(moving), _t(mvalid),
        torch.from_numpy(X), **kw)
    for k in range(2):
        np.testing.assert_allclose(_np(tt.H[k]), np.asarray(tj.H), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(_np(tt.b[k]), np.asarray(tj.b), rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(_np(tt.matched[k]), np.asarray(tj.matched))
    H, b = tj.H, tj.b
    Ht, bt = _t(H), _t(b)
    np.testing.assert_allclose(
        _np(pt_icp.solve_gn(Ht, bt)), np.asarray(jax_icp.solve_gn(H, b)), atol=1e-9)
    np.testing.assert_allclose(
        _np(pt_icp.gn_se3_step(torch.from_numpy(X), Ht, bt)),
        np.asarray(jax_icp.gn_se3_step(jnp.asarray(X), H, b)), atol=1e-9)
    np.testing.assert_allclose(
        float(pt_icp.neg_logdet(Ht)), float(jax_icp.neg_logdet(H)), rtol=1e-9)
    zero = torch.zeros((6, 6), dtype=torch.float64)
    assert not pt_icp.solve_gn(zero, torch.ones(6, dtype=torch.float64)).any()
    step = np.array([3.0, 0.2, 0.0, 0.0, 0.9, 0.1])  # beyond the trust region
    np.testing.assert_allclose(
        _np(pt_icp.clamp_step(torch.from_numpy(step))),
        np.asarray(jax_icp.clamp_step(jnp.asarray(step))), rtol=0, atol=1e-15)


def test_madicp_matches_jax(rng):
    """Pairwise registration: same pose as the JAX package at 1e-9 (f64)."""
    from conftest import four_walls_cloud

    ref = four_walls_cloud(rng, points_per_wall=500)
    R = Rotation.from_rotvec([0.0, 0.0, 0.04]).as_matrix()
    query = (ref - np.array([0.06, -0.04, 0.01])) @ R + rng.normal(0, 0.002, ref.shape)
    outs = []
    for cls, kw in ((JaxMADicp, dict(dtype=jnp.float64)),
                    (MADicp, dict(dtype=torch.float64, device="cpu"))):
        icp = cls(depth=12, **kw)
        icp.set_reference_cloud(ref)
        icp.set_query_cloud(query)
        outs.append((icp.compute(np.eye(4), icp_iterations=12), icp.last_matched))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    assert abs(outs[1][0][0, 3] - 0.06) < 5e-3  # and it is a good registration


def test_madtree_per_point_self_match(four_walls):
    """b_max=1e-5 gives per-point leaves: searching the build cloud
    returns each point exactly (the nn_search oracle)."""
    tree = MADtree(dtype=torch.float64, device="cpu")
    tree.build(four_walls[:800])
    pts, normals, d = tree.search_cloud_dist(four_walls[:800])
    np.testing.assert_allclose(d, 0.0, atol=1e-12)
    assert normals.shape == (800, 3)
