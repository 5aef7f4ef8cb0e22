"""The association and normal-equation kernels of the PyTorch port: the
descent (``kernels/descent.py``, ``search_forest``'s body) and the ICP
terms (``kernels/icp_terms.py``, ``terms_from_payload``'s body).

On the CPU: both wrappers' dispatch and argument checks, and their plain
versions against the JAX package's ``search_forest`` / ``associate_packed``
and ``terms_from_payload`` at 1e-9 in float64 (parked queries, warm
starts, ``depth % 3 == 0``, margins, per-query bases, leading keyframe
axes, per-keyframe points, a fleet-sized batch); the kernel's read
pattern (``panel_reads``) against the plain version. Tests marked
``cuda`` hold each kernel to its plain version on the card (descent bit
for bit; terms' ``matched`` bit for bit and H, b within 1e-5 relative of
a float64 sum) and in a CUDA graph, and skip without one. JAX is
imported by the CPU tests only, so a machine with a card needs none."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from madicp_tpu_torch.kernels import certify_slack, descent, icp_terms
from madicp_tpu_torch.ops.tree import build_tree, transform_tree

TERMS_KW = dict(b_max=0.2, b_ratio=0.02, rho_ker=0.01)  # rho 0.1: both Huber branches


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's tree and ICP-core modules, on the CPU with x64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import madicp_tpu.ops.icp_core as jax_icp
    import madicp_tpu.ops.tree as jax_tree

    return jax_tree, jax_icp


def _room(rng, n=700):
    """Floor and four walls of a 4 m room, 5 n points."""
    return np.concatenate([
        rng.uniform([0, 0, 0], [4, 0.01, 2], (n, 3)),
        rng.uniform([0, 0, 0], [0.01, 4, 2], (n, 3)),
        rng.uniform([0, 3.99, 0], [4, 4, 2], (n, 3)),
        rng.uniform([3.99, 0, 0], [4, 4, 2], (n, 3)),
        rng.uniform([0, 0, 0], [4, 4, 0.01], (n, 3)),
    ])


_FORESTS: dict = {}


def forest(depth: int, dtype=torch.float64):
    """Two trees of one room scene (the second moved) as a flat (2 M, 56)
    table, the scene's points and M; built once per depth on the CPU."""
    if depth not in _FORESTS:
        rng = np.random.default_rng(depth)
        pts = _room(rng)
        p = torch.from_numpy(pts)
        tree, _ = build_tree(p, torch.ones(len(pts), dtype=torch.bool), depth=depth,
                             b_max=0.2, b_min=0.1)
        R = torch.from_numpy(Rotation.from_rotvec([0.0, 0.02, 0.2]).as_matrix())
        moved = transform_tree(tree, R, torch.tensor([0.3, -0.1, 0.05], dtype=torch.float64))
        _FORESTS[depth] = (torch.cat([tree.nav, moved.nav]), pts, tree.nav.shape[0])
    nav, pts, M = _FORESTS[depth]
    return nav.to(dtype), pts, M


def descent_case(case: str, n: int = 600, seed: int = 0):
    """(nav, queries, depth, kwargs of search_forest) for one case:
    ``root`` (per-query base over the two trees, 10% parked, blocks and
    margins), ``warm`` (restarts 4 levels above the root descent's leaf
    with 3 gathers), ``depth9`` (depth % 3 == 0: the extra gather of the
    blocks), ``ids`` (ids only, int base)."""
    depth = 9 if case == "depth9" else 10
    nav, pts, M = forest(depth)
    rng = np.random.default_rng(seed)
    q = pts[rng.integers(0, len(pts), n)] + rng.normal(0, 0.05, (n, 3))
    queries = torch.from_numpy(q)
    valid = torch.from_numpy(rng.random(n) > 0.1)
    base = torch.from_numpy(rng.integers(0, 2, n) * M)
    kw = dict(valid=valid, return_blocks=True, return_margin=True)
    if case == "ids":
        return nav, queries, depth, 0, {}
    if case == "warm":
        ids0 = descent.descend_plain(nav, queries, base, depth)
        kw.update(start=ids0 >> 4, n_gathers=3)
    return nav, queries, depth, base, kw


DESCENT_CASES = ["root", "warm", "depth9", "ids"]


def half_turns(groups: int, rng) -> torch.Tensor:
    """(groups, 4, 4) float64 poses: turns within 0.01-0.04 rad of a half
    turn about a tilted axis, and translations of a few metres."""
    X = np.broadcast_to(np.eye(4), (groups, 4, 4)).copy()
    axis = np.array([0.3, -0.2, 1.0]) / np.linalg.norm([0.3, -0.2, 1.0])
    for g in range(groups):
        X[g, :3, :3] = Rotation.from_rotvec((np.pi - 0.01 * (g + 1)) * axis).as_matrix()
        X[g, :3, 3] = rng.normal(0, 3.0, 3)
    return torch.from_numpy(X)


def to_scan(mapped: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Map-frame points (G, Q, 3) in the scan frame of their group's pose
    (P, 4, 4), P dividing G: ``R^T (q - t)``."""
    X = X.repeat_interleave(mapped.shape[0] // X.shape[0], dim=0)
    return (mapped - X[:, None, :3, 3]) @ X[:, :3, :3]


def ring_case(case: str, n: int = 600, seed: int = 0, groups: int = 1, form: str = "ring"):
    """A :func:`descent_case` in the ring form the step launches: the
    forest's two trees as (T, M, 56) (``groups`` copies of them, T = 2
    groups), the queries in the scan frame of each group's pose ``X``
    (:func:`half_turns`; ``form`` "ring": each group's (``groups``, n, 3)
    shared by its two trees, "flat": each tree's own, (T, n, 3)), ``need``
    (T, n) (the case's valid flags in the first tree, another 70% in the
    second), a warm start from a first descent's ids, and round 0's
    results as a merge's previous buffers. Returns ``(ring, queries,
    depth, kwargs, prev)``, ``X`` among the kwargs."""
    nav, q, depth, _, kw = descent_case(case, n=n, seed=seed)
    M = nav.shape[0] // 2
    rng = np.random.default_rng(seed + 1)
    T = 2 * groups
    G = groups if form == "ring" else T
    ring = nav.view(2, M, 56).repeat(groups, 1, 1)
    mapped = (q[None] + torch.from_numpy(rng.normal(0, 0.05, (G, n, 3)))).to(nav.dtype)
    X = half_turns(groups, rng)
    queries = to_scan(mapped, X)
    valid = kw.get("valid", torch.ones(n, dtype=torch.bool))
    need = torch.stack([valid, torch.from_numpy(rng.random(n) < 0.7)]).repeat(groups, 1)
    rkw = dict(need=need, X=X, return_margin=case != "ids")
    if case == "warm":
        ids0 = descent.descend_ring_plain(ring, queries, depth, torch.ones_like(need), X=X)[0]
        rkw.update(start=ids0 >> 4, n_gathers=3)
    # the previous round: every entry, 3 cm away
    prev = descent.descend_ring_plain(ring, queries + 0.03, depth,
                                      torch.ones((T, n), dtype=torch.bool), X=X,
                                      return_margin=rkw["return_margin"])
    return ring, queries, depth, rkw, prev


def axis_ring(L: int, dtype, device, form: str = "ring"):
    """Three one-split trees whose root planes are x = 0, y = 0 and z = 0
    (children leaves), ``L`` scan-frame points at 1-30 m and a pose near
    a half turn: ``(ring (3, 4, 56), queries, X (1, 4, 4), pts (L, 3))``,
    the queries (1, L, 3) shared by the three trees or (form "flat") each
    tree's own copy (3, L, 3). A descent of tree c ends on node 2 + (q_c
    >= 0) with margin |q_c|: it shows the mapped query's coordinate c
    (:func:`descended_queries`)."""
    rng = np.random.default_rng(L)
    pts = rng.normal(0, 1, (L, 3))
    pts *= rng.uniform(1, 30, (L, 1)) / np.linalg.norm(pts, axis=-1, keepdims=True)
    ring = torch.zeros((3, 4, 56), dtype=torch.float64)
    for c in range(3):
        ring[c, 1, 3 + c] = 1.0  # the root's split normal, through the origin
        ring[c, 1, 6:8] = torch.tensor([3.0, 2.0])  # both children; real interior
        ring[c, 1, 15] = ring[c, 1, 23] = 3.0  # the children are leaves
        ring[c, 2, 7] = ring[c, 3, 7] = 3.0
    pts = torch.from_numpy(pts)
    queries = pts[None] if form == "ring" else pts[None].expand(3, L, 3)
    X = half_turns(1, rng)
    return (ring.to(dtype).to(device), queries.to(dtype).to(device), X.to(dtype).to(device),
            pts.to(dtype).to(device))


def descended_queries(ids: torch.Tensor, margin: torch.Tensor) -> torch.Tensor:
    """The mapped queries (L, 3) an :func:`axis_ring` descent saw."""
    return torch.where(ids == 3, margin, -margin).mT


# ------------------------------------------------------------------ CPU --
def test_descend_dispatch_and_argument_checks():
    """CPU tensors take the plain version and count no launch; wrong
    dtypes, shapes and devices raise on every device."""
    nav, q, depth, base, kw = descent_case("root", n=64)
    before = descent.counter.launches
    got = descent.descend(nav, q, base, depth, **kw)
    want = descent.descend_plain(nav, q, base, depth, **kw)
    assert descent.counter.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        descent.descend(nav.to("meta"), q.to("meta"), base.to("meta"), depth)
    with pytest.raises(ValueError, match="different devices"):
        descent.descend(nav.to("meta"), q, base, depth)
    with pytest.raises(TypeError, match="queries are"):
        descent.descend(nav, q.float(), base, depth)
    with pytest.raises(TypeError, match="float32/float64"):
        descent.descend(nav.half(), q.half(), base, depth)
    with pytest.raises(ValueError, match="want nav"):
        descent.descend(nav[:, :55], q, base, depth)
    with pytest.raises(ValueError, match="base must be"):
        descent.descend(nav, q, base[1:], depth)
    with pytest.raises(TypeError, match="valid must be bool"):
        descent.descend(nav, q, base, depth, valid=kw["valid"].long())
    with pytest.raises(TypeError, match="start must be an integer"):
        descent.descend(nav, q, base, depth, start=q[:, 0])
    with pytest.raises(ValueError, match="n_gathers >= 0"):
        descent.descend(nav, q, base, depth, n_gathers=-1)


def _terms_inputs(lead_pay, lead_pts, lead_x, L, seed=0, dtype=torch.float64):
    """Synthetic terms inputs: payload (*lead_pay, L, 8) near the moving
    points mapped by X, unit normals, bbox0 in [0, 0.3), flags among
    {3, 2, 0} (mostly leaves); points (*lead_pts, L, 3) at 1-30 m; X
    (*lead_x, 4, 4) small rigid motions; valid 90% true."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, tuple(lead_pts) + (L, 3))
    pts *= rng.uniform(1, 30, tuple(lead_pts) + (L, 1)) / np.linalg.norm(pts, axis=-1,
                                                                        keepdims=True)
    X = np.broadcast_to(np.eye(4), tuple(lead_x) + (4, 4)).copy()
    rot = Rotation.from_rotvec(rng.normal(0, 0.02, (int(np.prod(lead_x, dtype=int)), 3)))
    X[..., :3, :3] = rot.as_matrix().reshape(tuple(lead_x) + (3, 3))
    X[..., :3, 3] = rng.normal(0, 0.1, tuple(lead_x) + (3,))
    ml = pts @ np.swapaxes(X[..., :3, :3], -1, -2) + X[..., None, :3, 3]
    shape = tuple(np.broadcast_shapes(tuple(lead_pay), ml.shape[:-2])) + (L,)
    n = rng.normal(0, 1, shape + (3,))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    payload = np.concatenate([
        np.broadcast_to(ml, shape + (3,)) + rng.normal(0, 0.15, shape + (3,)), n,
        rng.uniform(0, 0.3, shape + (1,)),
        rng.choice([3.0, 3.0, 3.0, 2.0, 0.0], shape + (1,)),
    ], axis=-1)
    payload = np.array(np.broadcast_to(payload, tuple(lead_pay) + (L, 8)))
    valid = rng.random(tuple(lead_pts) + (L,)) > 0.1
    return tuple(torch.from_numpy(a).to(dtype) if a.dtype != bool else torch.from_numpy(a)
                 for a in (payload, pts, valid, X))


# (payload's lead, points' lead, X's lead): one tree; keyframes sharing
# points; per-keyframe points (prefix); a fleet-sized batch (B, K, L)
TERMS_CASES = {
    "single": ((), (), (), 200),
    "keyframes": ((4,), (), (), 200),
    "per_keyframe_points": ((3,), (3,), (), 150),
    "fleet": ((2, 3), (2, 1), (2, 1), 64),
}


def test_terms_dispatch_and_argument_checks():
    """CPU tensors take the plain version and count no launch; wrong
    dtypes, shapes and devices raise on every device."""
    payload, pts, valid, X = _terms_inputs((2,), (), (), 32)
    before = icp_terms.counter.launches
    got = icp_terms.terms(payload, pts, valid, X, **TERMS_KW)
    want = icp_terms.terms_plain(payload, pts, valid, X, **TERMS_KW)
    assert icp_terms.counter.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        icp_terms.terms(*(t.to("meta") for t in (payload, pts, valid, X)), **TERMS_KW)
    with pytest.raises(ValueError, match="different devices"):
        icp_terms.terms(payload, pts, valid, X.to("meta"), **TERMS_KW)
    with pytest.raises(TypeError, match="must be the payload's"):
        icp_terms.terms(payload, pts.float(), valid, X, **TERMS_KW)
    with pytest.raises(TypeError, match="float32/float64"):
        icp_terms.terms(payload.half(), pts.half(), valid, X.half(), **TERMS_KW)
    with pytest.raises(TypeError, match="moving_valid must be bool"):
        icp_terms.terms(payload, pts, valid.long(), X, **TERMS_KW)
    with pytest.raises(ValueError, match="want payload"):
        icp_terms.terms(payload[..., :7], pts, valid, X, **TERMS_KW)
    with pytest.raises(ValueError, match="payload entries"):
        icp_terms.terms(payload, pts[1:], valid, X, **TERMS_KW)
    with pytest.raises(ValueError, match="do not broadcast"):
        icp_terms.terms(payload, pts, valid, X.expand(3, 4, 4), **TERMS_KW)


# clusters of (threads, cluster blocks) of the terms kernel that an H100
# 80GB HBM3 holds at once (cudaOccupancyMaxActiveClusters, float32)
H100_CLUSTERS = {
    256: {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30},
    512: {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15},
}


@pytest.mark.parametrize("n_lead, L, threads, cluster, tile", [
    (16, 32768, 512, 6, 5472),    # the flagship: 16 x 8 x 512 would take two waves
    (16, 32765, 512, 6, 5472),    # L not a multiple of the tile
    (64, 32768, 512, 2, 16384),   # the fleet at B = 4
    (1, 32768, 512, 8, 4096),     # one tree: the largest cluster
    (16, 3000, 256, 1, 3008),     # too few entries a thread to split
    (200, 32768, 256, 1, 32768),  # more leads than a wave of 512-thread blocks
    (400, 32768, 256, 1, 32768),  # more than one wave of anything
    (4, 0, 256, 1, 0),
])
def test_terms_plan(n_lead, L, threads, cluster, tile):
    """The terms kernel's launch on an H100's cluster capacity: among the
    block sizes and clusters that hold every leading index at once and
    give a thread at least 8 entries, the most threads a leading index;
    one 256-thread block a lead where none does; tiles of whole warps
    that cover L."""
    pl = icp_terms.plan(n_lead, L, lambda t, c: H100_CLUSTERS[t][c])
    assert pl == (cluster, tile, threads)
    assert pl.cluster * pl.tile >= L and pl.tile % 32 == 0
    assert pl.cluster == 1 or (n_lead <= H100_CLUSTERS[pl.threads][pl.cluster]
                               and -(-L // (pl.cluster * pl.threads))
                               >= icp_terms.MIN_PER_THREAD)


def test_terms_vector_rows():
    """A payload whose rows are 8 contiguous values at 16-byte aligned
    addresses takes the 16-byte loads, in both dtypes, with leading axes
    and with rows shared by the leading indices (stride 0 across a lead);
    a view broadcast along its entries (row stride 0), a strided slice, a
    payload that starts off a 16-byte boundary and rows of 12 values take
    the scalar loads."""
    for dtype in (torch.float32, torch.float64):
        pay = torch.zeros((2, 4, 100, 8), dtype=dtype)
        assert icp_terms.vector_rows(pay, (2, 4))
        assert icp_terms.vector_rows(pay[:, :1], (2, 4))  # shared across a lead
        assert icp_terms.vector_rows(pay[0, 0], (3,))
        assert not icp_terms.vector_rows(pay[0, 0, :1].expand(100, 8), (2,))
        assert not icp_terms.vector_rows(pay[:, :, ::2], (2, 4))
        flat = torch.zeros(2 * 4 * 100 * 8 + 1, dtype=dtype)
        assert not icp_terms.vector_rows(flat[1:].view(2, 4, 100, 8), (2, 4))
        wide = torch.zeros((3, 100, 12), dtype=dtype)
        assert not icp_terms.vector_rows(wide[..., :8], (3,))


# n_live of the bound cases, as a share of L: none live, some (a
# different count a sequence), every entry, more than L
BOUNDS = {"zero": (0.0, 0.0), "partial": (0.37, 0.81), "full": (1.0, 1.0), "over": (1.0, 2.5)}


def _n_live(case: str, L: int, B: int = 2) -> torch.Tensor:
    lo, hi = BOUNDS[case]
    extra = 5 if case == "over" else 0
    return torch.tensor([int(round(L * (lo if b % 2 == 0 else hi))) + extra for b in range(B)],
                        dtype=torch.int64)


def _cut(valid: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """``valid`` (..., L) with every entry at or past ``n_live`` (...) off."""
    return valid & (torch.arange(valid.shape[-1]) < n_live[..., None])


@pytest.mark.parametrize("kernel", ["terms", "certify_slack"])
@pytest.mark.parametrize("bound", list(BOUNDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_bound_is_the_mask_cut_at_it(kernel, bound, dtype):
    """``n_live``: K7's and K11's plain versions equal the same call whose
    valid mask is cut at the bound (bit for bit); ``matched`` and
    ``need`` are false past it; the bounded slack is the unbounded one
    below the bound and keeps its input past it; the wrapper (its CPU
    dispatch) gives the plain version's results and rejects an
    ``n_live`` of another dtype or shape."""
    from madicp_tpu_torch.probes.gn_cases import slack_inputs

    if kernel == "terms":
        payload, pts, valid, X = _terms_inputs((2, 3), (2, 1), (2, 1), 64, dtype=dtype)
        n = _n_live(bound, 64)[:, None]  # (2, 1): one bound a sequence, over its keyframes
        got = icp_terms.terms_plain(payload, pts, valid, X, **TERMS_KW, n_live=n)
        want = icp_terms.terms_plain(payload, pts, _cut(valid, n), X, **TERMS_KW)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
        past = torch.arange(64) >= n[..., None]  # (2, 1, 64)
        assert not (got[2] & past).any()
        if bound == "zero":
            assert not got[0].any() and not got[1].any()
        H, b, m = icp_terms.terms(payload, pts, valid, X, **TERMS_KW, n_live=n,
                                  with_matched=False)
        assert m is None and torch.equal(H, got[0]) and torch.equal(b, got[1])
        with pytest.raises(TypeError, match="n_live must be int64"):
            icp_terms.terms(payload, pts, valid, X, **TERMS_KW, n_live=n.int())
        with pytest.raises(ValueError, match="does not broadcast"):
            icp_terms.terms(payload, pts, valid, X, **TERMS_KW, n_live=n.expand(2, 4))
        with pytest.raises(ValueError, match="does not broadcast"):
            icp_terms.terms(payload, pts, valid, X, **TERMS_KW, n_live=n[None].expand(5, 2, 1))
        return
    s = slack_inputs(dtype, B=2, K=3, L=500)
    n = _n_live(bound, 500)
    a = {k: v.clone() for k, v in s.items()}
    c = {k: v.clone() for k, v in s.items()}
    need = certify_slack.certify_slack_plain(**a, n_live=n)
    want = certify_slack.certify_slack_plain(**dict(c, leaves_valid=_cut(s["leaves_valid"], n)))
    assert torch.equal(need, want) and torch.equal(a["n_descents"], c["n_descents"])
    below = torch.arange(500) < n[:, None]  # (2, 500)
    assert not (need & ~below[:, None, :]).any()
    keep = below[:, None, :].expand_as(s["slack"])
    assert torch.equal(a["slack"][keep], c["slack"][keep])
    assert torch.equal(a["slack"][~keep], s["slack"][~keep])
    w = {k: v.clone() for k, v in s.items()}
    assert torch.equal(certify_slack.certify_slack(**w, n_live=n), need)
    assert torch.equal(w["slack"], a["slack"]) and torch.equal(w["n_descents"], a["n_descents"])
    with pytest.raises(TypeError, match="n_live must be int64"):
        certify_slack.certify_slack(**s, n_live=n.int())
    with pytest.raises(ValueError, match="want n_live"):
        certify_slack.certify_slack(**s, n_live=n[:1])


def test_the_bound_leaves_a_cpu_drive_bit_for_bit(monkeypatch):
    """A certified drive whose terms and slack pass take the scan's leaf
    count as their bound equals, bit for bit, the drive that walks every
    slot (the leaves are a prefix of their slots: the bound cuts off only
    entries that were invalid)."""
    from madicp_tpu_torch.models import pipeline as pl

    def drive():
        p = pl.Pipeline(10.0, False, 0.2, 0.1, 0.8, 0.1, 0.02, 3, n_points=4096, depth=10,
                        max_icp_iterations=4, dtype=torch.float64, device="cpu")
        rng = np.random.default_rng(3)
        room = rng.permutation(_room(rng, n=700))
        got = []
        for i in range(4):
            p.compute(0.1 * i, room[: 2000 - 300 * i] + [0.1 * i, 0.0, 0.0])
            got.append((p.current_pose(), p.inlier_ratio(), p.descents()))
        return got

    bounded = drive()
    terms, slack = pl.terms_from_payload, certify_slack.certify_slack
    monkeypatch.setattr(pl, "terms_from_payload",
                        lambda *a, n_live=None, **kw: terms(*a, **kw))
    monkeypatch.setattr(certify_slack, "certify_slack", lambda *a, n_live=None: slack(*a))
    for (xa, ra, da), (xb, rb, db) in zip(bounded, drive()):
        np.testing.assert_array_equal(xa, xb)
        assert ra == rb and da == db


def test_moving_in_map_order():
    """The map-frame points are ``((m_x R_c0 + m_y R_c1) + m_z R_c2) +
    t_c`` bit for bit (the kernel's order, one rounding an operation),
    within an ulp of ``m R^T + t`` as a matrix product, with leading axes
    on either side."""
    payload, pts, valid, X = _terms_inputs((3,), (3,), (3,), 50, dtype=torch.float32)
    ml = icp_terms.moving_in_map(pts, X)
    R, t = X[:, None, :3, :3], X[:, None, :3, 3]
    for c in range(3):
        want = ((pts[..., 0] * R[..., c, 0] + pts[..., 1] * R[..., c, 1])
                + pts[..., 2] * R[..., c, 2]) + t[..., c]
        assert torch.equal(ml[..., c], want)
    torch.testing.assert_close(ml, pts @ X[..., :3, :3].mT + X[..., None, :3, 3],
                               rtol=1e-6, atol=1e-5)
    assert icp_terms.moving_in_map(pts[0], X).shape == (3, 50, 3)


@pytest.mark.parametrize("case", DESCENT_CASES)
def test_descend_plain_matches_jax(jax_ref, case):
    """float64, the same nav table: ids and blocks equal, margins within
    1e-9 of the JAX package's search_forest (gather path); blocks through
    ``associate_packed`` too where the root descent gives them."""
    jax_tree, jax_icp = jax_ref
    import jax.numpy as jnp

    nav, q, depth, base, kw = descent_case(case)
    got = descent.descend_plain(nav, q, base, depth, **kw)
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    jbase = jnp.asarray(base.numpy()) if isinstance(base, torch.Tensor) else base
    want = jax_tree.search_forest(jnp.asarray(nav.numpy()), jnp.asarray(q.numpy()), jbase,
                                  depth, **jkw)
    if case == "ids":
        got, want = (got,), (want,)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if len(got) > 1:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-9, atol=0)
        assert (got[0] == 0).sum() == (~kw["valid"]).sum()  # parked on row 0
    if case == "root":
        ids_j, pay_j = jax_icp.associate_packed(
            jnp.asarray(nav.numpy()), jbase, depth, jnp.asarray(q.numpy()), jkw["valid"])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(pay_j))


@pytest.mark.parametrize("case", DESCENT_CASES)
def test_kernel_read_pattern_keeps_the_plain_results(case):
    """The kernel's loop (``panel_reads``: panels 0, child, grandchild,
    a query stopping after its first row without a step) gives the plain
    version's ids, blocks and margins bit for bit; a parked query reads
    one panel, and no query reads more than 3 a row."""
    nav, q, depth, base, kw = descent_case(case)
    kw = dict(kw, return_blocks=True, return_margin=True)
    node, blk, margin, keys = descent.panel_reads(
        nav, q, base, depth, kw.get("valid"), kw.get("start"), kw.get("n_gathers"), True)
    want = descent.descend_plain(nav, q, base, depth, **kw)
    for a, b in zip((node, blk, margin), want):
        assert torch.equal(a, b)
    n_gathers = kw.get("n_gathers") or descent.default_gathers(depth, True)
    assert keys.numel() <= 3 * n_gathers * len(q)
    if "valid" in kw:
        parked = int((~kw["valid"]).sum())
        row0 = (keys // 7) % (nav.shape[0] // 2) == 0
        assert int(row0.sum()) == parked and bool((keys[row0] % 7 == 0).all())


@pytest.mark.parametrize("case", list(TERMS_CASES))
def test_terms_plain_matches_jax(jax_ref, case):
    """float64: H and b within 1e-9 and matched equal to the JAX
    package's terms_from_payload, leading index by leading index (one
    tree; keyframes sharing points; per-keyframe points; a (2, 3, 64)
    fleet batch with a pose per sequence)."""
    _, jax_icp = jax_ref
    import jax.numpy as jnp

    lead_pay, lead_pts, lead_x, L = TERMS_CASES[case]
    payload, pts, valid, X = _terms_inputs(lead_pay, lead_pts, lead_x, L, seed=L)
    H, b, matched = icp_terms.terms_plain(payload, pts, valid, X, **TERMS_KW)
    lead = tuple(torch.broadcast_shapes(payload.shape[:-2], pts.shape[:-2], X.shape[:-2]))
    assert H.shape == lead + (6, 6) and b.shape == lead + (6,) and matched.shape == lead + (L,)
    assert 0 < int(matched.sum()) < matched.numel()
    for idx in np.ndindex(*lead):
        sel = lambda t, own: t.expand(lead + t.shape[t.dim() - own:])[idx]  # noqa: E731
        want = jax_icp.terms_from_payload(
            *(jnp.asarray(sel(t, own).numpy()) for t, own in
              ((payload, 2), (pts, 2), (valid, 1), (X, 2))), **TERMS_KW)
        np.testing.assert_allclose(H[idx].numpy(), np.asarray(want.H), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(b[idx].numpy(), np.asarray(want.b), rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(matched[idx].numpy(), np.asarray(want.matched))


@pytest.mark.parametrize("form", ["ring", "flat"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("case", DESCENT_CASES)
def test_ring_form_is_the_expanded_call(case, groups, form):
    """The ring form (each group's queries, mapped by its pose, shared by
    its trees or each tree's own; row offsets from the entry's tree)
    equals today's call over the flat table with the mapped queries
    (``moving_in_map``) copied to every tree and a per-entry base, bit for
    bit; with ``out`` only the ``need`` entries change."""
    ring, queries, depth, kw, prev = ring_case(case, groups=groups, form=form)
    T, M = ring.shape[:2]
    G, n = queries.shape[:2]
    got = descent.descend_ring(ring, queries, depth, **kw)
    mapped = icp_terms.moving_in_map(queries, kw["X"].repeat_interleave(G // groups, dim=0))
    q = mapped[:, None].expand(G, T // G, n, 3).reshape(T * n, 3)
    base = (torch.arange(T) * M)[:, None].expand(T, n).reshape(T * n)
    start = kw.get("start")
    want = descent.descend(ring.reshape(T * M, 56), q, base, depth,
                           valid=kw["need"].reshape(-1),
                           start=None if start is None else start.reshape(-1),
                           n_gathers=kw.get("n_gathers"), return_blocks=True,
                           return_margin=kw["return_margin"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape[:2] == (T, n) and torch.equal(a.reshape(b.shape), b)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("form", ["ring", "flat"])
def test_mapped_queries_descend_as_the_transform_then_the_descent(form, B, merged):
    """Scan-frame queries with the sequences' poses descend as the step's
    former path did: each sequence's queries transformed by a matrix
    product, then the descent of the map-frame points (under the identity
    pose). Float64, the ring form (a sequence's queries shared by its
    trees) and the flat one (each tree's own, the sequence's pose),
    fresh and merged into the previous buffers: ids and blocks equal,
    margins within 1e-12."""
    ring, queries, depth, kw, prev = ring_case("root", n=400, groups=B, form=form)
    X = kw.pop("X")
    G = queries.shape[0]
    Xg = X.repeat_interleave(G // B, dim=0)
    q = queries @ Xg[:, :3, :3].mT + Xg[:, None, :3, 3]
    bufs = [tuple(t.clone() for t in prev) if merged else None for _ in range(2)]
    got = descent.descend_ring_plain(ring, queries, depth, **kw, X=X, out=bufs[0])
    want = descent.descend_ring_plain(ring, q, depth, **kw, X=torch.eye(4, dtype=X.dtype),
                                      out=bufs[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-12)
    assert int((got[0] > 1).sum()) > 0.5 * got[0].numel()


@pytest.mark.parametrize("form", ["ring", "flat"])
def test_ring_query_is_the_terms_map_frame_point(form):
    """The plain ring descent maps each query as the terms do
    (``moving_in_map``, K7's ``ml``), bit for bit: the one-split trees of
    :func:`axis_ring` show each coordinate of the query it descended."""
    ring, queries, X, pts = axis_ring(500, torch.float64, "cpu", form)
    need = torch.ones((3, 500), dtype=torch.bool)
    ids, _, margin = descent.descend_ring(ring, queries, 2, need, X=X, return_margin=True)
    assert torch.equal(descended_queries(ids, margin), icp_terms.moving_in_map(pts, X[0]))


@pytest.mark.parametrize("case", DESCENT_CASES)
def test_merged_plain_is_descend_plain_and_where(case):
    """The merged mode's plain version (``out``) is ``descend_plain``
    followed by the certified schedule's three ``torch.where``s, bit for
    bit, written into the buffers it was given."""
    ring, queries, depth, kw, prev = ring_case(case, groups=2)
    bufs = tuple(t.clone() for t in prev)
    got = descent.descend_ring(ring, queries, depth, **kw, out=bufs)
    fresh = descent.descend_ring_plain(ring, queries, depth, **kw)
    need = kw["need"]
    assert all(g is b for g, b in zip(got, bufs))
    for g, f, p in zip(got, fresh, prev):
        assert torch.equal(g, torch.where(need.view(need.shape + (1,) * (f.dim() - 2)), f, p))
    assert not torch.equal(bufs[0], prev[0])  # some entries moved


def test_ring_argument_checks():
    ring, queries, depth, kw, prev = ring_case("root", n=64, groups=2)
    X = kw["X"]
    with pytest.raises(ValueError, match="do not match"):
        descent.descend_ring(ring[:3], queries, depth, kw["need"][:3], X=X)
    with pytest.raises(ValueError, match="start must be"):
        descent.descend_ring(ring, queries, depth, kw["need"], X=X,
                             start=kw["need"][:, 1:].long())
    with pytest.raises(TypeError, match="need must be bool"):
        descent.descend_ring(ring, queries, depth, kw["need"].long(), X=X)
    with pytest.raises(ValueError, match="out must be"):
        descent.descend_ring(ring, queries, depth, kw["need"], X=X, return_margin=True,
                             out=prev[:2])
    with pytest.raises(TypeError, match="queries are"):
        descent.descend_ring(ring, queries.float(), depth, kw["need"], X=X)
    with pytest.raises(ValueError, match="P dividing"):
        descent.descend_ring(ring, queries, depth, kw["need"], X=X.repeat(2, 1, 1)[:3])
    with pytest.raises(ValueError, match="P dividing"):
        descent.descend_ring(ring, queries, depth, kw["need"], X=X[:, :3])
    with pytest.raises(TypeError, match="X is"):
        descent.descend_ring(ring, queries, depth, kw["need"], X=X.float())
    with pytest.raises(TypeError, match="X"):
        descent.descend_ring(ring, queries, depth, kw["need"])


def test_certified_drive_merges_in_place_as_descend_and_where(monkeypatch):
    """The certified schedule (``certify_compact`` 0) hands each later
    round's re-association to the descent as a merge into the previous
    round's results; a drive whose merges are done as descend + where
    outside the descent (the schedule before the merged mode) gives the
    same poses, inlier ratios and descents, bit for bit (float32, a room
    passed at 5 cm a scan)."""
    from madicp_tpu_torch.models.pipeline import Pipeline

    rng = np.random.default_rng(3)
    room = _room(rng, n=800)
    scans = [room - np.array([0.05 * i, 0.02 * i, 0.0]) + rng.normal(0, 0.001, room.shape)
             for i in range(4)]
    kw = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8, b_min=0.1,
              b_ratio=0.02, num_keyframes=2, n_points=4096, depth=10, max_leaves=1024,
              certify=True, dtype=torch.float32, device="cpu")

    def drive():
        pipe = Pipeline(**kw)
        out = []
        for i, scan in enumerate(scans):
            pipe.compute(0.1 * i, scan)
            out.append((pipe.current_pose(), pipe.inlier_ratio(), pipe.descents()))
        return out

    merged = drive()
    real, calls = descent.descend_ring, []

    def unmerged(nav, queries, depth, need, out=None, **k):
        calls.append(out is not None)
        if out is None:
            return real(nav, queries, depth, need, **k)
        fresh = real(nav, queries, depth, need, **k)
        return tuple(torch.where(need.view(need.shape + (1,) * (f.dim() - 2)), f, o)
                     for f, o in zip(fresh, out))

    monkeypatch.setattr(descent, "descend_ring", unmerged)
    parent = drive()
    assert any(calls) and not all(calls)  # round 0 fresh, later rounds merged
    for (pa, ra, da), (pb, rb, db) in zip(merged, parent):
        np.testing.assert_array_equal(pa, pb)
        assert ra == rb and da == db


# ------------------------------------------------------------------ card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _to(kw: dict, device) -> dict:
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", DESCENT_CASES)
@pytest.mark.parametrize("n", [1000, 4096])
def test_descend_kernel_is_bitwise_the_plain_version_on_cuda(cuda_device, dtype, case, n):
    """The kernel against the plain version on the card: ids, blocks and
    margins bit for bit, float32 and float64, at every case and at a
    query count that is not a multiple of the block; one launch a call."""
    nav, q, depth, base, kw = descent_case(case, n=n, seed=n)
    nav, q = nav.to(dtype).to(cuda_device), q.to(dtype).to(cuda_device)
    base = base.to(cuda_device) if isinstance(base, torch.Tensor) else base
    kw = _to(kw, cuda_device)
    want = descent.descend_plain(nav, q, base, depth, **kw)
    before = descent.counter.launches
    got = descent.descend(nav, q, base, depth, **kw)
    torch.cuda.synchronize()
    assert descent.counter.launches == before + 1
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
def test_descend_kernel_takes_an_unaligned_table_on_cuda(cuda_device):
    """A table that starts off a 16-byte boundary takes the scalar loads:
    still bit for bit."""
    nav, q, depth, base, kw = descent_case("root", n=777)
    flat = torch.zeros(nav.numel() + 1, dtype=torch.float32, device=cuda_device)
    shifted = flat[1:].view(nav.shape)
    shifted.copy_(nav)
    q, base, kw = q.float().to(cuda_device), base.to(cuda_device), _to(kw, cuda_device)
    for a, b in zip(descent.descend(shifted, q, base, depth, **kw),
                    descent.descend_plain(shifted, q, base, depth, **kw)):
        assert torch.equal(a, b)


def _ring_on(case, dtype, device, n=1000, groups=1, form="ring"):
    ring, queries, depth, kw, prev = ring_case(case, n=n, seed=n + groups, groups=groups,
                                               form=form)
    prev = tuple(t.to(dtype) if t.is_floating_point() else t for t in prev)
    kw["X"] = kw["X"].to(dtype)
    return (ring.to(dtype).to(device), queries.to(dtype).to(device), depth, _to(kw, device),
            tuple(t.to(device) for t in prev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", DESCENT_CASES)
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("form", ["ring", "flat"])
def test_ring_kernel_is_bitwise_the_plain_version_on_cuda(cuda_device, dtype, case, groups,
                                                          form):
    """The ring form on the card (each group's scan-frame queries, mapped
    in the kernel by its pose near a half turn, shared by its two trees
    or each tree's own; 4 groups: a B = 4 batch of 2 keyframes), fresh
    and merged into the previous buffers: ids, blocks and margins bit for
    bit against the plain version, 1000 queries a tree (not a multiple of
    a block); one launch a call, and the merge leaves the entries without
    ``need`` untouched."""
    ring, queries, depth, kw, prev = _ring_on(case, dtype, cuda_device, groups=groups,
                                              form=form)
    for merged in (False, True):
        want = descent.descend_ring_plain(ring, queries, depth, **kw,
                                          out=tuple(t.clone() for t in prev) if merged else None)
        bufs = tuple(t.clone() for t in prev) if merged else None
        before = descent.counter.launches
        got = descent.descend_ring(ring, queries, depth, **kw, out=bufs)
        torch.cuda.synchronize()
        assert descent.counter.launches == before + 1
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["ring", "flat"])
def test_ring_kernel_query_is_the_terms_ml_on_cuda(cuda_device, dtype, form):
    """K6's in-kernel query is K7's map-frame point ``ml`` bit for bit: the
    one-split trees of :func:`axis_ring` show each coordinate of the
    query the kernel descended, and K7 with that point as its matched
    point and a zero radius (b_max 1e-30, b_ratio 0) gates every entry in
    (``dist`` is 0 only where its ``ml`` is the same point) and none once
    the point moves by an ulp; the query is also the plain ``moving_in_map``
    on the card."""
    L = 3000
    ring, queries, X, pts = axis_ring(L, dtype, cuda_device, form)
    need = torch.ones((3, L), dtype=torch.bool, device=cuda_device)
    ids, _, margin = descent.descend_ring(ring, queries, 2, need, X=X, return_margin=True)
    q = descended_queries(ids, margin)
    assert torch.equal(q, icp_terms.moving_in_map(pts, X[0]))
    payload = torch.zeros((L, 8), dtype=dtype, device=cuda_device)
    payload[:, 3], payload[:, 7] = 1.0, 3.0
    gate = dict(b_max=1e-30, b_ratio=0.0, rho_ker=0.01)
    valid = torch.ones(L, dtype=torch.bool, device=cuda_device)
    for f, inside in ((q, True), (torch.nextafter(q, q + 1.0), False)):
        payload[:, :3] = f
        _, _, matched = icp_terms.terms(payload, pts, valid, X[0], **gate)
        assert bool(matched.all()) if inside else not bool(matched.any())


@pytest.mark.cuda
def test_parked_entries_descend_to_the_leaf_they_kept_on_cuda(cuda_device, monkeypatch):
    """On a certified drive stepped eagerly on the card, every entry a
    later round's certificate parks (live, its slack above the floor)
    descends, when forced fresh from the root with the round's pose, to
    the leaf it kept: each merged re-association is checked against a
    fresh descent of every live entry."""
    from madicp_tpu_torch.models.pipeline import _lift, odometry_step

    real, checked = descent.descend_ring, []

    def checking(nav, queries, depth, need, out=None, **kw):
        if out is not None:
            kept = out[0].clone()
            parked = (kept > 0) & ~need
            fresh = real(nav, queries, depth, need | (kept > 0), **kw)[0]
            checked.append((int(parked.sum()), int((fresh != kept)[parked].sum())))
        return real(nav, queries, depth, need, out=out, **kw)

    p = _card_pipeline(cuda_device, dtype=torch.float32)
    for i in range(3):
        p.compute(0.1 * i, _room_scan(i, 12000))
    monkeypatch.setattr(descent, "descend_ring", checking)
    state = _lift(p.state)
    for i in range(3, 7):
        pts, valid, _ = p.stage(_room_scan(i, 12000))
        state, _ = odometry_step(p.cfg, state, pts[None], valid[None], None)
    assert len(checked) == 4 * (p.cfg.max_icp_iterations - 1)
    assert sum(n for n, _ in checked) > 0 and all(bad == 0 for _, bad in checked)


@pytest.mark.cuda
def test_ring_kernel_takes_an_unaligned_table_on_cuda(cuda_device):
    """A ring that starts off a 16-byte boundary takes the scalar loads,
    fresh and merged, with queries that are a strided view of wider rows
    (as the step's leaves are of its leaf table), read where they lie:
    still bit for bit."""
    ring, queries, depth, kw, prev = _ring_on("root", torch.float32, cuda_device, n=777)
    flat = torch.zeros(ring.numel() + 1, dtype=torch.float32, device=cuda_device)
    shifted = flat[1:].view(ring.shape)
    shifted.copy_(ring)
    wide = torch.zeros(queries.shape[:-1] + (8,), dtype=torch.float32, device=cuda_device)
    wide[..., :3] = queries
    queries = wide[..., :3]
    assert not queries.is_contiguous()
    for merged in (False, True):
        bufs = [tuple(t.clone() for t in prev) if merged else None for _ in range(2)]
        for a, b in zip(descent.descend_ring(shifted, queries, depth, **kw, out=bufs[0]),
                        descent.descend_ring_plain(shifted, queries, depth, **kw, out=bufs[1])):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True])
def test_ring_kernel_reads_strided_queries_in_place_on_cuda(cuda_device, merged):
    """A B = 4 batch's queries as a strided view of wider rows (the step's
    leaves are one of their leaf table) are read where they lie: the call
    allocates its outputs and nothing else (no copy of the queries, no
    flattened view), and equals the call on a contiguous copy bit for
    bit."""
    ring, queries, depth, kw, prev = _ring_on("root", torch.float32, cuda_device, groups=4)
    wide = torch.zeros(queries.shape[:-1] + (8,), dtype=torch.float32, device=cuda_device)
    wide[..., :3] = queries
    strided = wide[..., :3]
    bufs = [tuple(t.clone() for t in prev) if merged else None for _ in range(2)]
    want = descent.descend_ring(ring, queries, depth, **kw, out=bufs[0])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    got = descent.descend_ring(ring, strided, depth, **kw, out=bufs[1])
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda_device) - before
    outputs = 0 if merged else sum(-(-t.numel() * t.element_size() // 512) * 512 for t in got)
    assert grown == outputs
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merged_ring_replays_in_a_cuda_graph(cuda_device, dtype):
    """The merge captured in a CUDA graph (writing into the buffers in
    place) and replayed twice, the buffers reset to the previous round's
    before each replay, equals the eager merge bit for bit."""
    ring, queries, depth, kw, prev = _ring_on("root", dtype, cuda_device, n=3000, groups=2)
    eager = descent.descend_ring(ring, queries, depth, **kw, out=tuple(t.clone() for t in prev))
    bufs = tuple(t.clone() for t in prev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        descent.descend_ring(ring, queries, depth, **kw, out=bufs)
    for _ in range(2):
        for b, p in zip(bufs, prev):
            b.copy_(p)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(bufs, eager):
            assert torch.equal(a, b)


def _terms_reference(payload, pts, valid, X):
    """(H, b) as a float64 sum of the plain version's own per-entry terms
    (its J, s and e in the working type), and its matched."""
    J, s, e, matched = icp_terms.entry_terms(payload, pts, valid, X, **TERMS_KW)
    Js = (J * s[..., None]).double()
    return Js.mT @ J.double(), torch.sum(Js * e.double()[..., None], dim=-2), matched


def _rel_frobenius(got, want, axes):
    return ((got.double() - want).square().sum(axes).sqrt()
            / want.square().sum(axes).sqrt().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(TERMS_CASES) + ["flagship_rows"])
def test_terms_kernel_matches_the_plain_version_on_cuda(cuda_device, dtype, case):
    """matched bit for bit; H and b within 1e-5 (float32) or 1e-12
    (float64) relative, Frobenius per leading index, of a float64 sum of
    the plain version's per-entry terms; one launch a call. Also a
    leading (16,) at L = 32768 - 3, the flagship's tile counts."""
    lead_pay, lead_pts, lead_x, L = TERMS_CASES.get(case, ((16,), (), (), 32765))
    args = [t.to(cuda_device) for t in _terms_inputs(lead_pay, lead_pts, lead_x, L,
                                                     seed=L, dtype=dtype)]
    H_ref, b_ref, m_ref = _terms_reference(*args)
    before = icp_terms.counter.launches
    H, b, matched = icp_terms.terms(*args, **TERMS_KW)
    torch.cuda.synchronize()
    assert icp_terms.counter.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert H.dtype == b.dtype == dtype and torch.equal(matched, m_ref)
    assert torch.equal(H, H.mT)
    assert float(_rel_frobenius(H, H_ref, (-2, -1)).max()) <= tol
    assert float(_rel_frobenius(b, b_ref, (-1,)).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["fleet_b4", "strided", "graph"])
def test_terms_kernel_cluster_launches_on_cuda(cuda_device, dtype, case):
    """The terms kernel's cluster launches at full size: the fleet's B = 4
    (4, 16) leading indices of 32768 entries; a payload that is a strided
    view of wider rows (the scalar loads) equal bit for bit to the
    contiguous call on the same values; and a flagship call (16 leads, a
    cluster of several blocks each) captured in a CUDA graph, replayed
    twice, equal to the eager call bit for bit. Each one launch, matched
    bit for bit and H, b within 1e-5 (1e-12) of the float64 sum."""
    lead = {"fleet_b4": ((4, 16), (4, 1), (4, 1)), "strided": ((16,), (), ()),
            "graph": ((16,), (), ())}[case]
    L = 32768 if case == "fleet_b4" else 32765
    args = [t.to(cuda_device) for t in _terms_inputs(*lead, L, seed=3, dtype=dtype)]
    H_ref, b_ref, m_ref = _terms_reference(*args)
    before = icp_terms.counter.launches
    H, b, matched = icp_terms.terms(*args, **TERMS_KW)
    torch.cuda.synchronize()
    assert icp_terms.counter.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert torch.equal(matched, m_ref) and torch.equal(H, H.mT)
    assert float(_rel_frobenius(H, H_ref, (-2, -1)).max()) <= tol
    assert float(_rel_frobenius(b, b_ref, (-1,)).max()) <= tol
    if case == "strided":
        wide = torch.zeros(args[0].shape[:-1] + (12,), dtype=dtype, device=cuda_device)
        wide[..., :8] = args[0]
        view = wide[..., :8]
        assert not icp_terms.vector_rows(view, (16,)) and icp_terms.vector_rows(args[0], (16,))
        got = icp_terms.terms(view, *args[1:], **TERMS_KW)
        for a, w in zip(got, (H, b, matched)):
            assert torch.equal(a, w)
    if case == "graph":
        assert icp_terms.plan(16, L, icp_terms.card_capacity(cuda_device, dtype)).cluster > 1
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = icp_terms.terms(*args, **TERMS_KW)
        for _ in range(2):
            for t in out:
                t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            for a, w in zip(out, (H, b, matched)):
                assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_assoc_kernels_replay_in_a_cuda_graph(cuda_device, dtype):
    """Both kernels captured in one CUDA graph and replayed twice equal
    their eager calls bit for bit (no float atomics, no workspace that
    outlives a call, sums in a fixed order)."""
    nav, q, depth, base, kw = descent_case("root", n=3000)
    nav, q = nav.to(dtype).to(cuda_device), q.to(dtype).to(cuda_device)
    base, kw = base.to(cuda_device), _to(kw, cuda_device)
    args = [t.to(cuda_device) for t in _terms_inputs((4,), (), (), 3000, dtype=dtype)]

    def call():
        return (descent.descend(nav, q, base, depth, **kw)
                + icp_terms.terms(*args, **TERMS_KW))

    eager = [t.clone() for t in call()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bound", list(BOUNDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bounded_kernels_match_their_plain_versions_on_cuda(cuda_device, dtype, bound):
    """K7 with a bound a sequence over (2, 16) leading indices: matched
    bit for bit with the plain version's (false past the bound), H and b
    within the unbounded tests' tolerance of the float64 sum of the
    cut mask's terms, one launch; without matched the same H and b bit
    for bit. K11 with a bound: need, the slack and the count bit for bit
    with the plain version, on rows of 16-byte multiples (L = 4096) and
    not (L = 4095)."""
    from madicp_tpu_torch.probes.gn_cases import slack_inputs

    L = 4099
    args = [t.to(cuda_device) for t in _terms_inputs((2, 16), (2, 1), (2, 1), L, seed=7,
                                                     dtype=dtype)]
    n = _n_live(bound, L)[:, None].to(cuda_device)
    cut = args[2] & (torch.arange(L, device=cuda_device) < n[..., None])
    H_ref, b_ref, m_ref = _terms_reference(args[0], args[1], cut, args[3])
    before = icp_terms.counter.launches
    H, b, matched = icp_terms.terms(*args, **TERMS_KW, n_live=n)
    torch.cuda.synchronize()
    assert icp_terms.counter.launches == before + 1
    assert torch.equal(matched, m_ref) and torch.equal(H, H.mT)
    if bound == "zero":
        assert not H.any() and not b.any()
    else:
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert float(_rel_frobenius(H, H_ref, (-2, -1)).max()) <= tol
        assert float(_rel_frobenius(b, b_ref, (-1,)).max()) <= tol
    H2, b2, m2 = icp_terms.terms(*args, **TERMS_KW, n_live=n, with_matched=False)
    assert m2 is None and torch.equal(H2, H) and torch.equal(b2, b)
    for Ls in (4096, 4095):
        s = {k: v.to(cuda_device) for k, v in slack_inputs(dtype, B=2, K=16, L=Ls).items()}
        p = {k: v.clone() for k, v in s.items()}
        nl = _n_live(bound, Ls).to(cuda_device)
        need = certify_slack.certify_slack(**s, n_live=nl)
        want = certify_slack.certify_slack_plain(**p, n_live=nl)
        torch.cuda.synchronize()
        assert torch.equal(need, want)
        assert torch.equal(s["slack"], p["slack"]) and torch.equal(s["n_descents"],
                                                                   p["n_descents"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_replay_takes_each_calls_bound_on_cuda(cuda_device, dtype):
    """K7 and K11 captured in one CUDA graph with their bound in a static
    buffer, replayed with the full L, then a smaller bound, then the full L
    again: each replay equals the eager calls at its bound bit for bit,
    and no matched or need flag of an earlier replay survives past a
    smaller bound."""
    from madicp_tpu_torch.probes.gn_cases import slack_inputs

    L = 8192
    args = [t.to(cuda_device) for t in _terms_inputs((2, 16), (2, 1), (2, 1), L, seed=11,
                                                     dtype=dtype)]
    s = {k: v.to(cuda_device) for k, v in slack_inputs(dtype, B=2, K=16, L=L).items()}
    s["slack"].fill_(-1.0)  # every live entry needs a descent: need is dense below the bound
    init = {k: v.clone() for k, v in s.items()}
    n = torch.full((2,), L, dtype=torch.int64, device=cuda_device)

    def call():
        return (icp_terms.terms(*args, **TERMS_KW, n_live=n[:, None])
                + (certify_slack.certify_slack(**s, n_live=n),))

    def reset():
        for k, v in init.items():
            s[k].copy_(v)

    call()
    reset()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        call()
    torch.cuda.current_stream().wait_stream(side)
    reset()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for bound in ([L, L], [3001, 517], [L, L]):
        n.copy_(torch.tensor(bound))
        reset()
        graph.replay()
        torch.cuda.synchronize()
        got = [t.clone() for t in out] + [s["slack"].clone(), s["n_descents"].clone()]
        reset()
        eager = list(call()) + [s["slack"].clone(), s["n_descents"].clone()]
        torch.cuda.synchronize()
        for a, w in zip(got, eager):
            assert torch.equal(a, w)
        past = torch.arange(L, device=cuda_device) >= n[:, None]  # (2, L)
        assert not (got[2] & past[:, None, :]).any() and not (got[3] & past[:, None, :]).any()
        if bound[0] == L:  # every valid leaf of a live keyframe needs a descent
            assert got[2].any() and torch.equal(got[3][0, 0], init["leaves_valid"][0])


def _card_pipeline(device, **kw):
    from madicp_tpu_torch.models.pipeline import Pipeline

    return Pipeline(10.0, False, 0.2, 0.1, 0.8, 0.1, 0.02, 3, n_points=16384, depth=12,
                    max_icp_iterations=6, device=device, **kw)


def _room_scan(i: int, n: int) -> np.ndarray:
    """``n`` points of the walled room, drawn for scan ``i``, 0.1 m further
    along x each scan."""
    rng = np.random.default_rng(i)
    return rng.permutation(_room(rng, n=4000))[:n] + [0.1 * i, 0.0, 0.0]


@pytest.mark.cuda
def test_a_captured_step_walks_each_scans_own_leaves_on_cuda(cuda_device):
    """A captured step replayed on a scan with many leaves, then on one
    with few (and back): its pose, inlier ratio, map flag and descents
    equal the eager step's on the same state bit for bit; and the
    certified rounds captured alone, replayed on those scans' leaves,
    equal their eager calls with no matched flag past a scan's leaves."""
    from madicp_tpu_torch.models.pipeline import _lift, icp_rounds, odometry_step
    from madicp_tpu_torch.ops.tree import build_tree, get_leaves

    p = _card_pipeline(cuda_device)
    for i in range(3):  # the bootstrap, the warm-up, the capture
        p.compute(0.1 * i, _room_scan(i, 12000))
    sizes = (12000, 1500, 12000, 900)
    leaves = []
    for i, n in enumerate(sizes, start=3):
        state = _lift(p.state)
        before = type(state)(*(f._replace(nav=f.nav.clone()) if hasattr(f, "nav") else f.clone()
                               for f in state))
        pts, valid, _ = p.stage(_room_scan(i, n))
        p.compute_device(0.1 * i, pts, valid)
        _, out = odometry_step(p.cfg, before, pts[None], valid[None], None)
        assert torch.equal(p.state.X, out.pose[0])
        assert p.inlier_ratio() == float(out.inlier_ratio[0])
        assert p.is_map_updated() == bool(out.map_updated[0])
        assert p.descents() == int(out.n_descents[0])
        tree, _ = build_tree(pts[None], valid[None], depth=p.cfg.depth, b_max=p.cfg.b_max,
                             b_min=p.cfg.b_min)
        leaves.append(get_leaves(tree, p.cfg.leaves_cap))
    assert int(leaves[1].valid.sum()) < int(leaves[0].valid.sum()) // 2

    st = p.state
    kf_tree, kf_valid = st.kf_tree, st.kf_valid[None].to(p.cfg.dtype)
    kf_tree = kf_tree._replace(nav=kf_tree.nav[None])
    lp, lv = leaves[0].pts.clone(), leaves[0].valid.clone()
    X0 = st.X[None].clone()

    def rounds():
        return icp_rounds(p.cfg, kf_tree, kf_valid, lp, lv, X0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rounds()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rounds()
    for lf in leaves:
        lp.copy_(lf.pts)
        lv.copy_(lf.valid)
        graph.replay()
        torch.cuda.synchronize()
        got = [t.clone() for t in out]
        for a, w in zip(got, rounds()):
            assert torch.equal(a, w)
        assert not (got[2] & ~lv).any()


@pytest.mark.cuda
def test_the_bound_adds_no_graph_node_on_cuda(cuda_device, monkeypatch):
    """The captured step with the bound has as many nodes and launches as
    the step whose terms and slack pass walk every slot."""
    from madicp_tpu_torch.models import pipeline as pl

    def captured():
        p = _card_pipeline(cuda_device)
        for i in range(3):
            p.compute(0.1 * i, _room_scan(i, 12000))
        p.current_pose()
        (_, nodes, launches), = p._graphs.captured().values()
        return nodes, launches

    bounded = captured()
    terms, slack = pl.terms_from_payload, certify_slack.certify_slack
    monkeypatch.setattr(pl, "terms_from_payload",
                        lambda *a, n_live=None, **kw: terms(*a, **kw))
    monkeypatch.setattr(certify_slack, "certify_slack", lambda *a, n_live=None: slack(*a))
    assert captured() == bounded
