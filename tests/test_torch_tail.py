"""The step's prediction and tail in the PyTorch port: K14
(``kernels/step_scalars.py``: ``predict`` and ``tail``) and K13
(``kernels/ring_write.py``: the frame record and the promotion's tree
copy).

On the CPU, from numpy inputs made from a seed: the plain prediction
against the JAX package's ``exp_se3_split`` and product; the velocity
estimate (``ops/velocity.py``, which the plain tail calls)
against its ``estimate_velocity`` for window lengths 0, 1, 2, 5 and 10,
with and without the robust clamp; ``neg_logdet`` (the explicit LU)
against its ``neg_logdet``, also where ``det H <= 0`` gives the dtype's
max; the plain tail against the JAX step's tail (``madicp_tpu/models/
pipeline.py:736-792`` per sequence: its ``estimate_velocity``,
``neg_logdet`` and bookkeeping) and the plain ring write against its
``transform_tree``, ``_set_slot`` and promotion copy, for a batch of two
where one sequence promotes, with ``best == head``, with a slot this
process does not hold and with every frame invalid before the scan; the
wrappers' CPU dispatch and argument checks. Float64 is held at 1e-12 on
scalars and 1e-9 on positions (as ``tests/test_torch_graphs.py``);
float32 at 2e-5 on poses and velocities and 1e-4 on ``-log det`` (a few
ulps of values up to ~40 in two orders of rounding against XLA's
fused, reassociated float32). The tail written in place (``out``, the
step's form) equals the fresh tail bit for bit and keeps its
destinations; a CPU drive of ``step_in_place`` equals the functional
``odometry_step`` and copies no state field. Tests marked ``cuda``
hold both kernels to their plain versions on the card bit for bit in
every case, float32 and float64, B = 1 and 4, fresh and in place, and
skip without one. JAX is imported by the CPU tests only, so a machine
with a card needs none."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from madicp_tpu_torch.kernels import ring_write, step_scalars
from madicp_tpu_torch.models.pipeline import PipelineState
from madicp_tpu_torch.ops.constants import FRAME_WINDOW, SMOOTHING_T
from madicp_tpu_torch.ops.icp_core import neg_logdet
from madicp_tpu_torch.ops.tree import NAV_WIDTH, SearchTree
from madicp_tpu_torch.ops.velocity import estimate_velocity

torch.set_num_threads(2)

DTYPES = (torch.float64, torch.float32)
# tolerances against the JAX package (module docstring)
POSE_TOL = {torch.float64: 1e-9, torch.float32: 2e-5}
SCALAR_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
LOGDET_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
NP = {torch.float64: np.float64, torch.float32: np.float32}
HZ = 10.0
M = 32  # arena rows of the small trees
K = 4   # keyframes a ring
CASES = ("promote_one", "best_is_head", "slot_not_held", "all_invalid", "no_promote")


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's functions the step's tail runs, on the CPU with
    x64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import madicp_tpu.models.pipeline as jax_pipeline
    import madicp_tpu.models.vel_estimator as jax_vel
    import madicp_tpu.ops.icp_core as jax_icp
    import madicp_tpu.ops.lie as jax_lie
    import madicp_tpu.ops.tree as jax_tree

    return dict(pipeline=jax_pipeline, vel=jax_vel, icp=jax_icp, lie=jax_lie, tree=jax_tree)


def _pose(rng, angle=0.3, shift=2.0) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * angle).as_matrix()
    T[:3, 3] = rng.normal(size=3) * shift
    return T


def _trajectory(rng, count: int, clamp: bool) -> np.ndarray:
    """A (W, 4, 4) pose window whose last ``min(count, W)`` slots hold a
    drive (the rest the identity, as the state starts); with ``clamp`` the
    steps jump so the residuals pass the robust threshold."""
    W = SMOOTHING_T
    traj = np.tile(np.eye(4), (W, 1, 1))
    pose = _pose(rng)
    n = min(count, W)
    for w in range(W - n, W):
        d = np.eye(4)
        d[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * (0.3 if clamp else 0.02)).as_matrix()
        d[:3, 3] = np.array([1.0, 0.1, 0.0]) + rng.normal(size=3) * (1.0 if clamp else 0.02)
        pose = pose @ d
        traj[w] = pose
    return traj


def _spd(rng, scale=1e3) -> np.ndarray:
    A = rng.normal(size=(6, 6))
    return A @ A.T * scale + np.eye(6)


def tail_case(case: str, dtype, B: int = 2, seed: int = 0, device="cpu", L: int = 200):
    """The tail's and the ring write's inputs for ``B`` sequences (numpy
    from ``seed``, then tensors): ``(state, X, H, matched, valid, hz, nav,
    kw)``. Sequence 0 promotes (its inlier ratio is below ``p_th``) unless
    ``case`` is ``no_promote``, the others do not; ``best_is_head``: every
    other valid window frame weighs more than the new record;
    ``slot_not_held``: the ring is a process's shard that does not hold
    the ring heads; ``all_invalid``: no window frame is valid before the
    scan. Window lengths cycle through 0, 1, 4, 9 (1, 2, 5, 10 after the
    scan); sequence 1 jumps (the velocity's robust clamp)."""
    rng = np.random.default_rng(seed)
    F = FRAME_WINDOW
    npt = NP[dtype]
    X = np.stack([_pose(rng) for _ in range(B)])
    H = np.stack([_spd(rng) for _ in range(B)])
    valid = np.zeros((B, L), bool)
    matched = rng.random((B, L)) < 0.95
    for b in range(B):
        valid[b, :L - 13 * b] = True
        if b == 0 and case != "no_promote":
            matched[b] = rng.random(L) < 0.5
    counts = np.array([(0, 1, 4, 9)[b % 4] for b in range(B)], np.int32)
    traj = np.stack([_trajectory(rng, int(c), clamp=b == 1) for b, c in enumerate(counts)])
    velocity = rng.normal(size=(B, 6)) * 0.5
    if B > 1:
        velocity[-1, 3:] = 1e-6  # the prediction's small-angle branch
    fr_valid = rng.random((B, F)) < 0.7
    fr_weight = rng.normal(size=(B, F)) * 5.0
    fr_weight[rng.random((B, F)) < 0.1] = np.inf
    seq = np.array([37 + 5 * b for b in range(B)], np.int32)
    fr_seq = np.stack([np.arange(s - F, s) for s in seq]).astype(np.int32)
    fr_head = rng.integers(0, F, B).astype(np.int32)
    if case == "promote_one":  # a valid old frame outweighs the new record
        fr_valid[np.arange(B), (fr_head + 3) % F] = True
        fr_weight[np.arange(B), (fr_head + 3) % F] = -1e3
    if case == "best_is_head":
        fr_weight[:] = 1e6
    if case == "all_invalid":
        fr_valid[:] = False
    kf_offset = K if case == "slot_not_held" else 0
    state = PipelineState(
        X=torch.as_tensor(np.stack([_pose(rng) for _ in range(B)]).astype(npt), device=device),
        velocity=torch.as_tensor(velocity.astype(npt), device=device),
        traj=torch.as_tensor(traj.astype(npt), device=device),
        traj_count=torch.as_tensor(counts, device=device),
        kf_tree=SearchTree(nav=torch.as_tensor(
            rng.normal(size=(B, K, M, NAV_WIDTH)).astype(npt), device=device)),
        kf_valid=torch.as_tensor(rng.random((B, K)) < 0.5, device=device),
        kf_head=torch.as_tensor(rng.integers(0, K, B).astype(np.int32), device=device),
        keyframe_to_map=torch.as_tensor(np.stack([_pose(rng) for _ in range(B)]).astype(npt),
                                        device=device),
        fr_tree=SearchTree(nav=torch.as_tensor(
            rng.normal(size=(B, F, M, NAV_WIDTH)).astype(npt), device=device)),
        fr_valid=torch.as_tensor(fr_valid, device=device),
        fr_weight=torch.as_tensor(fr_weight.astype(npt), device=device),
        fr_seq=torch.as_tensor(fr_seq, device=device),
        fr_pose=torch.as_tensor(np.stack([[_pose(rng) for _ in range(F)]
                                          for _ in range(B)]).astype(npt), device=device),
        fr_head=torch.as_tensor(fr_head, device=device),
        seq=torch.as_tensor(seq, device=device),
        seq_keyframe=torch.as_tensor(seq - 3, device=device),
    )
    t = lambda a: torch.as_tensor(a.astype(npt) if a.dtype != bool else a, device=device)  # noqa: E731
    nav = t(rng.normal(size=(B, M, NAV_WIDTH)) * 10.0)
    kw = dict(p_th=0.8, num_keyframes=K, kf_offset=kf_offset)
    hz = torch.full((), HZ, dtype=dtype, device=device)
    return state, t(X), t(H), t(matched), t(valid), hz, nav, kw


def _jax_tail(jax_ref, state, X, H, matched, valid, nav, p_th, num_keyframes, kf_offset):
    """The JAX step's tail (``madicp_tpu/models/pipeline.py:736-792``) one
    sequence at a time, with the port's per-process slot rule (a process
    writes only a ring slot it holds; the JAX step holds them all):
    ``({field: numpy (B, ...)}, (fr_nav, kf_nav))``."""
    import jax.numpy as jnp

    jp, jv, ji, jt = jax_ref["pipeline"], jax_ref["vel"], jax_ref["icp"], jax_ref["tree"]
    n = lambda a: a.cpu().numpy()  # noqa: E731
    F = state.fr_valid.shape[1]
    K_l = state.kf_valid.shape[1]
    out: dict = {k: [] for k in step_scalars.Tail._fields if k != "plan"}
    fr_navs, kf_navs = [], []
    for b in range(X.shape[0]):
        Xb = jnp.asarray(n(X[b]))
        dtype = Xb.dtype
        n_leaves = jnp.sum(n(valid[b]))
        ratio = (jnp.sum(n(matched[b]) & n(valid[b])) / jnp.maximum(n_leaves, 1)).astype(dtype)
        traj = jnp.concatenate([n(state.traj[b])[1:], n(X[b])[None]], axis=0)
        traj_count = int(state.traj_count[b]) + 1
        hz = jnp.asarray(HZ, dtype)
        velocity = jv.estimate_velocity(jnp.asarray(n(state.velocity[b])), traj,
                                        jnp.asarray(traj_count), 1.0 / hz)
        weight = ji.neg_logdet(jnp.asarray(n(H[b])))
        moved = jt.transform_tree(jt.SearchTree(nav=jnp.asarray(n(nav[b]))), Xb[:3, :3], Xb[:3, 3])
        head = int(state.fr_head[b])
        fr_tree = jp._set_slot(jt.SearchTree(nav=jnp.asarray(n(state.fr_tree.nav[b]))), head,
                               moved)
        fr_valid = jnp.asarray(n(state.fr_valid[b])).at[head].set(True)
        fr_weight = jnp.asarray(n(state.fr_weight[b])).at[head].set(weight)
        fr_seq = jnp.asarray(n(state.fr_seq[b])).at[head].set(int(state.seq[b]))
        fr_pose = jnp.asarray(n(state.fr_pose[b])).at[head].set(Xb)
        promote = bool(ratio < p_th)
        best = int(jnp.argmin(jnp.where(fr_valid, fr_weight, jnp.inf)))
        best_seq = fr_seq[best]
        kf_tree = jt.SearchTree(nav=jnp.asarray(n(state.kf_tree.nav[b])))
        kf_valid = jnp.asarray(n(state.kf_valid[b]))
        kf_head, kf_pose = int(state.kf_head[b]), jnp.asarray(n(state.keyframe_to_map[b]))
        seq_kf = int(state.seq_keyframe[b])
        if promote:
            slot = kf_head - kf_offset
            if 0 <= slot < K_l:
                kf_tree = jp._set_slot(kf_tree, slot, jt.SearchTree(nav=fr_tree.nav[best]))
                kf_valid = kf_valid.at[slot].set(True)
            kf_head = (kf_head + 1) % num_keyframes
            fr_valid = fr_valid & (fr_seq > best_seq)
            kf_pose, seq_kf = fr_pose[best], int(best_seq)
        row = dict(velocity=velocity, traj=traj, traj_count=traj_count, ratio=ratio,
                   n_leaves=n_leaves, promote=promote, fr_valid=fr_valid, fr_weight=fr_weight,
                   fr_seq=fr_seq, fr_pose=fr_pose, fr_head=(head + 1) % F, kf_valid=kf_valid,
                   kf_head=kf_head, keyframe_to_map=kf_pose, seq_keyframe=seq_kf,
                   seq=int(state.seq[b]) + 1)
        for k, v in row.items():
            out[k].append(np.asarray(v))
        fr_navs.append(np.asarray(fr_tree.nav))
        kf_navs.append(np.asarray(kf_tree.nav))
    return {k: np.stack(v) for k, v in out.items()}, (np.stack(fr_navs), np.stack(kf_navs))


# ------------------------------------------------------------------ CPU --
@pytest.mark.parametrize("dtype", DTYPES)
def test_predict_plain_matches_jax(jax_ref, dtype):
    """X exp_se3_split(v / hz) against the JAX package's, both branches of
    exp_so3 (a rotation step below theta^2 = 1e-8 and large ones)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    B = 6
    X = np.stack([_pose(rng) for _ in range(B)])
    v = rng.normal(size=(B, 6)) * 3.0
    v[0, 3:] = 1e-5  # theta^2 = 3e-12 at 10 Hz
    v[1] = 0.0
    hz = torch.full((), HZ, dtype=dtype)
    got = step_scalars.predict_plain(torch.as_tensor(X.astype(NP[dtype])),
                                     torch.as_tensor(v.astype(NP[dtype])), hz)
    Xj, vj = jnp.asarray(X.astype(NP[dtype])), jnp.asarray(v.astype(NP[dtype]))
    want = np.asarray(Xj @ jax_ref["lie"].exp_se3_split(vj / jnp.asarray(HZ, Xj.dtype)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POSE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("count", [0, 1, 2, 5, 10])
@pytest.mark.parametrize("clamp", [False, True], ids=["smooth", "clamped"])
def test_velocity_estimate_matches_jax(jax_ref, dtype, count, clamp):
    """The explicit-order estimate (a batch of three windows) against the
    JAX package's, window lengths 0 to 10, with the robust clamp active
    on jumping windows."""
    import jax.numpy as jnp

    rng = np.random.default_rng(10 * count + clamp)
    trajs = np.stack([_trajectory(rng, count, clamp) for _ in range(3)])
    v0 = rng.normal(size=(3, 6)) * 0.5
    npt = NP[dtype]
    got = estimate_velocity(torch.as_tensor(v0.astype(npt)), torch.as_tensor(trajs.astype(npt)),
                            torch.full((3,), count, dtype=torch.int32),
                            torch.full((), 1.0 / HZ, dtype=dtype))
    want = np.stack([np.asarray(jax_ref["vel"].estimate_velocity(
        jnp.asarray(v0[b].astype(npt)), jnp.asarray(trajs[b].astype(npt)), jnp.asarray(count),
        0.1)) for b in range(3)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCALAR_TOL[dtype])
    if clamp and count >= 2:  # the jumping window's residuals pass the threshold
        e = got.numpy() - v0
        assert np.all(np.isfinite(e)) and np.abs(e).max() > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_neg_logdet_matches_jax(jax_ref, dtype):
    """-log det H by the explicit LU against the JAX package's slogdet
    form: SPD systems at metre and flagship scales, a pivot swap, and the
    dtype's max where det H <= 0 (a negative eigenvalue, a zero row and
    column, one row swap); a NaN entry gives the max as well (JAX's
    slogdet gives NaN there; the port never ranks a NaN weight)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    Hs = [_spd(rng, s) for s in (1.0, 1e3, 1e5)]
    P = np.eye(6)[[1, 0, 2, 3, 4, 5]]
    Hs.append(P @ _spd(rng) @ P.T + np.diag([0, 0, 0, 0, 0, 1e-3]))
    Q = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
    Q6 = np.kron(np.eye(2), Q)
    neg = Q6 @ np.diag([-1.0, 2, 3, 4, 5, 6]) @ Q6.T * 1e3
    sing = _spd(rng)
    sing[3], sing[:, 3] = 0.0, 0.0
    swapped = _spd(rng)[[1, 0, 2, 3, 4, 5]]  # one row swap: det < 0
    Hs += [neg, sing, swapped]
    H = np.stack(Hs).astype(NP[dtype])
    got = neg_logdet(torch.as_tensor(H)).numpy()
    want = np.stack([np.asarray(jax_ref["icp"].neg_logdet(jnp.asarray(h))) for h in H])
    big = np.finfo(NP[dtype]).max
    assert (want[-3:] == big).all() and (want[:-3] < big).all()
    np.testing.assert_allclose(got[:-3], want[:-3], rtol=LOGDET_TOL[dtype], atol=0)
    np.testing.assert_array_equal(got[-3:], want[-3:])
    nan = H[0].copy()
    nan[1, 4] = np.nan
    assert neg_logdet(torch.as_tensor(nan)).item() == big


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_tail_and_ring_write_plain_match_the_jax_step(jax_ref, dtype, case):
    """The plain tail and ring write for a batch of two against the JAX
    step's tail one sequence at a time: every scalar, flag and pose, the
    frame window and the keyframe ring (positions within the pose
    tolerance, the rest exactly)."""
    state, X, H, matched, valid, hz, nav, kw = tail_case(case, dtype)
    fr0, kf0 = state.fr_tree.nav.clone(), state.kf_tree.nav.clone()
    got = step_scalars.tail_plain(state, X, H, matched, valid, hz, **kw)
    ring_write.ring_write_plain(nav, X, got.plan, state.fr_tree.nav, state.kf_tree.nav)
    want, (fr_want, kf_want) = _jax_tail(jax_ref, state._replace(
        fr_tree=SearchTree(nav=fr0), kf_tree=SearchTree(nav=kf0)), X, H, matched, valid, nav,
        **kw)
    # JAX divides the counts in float64 and rounds to float32
    tol = {"velocity": SCALAR_TOL[dtype], "fr_weight": LOGDET_TOL[dtype],
           "ratio": 0 if dtype == torch.float64 else 1e-7}
    for name in want:
        g, w = getattr(got, name).numpy(), want[name]
        if name in tol and tol[name]:
            np.testing.assert_allclose(g, w, rtol=tol[name] if name == "fr_weight" else 0,
                                       atol=0 if name == "fr_weight" else tol[name],
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(state.fr_tree.nav.numpy(), fr_want, rtol=0,
                               atol=POSE_TOL[dtype] * 10)
    np.testing.assert_allclose(state.kf_tree.nav.numpy(), kf_want, rtol=0,
                               atol=POSE_TOL[dtype] * 10)
    promote, head, best, slot, write = (got.promote.numpy(), *got.plan.numpy().T)
    assert promote[0] == (case != "no_promote") and not promote[1:].any()
    assert (write == 1).tolist() == [promote[0] and case != "slot_not_held", False]
    if case in ("best_is_head", "all_invalid"):
        assert best[0] == head[0]
    if case == "promote_one":
        assert best[0] != head[0]


def test_ring_write_plain_copies_only_the_promoted_slot():
    """The window slot of every sequence takes its moved tree; the
    keyframe ring changes only at the slot a promoting sequence writes,
    and a copy there is the window tree ``best`` as the frame record left
    it."""
    state, X, H, matched, valid, hz, nav, kw = tail_case("promote_one", torch.float64)
    got = step_scalars.tail_plain(state, X, H, matched, valid, hz, **kw)
    fr0, kf0 = state.fr_tree.nav.clone(), state.kf_tree.nav.clone()
    ring_write.ring_write_plain(nav, X, got.plan, state.fr_tree.nav, state.kf_tree.nav)
    head, best, slot, write = got.plan.tolist()[0]
    assert write == 1
    changed = (state.kf_tree.nav != kf0).flatten(2).any(-1)
    assert changed.tolist() == [[k == slot for k in range(K)], [False] * K]
    assert torch.equal(state.kf_tree.nav[0, slot], state.fr_tree.nav[0, best])
    assert torch.equal(state.fr_tree.nav[0, best], fr0[0, best])  # best is not this scan's
    assert not torch.equal(state.fr_tree.nav[1, got.plan[1, 0]], fr0[1, got.plan[1, 0]])


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers return their plain versions' results bit
    for bit and count no launch."""
    state, X, H, matched, valid, hz, nav, kw = tail_case("promote_one", torch.float32)
    c13, c14 = ring_write.counter.launches, step_scalars.counter.launches
    assert torch.equal(step_scalars.predict(state.X, state.velocity, hz),
                       step_scalars.predict_plain(state.X, state.velocity, hz))
    got, want = (step_scalars.tail(state, X, H, matched, valid, hz, **kw),
                 step_scalars.tail_plain(state, X, H, matched, valid, hz, **kw))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fr, kf = state.fr_tree.nav.clone(), state.kf_tree.nav.clone()
    ring_write.ring_write(nav, X, got.plan, state.fr_tree.nav, state.kf_tree.nav)
    ring_write.ring_write_plain(nav, X, got.plan, fr, kf)
    assert torch.equal(fr, state.fr_tree.nav) and torch.equal(kf, state.kf_tree.nav)
    assert (ring_write.counter.launches, step_scalars.counter.launches) == (c13, c14)


STATE_FIELDS = ("X",) + tuple(name for name, _, _ in step_scalars._STATE)


def _scalars(state):
    """A copy of a state's tensors but its trees (None)."""
    return type(state)(*(None if f is None or isinstance(f, SearchTree) else f.clone()
                         for f in state))


def _pointers(state) -> list:
    return [getattr(state, name).data_ptr() for name in STATE_FIELDS]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_the_tail_in_place_equals_the_fresh_tail(dtype, case):
    """The state as its own destination (``out``, as the step hands it
    over): every field of the result is the state's own tensor, holding
    the fresh tail's bits (X the rounds' pose), and no destination
    moved; the same through the wrapper and the plain version."""
    state, X, H, matched, valid, hz, nav, kw = tail_case(case, dtype)
    want = step_scalars.tail_plain(state, X, H, matched, valid, hz, **kw)
    for fn in (step_scalars.tail, step_scalars.tail_plain):
        dst = _scalars(state)
        ptrs = _pointers(dst)
        got = fn(dst, X, H, matched, valid, hz, **kw, out=dst)
        for name, g, w in zip(step_scalars.Tail._fields, got, want):
            assert torch.equal(g, w), name
            if name in STATE_FIELDS:
                assert g is getattr(dst, name), name
        assert torch.equal(dst.X, X) and dst.X.data_ptr() != X.data_ptr()
        assert _pointers(dst) == ptrs


def test_the_tail_in_place_reads_before_it_writes():
    """In place, the trajectory's shift reads the slots it overwrites
    (slot w takes the old slot w + 1) and, where the best frame is the
    scan's own record (``best == head``), the keyframe pose is X and the
    window's head slot too."""
    state, X, H, matched, valid, hz, nav, kw = tail_case("best_is_head", torch.float64)
    old = _scalars(state)
    got = step_scalars.tail(state, X, H, matched, valid, hz, **kw, out=state)
    assert torch.equal(state.traj[:, :-1], old.traj[:, 1:])
    assert torch.equal(state.traj[:, -1], X)
    assert torch.equal(state.traj_count, old.traj_count + 1)
    head, best = got.plan[0, 0], got.plan[0, 1]
    assert head == best and got.promote[0]
    assert torch.equal(state.keyframe_to_map[0], X[0]) and torch.equal(state.fr_pose[0, head],
                                                                      X[0])
    others = torch.arange(state.fr_pose.shape[1]) != old.fr_head[0]
    assert torch.equal(state.fr_pose[0, others], old.fr_pose[0, others])


def test_a_destination_that_is_not_contiguous_raises():
    """A destination the kernel could not write as one block raises, on
    the wrapper and the plain version, before anything is written."""
    state, X, H, matched, valid, hz, nav, kw = tail_case("promote_one", torch.float32)
    for name in ("traj", "X"):
        t = getattr(state, name)
        bent = t.transpose(-1, -2).contiguous().transpose(-1, -2)
        dst = _scalars(state)._replace(**{name: bent})
        before = _scalars(dst)
        for fn in (step_scalars.tail, step_scalars.tail_plain):
            with pytest.raises(ValueError, match="contiguous"):
                fn(state, X, H, matched, valid, hz, **kw, out=dst)
        assert all(torch.equal(getattr(dst, f), getattr(before, f)) for f in STATE_FIELDS)
    with pytest.raises(ValueError):
        step_scalars.tail(state, X, H, matched, valid, hz, **kw,
                          out=_scalars(state)._replace(traj=state.traj[:, 1:].clone()))
    with pytest.raises(TypeError):
        step_scalars.tail(state, X, H, matched, valid, hz, **kw,
                          out=_scalars(state)._replace(seq=state.seq.long()))


def _room_drive(n_scans: int = 6, n_points: int = 1024):
    """A small room drive (no JAX) whose inlier ratios fall on both sides
    of ``p_th`` = 0.7: scans 1 and 2 promote, 3-5 do not."""
    from tests_fixtures_helper import synthetic_room_scans

    from madicp_tpu_torch.models.pipeline import PipelineConfig

    scans, _ = synthetic_room_scans(np.random.default_rng(3), n_scans=n_scans, n_points=600,
                                    step=0.2)
    cfg = PipelineConfig(sensor_hz=HZ, num_keyframes=3, n_points=n_points, depth=7, p_th=0.7,
                         max_icp_iterations=4, dtype=torch.float64)
    batches = []
    for scan in scans:
        pts = torch.zeros((1, n_points, 3), dtype=torch.float64)
        pts[0, :len(scan)] = torch.as_tensor(scan)
        val = torch.zeros((1, n_points), dtype=torch.bool)
        val[0, :len(scan)] = True
        batches.append((pts, val))
    return cfg, batches


def test_step_in_place_equals_odometry_step_and_copies_nothing(monkeypatch):
    """A CPU drive of ``step_in_place`` (the captured body) against the
    functional ``odometry_step`` on a copy, bit for bit, over scans that
    promote and scans that do not. After every step each state field is
    still the buffers' own tensor and ``write_state`` found each field of
    the new state already there (it copied none)."""
    from madicp_tpu_torch.models import step_graph
    from madicp_tpu_torch.models.pipeline import init_state, initialize_step, odometry_step

    cfg, batches = _room_drive()
    state = init_state(cfg, "cpu", batch=1)
    state, _ = initialize_step(cfg, state, *batches[0], None)
    state = type(state)(*(SearchTree(nav=f.nav.clone()) if isinstance(f, SearchTree)
                          else f.clone() for f in state))
    twin = type(state)(*(SearchTree(nav=f.nav.clone()) if isinstance(f, SearchTree)
                         else f.clone() for f in state))
    fields = lambda s: [f.nav if isinstance(f, SearchTree) else f for f in s]  # noqa: E731
    buffers = fields(state)
    ptrs = [t.data_ptr() for t in buffers]
    copied = []
    real = step_graph.write_state

    def spy(dst, src):
        copied.append([name for name, d, s in zip(dst._fields, fields(dst), fields(src))
                       if s is not d])
        real(dst, src)

    monkeypatch.setattr(step_graph, "write_state", spy)
    promoted = []
    for pts, val in batches[1:]:
        out = step_graph.step_in_place(cfg, state, pts, val)
        twin, want = odometry_step(cfg, twin, pts, val, None)
        promoted.append(bool(out.map_updated[0]))
        for name, a, b in zip(state._fields, fields(state), fields(twin)):
            assert torch.equal(a, b), name
        for a, b in zip(out, want):
            assert torch.equal(a, b)
        assert out.pose.data_ptr() != state.X.data_ptr()
        assert all(a is b for a, b in zip(fields(state), buffers))
        assert [t.data_ptr() for t in fields(state)] == ptrs
    assert copied == [[]] * len(batches[1:])
    assert any(promoted) and not all(promoted), promoted


def test_wrong_operands_raise():
    """Wrong dtypes, shapes and devices raise on every device, and the
    kernels' launch functions refuse non-contiguous or misaligned
    operands before they launch."""
    state, X, H, matched, valid, hz, nav, kw = tail_case("promote_one", torch.float32)
    with pytest.raises(TypeError):
        step_scalars.predict(state.X.double(), state.velocity, hz)
    with pytest.raises(ValueError):
        step_scalars.predict(state.X, state.velocity[:, :3], hz)
    with pytest.raises(ValueError):
        step_scalars.predict(state.X.to("meta"), state.velocity, hz)
    with pytest.raises(TypeError):
        step_scalars.tail(state, X, H.double(), matched, valid, hz, **kw)
    with pytest.raises(TypeError):
        step_scalars.tail(state._replace(fr_seq=state.fr_seq.long()), X, H, matched, valid, hz,
                          **kw)
    with pytest.raises(ValueError):
        step_scalars.tail(state, X, H, matched[:, 1:], valid, hz, **kw)
    with pytest.raises(ValueError):
        step_scalars.tail(state, X, H, matched, valid, hz[None], **kw)
    with pytest.raises(ValueError):
        step_scalars.launch_predict(state.X.mT, state.velocity, hz)
    with pytest.raises(ValueError):
        step_scalars.launch_tail(state, X.mT, H, matched, valid, hz, **kw)
    plan = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        ring_write.ring_write(nav, X, plan.long(), state.fr_tree.nav, state.kf_tree.nav)
    with pytest.raises(TypeError):
        ring_write.ring_write(nav.double(), X, plan, state.fr_tree.nav, state.kf_tree.nav)
    with pytest.raises(ValueError):
        ring_write.ring_write(nav[:, :-1], X, plan, state.fr_tree.nav, state.kf_tree.nav)
    with pytest.raises(ValueError):
        ring_write.launch(nav, X, plan, state.fr_tree.nav.transpose(0, 1).contiguous()
                          .transpose(0, 1), state.kf_tree.nav)
    odd = torch.empty(nav.numel() + 1, dtype=nav.dtype)[1:].view(nav.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ring_write.launch(odd, X, plan, state.fr_tree.nav, state.kf_tree.nav)


# ------------------------------------------------------------------ card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _equal(a, b) -> bool:
    return torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                 and torch.equal(a.nan_to_num(), b.nan_to_num()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_k14_and_k13_equal_their_plain_versions_on_cuda(cuda_device, dtype, B, case):
    """predict, tail and the ring write on the card against their plain
    versions on the card, bit for bit, with one count each."""
    state, X, H, matched, valid, hz, nav, kw = tail_case(case, dtype, B=B, seed=B,
                                                         device=cuda_device, L=4099)
    c13, c14 = ring_write.counter.launches, step_scalars.counter.launches
    assert torch.equal(step_scalars.predict(state.X, state.velocity, hz),
                       step_scalars.predict_plain(state.X, state.velocity, hz))
    got = step_scalars.tail(state, X, H, matched, valid, hz, **kw)
    want = step_scalars.tail_plain(state, X, H, matched, valid, hz, **kw)
    for name, g, w in zip(step_scalars.Tail._fields, got, want):
        assert _equal(g, w), name
    fr, kf = state.fr_tree.nav.clone(), state.kf_tree.nav.clone()
    ring_write.ring_write(nav, X, got.plan, state.fr_tree.nav, state.kf_tree.nav)
    ring_write.ring_write_plain(nav, X, want.plan, fr, kf)
    torch.cuda.synchronize()
    assert torch.equal(fr, state.fr_tree.nav) and torch.equal(kf, state.kf_tree.nav)
    assert (ring_write.counter.launches - c13, step_scalars.counter.launches - c14) == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k14_scalars_on_every_branch_on_cuda(cuda_device, dtype):
    """The velocity estimate for window lengths 0-10 with and without the
    clamp, -log det where det H <= 0, a NaN and an all-inf window, each
    through the tail kernel against the plain version bit for bit."""
    rng = np.random.default_rng(7)
    for count in (0, 1, 2, 5, 10):
        for case in ("promote_one", "no_promote"):
            state, X, H, matched, valid, hz, nav, kw = tail_case(case, dtype, B=4, seed=count,
                                                                 device=cuda_device)
            counts = torch.full_like(state.traj_count, max(count - 1, 0))
            Hn = H.clone()
            Hn[1, 0] = -Hn[1, 0]  # det < 0
            Hn[2, 3] = Hn[2, 2]   # singular
            Hn[3, 1, 1] = float("nan")
            weight = state.fr_weight.clone()
            weight[0] = float("inf")  # no finite old weight: the record decides
            s = state._replace(traj_count=counts, fr_weight=weight,
                               velocity=torch.as_tensor(rng.normal(size=(4, 6)) * 3.0,
                                                        dtype=dtype, device=cuda_device))
            got = step_scalars.tail(s, X, Hn, matched, valid, hz, **kw)
            want = step_scalars.tail_plain(s, X, Hn, matched, valid, hz, **kw)
            for name, g, w in zip(step_scalars.Tail._fields, got, want):
                assert _equal(g, w), (count, case, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_replay_of_predict_tail_and_ring_write_equals_the_eager_calls_on_cuda(cuda_device,
                                                                                dtype):
    """A CUDA graph's replay of predict, tail and ring write equals the
    eager calls bit for bit."""
    state, X, H, matched, valid, hz, nav, kw = tail_case("promote_one", dtype, B=4,
                                                         device=cuda_device)

    def call(fr_nav, kf_nav):
        X0 = step_scalars.predict(state.X, state.velocity, hz)
        t = step_scalars.tail(state, X0, H, matched, valid, hz, **kw)
        ring_write.ring_write(nav, X0, t.plan, fr_nav, kf_nav)
        return (X0,) + tuple(t)

    fr_e, kf_e = state.fr_tree.nav.clone(), state.kf_tree.nav.clone()
    eager = call(fr_e, kf_e)
    fr_g, kf_g = state.fr_tree.nav.clone(), state.kf_tree.nav.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(fr_g.clone(), kf_g.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(fr_g, kf_g)
    graph.replay()
    torch.cuda.synchronize()
    assert all(_equal(o, e) for o, e in zip(out, eager))
    assert torch.equal(fr_g, fr_e) and torch.equal(kf_g, kf_e)


def _flags(t: torch.Tensor, layout: str) -> torch.Tensor:
    """``t`` (B, L) bools as the layout asks: as is, or one byte past a
    16-byte boundary (contiguous: the kernel's byte-at-a-time path)."""
    if layout != "unaligned":
        return t
    store = torch.empty(t.numel() + 16, dtype=torch.bool, device=t.device)
    out = store[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("case", ["no_promote", "promote_one", "best_is_head"])
@pytest.mark.parametrize("layout", ["L16", "ragged", "unaligned", "empty"])
def test_k14_tail_fresh_and_in_place_equal_the_plain_version_on_cuda(cuda_device, dtype, B,
                                                                      case, layout):
    """The tail kernel with fresh outputs and in place (the state its own
    destination) against the plain version, bit for bit, at L = 8192
    (every flag in 16-byte words), 4099 (a ragged end and rows off a
    16-byte boundary), with flags one byte off a boundary and L = 0; the
    in-place call keeps its destinations."""
    L = {"L16": 8192, "ragged": 4099, "unaligned": 8192, "empty": 0}[layout]
    state, X, H, matched, valid, hz, nav, kw = tail_case(case, dtype, B=B, seed=B,
                                                         device=cuda_device, L=L)
    matched, valid = _flags(matched, layout), _flags(valid, layout)
    want = step_scalars.tail_plain(state, X, H, matched, valid, hz, **kw)
    got = step_scalars.tail(state, X, H, matched, valid, hz, **kw)
    dst = _scalars(state)
    ptrs = _pointers(dst)
    placed = step_scalars.tail(dst, X, H, matched, valid, hz, **kw, out=dst)
    torch.cuda.synchronize()
    for name, g, p, w in zip(step_scalars.Tail._fields, got, placed, want):
        assert _equal(g, w) and _equal(p, w), name
    assert torch.equal(dst.X, X) and _pointers(dst) == ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_replay_of_the_tail_in_place_equals_the_eager_steps_on_cuda(cuda_device, dtype):
    """Three steps of predict and the in-place tail on one state, eagerly
    and as three replays of one captured step on a copy: the same state
    bit for bit after each, with the destinations where they were."""
    state, X, H, matched, valid, hz, nav, kw = tail_case("promote_one", dtype, B=4,
                                                         device=cuda_device)
    eager, graphed = _scalars(state), _scalars(state)

    def step(s):
        X0 = step_scalars.predict(s.X, s.velocity, hz)
        return step_scalars.tail(s, X0, H, matched, valid, hz, **kw, out=s).plan

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(_scalars(state))
    torch.cuda.current_stream().wait_stream(side)
    ptrs = _pointers(graphed)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        plan = step(graphed)
    for _ in range(3):
        want = step(eager)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(plan, want)
        assert all(torch.equal(getattr(graphed, f), getattr(eager, f)) for f in STATE_FIELDS)
    assert _pointers(graphed) == ptrs
