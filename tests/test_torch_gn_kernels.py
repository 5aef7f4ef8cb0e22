"""The GN update and the certified slack pass of the PyTorch port: K10
(``kernels/gn_update.py``, ``gn_se3_step``'s body and a round's keyframe
sum) and K11 (``kernels/certify_slack.py``, a certified later round's
motion bound, slack, ``need`` and descent count).

On the CPU: ``gn_update_plain`` against the JAX package's ``gn_se3_step``
at 1e-9 in float64, one sequence and batches of four (real normal
equations, an empty H, a singular one whose solve is not finite, steps
beyond each trust bound, both branches of ``exp_so3``, an infinite
diagonal entry), and in its per-keyframe form against the JAX rounds'
einsum and ``gn_se3_step``; its batched LU against the same LU written
one scalar at a time; ``certify_slack_plain`` against the GEMM form
of the motion bound and ``eps_cert`` that ``icp_rounds`` used before it
(within a few ulps), and its ``need`` and count against ``uncert &
live_kl`` as the rounds formed them; both wrappers' CPU dispatch and
argument checks. Tests marked ``cuda`` hold each kernel to its plain
version on the card (K10 within 5e-6 relative in float32 and 1e-12 in
float64; K11's slack, ``need`` and count bit for bit) and a CUDA graph's
replay to the eager calls bit for bit (K7 -> K10 -> K11 among them), and
skip without one. JAX is imported by the CPU tests only, so a machine
with a card needs none."""

import numpy as np
import pytest
import torch

from madicp_tpu_torch.kernels import certify_slack, gn_update, icp_terms
from madicp_tpu_torch.probes.gn_cases import (
    BATCHES,
    GN_CASES,
    TERMS_KW,
    gemm_slack_pass,
    gn_batch,
    gn_case,
    keyframe_terms,
    round_inputs,
    scaled_system,
    slack_inputs,
)


@pytest.fixture(scope="module")
def jax_icp():
    """The JAX package's ICP-core module, on the CPU with x64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import madicp_tpu.ops.icp_core as jax_icp

    return jax_icp


@pytest.mark.parametrize("name", list(BATCHES))
def test_gn_update_plain_matches_jax(jax_icp, name):
    """gn_update_plain against the JAX package's gn_se3_step at 1e-9
    (float64), one sequence per case and two batches of four."""
    import jax.numpy as jnp

    X, H, b = gn_batch(BATCHES[name])
    got = gn_update.gn_update_plain(*(torch.from_numpy(a) for a in (X, H, b))).numpy()
    want = np.stack([np.asarray(jax_icp.gn_se3_step(jnp.asarray(x), jnp.asarray(h),
                                                    jnp.asarray(v)))
                     for x, h, v in zip(X, H, b)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", GN_CASES)
def test_gn_update_cases_do_what_they_name(case):
    """Each case exercises its branch: no step where H is empty or the
    solve is not finite, a clamped step at the trust bound, the small-angle
    branch below theta^2 = 1e-8 and the regular branch above it."""
    X, H, b = (torch.from_numpy(a) for a in gn_case(case))
    dx = gn_update.clamp_step(gn_update.solve_gn(H, b))
    out = gn_update.gn_update_plain(X, H, b)
    if case == "empty":
        assert not dx.any() and torch.equal(out, X @ torch.eye(4, dtype=torch.float64))
        return
    if case == "singular":  # the scaled solve is not finite where it zeroes
        A, rhs = scaled_system(H, b)
        assert float(A[2, 2]) == 0.0
        y = gn_update.lu_solve(A, rhs)
        assert not torch.isfinite(y[:3]).any() and torch.isfinite(y[3:]).all()
        assert not dx[:3].any() and dx[3:].all()
    if case.startswith("inf_"):  # row and column i zero but for a NaN pivot
        i = int(case[4:])
        A, _ = scaled_system(H, b)
        assert torch.isnan(A[i, i]) and not A[i].nan_to_num().any()
        assert not A[:, i].nan_to_num().any()
        assert not dx[:i + 1].any() and dx[i + 1:].all()
    theta_sq = float((dx[3:] ** 2).sum())
    if case == "clamp_t":
        assert float(dx[:3].norm()) == pytest.approx(gn_update.GN_STEP_MAX_T)
    elif case == "clamp_r":
        assert float(dx[3:].norm()) == pytest.approx(gn_update.GN_STEP_MAX_R)
    elif case == "small_angle":
        assert 0 < theta_sq < 1e-8
    if case != "small_angle":
        assert theta_sq >= 1e-8
    assert torch.isfinite(out).all() and not torch.equal(out, X)


def scalar_lu_solve(A: np.ndarray, r: np.ndarray) -> np.ndarray:
    """The LU rule of ``gn_update.lu_solve`` one scalar at a time (numpy,
    A's type): LAPACK's first largest pivot (a NaN only where it comes
    first), multipliers by the pivot's reciprocal, no elimination where
    the pivot is zero or the column below it is, the substitution by the
    pivots' reciprocals."""
    A, r, n = A.copy(), r.copy(), A.shape[0]
    one, inv = A.dtype.type(1), []
    for k in range(n):
        p = k
        for j in range(k + 1, n):
            if abs(A[j, k]) > abs(A[p, k]):
                p = j
        A[[k, p]], r[[k, p]] = A[[p, k]], r[[p, k]]
        inv.append(one / A[k, k])
        if A[k, k] == 0 or not A[k + 1:, k].any():
            continue
        for i in range(k + 1, n):
            m = A[i, k] * inv[k]
            A[i, k + 1:] = A[i, k + 1:] - m * A[k, k + 1:]
            r[i] = r[i] - m * r[k]
    y = np.empty_like(r)
    for k in reversed(range(n)):
        y[k] = r[k] * inv[k]
        r[:k] = r[:k] - A[:k, k] * y[k]
    return y


LU_KINDS = ("random", "spd", "nan_pivot", "zero_pivot", "ties", "nan_below")


def lu_systems(kind: str, n: int = 24, seed: int = 0) -> tuple:
    """``n`` seeded 6x6 systems of ``kind``: a NaN pivot in a column and
    row zero elsewhere (an infinite ``H_ii``), a zero column (a zero
    pivot), integer entries (ties), a NaN below the diagonal."""
    rng = np.random.default_rng(seed + LU_KINDS.index(kind))
    A, r = rng.standard_normal((n, 6, 6)), rng.standard_normal((n, 6))
    for i, a in enumerate(A):
        c = i % 6
        if kind == "spd":
            A[i] = a @ a.T
        elif kind == "nan_pivot":
            a[c, :] = a[:, c] = 0
            a[c, c] = np.nan
        elif kind == "zero_pivot":
            a[:, c] = 0
        elif kind == "ties":
            A[i] = np.round(2 * a)
        elif kind == "nan_below":
            a[(c + 1 + i % 5) % 6, c] = np.nan
    return A, r


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", LU_KINDS)
def test_lu_solve_is_the_scalar_lu(kind, dtype):
    """The batched LU of the plain solve equals the scalar LU bit for bit
    (NaN where it is NaN) on every kind of system, singular ones too."""
    A, r = (a.astype(dtype) for a in lu_systems(kind))
    got = gn_update.lu_solve(torch.from_numpy(A), torch.from_numpy(r)).numpy()
    with np.errstate(all="ignore"):
        want = np.stack([scalar_lu_solve(a, v) for a, v in zip(A, r)])
    np.testing.assert_array_equal(got, want)
    if kind in ("random", "spd", "ties"):
        assert np.isfinite(got).any()


@pytest.mark.parametrize("K", [1, 4])
def test_gn_update_plain_folds_the_keyframe_sum_as_jax(jax_icp, K):
    """The per-keyframe form against the JAX rounds' keyframe sum
    (``madicp_tpu/models/pipeline.py:432-433``'s einsum, an empty ring slot
    weighted 0) and ``gn_se3_step``, float64 at 1e-9: the update and the
    sums it returns."""
    import jax.numpy as jnp

    X, H, b, w = keyframe_terms(2, K, seed=K)
    got, got_H, got_b = gn_update.gn_update_plain(*(torch.from_numpy(a) for a in (X, H, b, w)))
    for i in range(2):
        want_H = jnp.einsum("k,kij->ij", jnp.asarray(w[i]), jnp.asarray(H[i]))
        want_b = jnp.einsum("k,ki->i", jnp.asarray(w[i]), jnp.asarray(b[i]))
        want = jax_icp.gn_se3_step(jnp.asarray(X[i]), want_H, want_b)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=1e-9)
        np.testing.assert_allclose(got_H[i].numpy(), np.asarray(want_H), rtol=1e-12, atol=0)
        np.testing.assert_allclose(got_b[i].numpy(), np.asarray(want_b), rtol=1e-12, atol=1e-12)
    assert torch.equal(gn_update.gn_update(*(torch.from_numpy(a) for a in (X, H, b, w)))[0], got)


def test_gn_update_rejects_weights_that_do_not_match():
    """``w`` must be (..., K) with H's and b's K, on their device and type."""
    X, H, b, w = (torch.from_numpy(a) for a in keyframe_terms(2, 4))
    for bad in (w[:, :3], w[:, :, None], w.float(), w.to("meta")):
        with pytest.raises((ValueError, TypeError)):
            gn_update.gn_update(X, H, b, bad)
    with pytest.raises(ValueError):
        gn_update.gn_update(X, H[:, :3], b, w)
    with pytest.raises(ValueError):
        gn_update.gn_update(X, H[..., 0, :, :], b[..., 0, :], w)  # summed terms with w


def test_gn_se3_step_dispatches_to_the_plain_version_on_cpu(monkeypatch):
    """On CPU tensors gn_se3_step (and the wrapper) run the plain chain and
    never count a launch; a batch of four broadcasts one X and equals four
    single calls."""
    from madicp_tpu_torch.ops import icp_core

    X, H, b = (torch.from_numpy(a) for a in gn_batch(BATCHES["b4_mixed"]))
    before = gn_update.counter.launches
    assert torch.equal(icp_core.gn_se3_step(X, H, b), gn_update.gn_update_plain(X, H, b))
    single = torch.stack([gn_update.gn_update(X[0], H[i], b[i]) for i in range(4)])
    torch.testing.assert_close(gn_update.gn_update(X[0], H, b), single, rtol=0, atol=1e-12)
    assert gn_update.counter.launches == before
    calls = []
    monkeypatch.setattr(gn_update, "gn_update_plain",
                        lambda *a: calls.append(a) or torch.zeros(4, 4, dtype=torch.float64))
    icp_core.gn_se3_step(X[0], H[0], b[0])
    assert len(calls) == 1


def test_gn_update_rejects_bad_arguments():
    X, H, b = (torch.from_numpy(a) for a in gn_case("real"))
    with pytest.raises(TypeError):
        gn_update.gn_update(X.float(), H, b)
    with pytest.raises(ValueError):
        gn_update.gn_update(X, H[:5, :5], b)
    with pytest.raises(ValueError):
        gn_update.gn_update(X[None].expand(3, 4, 4), H[None].expand(2, 6, 6), b)
    with pytest.raises(ValueError):
        gn_update.gn_update(X, H.to("meta"), b)


# ------------------------------------------------------------ slack pass --
def bound_ulps(s: dict, bound: torch.Tensor) -> torch.Tensor:
    """8 ulps of the motion bound's scale (B, L): the bound plus the
    leaf's norm times the largest entry of the pose difference."""
    scale = s["pts"].norm(dim=-1) * (s["X"] - s["Xp"])[:, :3].abs().amax((1, 2))[:, None]
    return 8 * torch.finfo(bound.dtype).eps * (scale + bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_motion_bound_and_eps_cert_are_the_gemm_form_within_ulps(dtype):
    """The explicit order of both versions is the GEMM form's value
    within a few ulps of the bound's scale (the norm of its inputs); the
    floor is the GEMM form's up to one rounding of its sum."""
    s = slack_inputs(dtype)
    bound, eps, *_ = gemm_slack_pass(**s)
    got = certify_slack.motion_bound(s["pts"], s["Xp"], s["X"])
    assert bool(((got - bound).abs() <= bound_ulps(s, bound)).all())
    ulp = torch.finfo(dtype).eps
    assert bool(((certify_slack.eps_cert(s["X"], s["r_norm"]) - eps).abs() <= 2 * ulp * eps).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 2])
def test_certify_slack_plain_is_the_rounds_uncert_and_count(dtype, B):
    """need and its count equal ``uncert & live_kl`` and the count the
    rounds formed; the slack is decremented and the count added in place;
    the dead keyframe and invalid leaves never re-descend."""
    s = slack_inputs(dtype, B=B)
    bound, _, slack_want, need_want, count_want = gemm_slack_pass(**s)
    slack, nd = s["slack"], s["n_descents"]
    need = certify_slack.certify_slack_plain(**s)
    assert slack is s["slack"] and nd is s["n_descents"]
    assert bool(((slack - slack_want).abs() <= bound_ulps(s, bound)[:, None]).all())
    assert torch.equal(need, need_want)
    assert torch.equal(nd, count_want)
    assert 0 < int(need.sum()) < need.numel() // 2
    if B == 2:
        assert not need[0, -1].any()
    assert not (need & ~s["leaves_valid"][:, None, :]).any()


def test_certify_slack_dispatches_to_the_plain_version_on_cpu(monkeypatch):
    """On CPU tensors the wrapper runs the plain version (same results, no
    launch counted)."""
    a, b = slack_inputs(torch.float32), slack_inputs(torch.float32)
    before = certify_slack.counter.launches
    assert torch.equal(certify_slack.certify_slack(**a), certify_slack.certify_slack_plain(**b))
    assert torch.equal(a["slack"], b["slack"]) and torch.equal(a["n_descents"], b["n_descents"])
    assert certify_slack.counter.launches == before
    calls = []
    monkeypatch.setattr(certify_slack, "certify_slack_plain", lambda *a: calls.append(a))
    certify_slack.certify_slack(**a)
    assert len(calls) == 1


def test_certify_slack_rejects_bad_arguments():
    s = slack_inputs(torch.float32)
    with pytest.raises(TypeError):
        certify_slack.certify_slack(**dict(s, X=s["X"].double()))
    with pytest.raises(TypeError):
        certify_slack.certify_slack(**dict(s, n_descents=s["n_descents"].int()))
    with pytest.raises(ValueError):
        certify_slack.certify_slack(**dict(s, kf_live=s["kf_live"][:, :2]))
    with pytest.raises(ValueError):
        certify_slack.certify_slack(**dict(s, pts=s["pts"].to("meta")))


# ------------------------------------------------------------------ card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


GN_TOL = {torch.float32: 5e-6, torch.float64: 1e-12}


def _gn_on(name, dtype, device):
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in gn_batch(BATCHES[name]))


def _gn_rel(got, want) -> float:
    """Largest relative Frobenius distance of the poses."""
    d = (got.double() - want.double()).square().sum((-2, -1)).sqrt()
    return float((d / want.double().square().sum((-2, -1)).sqrt()).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(BATCHES))
def test_gn_update_kernel_matches_the_plain_version_on_cuda(cuda_device, dtype, name):
    """K10 against the plain version on the card (the whole batch: its
    explicit LU follows the kernel's rules) and on the CPU, which holds
    the JAX reference."""
    X, H, b = _gn_on(name, dtype, cuda_device)
    before = gn_update.counter.launches
    got = gn_update.gn_update(X, H, b)
    torch.cuda.synchronize()
    assert gn_update.counter.launches == before + 1
    assert _gn_rel(got, gn_update.gn_update_plain(X, H, b)) <= GN_TOL[dtype]
    cpu = gn_update.gn_update_plain(*(t.cpu() for t in (X, H, b)))
    assert _gn_rel(got.cpu(), cpu) <= GN_TOL[dtype]
    if name == "empty":
        assert torch.equal(got, X)  # no step: X times the identity, exactly


def _sum_bound(terms, w, dtype):
    """Two orders of a K-term sum differ by at most 2 K eps times the sum
    of the terms' magnitudes (entry by entry)."""
    lead = w.shape + (1,) * (terms.dim() - w.dim())
    return 2 * w.shape[-1] * torch.finfo(dtype).eps * (w.abs().view(lead) * terms.abs()).sum(1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 4, 16, 17])
def test_gn_update_kernel_folds_the_keyframe_sum_on_cuda(cuda_device, dtype, K):
    """K10 on per-keyframe terms (K up to past one load batch of 16)
    against the plain version: the update within the tolerance, the sums
    it returns within the two orders' bound; broadcast X and strided
    terms give the same bits."""
    X, H, b, w = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
                  for a in keyframe_terms(3, K, seed=K))
    got, got_H, got_b = gn_update.gn_update(X, H, b, w)
    want, want_H, want_b = gn_update.gn_update_plain(X, H, b, w)
    assert _gn_rel(got, want) <= GN_TOL[dtype]
    assert bool(((got_H - want_H).abs() <= _sum_bound(H, w, dtype)).all())
    assert bool(((got_b - want_b).abs() <= _sum_bound(b, w, dtype)).all())
    Ht = H.mT.contiguous().mT
    assert all(torch.equal(g, o) for g, o in zip(gn_update.gn_update(X, Ht, b, w),
                                                 (got, got_H, got_b)))
    one = gn_update.gn_update(X[0], H, b, w)[0]  # X broadcast over the batch
    assert _gn_rel(one, gn_update.gn_update_plain(X[0], H, b, w)[0]) <= GN_TOL[dtype]


@pytest.mark.cuda
def test_gn_update_kernel_takes_broadcast_and_strided_operands_on_cuda(cuda_device):
    X, H, b = _gn_on("b4_mixed", torch.float64, cuda_device)
    want = gn_update.gn_update_plain(X[0], H, b)
    got = gn_update.gn_update(X[0], H, b)  # X broadcast over the batch
    assert got.shape == (4, 4, 4) and _gn_rel(got, want) <= 1e-12
    Ht = H.mT.contiguous().mT  # column-major H
    assert torch.equal(gn_update.gn_update(X, Ht, b), gn_update.gn_update(X, H, b))
    single = gn_update.gn_update(X[1], H[1], b[1])  # one sequence, no batch axis
    assert single.shape == (4, 4) and torch.equal(single, gn_update.gn_update(X, H, b)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("K, L", [(5, 3000), (5, 4095), (16, 4096), (3, 257)])
def test_certify_slack_kernel_is_bitwise_the_plain_version_on_cuda(cuda_device, dtype, B, K,
                                                                   L):
    """Bit for bit, on tiles and keyframe groups with ragged edges (an L
    that is no multiple of the tile or of the vector width, a K that is
    no multiple of the keyframe group)."""
    s = slack_inputs(dtype, B=B, K=K, L=L)
    a = {k: v.to(cuda_device) for k, v in s.items()}
    p = {k: v.clone() for k, v in a.items()}
    before = certify_slack.counter.launches
    need = certify_slack.certify_slack(**a)
    torch.cuda.synchronize()
    assert certify_slack.counter.launches == before + 1
    want = certify_slack.certify_slack_plain(**p)
    assert torch.equal(need, want)
    assert torch.equal(a["slack"], p["slack"])
    assert torch.equal(a["n_descents"], p["n_descents"])


@pytest.mark.cuda
def test_gn_kernels_replay_in_a_cuda_graph(cuda_device):
    """A replay of both kernels equals the eager calls bit for bit."""
    X, H, b = _gn_on("b4_mixed", torch.float32, cuda_device)
    s = {k: v.to(cuda_device) for k, v in slack_inputs(torch.float32, K=5, L=3000).items()}
    init = {k: v.clone() for k, v in s.items()}
    eager_X = gn_update.gn_update(X, H, b)
    eager_need = certify_slack.certify_slack(**s)
    eager = {k: v.clone() for k, v in s.items()}
    for k, v in init.items():
        s[k].copy_(v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        gn_update.gn_update(X, H, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_X = gn_update.gn_update(X, H, b)
        out_need = certify_slack.certify_slack(**s)
    for k, v in init.items():
        s[k].copy_(v)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out_X, eager_X) and torch.equal(out_need, eager_need)
    for k in ("slack", "n_descents"):
        assert torch.equal(s[k], eager[k])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_round_kernels_replay_in_a_cuda_graph(cuda_device, dtype):
    """K7 -> K10 (the per-keyframe form) -> K11, launched back to back as a
    certified round launches them: a CUDA graph's replay equals the eager
    calls bit for bit, and K10 and K11 equal their plain versions."""
    r = {k: v.to(cuda_device) for k, v in round_inputs(dtype, K=16, L=4096).items()}
    init = {k: r[k].clone() for k in ("slack", "n_descents")}

    def one_round():
        H, b, _ = icp_terms.terms(r["payload"], r["pts"][:, None], r["leaves_valid"][:, None],
                                  r["Xp"][:, None], **TERMS_KW)
        X, Hs, bs = gn_update.gn_update(r["Xp"], H, b, r["w"])
        need = certify_slack.certify_slack(r["slack"], r["Xp"], X, r["pts"], r["r_norm"],
                                           r["leaves_valid"], r["kf_live"], r["n_descents"])
        return H, b, X, Hs, bs, need

    def reset():
        for k, v in init.items():
            r[k].copy_(v)

    eager = one_round()
    eager_state = {k: r[k].clone() for k in init}
    want = gn_update.gn_update_plain(r["Xp"], eager[0], eager[1], r["w"])
    assert _gn_rel(eager[2], want[0]) <= GN_TOL[dtype]
    reset()
    p = {k: v.clone() for k, v in r.items()}
    want_need = certify_slack.certify_slack_plain(p["slack"], p["Xp"], eager[2], p["pts"],
                                                  p["r_norm"], p["leaves_valid"], p["kf_live"],
                                                  p["n_descents"])
    assert torch.equal(eager[5], want_need) and torch.equal(p["slack"], eager_state["slack"])
    reset()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        one_round()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = one_round()
    for _ in range(2):
        reset()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(out, eager))
        for k in init:
            assert torch.equal(r[k], eager_state[k])
