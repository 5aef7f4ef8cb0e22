"""The GN update and the certified slack pass of the PyTorch port: K10
(``kernels/gn_update.py``, ``gn_se3_step``'s body) and K11
(``kernels/certify_slack.py``, a certified later round's motion bound,
slack, ``need`` and descent count).

On the CPU: ``gn_update_plain`` against the JAX package's ``gn_se3_step``
at 1e-9 in float64, one sequence and a batch of four (real normal
equations, an empty H, a singular one whose solve is not finite, steps beyond each trust
bound, both branches of ``exp_so3``); ``certify_slack_plain`` against the
GEMM form of the motion bound and ``eps_cert`` that ``icp_rounds`` used
before it (within a few ulps), and its ``need`` and count against
``uncert & live_kl`` as the rounds formed them; both wrappers' CPU dispatch
and argument checks. Tests marked ``cuda`` hold each kernel to its plain
version on the card (K10 within 5e-6 relative in float32 and 1e-12 in
float64; K11's slack, ``need`` and count bit for bit) and a CUDA graph's
replay to the eager call bit for bit, and skip without one. JAX is
imported by the CPU tests only, so a machine with a card needs none."""

import numpy as np
import pytest
import torch

from madicp_tpu_torch.kernels import certify_slack, gn_update
from madicp_tpu_torch.probes.gn_cases import (
    BATCHES,
    GN_CASES,
    gemm_slack_pass,
    gn_batch,
    gn_case,
    plain_by_sequence,
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
        y = torch.linalg.solve_ex(A, rhs)[0]
        assert not torch.isfinite(y[:3]).any() and torch.isfinite(y[3:]).all()
        assert not dx[:3].any() and dx[3:].all()
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
    """K10 against the plain version of each sequence on its own
    (``gn_cases.plain_by_sequence``: the plain batched LU on the card zeroes
    a singular system's whole step), and against the plain version on the
    CPU, which holds the JAX reference."""
    X, H, b = _gn_on(name, dtype, cuda_device)
    before = gn_update.counter.launches
    got = gn_update.gn_update(X, H, b)
    torch.cuda.synchronize()
    assert gn_update.counter.launches == before + 1
    assert _gn_rel(got, plain_by_sequence(X, H, b)) <= GN_TOL[dtype]
    cpu = gn_update.gn_update_plain(*(t.cpu() for t in (X, H, b)))
    assert _gn_rel(got.cpu(), cpu) <= GN_TOL[dtype]
    if name == "empty":
        assert torch.equal(got, X)  # no step: X times the identity, exactly


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
def test_certify_slack_kernel_is_bitwise_the_plain_version_on_cuda(cuda_device, dtype, B):
    s = slack_inputs(dtype, B=B, K=5, L=3000)
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
