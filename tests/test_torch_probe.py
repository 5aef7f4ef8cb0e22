"""The scatter probe's kernels in the port against the JAX probe's
(``scripts/pallas_scatter_probe.py``, loaded from its file and left as
it is), on the CPU at N = 4096: the Pallas kernels run in TPU interpret
mode, the port's wrappers take their plain versions. Also the port's
probe entry point on the CPU."""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from madicp_tpu_torch.kernels import scatter_probe as sp
from madicp_tpu_torch.probes import scatter_probe as probe

REPO = Path(__file__).resolve().parents[1]
N = 4096
Q, MQ = probe.Q, probe.MQ


@pytest.fixture
def jax_probe(monkeypatch):
    """The JAX probe as a module, with its global N cut to 4096 (its
    ``make_*`` read N when called)."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # it prepends "."
    spec = importlib.util.spec_from_file_location(
        "pallas_scatter_probe", REPO / "scripts" / "pallas_scatter_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "N", N)
    return mod


def _ids(rng, m: int, n: int) -> np.ndarray:
    """(1, n) ids in [0, m), with ids m + 7, m and -1 that drop."""
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[rng.random(n) < 0.05] = m
    idx[:3] = [-1, m + 7, -1]
    return idx[None, :]


@pytest.mark.parametrize("mode", ["f32", "highest", "bf16x3"])
@pytest.mark.parametrize("m", [64, 4096])
def test_onehot_segsum_matches_pallas_interpret(jax_probe, mode, m):
    """onehot_segsum (plain version on the CPU) against
    make_onehot_segsum in interpret mode: atol 1e-4 (f32 sum order)."""
    rng = np.random.default_rng(m)
    idx2d = _ids(rng, m, N)
    vals_t = rng.normal(0, 1, (16, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_probe.make_onehot_segsum(m, mode=mode)(
            jnp.asarray(idx2d), jnp.asarray(vals_t)))
    got = sp.onehot_segsum(torch.from_numpy(idx2d), torch.from_numpy(vals_t), m, mode)
    assert got.shape == (16, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("m", [64, 256, 4096])
def test_fused_moments_matches_pallas_interpret(jax_probe, m):
    """fused_moments (plain version) against make_fused_moments in
    interpret mode, all 16 columns: atol 1e-4 (f32 sum order)."""
    rng = np.random.default_rng(m + 1)
    idx2d = _ids(rng, m, N)
    d = rng.normal(0, 1, (N, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_probe.make_fused_moments(m)(jnp.asarray(idx2d), jnp.asarray(d)))
    got = sp.fused_moments(torch.from_numpy(idx2d), torch.from_numpy(d), m)
    assert got.shape == (m, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


_F32 = np.finfo(np.float32)
SPLIT_FAMILIES = {  # float32 values -> bf16x3_parts
    "signed_zeros": [0.0, -0.0],
    "subnormals": [1e-45, -1e-45, 1.1754942e-38, -3e-39, 5.9e-39, 2.0**-140,
                   -1.37 * 2.0**-130, 1.9 * 2.0**-120, -1.777 * 2.0**-115, 2.0**-126],
    "near_float32_max": [_F32.max, -_F32.max, np.nextafter(_F32.max, np.float32(0)),
                         3.0e38, -2.9e38, 1.7e38],
    "negatives": -(10.0 ** np.random.default_rng(1).uniform(-30, 30, 512)),
    "seeded_normal": np.random.default_rng(0).normal(0, 1, 4096),
}


@pytest.mark.parametrize("family", list(SPLIT_FAMILIES))
def test_bf16x3_split_is_exact(family):
    """The split behind the bf16x3 mode: hi + mid + lo == v bit for bit
    (-0 comes back +0, the value any sum from zero takes), so the mode's
    three float32-accumulated products with the one-hot are the float32
    segment sum of v, and the port runs that scatter. Each part keeps only
    the high 16 bits of a float32 (a bf16 value) wherever v's residues are
    normal floats, |v| >= 2^-110; below, hi and mid still do and lo is the
    exact rest."""
    v = torch.from_numpy(np.asarray(SPLIT_FAMILIES[family], dtype=np.float32))
    hi, mid, lo = sp.bf16x3_parts(v)

    def bits(x):
        return x.view(torch.int32)

    assert torch.equal(bits(hi + mid + lo), bits(v + 0.0))
    assert torch.equal(bits(lo + mid + hi), bits(v + 0.0))
    assert not (bits(hi) & 0xFFFF).any() and not (bits(mid) & 0xFFFF).any()
    assert not (bits(lo)[v.abs() >= 2.0**-110] & 0xFFFF).any()


def _rows_case():
    """The shapes of the probe's sections B and C, with ids >= Mq that
    drop (negative ids are left out: JAX's ``.at[]`` wraps them)."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, MQ + 8, Q).astype(np.int32)
    vals = rng.normal(0, 1, (Q, 16)).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("name", ["rmw_segsum", "scatter_segsum"])
def test_rows_segsum_matches_xla_scatter_add(name):
    """rmw_kernel and scat_kernel are closures inside the JAX probe's
    main() and cannot be called alone, so the plain versions are held to
    the function both compute, ``zeros((Mq, 16)).at[idx].add(vals,
    mode="drop")`` by XLA on the CPU: atol 1e-5 (f32 sum order)."""
    idx, vals = _rows_case()
    want = np.asarray(jnp.zeros((MQ, 16), jnp.float32).at[jnp.asarray(idx)].add(
        jnp.asarray(vals), mode="drop"))
    got = getattr(sp, name)(torch.from_numpy(idx[None, :]), torch.from_numpy(vals), MQ)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_rmw_segsum_plain_is_bitwise_float32_add_at():
    """In row order in float32: bit for bit np.add.at."""
    idx, vals = _rows_case()
    idx[:4] = -5  # negative ids drop as well
    want = np.zeros((MQ, 16), np.float32)
    keep = (idx >= 0) & (idx < MQ)
    np.add.at(want, idx[keep], vals[keep])
    got = sp.rmw_segsum(torch.from_numpy(idx), torch.from_numpy(vals), MQ).numpy()
    assert np.array_equal(got, want)


def test_probe_draws_the_jax_probes_inputs():
    """Same default_rng(0) draws in the same order as the JAX probe's
    main() (pallas_scatter_probe.py:235-246, :296-302, :384-385)."""
    n, sizes = 1024, (64, 256)
    rng = np.random.default_rng(0)

    def draw(m):
        idx = rng.integers(0, m, n).astype(np.int32)
        idx[rng.random(n) < 0.05] = m
        return idx[None, :]

    vals = rng.normal(0, 1, (n, 16)).astype(np.float32)
    ids_a = [draw(m) for m in sizes]
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    ids_a2 = [draw(m) for m in sizes]
    idx_q = rng.integers(0, MQ, Q).astype(np.int32)[None, :]
    vals_q = rng.normal(0, 1, (Q, 16)).astype(np.float32)

    cases = probe.cases("cpu", n, sizes)
    a = [c for c in cases if c.section == "A" and c.mode == "f32"]
    a2 = [c for c in cases if c.section == "A2"]
    (b,) = [c for c in cases if c.section == "B"]
    for case, ids in zip(a, ids_a):
        np.testing.assert_array_equal(case.call.args[0].numpy(), ids)
        np.testing.assert_array_equal(case.call.args[1].numpy(), vals.T)
    for case, ids in zip(a2, ids_a2):
        np.testing.assert_array_equal(case.call.args[0].numpy(), ids)
        np.testing.assert_array_equal(case.call.args[1].numpy(), d)
    np.testing.assert_array_equal(b.call.args[0].numpy(), idx_q)
    np.testing.assert_array_equal(b.call.args[1].numpy(), vals_q)


def test_probe_entry_point_on_cpu(capsys):
    """--device cpu: every case checked through the plain versions, one
    parseable JSON line each, and no times."""
    rc = probe.main(["--device", "cpu", "--n", "2048", "--sizes", "64,256"])
    assert rc == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    want = [("A", "onehot_segsum", mode, m) for m in (64, 256) for mode in sp.MODES]
    want += [("A2", "fused_moments", None, m) for m in (64, 256)]
    want += [("B", "rmw_segsum", None, MQ), ("C", "scatter_segsum", None, MQ)]
    assert [(r["section"], r["kernel"], r["mode"], r["M"]) for r in recs] == want
    assert all(r["ok"] and r["card"] == "cpu" and "ms" not in r for r in recs)
    assert all(r["max_abs_err"] <= probe.TOL and r["bound_ms"] > 0 for r in recs)
    # the bound is the function's (bytes at these shapes), the same in
    # every mode: no record counts a dense one-hot design's flops
    assert all(r["bound_by"] == "bytes" for r in recs)
    assert not any(k.startswith("design") for r in recs for k in r)
    by_m = {(r["mode"], r["M"]): r["bound_ms"] for r in recs if r["section"] == "A"}
    assert all(by_m[("bf16x3", m)] == by_m[("f32", m)] for m in (64, 256))


def test_probe_entry_point_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main([])
