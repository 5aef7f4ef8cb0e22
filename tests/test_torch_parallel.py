"""The port's parallel layer against the JAX package on the CPU, float64,
at the JAX fleet tests' size (tests/test_parallel.py: 2048 points, depth
11, 4 keyframes): the batched ``Fleet`` against the JAX ``Fleet`` and
against one port ``Pipeline`` per sequence (every schedule), a JAX fleet
state carried across, the state's keyframe split, and the errors of
``Fleet`` and ``fleet_eval``. Multi-process runs are in
tests/test_torch_distributed.py."""

import dataclasses

import numpy as np
import pytest
import torch

from madicp_tpu_torch.apps import fleet_eval
from madicp_tpu_torch.models.pipeline import Pipeline, PipelineConfig, init_state
from madicp_tpu_torch.parallel import Fleet, state_shardings
from madicp_tpu_torch.parallel.mesh import make_global, make_mesh
from madicp_tpu_torch.utils.convert import kf_shard, kf_unshard, state_from_numpy
from tests_fixtures_helper import synthetic_room_scans
from torch_shared import shared_arrays

torch.set_num_threads(2)

N, DEPTH, K, B = 2048, 11, 4, 3
# steps of 0.02, 0.15 and 0.3 m a scan put the inlier ratios of scan 1
# on both sides of P_TH: one sequence promotes where the others do not
STEPS, P_TH, N_SCANS = (0.02, 0.15, 0.3), 0.85, 4
CFG = PipelineConfig(sensor_hz=10.0, num_keyframes=K, n_points=N, depth=DEPTH,
                     p_th=P_TH, dtype=torch.float64)
PIPE_KW = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=P_TH,
               b_min=0.1, b_ratio=0.02, num_keyframes=K, n_points=N, depth=DEPTH,
               dtype=torch.float64, device="cpu")
SCHEDULES = {
    "exact": dict(certify=False),
    "certified": dict(),
    "compact": dict(certify_compact=64),
    "prefix": dict(certify_prefix=64),
    "fast": dict(assoc_mode="fast", reassoc_every=2, reassoc_backup=6),
}


@pytest.fixture(scope="module")
def batches():
    """(points (B, N, 3), valid (B, N)) of each scan index: sequence b
    walks ``STEPS[b]`` a scan through its own room."""
    rng = np.random.default_rng(0)
    seqs = [synthetic_room_scans(rng, n_scans=N_SCANS, n_points=1200, step=s)[0]
            for s in STEPS]
    out = []
    for i in range(N_SCANS):
        pts, val = np.zeros((B, N, 3)), np.zeros((B, N), bool)
        for b in range(B):
            pts[b, :len(seqs[b][i])] = seqs[b][i]
            val[b, :len(seqs[b][i])] = True
        out.append((pts, val))
    return out


@pytest.fixture(scope="module")
def jax_drive(batches, request):
    """The JAX Fleet (no mesh) over every scan: per scan its poses and
    promotions, and its state after scan 1 as numpy; computed once for
    every pytest-xdist worker (``torch_shared``)."""

    def compute():
        poses, promoted, state1 = _jax_drive(batches)
        return dict(poses=poses, promoted=promoted,
                    **{f"state1_{name}": v for name, v in state1.items()})

    got = shared_arrays(request, "test_torch_parallel_jax_drive", compute)
    return (got["poses"], got["promoted"],
            {name[7:]: v for name, v in got.items() if name.startswith("state1_")})


def _jax_drive(batches):
    """:func:`jax_drive`'s numbers, computed here."""
    import jax
    import jax.numpy as jnp

    from madicp_tpu.models.pipeline import PipelineConfig as JaxConfig
    from madicp_tpu.parallel import Fleet as JaxFleet

    fleet = JaxFleet(JaxConfig(sensor_hz=10.0, num_keyframes=K, n_points=N, depth=DEPTH,
                               p_th=P_TH, dtype=jnp.float64), B)
    poses, promoted, state1 = [], [], None
    for i, (pts, val) in enumerate(batches):
        out = fleet.compute(np.full(B, 0.1 * i), pts, val)
        poses.append(fleet.poses())
        promoted.append(np.asarray(out.map_updated))
        if i == 1:
            state1 = {name: np.asarray(getattr(fleet.states, name).nav
                                       if name.endswith("_tree")
                                       else getattr(fleet.states, name))
                      for name in fleet.states._fields}
    jax.clear_caches()
    return np.stack(poses), np.stack(promoted), state1


def test_fleet_matches_jax_fleet(batches, jax_drive):
    """Every sequence, every scan, at 1e-9; a scan where promotion
    differs across sequences (masked on the device) is among them."""
    want, want_promoted, _ = jax_drive
    fleet = Fleet(CFG, B, device="cpu")
    promoted = []
    for i, (pts, val) in enumerate(batches[:3]):
        out = fleet.compute(np.full(B, 0.1 * i), pts, val)
        promoted.append(out.map_updated.numpy())
        np.testing.assert_allclose(fleet.poses(), want[i], atol=1e-9)
        assert out.pose.shape == (B, 4, 4) and out.leaves_pts.shape[0] == B
    promoted = np.stack(promoted)
    np.testing.assert_array_equal(promoted, want_promoted[:3])
    assert any(len(set(p)) > 1 for p in promoted), promoted


def test_jax_fleet_state_continues_in_the_port(batches, jax_drive):
    """The JAX fleet's state after scan 1, read as numpy, becomes the
    port fleet's state; both then drive the remaining scans and agree at
    1e-9."""
    want, _, state1 = jax_drive
    fleet = Fleet(CFG, B, device="cpu")
    fleet.states = state_from_numpy(CFG, state1, "cpu")
    fleet._initialized = True
    assert fleet.states.kf_tree.nav.shape == (B, K, CFG.arena, 56)
    for i in range(2, N_SCANS):
        pts, val = batches[i]
        fleet.compute(np.full(B, 0.1 * i), pts, val)
        np.testing.assert_allclose(fleet.poses(), want[i], atol=1e-9)
    with pytest.raises(ValueError, match="leading"):
        state_from_numpy(CFG, dict(state1, seq=state1["seq"][:2]), "cpu")


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_fleet_matches_one_pipeline_per_sequence(batches, schedule):
    """The batched step equals B port Pipelines stepped one by one (the
    single Pipeline promotes through its host read) at 1e-9, with the
    same promotions and descent counts."""
    kw = SCHEDULES[schedule]
    fleet = Fleet(dataclasses.replace(CFG, **kw), B, device="cpu")
    pipes = [Pipeline(**PIPE_KW, **kw) for _ in range(B)]
    for i, (pts, val) in enumerate(batches):
        out = fleet.compute(np.full(B, 0.1 * i), pts, val)
        for b, pipe in enumerate(pipes):
            pipe.compute(0.1 * i, pts[b, val[b]])
        np.testing.assert_allclose(
            fleet.poses(), np.stack([p.current_pose() for p in pipes]), atol=1e-9)
        assert out.map_updated.tolist() == [p.is_map_updated() for p in pipes]
        assert out.n_descents.tolist() == [p.descents() for p in pipes]
        np.testing.assert_allclose(out.inlier_ratio.numpy(),
                                   [p.inlier_ratio() for p in pipes], atol=1e-12)


@pytest.mark.parametrize("batch", [None, 2])
def test_kf_shard_and_its_inverse(batch):
    """Splitting a state's keyframe ring into shards and joining them
    gives the state back; only ``kf_tree`` and ``kf_valid`` split, as
    ``state_shardings`` says."""
    cfg = dataclasses.replace(CFG, depth=4)
    g = torch.Generator().manual_seed(3)
    state = init_state(cfg, "cpu", batch=batch)
    state = state._replace(
        kf_tree=type(state.kf_tree)(torch.rand(state.kf_tree.nav.shape, generator=g,
                                               dtype=torch.float64)),
        kf_valid=torch.rand(state.kf_valid.shape, generator=g) > 0.5)
    shards = [kf_shard(state, i, 2) for i in range(2)]
    assert shards[1].kf_tree.nav.shape[-3] == K // 2
    back = kf_unshard(shards)
    for a, b in zip(back, state):
        a, b = (a.nav, b.nav) if hasattr(a, "nav") else (a, b)
        assert torch.equal(a, b)
    specs = state_shardings(batched=batch is not None)
    split = [n for n, s in zip(specs._fields, specs)
             if "kf" in (s.nav if hasattr(s, "nav") else s)]
    assert split == ["kf_tree", "kf_valid"]
    with pytest.raises(ValueError, match="split"):
        kf_shard(state, 0, 3)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_step_and_round_on_a_one_rank_world(batches):
    """The keyframe-sharded step (make_sharded_pipeline_step) and the
    standalone sharded round on a one-rank gloo world: the all-reduce
    hook runs for real; the step tracks the port Pipeline at 1e-9 and
    the round equals the local sums."""
    from madicp_tpu_torch.ops.icp_core import associate_ring, terms_from_payload
    from madicp_tpu_torch.ops.tree import build_tree, get_leaves
    from madicp_tpu_torch.parallel import (
        distributed, fleet_mesh, icp_round_sharded, make_sharded_pipeline_step, topology)
    from madicp_tpu_torch.parallel.sharded_icp import counter

    topo = distributed.initialize(f"localhost:{_free_port()}", 1, 0, backend="gloo",
                                  device="cpu")
    try:
        assert topo["backend"] == "gloo" and topo == topology()
        distributed.barrier("one rank")
        assert fleet_mesh(1).mesh_dim_names == ("seq", "kf")
        mesh = make_mesh(kf=1, seq=1)
        step, place_state, place_inputs = make_sharded_pipeline_step(CFG, mesh,
                                                                     device="cpu")
        state = place_state(init_state(CFG, "cpu"))
        pipe = Pipeline(**PIPE_KW)
        before = counter.all_reduces
        for i, (pts, val) in enumerate(batches):
            state, out = step(state, *place_inputs(pts[1], val[1], 0.1 * i))
            pipe.compute(0.1 * i, pts[1, val[1]])
            np.testing.assert_allclose(out.pose.numpy(), pipe.current_pose(), atol=1e-9)
            assert bool(out.map_updated) == pipe.is_map_updated()
        assert counter.all_reduces - before == (N_SCANS - 1) * (15 + 2)

        pts, val = (torch.as_tensor(a[0]) for a in batches[0])
        tree, _ = build_tree(pts, val, depth=DEPTH, b_max=0.2, b_min=0.1)
        leaves = get_leaves(tree, 256)
        ring = type(tree)(torch.stack([tree.nav] * K))
        kf_valid = torch.tensor([True, True, False, True])
        X = torch.eye(4, dtype=torch.float64)
        H, b, matched = icp_round_sharded(mesh, ring, kf_valid, leaves.pts, leaves.valid,
                                          X, b_max=0.2, b_ratio=0.02, rho_ker=0.1)
        _, payload = associate_ring(ring.nav, DEPTH, leaves.pts, leaves.valid.expand(K, 256),
                                    X=X)
        t = terms_from_payload(payload, leaves.pts, leaves.valid, X,
                               b_max=0.2, b_ratio=0.02, rho_ker=0.1)
        w = kf_valid.double()
        torch.testing.assert_close(H, torch.einsum("k,kij->ij", w, t.H), rtol=1e-12, atol=0)
        torch.testing.assert_close(b, torch.einsum("k,ki->i", w, t.b), rtol=1e-12, atol=0)
        assert torch.equal(matched, (t.matched & kf_valid[:, None]).any(0))
    finally:
        distributed.shutdown()


class _GridMesh:
    """A (seq, kf) grid coordinate, as a DeviceMesh reports it."""

    mesh_dim_names = ("seq", "kf")

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


def test_make_global_keeps_this_ranks_block():
    x = np.arange(4 * 6).reshape(4, 6)
    mesh = _GridMesh((2, 3), (1, 2))
    np.testing.assert_array_equal(make_global(x, ("seq", "kf"), mesh), x[2:4, 4:6])
    np.testing.assert_array_equal(make_global(x, (None, "kf"), mesh), x[:, 4:6])
    with pytest.raises(ValueError, match="split"):
        make_global(np.zeros((5, 6)), ("seq",), mesh)


def test_fleet_and_fleet_eval_refuse_what_they_cannot_run(tmp_path):
    """The JAX package's errors, and no mesh without a world."""
    with pytest.raises(ValueError, match="kf"):
        Fleet(CFG, 2, shard_points=True, device="cpu")  # no mesh

    class NoSeq:
        mesh_dim_names = ("kf",)

    with pytest.raises(ValueError, match="seq"):
        Fleet(CFG, 2, mesh=NoSeq(), device="cpu")
    with pytest.raises(ValueError, match="torch.distributed"):
        make_mesh(kf=2, seq=1)
    data = tmp_path / "seq"
    data.mkdir()
    base = ["--data-paths", str(data), "--estimate-path", str(tmp_path / "out"),
            "--dataset-config", "kitti", "--device", "cpu"]
    with pytest.raises(ValueError, match="nproc-per-node 2"):
        fleet_eval.main(base + ["--seq-axis", "2"])
    with pytest.raises(ValueError, match="nproc-per-node 4"):
        fleet_eval.main(base + ["--seq-axis", "1", "--kf-axis", "4"])
    assert fleet_eval.main(base + ["--kf-axis", "2"]) == -1
    assert fleet_eval.main(base + ["--seq-axis", "2", "--shard-points"]) == -1
    assert fleet_eval.main(base[:1] + [str(tmp_path / "missing")] + base[2:]) == -1
