"""The deskew drives: the flagship configuration (131072 points, depth 16,
16 keyframes, 32768 leaves, 15 rounds, certified, float32) on sweeps of a
sensor that moves through the two-orientation world at a constant body
velocity, at the rate and range of a dataset configuration that deskews
(``mulran``: 10 Hz, 0.7-120 m; ``vbr_os1``: 20 Hz, 1.3-120 m).

A sweep is an Ouster OS1-64's 65,536 points of the world within range
(``utils/fixtures.py`` ``SweepDrive``, each point at the pose of the
moment the sensor sees it), padded to the flagship's 131072 as the CLI
pads them. The sensor drives at 3 m/s with 0.2 rad/s of yaw: 0.3 m and
0.02 rad a scan at 10 Hz (the step of ``chip_smoke.py``'s ``apps`` drive,
inside the association gate), half at 20 Hz. :class:`SweepSetup` primes
the keyframe ring with 16 trees of unskewed scans of the poses before the
drive (a map the sensor built earlier, as the bench primes its ring), so
a deskewed scan meets a map of the true geometry. The reference deskews
from the third scan on (it needs two poses), with the naive velocity of
the last two.
"""

from __future__ import annotations

import numpy as np
import torch

from madicp_tpu_torch.models.pipeline import Pipeline
from madicp_tpu_torch.ops.tree import build_tree, transform_tree
from madicp_tpu_torch.utils.config import DATASET_CONFIGS
from madicp_tpu_torch.utils.fixtures import SweepDrive, two_orientation_world

SPEED_M_S = (3.0, 0.0, 0.0)   # body velocity
YAW_RAD_S = (0.0, 0.0, 0.2)   # body rate
OS1_POINTS = 65536            # an OS1-64 scan: 64 beams x 1024 columns
WORLD_SEED, WORLD_DENSITY = 7, 2  # 81,600 world points


class SweepSetup:
    """A deskew drive of ``dataset``'s rate and range at the flagship
    widths: its sweeps (cached, float32), its truth, and pipelines of the
    configuration with a primed ring."""

    def __init__(self, device, dataset: str = "mulran", n_points: int = 131072,
                 num_keyframes: int = 16, depth: int = 16, max_leaves: int = 32768,
                 rest: int = 0, seed: int = 0, v_lin=SPEED_M_S, omega=YAW_RAD_S):
        self.device = torch.device(device)
        self.dataset, self.cf = dataset, DATASET_CONFIGS[dataset]
        self.n_points, self.num_keyframes = n_points, num_keyframes
        self.depth, self.max_leaves = depth, max_leaves
        world = two_orientation_world(np.random.default_rng(WORLD_SEED + seed), WORLD_DENSITY)
        self.drive = SweepDrive(world, self.cf.sensor_hz, v_lin, omega, OS1_POINTS,
                                self.cf.min_range, self.cf.max_range, rest=rest, seed=seed)
        self._sweeps: dict = {}

    def sweep(self, k: int) -> np.ndarray:
        """Scan ``k`` as the sensor records it, float32 (65,536, 3)."""
        if k not in self._sweeps:
            self._sweeps[k] = self.drive.sweep(k)
        return self._sweeps[k]

    def truth(self, k: int) -> np.ndarray:
        """Scan ``k``'s end pose in the frame of scan 0's end."""
        return self.drive.truth(k)

    def make_pipe(self, deskew: bool | None = None, mode: str = "reference",
                  dtype=torch.float32) -> Pipeline:
        """A certified pipeline (the shipped schedule) of the dataset's
        rate and deskew (``deskew`` None) at the flagship widths."""
        return Pipeline(
            sensor_hz=self.cf.sensor_hz, deskew=self.cf.deskew if deskew is None else deskew,
            deskew_mode=mode, b_max=0.2, rho_ker=0.1, p_th=0.8, b_min=0.1, b_ratio=0.02,
            num_keyframes=self.num_keyframes, n_points=self.n_points, depth=self.depth,
            max_leaves=self.max_leaves, dtype=dtype, device=self.device)

    def prime(self, pipe: Pipeline) -> None:
        """Bootstrap on scan 0, then fill the keyframe ring, in place, with
        trees of unskewed scans of the poses before the drive, each at its
        pose."""
        pipe.compute(0.0, self.sweep(0))
        K, cfg = self.num_keyframes, pipe.cfg
        for k in range(K):
            pts, valid, _ = pipe.stage(self.drive.static_scan(k - K))
            tree, _ = build_tree(pts, valid, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min)
            T = torch.as_tensor(self.truth(k - K), dtype=cfg.dtype, device=pipe.device)
            pipe.state.kf_tree.nav[k].copy_(transform_tree(tree, T[:3, :3], T[:3, 3]).nav)
        pipe.state = pipe.state._replace(
            kf_valid=torch.ones(K, dtype=torch.bool, device=pipe.device))

    def staged(self, pipe: Pipeline, first: int, last: int) -> dict:
        """Scans ``first`` to ``last`` padded and on the device."""
        return {k: pipe.stage(self.sweep(k)) for k in range(first, last + 1)}


def sweep_batch(setup: SweepSetup, first: int, B: int, dtype=torch.float32,
                column: bool = False) -> tuple:
    """The step's deskew inputs for scans ``first`` to ``first + B - 1``
    of ``setup``: ``points (B, n_points, 3)`` (each sweep padded with
    invalid zeros), ``valid (B, n_points)``, the true poses of the scan
    before and of the scan ``T_prev, T_now (B, 4, 4)`` and the sensor
    rate ``hz`` (0-dim), on the device. With ``column`` each sweep comes
    in capture-time order (descending azimuth, as an Ouster sensor
    delivers its columns); else in the world's draw order."""
    dev, N = setup.device, setup.n_points
    pts = np.zeros((B, N, 3))
    valid = np.zeros((B, N), bool)
    for b in range(B):
        s = setup.sweep(first + b).astype(np.float64)
        if column:
            s = s[np.argsort(-np.arctan2(s[:, 1], s[:, 0]), kind="stable")]
        pts[b, :len(s)], valid[b, :len(s)] = s, True
    T = lambda ks: torch.as_tensor(np.stack([setup.truth(k) for k in ks]),  # noqa: E731
                                   dtype=dtype, device=dev)
    scans = range(first, first + B)
    return (torch.as_tensor(pts, dtype=dtype, device=dev), torch.as_tensor(valid, device=dev),
            T([k - 1 for k in scans]), T(scans),
            torch.full((), setup.cf.sensor_hz, dtype=dtype, device=dev))


def truth_error(poses: np.ndarray, truths: np.ndarray) -> dict:
    """Translation error of (S, 4, 4) poses against their truths (m): the
    largest and the mean over the scans, and each scan's."""
    e = np.linalg.norm(poses[:, :3, 3] - truths[:, :3, 3], axis=1)
    return {"max_m": float(e.max()), "mean_m": float(e.mean()), "per_scan_m": e.tolist()}
