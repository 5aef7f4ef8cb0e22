"""Pairwise MAD-ICP registration.

API parity with the reference's ``pymadicp`` binding
(``src/pybind/tools/mad_icp_wrapper.h:33-112``): build a reference tree
and a query tree, then run a fixed number of full re-association
Gauss-Newton rounds from an initial guess.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from madicp_tpu_torch.ops.icp_core import gn_se3_step, icp_terms
from madicp_tpu_torch.ops.tree import Leaves, SearchTree, build_tree, get_leaves
from madicp_tpu_torch.utils.device import resolve_device


def _pad_pow2(n: int, minimum: int = 64) -> int:
    return max(minimum, 2 ** int(math.ceil(math.log2(max(n, 1)))))


def _padded(cloud, dtype, device):
    """Pad a cloud to a power of two; returns (points, valid, n_pad)."""
    cloud = np.asarray(cloud)
    n = cloud.shape[0]
    n_pad = _pad_pow2(n)
    pts = np.zeros((n_pad, 3))
    pts[:n] = cloud
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    return (
        torch.as_tensor(pts, dtype=dtype, device=device),
        torch.as_tensor(valid, device=device),
        n_pad,
    )


class MADicp:
    """Pairwise registration of a query cloud onto a reference cloud, on
    ``device`` (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, num_threads: int = 0, dtype=torch.float32, depth: int = 16,
                 device=None):
        del num_threads  # API parity with the reference binding
        self.device = resolve_device(device)
        self._dtype = dtype
        self._depth = depth
        self._ref_tree: Optional[SearchTree] = None
        self._leaves: Optional[Leaves] = None
        self._ref_b_max = 0.2
        self.last_matched: Optional[np.ndarray] = None

    def _build(self, cloud, b_max, b_min):
        pts, valid, n_pad = _padded(cloud, self._dtype, self.device)
        tree, _ = build_tree(pts, valid, depth=self._depth, b_max=b_max, b_min=b_min)
        return tree, n_pad

    def set_reference_cloud(self, cloud, b_max: float = 0.2, b_min: float = 0.1):
        """Build the fixed tree (reference ``mad_icp_wrapper.h:47-52``)."""
        self._ref_b_max = float(b_max)
        self._ref_tree, _ = self._build(cloud, b_max, b_min)

    def set_query_cloud(self, cloud, b_max: float = 0.2, b_min: float = 0.1):
        """Build the moving tree and extract its leaves
        (reference ``mad_icp_wrapper.h:40-45``)."""
        tree, n_pad = self._build(cloud, b_max, b_min)
        self._leaves = get_leaves(tree, max_leaves=n_pad)

    def compute(
        self,
        T_guess: np.ndarray,
        icp_iterations: int = 15,
        rho_ker: float = 0.1,
        b_ratio: float = 0.02,
        print_stats: bool = False,
    ) -> np.ndarray:
        """Run ICP from ``T_guess``; returns the 4x4 estimate
        (reference ``mad_icp_wrapper.h:54-102``)."""
        if self._ref_tree is None or self._leaves is None:
            raise RuntimeError("set_reference_cloud and set_query_cloud first")
        leaves = self._leaves
        X = torch.as_tensor(np.asarray(T_guess), dtype=self._dtype, device=self.device)
        matched = torch.zeros_like(leaves.valid)
        for _ in range(int(icp_iterations)):
            t = icp_terms(
                self._ref_tree, leaves.pts, leaves.valid, X,
                b_max=self._ref_b_max, b_ratio=b_ratio, rho_ker=rho_ker,
            )
            X = gn_se3_step(X, t.H, t.b)
            matched = t.matched
        matched = (matched & leaves.valid).cpu().numpy()
        self.last_matched = matched
        if print_stats:
            n_leaves = int(leaves.valid.sum())
            n_matched = int(matched.sum())
            print(f"MADicp|inliers ratio {n_matched / max(n_leaves, 1)}")
            print(f"--MADicp|matched leaves {n_matched}")
            print(f"--MADicp|total num leaves {n_leaves}")
        return X.cpu().numpy()

    # reference-style aliases
    setReferenceCloud = set_reference_cloud
    setQueryCloud = set_query_cloud
