"""Standalone MAD-tree nearest-neighbour tool.

API parity with the reference's ``pymadtree`` binding
(``src/pybind/tools/mad_tree_wrapper.h:34-71``): ``build`` (default
``b_max=1e-5`` giving per-point leaves), ``search`` for a single query,
``search_cloud`` and ``search_cloud_dist`` for batches, each one batched
descent on the device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from madicp_tpu_torch.models.registration import _padded
from madicp_tpu_torch.ops.tree import SearchTree, build_tree, search_tree
from madicp_tpu_torch.utils.device import resolve_device


class MADtree:
    """Host-facing MAD-tree: build once, batched approximate-NN queries,
    on ``device`` (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self._tree: Optional[SearchTree] = None
        self._dtype = dtype

    def build(
        self,
        cloud: np.ndarray,
        b_max: float = 1e-5,
        b_min: float = 0.1,
        max_parallel_level: int = 2,  # accepted for API parity; unused
        depth: Optional[int] = None,
    ) -> None:
        del max_parallel_level
        pts, valid, n_pad = _padded(cloud, self._dtype, self.device)
        if depth is None:
            # per-point leaves need ~log2(N) levels; PCA bisection is
            # near-balanced, leave headroom for uneven splits
            depth = int(math.ceil(math.log2(max(n_pad, 2)))) + 4
        self._tree, _ = build_tree(pts, valid, depth=depth, b_max=b_max, b_min=b_min)

    def _require_tree(self) -> SearchTree:
        if self._tree is None:
            raise RuntimeError("call build() first")
        return self._tree

    def search(self, query: np.ndarray):
        """Single query -> (matched point, matched normal)."""
        pts, normals = self.search_cloud(np.asarray(query)[None, :])
        return pts[0], normals[0]

    def search_cloud(self, queries: np.ndarray):
        """(Q,3) queries -> ((Q,3) matched points, (Q,3) matched normals)."""
        tree = self._require_tree()
        q = torch.as_tensor(np.asarray(queries), dtype=self._dtype, device=self.device)
        leaf = search_tree(tree, q)
        return (
            tree.repr.index_select(0, leaf).cpu().numpy(),
            tree.normal.index_select(0, leaf).cpu().numpy(),
        )

    def search_cloud_dist(self, queries: np.ndarray):
        """Like ``search_cloud`` plus the match distances."""
        pts, normals = self.search_cloud(queries)
        d = np.linalg.norm(pts - np.asarray(queries), axis=1)
        return pts, normals, d

    # reference-style aliases
    searchCloud = search_cloud
    searchCloudDist = search_cloud_dist
