"""Batched tensor math of the odometry path."""

from madicp_tpu_torch.ops import constants  # noqa: F401
from madicp_tpu_torch.ops.lie import (  # noqa: F401
    skew,
    exp_so3,
    log_so3,
    euler_xyz,
    se3_matrix,
    se3_inverse,
    se3_apply,
)
from madicp_tpu_torch.ops.eigh3 import eigh3  # noqa: F401
from madicp_tpu_torch.ops.tree import (  # noqa: F401
    SearchTree,
    build_tree,
    search_tree,
    search_forest,
    search_payload,
    get_leaves,
    transform_tree,
    tree_arena_size,
)
from madicp_tpu_torch.ops.icp_core import (  # noqa: F401
    icp_terms,
    icp_terms_packed,
    icp_normal_equations,
    gn_se3_step,
    solve_gn,
)
from madicp_tpu_torch.ops.deskew import deskew_cloud  # noqa: F401
