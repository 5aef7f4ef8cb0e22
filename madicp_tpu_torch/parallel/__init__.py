"""Process-mesh parallelism.

The reference's only parallel axis is one OpenMP thread per keyframe
with per-thread H/b adders reduced serially (``pipeline.cpp:180-185``,
``mad_icp.cpp:100-110``), and nothing for multiple sequences. Here both
are axes of a ``(seq, kf)`` mesh of ``torch.distributed`` ranks, one
device each:

- ``kf``: a sequence's keyframe ring is split across ranks; each rank
  descends its own keyframe trees and the partial 6x6 ``H`` / 6-vector
  ``b`` are all-reduced once a GN round (NCCL where every rank has a
  card, gloo otherwise; see :mod:`.distributed`).
- ``seq``: fleet mode — sequences advance data-parallel, one state per
  sequence, stacked on a batch axis that the ranks split.
"""

from madicp_tpu_torch.parallel.mesh import make_mesh, state_shardings  # noqa: F401
from madicp_tpu_torch.parallel.sharded_icp import (  # noqa: F401
    icp_round_sharded,
    make_sharded_pipeline_step,
)
from madicp_tpu_torch.parallel.fleet import Fleet  # noqa: F401
from madicp_tpu_torch.parallel.distributed import (  # noqa: F401
    fleet_mesh,
    initialize,
    topology,
)
