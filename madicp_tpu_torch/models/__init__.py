"""User-facing engines mirroring the reference's public API surface."""

from madicp_tpu_torch.models.nn import MADtree  # noqa: F401
from madicp_tpu_torch.models.registration import MADicp  # noqa: F401
from madicp_tpu_torch.models.vel_estimator import VelEstimator  # noqa: F401
from madicp_tpu_torch.ops.velocity import estimate_velocity  # noqa: F401
from madicp_tpu_torch.models.pipeline import Pipeline, PipelineConfig  # noqa: F401
