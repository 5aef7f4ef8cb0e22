"""madicp_tpu_torch — MAD-ICP LiDAR odometry in PyTorch for NVIDIA Hopper.

A port of :mod:`madicp_tpu` (JAX/TPU) that keeps its static-shape design
and its public layouts — heap-arena MAD-trees as ``(M, 56)`` ``nav``
rows, ``(K, L, 8)`` association payloads, the keyframe and frame rings
of ``PipelineState`` — so the two packages can be held against each
other on the same inputs. The JAX package stays the reference; this one
never imports it.

Layout
------
- :mod:`madicp_tpu_torch.ops`      batched tensor math (lie algebra, 3x3
                                   eigh, MAD-tree build/search, ICP core,
                                   deskew, the velocity estimate)
- :mod:`madicp_tpu_torch.kernels`  hand-written CUDA kernels for Hopper
                                   (``csrc/*.cu``), their ctypes wrappers
                                   and their plain PyTorch versions
- :mod:`madicp_tpu_torch.models`   user-facing engines (MADtree, MADicp,
                                   VelEstimator, Pipeline)
- :mod:`madicp_tpu_torch.utils`    configs, KITTI reader, trajectory IO,
                                   state conversion, device selection
- :mod:`madicp_tpu_torch.apps`     CLI entry point

Entry points (``Pipeline``, ``MADicp``, ``MADtree``, the CLI) run on the
CUDA device unless the caller passes ``device="cpu"``; with no CUDA
device they raise instead of silently running on the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Every matmul in this package is geometry (point and tree transforms,
# pose compositions, normal equations), so float32 must stay float32.
# On Hopper, TF32 keeps ~10 mantissa bits: the twin of the TPU's one-pass
# bf16 matmul that put up to 0.24 m of error into a point transform at
# 40 m range in the JAX package (madicp_tpu/__init__.py). Pinned here
# for cuBLAS and cuDNN alike; models.pipeline warns if a caller lowers
# them again after import.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from madicp_tpu_torch.ops import constants  # noqa: E402,F401
