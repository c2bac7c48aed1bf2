"""hive_tpu_torch — the PyTorch/CUDA port of hive_tpu for one NVIDIA H100.

The JAX package ``hive_tpu`` is the reference; each module here carries the
name of its counterparts there. Device code is plain PyTorch, except the
hand-written CUDA kernels under ``csrc/``, at least one for each Pallas
kernel of the repository: the integrator's refine query and band update,
and the band sampler, tile gather, patch gather and fused band trip of the
measurement entry points under ``micro/``.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"``; there is no silent CPU fallback. ``parallel`` splits the
sparse volume's block rows, DPT batches and pose correspondences over a
mesh of CUDA devices (``--num_devices``; ``get_device_mesh``,
``shard_batch``, ``shard_volume``, ``replicate``, ``shard_sparse_state``,
``integrate_frames_sharded``, ``get_mesh_sharded``).

The research entry points live under ``scripts``: ``scripts.experiments``
(the gt / cm / est experiment matrix and its LaTeX tables),
``scripts.compare_image_pair`` and ``scripts.compare_image_pairs`` (SSIM,
PSNR, LPIPS and MIFD of image pairs and folders); ``dataset`` is the CMU
Panoptic (Kinoptic) loader.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__version__ = "0.1.0"

# fp32 parity with hive_tpu, which pins its fp32 matmuls to HIGHEST precision
# (hive_tpu/core/transforms.py:33): the integrator's ``origins @ R.T`` decides
# by its rounding which pixel each voxel samples, so TF32 must stay off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def get_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless the caller asks
    for the CPU (``device="cpu"``) or names a CUDA device itself.

    :raises RuntimeError: when CUDA is not available and the CPU was not
        asked for.
    """
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu":
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("hive_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU.")
    return device if device is not None else torch.device("cuda", 0)


def on_device(device: torch.device):
    """A context that makes ``device`` current when it is a CUDA device (a
    kernel launched through the runtime API runs on the current device)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
