"""The process-wide device mesh behind ``--num_devices``.

Counterpart of ``hive_tpu/parallel/runtime.py``. :func:`configure` runs
once at pipeline start from ``PipelineOptions.num_devices``; the stages
that split pick the mesh up with :func:`runtime_mesh`:

* sparse TSDF integration splits its block rows over the mesh and
  extraction its active cubes (:mod:`hive_tpu_torch.parallel.fusion`);
* DPT depth inference splits frame batches
  (:class:`hive_tpu_torch.models.dpt.DPTDepthEstimator`);
* pose optimisation splits correspondences
  (:func:`hive_tpu_torch.pose_optimisation.optimise_packed_features`).

No stage needs a collective but the pose loss, whose per-shard partial
sums meet on the mesh's first device.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from hive_tpu_torch.parallel.mesh import DeviceMesh, get_device_mesh

_mesh: Optional[DeviceMesh] = None


def configure(num_devices: int = 1, device=None) -> Optional[DeviceMesh]:
    """Set the process-wide mesh from the ``--num_devices`` flag.

    :param num_devices: ``1`` (default) or ``0``: no mesh, every stage runs
        on one device. ``-1``: all CUDA devices. ``n > 1``: the first n
        CUDA devices, refused when the machine has fewer.
    :param device: the pipeline's device; with ``"cpu"`` the mesh is
        ``num_devices`` CPU shards (``-1``: one, so no mesh).
    :return: the mesh, or ``None`` for single-device execution (also when
        the mesh would hold one device).
    """
    global _mesh

    if num_devices in (0, 1):
        _mesh = None
        return None

    count = None if num_devices == -1 else num_devices
    cpu = device is not None and torch.device(device).type == "cpu"
    mesh = get_device_mesh(count, device="cpu" if cpu else None)

    if mesh.size < 2:
        _mesh = None
        return None

    logging.info(f"Multi-device runtime: {mesh.size} devices ({mesh.devices[0].type}).")
    _mesh = mesh
    return mesh


def runtime_mesh() -> Optional[DeviceMesh]:
    """The active device mesh, or ``None`` when running single-device."""
    return _mesh


def set_runtime_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Install (or clear, with ``None``) the runtime mesh directly."""
    global _mesh
    _mesh = mesh
