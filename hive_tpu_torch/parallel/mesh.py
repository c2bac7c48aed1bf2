"""Device meshes and the helpers that split tensors over them.

Counterpart of ``hive_tpu/parallel/mesh.py``. A :class:`DeviceMesh` is a
1-D tuple of torch devices under the one axis name ``"data"``: frame
batches, block rows and correspondences split over it in equal chunks,
chunk k on ``devices[k]``. Where ``hive_tpu`` places one sharded array,
the port keeps a list of per-device tensors.

Two differences by design. ``get_device_mesh`` never falls back to CPU
devices when fewer CUDA devices exist than asked for (``hive_tpu`` falls
back to its virtual CPU devices, which here would hide the card); it
raises instead. And a mesh may name one device more than once (an explicit
``devices=`` list), which splits work k ways on one card: the tests and
``chip_smoke.py`` hold such a split to the unsplit path.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class DeviceMesh(NamedTuple):
    """A 1-D mesh: ``devices[k]`` holds chunk k of whatever splits over it."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


def get_device_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
                    devices: Optional[Sequence] = None, device=None) -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (default: all).

    :param devices: the mesh's devices themselves, in order; one may repeat
        (a k-way split on one card). ``n_devices``, if given, must match.
    :param device: ``"cpu"`` builds ``n_devices`` CPU shards (default 1),
        the counterpart of the virtual CPU devices ``hive_tpu``'s tests use.
    :raises ValueError: for a count that is not positive, more than one
        axis name, or more CUDA devices than the machine has. There is no
        fallback to CPU devices.
    """
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} devices were given")
        n_devices = len(devices)
    elif device is not None and torch.device(device).type == "cpu":
        n_devices = 1 if n_devices is None else n_devices
        devices = (torch.device("cpu"),) * max(n_devices, 0)
    else:
        available = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n_devices = available if n_devices is None else n_devices
        if n_devices > available:
            raise ValueError(f"Requested {n_devices} CUDA devices but only {available} are "
                             f"available; there is no fallback to CPU devices.")
        devices = tuple(torch.device("cuda", i) for i in range(max(n_devices, 0)))

    if n_devices <= 0:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    for d in devices:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"{d} is not among the {torch.cuda.device_count()} CUDA devices")
    if len(tuple(axis_names)) != 1:
        raise ValueError("get_device_mesh builds 1-D meshes; got axis_names="
                         f"{tuple(axis_names)}.")
    return DeviceMesh(devices, tuple(axis_names))


def shard_batch(mesh: DeviceMesh, tensor, axis: int = 0) -> List[torch.Tensor]:
    """``tensor`` (numpy or torch) split along ``axis`` into ``mesh.size``
    equal chunks, chunk k on ``mesh.devices[k]``.

    :raises ValueError: when the axis does not divide over the mesh.
    """
    tensor = torch.as_tensor(tensor)
    size = tensor.shape[axis]
    if size % mesh.size:
        raise ValueError(f"axis {axis} of size {size} does not divide over "
                         f"{mesh.size} devices; pad first (pad_to_multiple)")
    return [chunk.to(d) for chunk, d in zip(torch.chunk(tensor, mesh.size, dim=axis),
                                            mesh.devices)]


def shard_volume(mesh: DeviceMesh, volume, axis: int = 0) -> List[torch.Tensor]:
    """Split a voxel array over its X axis (``axis=1`` for channel planes
    (3, X, Y, Z))."""
    return shard_batch(mesh, volume, axis=axis)


def replicate(mesh: DeviceMesh, tensor) -> List[torch.Tensor]:
    """``tensor`` on each device of the mesh (the same tensor where it
    already lies there)."""
    tensor = torch.as_tensor(tensor)
    return [tensor.to(d) for d in mesh.devices]


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Zero-pad ``axis`` up to a multiple (so it divides evenly over devices)."""
    size = array.shape[axis]
    padded = -size % multiple

    if padded == 0:
        return array

    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, padded)
    return np.pad(array, pad_width)
