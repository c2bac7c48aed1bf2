"""Block-sharded sparse TSDF integration and extraction over a device mesh.

Counterpart of ``hive_tpu/parallel/fusion.py``. The block-major voxel state
splits on its block axis into one slab of rows per device. Blocks are
independent (classification, the free-space, edge and band updates read
only their own blocks and the frame), so each device runs the port's
per-frame integrator on its slab, with its own block origins, and no
collective is needed: the result is bit-identical to the unsplit volume.
On the card that is two classification launches and one band update per
slab per frame.

Load balance: ``placement="contiguous"`` keeps x-major slabs, so a surface
in one x-range lands on few devices; ``placement="cyclic"`` (the default)
permutes the rows first, so device d holds blocks d, d+n, d+2n, ... of the
x-major grid and every device sees about 1/n of the band.

Extraction partitions the active cubes over the mesh: the state, un-permuted
to canonical order, is copied once to each device, each device emits its
chunks with the single-device emission, and the host welds the
concatenated streams: byte-identical to ``volume.get_mesh()``.
"""

from __future__ import annotations

import numpy as np

from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume
from hive_tpu_torch.parallel.mesh import DeviceMesh


def shard_sparse_state(volume: SparseTSDFVolume, mesh: DeviceMesh, axis: str = "data",
                       placement: str = "cyclic") -> None:
    """Split ``volume``'s block rows over ``mesh`` (one slab per device).

    :param placement: ``"cyclic"`` (default) round-robins blocks over the
        devices with ``hive_tpu``'s permutation; ``"contiguous"`` keeps
        x-major slabs.
    :raises ValueError: when the block count does not divide over the mesh.
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r}")
    n, nb = mesh.size, volume.num_blocks

    if nb % n != 0:
        raise ValueError(f"num_blocks={nb} must divide over mesh axis '{axis}' of size {n}")

    if placement == "cyclic":
        # Row order [0, n, 2n, ..., 1, 1+n, ...]: slab d holds blocks
        # {d, d+n, d+2n, ...}.
        perm = np.arange(nb).reshape(nb // n, n).T.reshape(-1)
    elif placement == "contiguous":
        perm = None
    else:
        raise ValueError(f"unknown placement {placement!r}")

    volume.place_block_rows(mesh.devices, perm)


def _check_placed(volume: SparseTSDFVolume, mesh: DeviceMesh) -> None:
    if volume.shards is None or tuple(s.device for s in volume.shards) != mesh.devices:
        raise ValueError("the volume's rows are not split over this mesh; call "
                         "shard_sparse_state(volume, mesh) first")


def integrate_frames_sharded(volume: SparseTSDFVolume, mesh: DeviceMesh, colors, depths,
                             camera_matrix, cam_to_world_poses, obs_weights=None):
    """Sharded counterpart of ``SparseTSDFVolume.integrate_frames``.

    Call :func:`shard_sparse_state` once first. The inputs are prepared once
    (the single-device path's one definition) and copied once to each
    device; the compaction cap comes from the global candidate fraction and
    each slab's capacities from its own rows, as ``hive_tpu``'s integrator
    derives them inside ``shard_map``. Each slab's frame is queued on its
    device's current stream.
    """
    _check_placed(volume, mesh)
    return volume.integrate_frames(colors, depths, camera_matrix, cam_to_world_poses,
                                   obs_weights)


def get_mesh_sharded(volume: SparseTSDFVolume, mesh: DeviceMesh, axis: str = "data",
                     chunk_size: int = 1 << 15):
    """Device-parallel isosurface extraction over ``mesh``: the active cubes
    partition over the devices in order, each device emits its part with
    the single-device emission, and the host welds the concatenated
    streams. Byte-identical to ``volume.get_mesh()``.

    Cubes per device per round: a power of two, at least 512, at most
    ``chunk_size`` (``hive_tpu``'s sizing). The state is copied to each
    device: emission gathers each cube's 8 corners from neighbouring block
    rows, so a split state would need halo exchanges.

    :return: (vertices, faces, normals, colors), as ``get_mesh``.
    """
    from hive_tpu_torch.ops.marching import extract_isosurface_blocked

    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r}")
    state = volume.state
    verts, faces, colors, normals = extract_isosurface_blocked(
        state.tsdf, state.weight, state.color, grid_blocks=volume.grid_blocks,
        block_size=volume.block_size, origin=volume.origin, voxel_size=volume.voxel_size,
        chunk_size=chunk_size, devices=mesh.devices)
    return verts, faces, normals, colors
