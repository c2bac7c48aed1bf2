"""Sparse (banded) TSDF fusion: per-block classification + compacted updates.

Counterpart of ``hive_tpu/ops/tsdf_sparse.py``; the per-voxel arithmetic is
the JAX package's, operation for operation, so the two hold the same state.

For every frame each fixed-size voxel block is classified with conservative
bounds — the block's 8 corners projected into the camera against a
min/max/validity mip pyramid of the depth image — and the band blocks are
re-queried with 5x5 cells two pyramid levels finer (the refine pass):

* **skip** — outside the view, no valid depth in the footprint, or entirely
  behind the surface band: no update;
* **free space** — in front of every surface of a fully-valid, fully-in-image
  footprint: dist = 1, weight += w, no gather. All frames' free weights of
  one ``integrate_frames`` call are summed and applied once at its end
  (weighted means are order-independent);
* **free edge** — provably free but only partly inside the image: the same
  update behind a per-voxel visibility mask (projection only, no gather);
* **band** — everything else: per voxel, project, sample the packed frame
  word, update. On the card one kernel launch updates a frame's whole band
  in place; on the CPU the plain version runs in trips of ``chunk`` slab
  rows, which bounds its temporaries.

Two stages run as hand-written CUDA kernels on the card: the frame's block
classification, one launch for pass 1 and one for the refine pass
(:mod:`hive_tpu_torch.ops.classify_blocks`; their compaction caps apply by
rank on the device, so no host sync sizes them), and the band update
(:mod:`hive_tpu_torch.ops.band_update`). On CPU tensors their wrappers take
the plain PyTorch versions.

Layout (as in the JAX package): block-major state, tsdf/weight ``(nb, BV)``
and colour ``(nb, 3*BV)`` with per-block R|G|B segments; the in-block voxel
order is z-major (``i = iz*Bx*By + ix*By + iy``), so a block's z-slabs are
contiguous column ranges and the slab view ``(nb*SUB, BVS)`` is a free
reshape.

Packed 32-bit words (pyramid cells, packed frame pixels) are carried as
int32 bit patterns: torch has no unsigned 32-bit shifts or reductions on
every device. Every field is masked after its shift.

The TPU package's A/B knobs (``HIVE_TSDF_*``, ``HIVE_PALLAS_*``), profiling
stubs and sampler window routing do not carry over: their defaults are the
constants here, and on the card one kernel serves every band block.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hive_tpu_torch import get_device, on_device
from hive_tpu_torch.ops.band_update import (band_scalars, band_update, camera_coords,
                                            project)
from hive_tpu_torch.ops.classify_blocks import (Geometry, classify_pass1, classify_refine,
                                               classify_scalars)
from hive_tpu_torch.ops.tsdf import world_to_camera


class SparseTSDFState(NamedTuple):
    tsdf: torch.Tensor    # (nb, BV) where BV = Bx * By * Bz
    weight: torch.Tensor  # (nb, BV)
    color: torch.Tensor   # (nb, 3*BV): per-block R|G|B channel segments


class BlockRows(NamedTuple):
    """One slab of a volume's block rows on one device: its state rows and
    the world origins (rows, 3) f32 of the blocks they hold."""
    device: torch.device
    state: SparseTSDFState
    origins: torch.Tensor


# Pass-1 classification compaction capacities, as fractions of the block
# count: per frame batch the host-side frustum estimate picks the smallest
# level that fits the batch's candidate fraction plus a sampling margin.
COMPACT_LEVELS = (0.375, 0.5, 0.625, 0.75)
COMPACT_MARGIN = 0.02


def pick_compact_cap(candidate_fraction: float):
    """Smallest compaction level covering ``candidate_fraction`` + margin,
    or None (query every block) when no level fits."""
    for level in COMPACT_LEVELS:
        if candidate_fraction + COMPACT_MARGIN <= level:
            return level
    return None


def prepare_integration_inputs(colors, depths, camera_matrix, cam_to_world_poses,
                               obs_weights, device):
    """The frame stack as the integrator takes it, on ``device``: (depths
    (N, H, W) f32, colors (N, H, W, 3), world_to_cams (N, 4, 4) f32, intr (4,)
    f32, obs_weights (N,) f32). The one definition for the single-device
    and the block-sharded paths, whose bit-equality depends on it."""
    depths = torch.as_tensor(depths, device=device).to(torch.float32)
    colors = torch.as_tensor(colors, device=device)[..., :3]
    K = np.asarray(camera_matrix, dtype=np.float32)
    intr = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dtype=torch.float32,
                        device=device)
    world_to_cams = torch.as_tensor(world_to_camera(cam_to_world_poses), device=device)
    if obs_weights is None:
        obs_weights = np.ones((depths.shape[0],), np.float32)
    obs_weights = torch.as_tensor(np.asarray(obs_weights, np.float32), device=device)
    return depths, colors, world_to_cams, intr, obs_weights


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def build_flat_pyramid(depth: torch.Tensor, height: int, width: int,
                       packed_u16: bool = False) -> torch.Tensor:
    """Min/max/valid mip pyramid, flattened level-major into ONE int32 buffer.

    ``packed_u16`` selects the validity semantics of the rgb565d16 sampling
    mode (valid iff 1 <= round(depth * 1000) <= 65535, ``pack_frame``'s range
    test); False keeps the rgb888 semantics (``depth > 0``). NaN is invalid
    in both.

    The image pads to a power-of-two canvas (min: +inf, max: -inf, valid:
    False — all conservative) and every level halves both axes by 2x2 max
    pooling. Each cell packs into one 32-bit word:

    * bits 0..15 — cell depth min, FLOORED to u16 millimetres (65535 when the
      cell has no valid pixel);
    * bits 16..30 — cell depth max, CEILED to 2 mm units; 0 = no valid pixel
      (decodes -inf), 0x7FFF = at/above the 65.534 m range cap (decodes +inf);
    * bit 31 — all-pixels-valid flag.

    :return: int32 flat buffer (the words' bit patterns); level layout per
        :func:`pyramid_layout`.
    """
    hp, wp = _next_pow2(height), _next_pow2(width)
    num_levels = int(math.log2(max(hp, wp))) + 1

    if packed_u16:
        d_mm = torch.round(depth * 1000.0)
        valid = (d_mm >= 1.0) & (d_mm <= 65535.0)
    else:
        valid = depth > 0.0

    # A +inf (or huge) valid pixel saturates the cell max into the far-cap
    # sentinel rather than reading as "no valid pixel".
    depth_capped = torch.clamp(depth, max=70.0)

    ninf = torch.tensor(-float("inf"), dtype=torch.float32, device=depth.device)
    stacked = torch.stack([
        torch.where(valid, -depth, ninf),           # -dmin
        torch.where(valid, depth_capped, ninf),     # dmax
        (~valid).to(torch.float32),                  # any-invalid flag
    ])
    canvas = torch.full((3, hp, wp), -float("inf"), dtype=torch.float32,
                        device=depth.device)
    canvas[:, :height, :width] = stacked
    # Padding cells read as INVALID (flag 1) but do not poison min/max.
    canvas[2, height:, :] = 1.0
    canvas[2, :, width:] = 1.0
    stacked = canvas

    levels = [stacked]
    for _ in range(num_levels - 1):
        if stacked.shape[1] > 1:
            stacked = torch.maximum(stacked[:, 0::2], stacked[:, 1::2])
        if stacked.shape[2] > 1:
            stacked = torch.maximum(stacked[:, :, 0::2], stacked[:, :, 1::2])
        levels.append(stacked)

    min_flat = -torch.cat([lv[0].reshape(-1) for lv in levels])
    max_flat = torch.cat([lv[1].reshape(-1) for lv in levels])
    all_valid = torch.cat([lv[2].reshape(-1) for lv in levels]) == 0.0
    no_valid = ~torch.isfinite(max_flat)  # max == -inf: no valid pixel at all

    dmin_mm = torch.clamp(torch.floor(min_flat * 1000.0), 0.0, 65535.0)
    dmin_mm = torch.where(no_valid, 65535.0, dmin_mm).to(torch.int64)

    dmax_units = torch.clamp(torch.ceil(max_flat * 500.0), 1.0, 32767.0)
    dmax_units = torch.where(no_valid, 0.0, dmax_units).to(torch.int64)

    valid_bit = (all_valid & ~no_valid).to(torch.int64)

    return _to_int32_bits(dmin_mm | (dmax_units << 16) | (valid_bit << 31))


def compact_ids(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Ascending indices of ``mask``'s True entries, tail-filled with
    ``fill`` to ``size`` — the ``jnp.nonzero(mask, size=size,
    fill_value=fill)[0]`` contract. Truncation at ``size`` keeps the
    smallest ids."""
    ids = torch.nonzero(mask).reshape(-1)[:size]
    if ids.numel() < size:
        ids = torch.cat([ids, torch.full((size - ids.numel(),), fill,
                                         dtype=ids.dtype, device=ids.device)])
    return ids


def pyramid_layout(height: int, width: int):
    """Static (offsets, widths, heights) arrays per pyramid level."""
    hp, wp = _next_pow2(height), _next_pow2(width)
    num_levels = int(math.log2(max(hp, wp))) + 1

    offsets, widths, heights = [], [], []
    offset = 0
    h, w = hp, wp

    for _ in range(num_levels):
        offsets.append(offset)
        widths.append(w)
        heights.append(h)
        offset += h * w
        h, w = max(h // 2, 1), max(w // 2, 1)

    return (np.asarray(offsets, np.int32), np.asarray(widths, np.int32),
            np.asarray(heights, np.int32))


class SparseTSDFVolume:
    """Block-major TSDF volume with banded integration.

    API mirrors :class:`hive_tpu.ops.tsdf_sparse.SparseTSDFVolume` (bounds +
    voxel size in, ``integrate_frames`` + ``get_mesh`` out); dims round up to
    block multiples.
    """

    SKIP, FREE, BAND, FREE_EDGE = 0, 1, 2, 3

    def __init__(self, volume_bounds, voxel_size: float,
                 trunc_margin: Optional[float] = None,
                 block_size: Union[int, Sequence[int]] = (8, 8, 8),
                 band_capacity_fraction: float = 0.25,
                 chunk_voxels: int = 1 << 16,
                 color_mode: str = "rgb565d16",
                 dtype=torch.float32, device=None):
        """
        :param band_capacity_fraction: upper bound on the banded update's
            per-trip width, as a fraction of the block count.
        :param chunk_voxels: voxel budget per banded-update trip of the
            CPU's plain version (the card updates a frame's band in one
            launch).
        :param color_mode: ``"rgb565d16"`` (default: u16-mm depth + dithered
            RGB565 in one 32-bit word per pixel) or ``"rgb888"`` (exact f32
            depth + 8-bit colour, two words).
        :param dtype: storage dtype (``torch.bfloat16`` halves memory);
            updates always accumulate in float32.
        :param device: ``"cpu"`` or a CUDA device; default ``cuda:0``.
        """
        volume_bounds = np.asarray(volume_bounds, dtype=np.float32)

        if volume_bounds.shape != (3, 2):
            raise ValueError(f"volume_bounds must be (3, 2), got {volume_bounds.shape}")

        if isinstance(block_size, int):
            block_size = (block_size,) * 3

        self.device = get_device(device)
        self.voxel_size = float(voxel_size)
        self.trunc_margin = float(trunc_margin if trunc_margin is not None
                                  else 5.0 * voxel_size)
        self.block_size: Tuple[int, int, int] = tuple(int(b) for b in block_size)

        B = np.asarray(self.block_size)
        dims = np.ceil((volume_bounds[:, 1] - volume_bounds[:, 0]) / voxel_size)
        dims = (np.ceil(dims / B) * B).astype(int)
        self.dims: Tuple[int, int, int] = tuple(int(d) for d in np.maximum(dims, B))
        self.origin = volume_bounds[:, 0].copy()
        self.volume_bounds = volume_bounds

        self.grid_blocks = tuple(int(d // b) for d, b in zip(self.dims, self.block_size))
        nb = int(np.prod(self.grid_blocks))
        self.num_blocks = nb

        bx, by, bz = np.meshgrid(*[np.arange(g) for g in self.grid_blocks], indexing="ij")
        block_index = np.stack([bx, by, bz], axis=-1).reshape(nb, 3)
        self.block_origins = (self.origin
                              + block_index * B * voxel_size).astype(np.float32)
        self.block_origins_device = torch.as_tensor(self.block_origins,
                                                    device=self.device)

        self.band_capacity = max(64, int(nb * band_capacity_fraction))
        self.chunk_voxels = int(chunk_voxels)

        if color_mode not in ("rgb565d16", "rgb888"):
            raise ValueError(f"unknown color_mode {color_mode!r}")
        self.color_mode = color_mode

        Bx, By, Bz = self.block_size
        self.block_voxels = Bx * By * Bz
        self.dtype = dtype
        self.state = SparseTSDFState(
            tsdf=torch.ones((nb, self.block_voxels), dtype=dtype, device=self.device),
            weight=torch.zeros((nb, self.block_voxels), dtype=dtype, device=self.device),
            color=torch.zeros((nb, 3 * self.block_voxels), dtype=dtype,
                              device=self.device),
        )

        # built lazily, keyed on (height, width, cap, rows, device)
        self._integrators = {}

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.dims))

    # -- block-row placement ----------------------------------------------------
    @property
    def state(self) -> SparseTSDFState:
        """The state in canonical x-major block order on ``self.device``. For
        a volume whose rows are split over devices (:meth:`place_block_rows`)
        this is a gathered, un-permuted copy; the slabs stay in ``shards``
        (a list of :class:`BlockRows`, else None) and row r of the split
        holds block ``block_perm[r]`` (None: block r)."""
        if self.shards is None:
            return self._state
        gathered = SparseTSDFState(*(torch.cat([s.state[i].to(self.device) for s in self.shards])
                                     for i in range(3)))
        if self.block_perm is None:
            return gathered
        inverse = torch.as_tensor(np.argsort(self.block_perm), device=self.device)
        return SparseTSDFState(*(x[inverse] for x in gathered))

    @state.setter
    def state(self, state: SparseTSDFState) -> None:
        """Replace the state (canonical block order, on ``self.device``);
        a split of the rows over devices ends."""
        self._state = state
        self.shards = None
        self.block_perm = None

    def place_block_rows(self, devices: Sequence[torch.device], perm=None) -> None:
        """Split the block rows into ``len(devices)`` equal slabs, slab k on
        ``devices[k]`` (a device may repeat). Row r of the split holds block
        ``perm[r]`` (default: block r). Integration runs on every slab with
        its own rows and origins (blocks are independent and carry their
        origins), so the result does not depend on the split."""
        nb, n = self.num_blocks, len(devices)
        if n == 0 or nb % n:
            raise ValueError(f"num_blocks={nb} must divide over {n} devices")
        perm = np.arange(nb) if perm is None else np.asarray(perm, np.int64)
        if perm.shape != (nb,) or not np.array_equal(np.sort(perm), np.arange(nb)):
            raise ValueError("perm must be a permutation of arange(num_blocks)")
        state = self.state
        rows = nb // n
        shards = []
        for k, device in enumerate(devices):
            ids = perm[k * rows:(k + 1) * rows]
            index = torch.as_tensor(ids, device=self.device)
            shards.append(BlockRows(
                torch.device(device),
                SparseTSDFState(*(x[index].to(device) for x in state)),
                torch.as_tensor(self.block_origins[ids], device=device)))
        self._state = None
        self.shards = shards
        self.block_perm = None if np.array_equal(perm, np.arange(nb)) else perm

    def load_state(self, tsdf, weight, color, block_perm=None) -> None:
        """Replace the state with numpy arrays in the ``hive_tpu``
        ``SparseTSDFState`` layout: tsdf/weight ``(nb, BV)``, colour
        ``(nb, 3*BV)``, z-major blocks. ``block_perm`` (row r holds block
        ``block_perm[r]``, as after ``hive_tpu``'s block-cyclic placement) is
        undone, so the port's rows are in canonical x-major block order."""
        nb, bv = self.num_blocks, self.block_voxels
        arrays = [np.array(a, np.float32) for a in (tsdf, weight, color)]
        for name, a, width in zip(("tsdf", "weight", "color"), arrays,
                                  (bv, bv, 3 * bv)):
            if a.shape != (nb, width):
                raise ValueError(f"{name} must be ({nb}, {width}), got {a.shape}")
        if block_perm is not None:
            inv = np.argsort(np.asarray(block_perm, np.int64))
            arrays = [a[inv] for a in arrays]
        self.state = SparseTSDFState(*(torch.as_tensor(a, device=self.device)
                                       .to(self.dtype) for a in arrays))

    # -- frame integration ----------------------------------------------------
    def _integrator(self, height: int, width: int,
                    compact_cap: Optional[float] = COMPACT_LEVELS[0],
                    rows: Optional[int] = None, device=None):
        """The stages for one frame size and compaction level, on a slab of
        ``rows`` block rows (default: all) on ``device`` (default: the
        volume's)."""
        rows = self.num_blocks if rows is None else rows
        device = self.device if device is None else torch.device(device)
        key = (height, width, compact_cap, rows, device)
        if key not in self._integrators:
            self._integrators[key] = _Integrator(self, height, width, compact_cap, rows,
                                                 device)
        return self._integrators[key]

    def integrate(self, color_image, depth_image, camera_matrix, cam_to_world_pose,
                  obs_weight: float = 1.0):
        self.integrate_frames(np.asarray(color_image, np.float32)[None],
                              np.asarray(depth_image, np.float32)[None],
                              camera_matrix,
                              np.asarray(cam_to_world_pose, np.float32)[None],
                              obs_weights=np.asarray([obs_weight], np.float32))

    def estimate_candidate_fraction(self, camera_matrix, cam_to_world_poses,
                                    height: int, width: int) -> float:
        """Host-side sampled estimate of the pass-1 candidate fraction.

        Mirrors the classification arithmetic on a strided sample of the
        block grid (<= ~4096 blocks) for <= 8 evenly spaced poses, returning
        the max over frames. A wrong estimate only costs speed: overflow
        candidates stay BAND.
        """
        K = np.asarray(camera_matrix, dtype=np.float32)
        poses_np = np.asarray(cam_to_world_poses, np.float32)

        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        w2cs = np.linalg.inv(poses_np)
        if w2cs.ndim == 2:
            w2cs = w2cs[None]

        if len(w2cs) > 8:
            idx = np.unique(np.round(
                np.linspace(0, len(w2cs) - 1, 8)).astype(int))
            w2cs = w2cs[idx]

        stride = max(1, int(math.ceil((self.num_blocks / 4096.0) ** (1 / 3))))
        B = np.asarray(self.block_size, np.float32)
        grids = [np.arange(0, g, stride) for g in self.grid_blocks]
        bx, by, bz = np.meshgrid(*grids, indexing="ij")
        origins = (self.origin
                   + np.stack([bx, by, bz], -1).reshape(-1, 3)
                   * B * self.voxel_size)
        offs = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                         for z in (0, 1)], np.float32) * B * self.voxel_size
        corners = origins[:, None, :] + offs[None]           # (M, 8, 3)

        R = w2cs[:, :3, :3]                                   # (F, 3, 3)
        t = w2cs[:, :3, 3]                                    # (F, 3)
        pts = np.einsum("mkj,fij->fmki", corners, R) + t[:, None, None, :]
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]       # (F, M, 8)
        safe_z = np.maximum(z, 1e-6)
        us, vs = fx * x / safe_z + cx, fy * y / safe_z + cy
        in_front = z.min(2) > 1e-6
        outside = ((z.max(2) <= 1e-6)
                   | ((fx * x + (cx + 2.0) * z).max(2) < 0)
                   | ((fx * x + (cx - width - 2.0) * z).min(2) > 0)
                   | ((fy * y + (cy + 2.0) * z).max(2) < 0)
                   | ((fy * y + (cy - height - 2.0) * z).min(2) > 0))
        overlaps = ((us.max(2) >= 0) & (us.min(2) < width)
                    & (vs.max(2) >= 0) & (vs.min(2) < height))
        cand = (in_front & overlaps) | (~in_front & ~outside)
        return float(cand.mean(1).max())

    def integrate_frames(self, colors, depths, camera_matrix, cam_to_world_poses,
                         obs_weights=None):
        """Fuse a stack of frames.

        :param colors: (N, H, W, 3) RGB (uint8 or float; numpy or tensor).
        :param depths: (N, H, W) float32 metres (0 = invalid).
        :param camera_matrix: (3, 3) shared intrinsics.
        :param cam_to_world_poses: (N, 4, 4) camera-to-world transforms.
        :param obs_weights: optional (N,) per-frame weights (default 1).
        """
        inputs = prepare_integration_inputs(colors, depths, camera_matrix, cam_to_world_poses,
                                            obs_weights, self.device)
        n, height, width = inputs[0].shape
        # One cap for every slab, from the global candidate fraction; each
        # slab's capacities derive from its own row count.
        cap = pick_compact_cap(self.estimate_candidate_fraction(
            camera_matrix, cam_to_world_poses, height, width))

        slabs = self.shards or [BlockRows(self.device, self._state, self.block_origins_device)]
        copies = {self.device: inputs}  # the frames, once on each device
        runs = []
        for slab in slabs:
            if slab.device not in copies:
                copies[slab.device] = tuple(x.to(slab.device) for x in inputs)
            integ = self._integrator(height, width, cap, slab.origins.shape[0], slab.device)
            runs.append((integ, integ.start(slab.state), slab.origins, copies[slab.device]))
        # Frame by frame over the slabs, each queued with its device current.
        for f in range(n):
            for integ, run, origins, frames in runs:
                with on_device(integ.device):
                    integ.integrate_frame(run, origins, frames, f)
        for integ, run, _, _ in runs:
            with on_device(integ.device):
                integ.finish(run)
        return self

    # -- extraction -----------------------------------------------------------
    def _dense(self):
        """(tsdf (X,Y,Z), weight (X,Y,Z), color planes (3,X,Y,Z)) float32."""
        BV = self.block_voxels
        color_planes = torch.stack(
            [self._to_dense(self.state.color[:, ch * BV:(ch + 1) * BV])
             for ch in range(3)])
        return (self._to_dense(self.state.tsdf), self._to_dense(self.state.weight),
                color_planes)

    def _to_dense(self, blocked: torch.Tensor) -> torch.Tensor:
        """(nb, BV) z-major blocks -> (X, Y, Z) float32."""
        nbx, nby, nbz = self.grid_blocks
        Bx, By, Bz = self.block_size
        a = blocked.to(torch.float32).reshape(nbx, nby, nbz, Bz, Bx, By)
        return a.permute(0, 4, 1, 5, 2, 3).reshape(*self.dims)

    def get_volume(self):
        tsdf, weight, color_planes = self._dense()
        color = color_planes.permute(1, 2, 3, 0).cpu().numpy()
        return tsdf.cpu().numpy(), weight.cpu().numpy(), color

    def get_mesh(self):
        from hive_tpu_torch.ops.marching import extract_isosurface_blocked

        verts, faces, colors, normals = extract_isosurface_blocked(
            self.state.tsdf, self.state.weight, self.state.color,
            grid_blocks=self.grid_blocks, block_size=self.block_size,
            origin=self.origin, voxel_size=self.voxel_size)

        return verts, faces, normals, colors


class _Integrator:
    """The integration stages for one (frame size, compaction level) on a
    slab of block rows on one device.

    The counterpart of the closures ``hive_tpu``'s ``_build_integrator``
    returns; :meth:`start`, :meth:`integrate_frame` for each frame and
    :meth:`finish` are its ``integrate_one.scan`` with a Python loop over
    frames in place of ``lax.scan``.
    """

    def __init__(self, volume: SparseTSDFVolume, height: int, width: int,
                 compact_cap: Optional[float], rows: int, device: torch.device):
        self.height, self.width = height, width
        self.compact_cap = compact_cap
        self.trunc = volume.trunc_margin
        self.voxel = volume.voxel_size
        self.color_mode = volume.color_mode
        self.layout = pyramid_layout(height, width)
        self.device = dev = device
        self.trunc_t = torch.tensor(self.trunc, dtype=torch.float32, device=dev)
        # The band update scales by the f32 reciprocal of the truncation, as
        # XLA compiles the JAX package's division by that constant.
        self.inv_trunc = torch.tensor(1.0, dtype=torch.float32, device=dev) / self.trunc_t

        Bx, By, Bz = volume.block_size
        self.corner_offsets = np.asarray(
            [[x * Bx, y * By, z * Bz] for x in (0.0, 1.0) for y in (0.0, 1.0)
             for z in (0.0, 1.0)], dtype=np.float32) * np.float32(self.voxel)
        self.geometry = Geometry(height, width, self.trunc,
                                 tuple(float(c) for c in self.corner_offsets[7]),
                                 self.layout)

        # SUB is the largest divisor of Bz keeping slab rows >= 512 voxels
        # (hive_tpu's measured trade-off); the default (8, 8, 8) block has
        # SUB = 1.
        BV = Bx * By * Bz
        SUB = 1
        for d in range(Bz, 0, -1):
            if Bz % d == 0 and BV // d >= 512:
                SUB = d
                break
        self.SUB, self.BV, self.BVS = SUB, BV, BV // SUB
        self.block = (Bx, By)
        self.slab_z = float(np.float32((Bz // SUB) * self.voxel))
        self.voxel_f32 = float(np.float32(self.voxel))

        flat_s = np.arange(self.BVS)
        self.iota_axes = [
            torch.as_tensor(((flat_s // By) % Bx).astype(np.float32), device=dev),
            torch.as_tensor((flat_s % By).astype(np.float32), device=dev),
            torch.as_tensor((flat_s // (Bx * By)).astype(np.float32), device=dev)]

        # The caps of a slab of ``rows`` block rows, as the JAX package's
        # integrator derives them inside ``shard_map``. Pass 1's compaction
        # capacity comes from the slab's rows (``rows``: every block is
        # queried). The refine capacity (band blocks beyond it stay
        # unrefined band) comes from the whole volume, 8-aligned, and is at
        # most the slab's rows.
        self.pass1_cap = rows if compact_cap is None else max(1024, int(rows * compact_cap))
        nb = volume.num_blocks
        refine_cap = min(nb, max(1024, nb // 8))
        self.refine_cap = min(rows, ((refine_cap + 7) // 8) * 8)

        # Per-trip width of the banded update on the CPU (slab rows) and of
        # the gather-free edge pass.
        self.chunk = min(volume.band_capacity * SUB,
                         max(64, volume.chunk_voxels // max(1, self.BVS)))
        self.edge_chunk = min(volume.band_capacity * SUB, 4 * self.chunk)

    # -- classification -------------------------------------------------------
    def classify(self, block_origins, pyramid, R, t, intr):
        """Pass-1 classes; with ``compact_cap`` set, only the first ``cap``
        frustum candidates are queried (overflow candidates conservatively
        stay BAND)."""
        return classify_pass1(block_origins, classify_scalars(R, t, intr), pyramid,
                              self.geometry, self.pass1_cap)

    def classify_refined(self, block_origins, pyramid, R, t, intr):
        """Pass 1, then the refine pass over up to ``refine_cap`` band blocks
        (one kernel launch each on the card): (classes, dmin_blk, dmax_blk,
        free_ok_blk), the last three the per-block refined depth window and
        free precondition for the z-slab culling (None when SUB == 1)."""
        scal = classify_scalars(R, t, intr)
        classes = classify_pass1(block_origins, scal, pyramid, self.geometry, self.pass1_cap)
        return (classes, *classify_refine(classes, block_origins, scal, pyramid, self.geometry,
                                          self.refine_cap, windows=self.SUB > 1))

    def slab_masks(self, block_origins, classes, dmin_blk, dmax_blk, free_ok_blk,
                   R, t, obs_weight):
        """Per-z-slab band/free decisions: (band_flat (nb*SUB,) bool,
        free_w_flat (nb*SUB,) f32, edge_flat (nb*SUB,) bool)."""
        V = SparseTSDFVolume
        SUB, trunc = self.SUB, self.trunc
        nb = classes.shape[0]
        band_blk = classes == V.BAND
        free_blk = classes == V.FREE
        edge_blk = classes == V.FREE_EDGE

        if SUB == 1:
            return band_blk, torch.where(free_blk, obs_weight, 0.0), edge_blk

        bx_, by_, bz_ = block_origins[:, 0], block_origins[:, 1], block_origins[:, 2]
        zc = []
        for k in range(8):
            ox, oy, oz = (float(c) for c in self.corner_offsets[k])
            zc.append(R[2, 0] * (bx_ + ox) + R[2, 1] * (by_ + oy)
                      + R[2, 2] * (bz_ + oz) + t[2])

        band_cols, free_cols = [], []
        for s in range(SUB):
            z_min_s = z_max_s = None
            for xb in (0, 4):
                for yb in (0, 2):
                    z0, z1 = zc[xb + yb], zc[xb + yb + 1]
                    for f in (s / SUB, (s + 1) / SUB):
                        zf = z0 + float(np.float32(f)) * (z1 - z0)
                        if z_min_s is None:
                            z_min_s = z_max_s = zf
                        else:
                            z_min_s = torch.minimum(z_min_s, zf)
                            z_max_s = torch.maximum(z_max_s, zf)

            free_s = band_blk & free_ok_blk & (z_max_s < dmin_blk - trunc)
            skip_s = band_blk & (z_min_s > dmax_blk + trunc)
            band_cols.append(band_blk & ~free_s & ~skip_s)
            free_cols.append(free_blk | free_s)

        band_flat = torch.stack(band_cols, dim=1).reshape(nb * SUB)
        free_flat = torch.stack(free_cols, dim=1).reshape(nb * SUB)
        edge_flat = torch.repeat_interleave(edge_blk, SUB)
        return band_flat, torch.where(free_flat, obs_weight, 0.0), edge_flat

    # -- updates ----------------------------------------------------------------
    def slab_base(self, block_origins, sub_ids, R, t):
        """Camera coordinates (K, 3) of the first voxel of each slab row."""
        SUB = self.SUB
        rows = torch.div(sub_ids, SUB, rounding_mode="floor")
        s = (sub_ids % SUB).to(torch.float32)

        origins = block_origins[rows]                                  # (K, 3)
        base = origins @ R.T + t                                       # (K, 3)
        # A slab's origin shifts along WORLD z by s * slab_z.
        return base + s[:, None] * (self.slab_z * R[:, 2])[None, :]

    def slab_camera_coords(self, block_origins, sub_ids, R, t):
        """Camera coordinates (K, BVS) x3 of every voxel of slab rows."""
        return camera_coords(self.slab_base(block_origins, sub_ids, R, t),
                             R * self.voxel_f32, self.iota_axes)

    def project_voxels(self, cam_x, cam_y, cam_z, intr):
        """Nearest pixel (u, v) int32 and the in-view mask."""
        return project(cam_x, cam_y, cam_z, intr, self.height, self.width)

    def pack_frame(self, depth, color_im):
        """Per-frame sampling words: rgb565d16 gives one int32 word per pixel
        (u16-mm depth | dithered RGB565 << 16); rgb888 gives the f32 depth's
        bits and a packed 8-bit RGB word."""
        if self.color_mode == "rgb888":
            c = torch.clamp(color_im.to(torch.float32), 0.0, 255.0).to(torch.int32)
            return (depth.contiguous().view(torch.int32),
                    c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16))

        # Depths beyond the u16-mm range become INVALID (0) rather than
        # clamping; NaN fails the <= test and lands on 0 as well.
        d_mm = torch.round(depth * 1000.0)
        d_mm = torch.where(d_mm <= 65535.0, torch.clamp(d_mm, 0.0, 65535.0), 0.0)
        d_mm = d_mm.to(torch.int64)

        # 2x2 ordered dither (0, .5 / .75, .25).
        h, w = depth.shape
        vv = (torch.arange(h, device=depth.device) & 1)[:, None]
        uu = (torch.arange(w, device=depth.device) & 1)[None, :]
        dith = (0.5 * uu + 0.75 * vv - 1.0 * (uu * vv)).to(torch.float32)

        c = torch.clamp(color_im.to(torch.float32), 0.0, 255.0)
        r5 = torch.floor(c[..., 0] * (31.0 / 255.0) + dith)
        g6 = torch.floor(c[..., 1] * (63.0 / 255.0) + dith)
        b5 = torch.floor(c[..., 2] * (31.0 / 255.0) + dith)
        r5 = torch.clamp(r5, 0.0, 31.0).to(torch.int64)
        g6 = torch.clamp(g6, 0.0, 63.0).to(torch.int64)
        b5 = torch.clamp(b5, 0.0, 31.0).to(torch.int64)

        return (_to_int32_bits(d_mm | (r5 << 16) | (g6 << 21) | (b5 << 27)),)

    def band_scalars(self, intr, R, obs_weight):
        """The band update's (16,) f32 scalars of one frame."""
        return band_scalars(intr, self.trunc_t, self.inv_trunc, obs_weight,
                            R * self.voxel_f32)

    def update_band(self, state, block_origins, sub_ids, sample, R, t, scal):
        """Update the band slab rows ``sub_ids`` of the slab-shaped ``state``
        in place with one frame (:func:`band_update`)."""
        band_update(state, sub_ids, self.slab_base(block_origins, sub_ids, R, t), scal,
                    sample, block=self.block, sub=self.SUB)

    def update_edge(self, state, block_origins, sub_ids, R, t, intr, obs_weight):
        """One gather-free trip over FREE_EDGE slab rows: every in-view voxel
        updates with dist = 1; colour is untouched. In place, as
        :meth:`update_band`."""
        store = state.tsdf.dtype
        slab_tsdf = state.tsdf[sub_ids].to(torch.float32)
        slab_weight = state.weight[sub_ids].to(torch.float32)

        cam_x, cam_y, cam_z = self.slab_camera_coords(block_origins, sub_ids, R, t)
        _, _, in_view = self.project_voxels(cam_x, cam_y, cam_z, intr)

        w_obs = torch.where(in_view, obs_weight, 0.0)
        w_new = slab_weight + w_obs
        safe_w = torch.clamp(w_new, min=1e-12)
        tsdf_new = torch.where(w_obs > 0, (slab_tsdf * slab_weight + w_obs) / safe_w,
                               slab_tsdf)

        state.tsdf.index_copy_(0, sub_ids, tsdf_new.to(store))
        state.weight.index_copy_(0, sub_ids, w_new.to(store))

    @staticmethod
    def apply_free_weights(state, free_weights, rows_per_pass: int = 1 << 15):
        """dist = 1 update with per-slab accumulated weights ``k``, in place.
        Only rows with k > 0 change (elsewhere the JAX package's elementwise
        pass reproduces the stored values bit for bit), so only they are
        touched, in bounded passes."""
        store = state.tsdf.dtype
        rows = torch.nonzero(free_weights > 0).reshape(-1)
        for start in range(0, rows.numel(), rows_per_pass):
            ids = rows[start:start + rows_per_pass]
            k = free_weights[ids][:, None]
            w_old = state.weight[ids].to(torch.float32)
            w_new = w_old + k
            tsdf = state.tsdf[ids].to(torch.float32)
            tsdf_new = (tsdf * w_old + k) / torch.clamp(w_new, min=1e-12)
            state.tsdf.index_copy_(0, ids, tsdf_new.to(store))
            state.weight.index_copy_(0, ids, w_new.to(store))

    def _trips(self, mask, width: Optional[int]):
        """The ascending ids of ``mask`` in trips of ``width``, or in one trip
        when ``width`` is None (one host sync for the stream's size)."""
        ids = torch.nonzero(mask).reshape(-1)
        width = width or max(1, ids.numel())
        return [ids[i:i + width] for i in range(0, ids.numel(), width)]

    def to_slabs(self, state: SparseTSDFState) -> SparseTSDFState:
        """(nb, BV) -> (nb*SUB, BVS) views; free in torch (contiguous). At
        SUB == 1 colour keeps its (nb, 3*BV) rows, one per block."""
        nb = state.tsdf.shape[0]
        SUB, BVS = self.SUB, self.BVS
        if SUB == 1:
            return state
        return SparseTSDFState(tsdf=state.tsdf.view(nb * SUB, BVS),
                               weight=state.weight.view(nb * SUB, BVS),
                               color=state.color.view(nb * 3 * SUB, BVS))

    def start(self, state: SparseTSDFState):
        """A run over a frame stack: the slab views of ``state`` and the
        frames' summed free weights, applied by :meth:`finish`."""
        free_weights = torch.zeros((state.tsdf.shape[0] * self.SUB,), dtype=torch.float32,
                                   device=state.tsdf.device)
        return self.to_slabs(state), free_weights

    def integrate_frame(self, run, block_origins, frames, f: int) -> None:
        """Fuse frame ``f`` of ``frames`` (:func:`prepare_integration_inputs`)
        into the run's state in place: the band update and the edge trips;
        its free weights add up for :meth:`finish`."""
        slabs, free_weights = run
        depths, colors, world_to_cams, intr, obs_weights = frames
        packed_u16 = self.color_mode == "rgb565d16"
        intr_s = tuple(intr[i] for i in range(4))
        depth, color_im = depths[f], colors[f]
        R, t = world_to_cams[f, :3, :3], world_to_cams[f, :3, 3]
        obs_weight = obs_weights[f]

        sample = self.pack_frame(depth, color_im)
        pyramid = build_flat_pyramid(depth, self.height, self.width, packed_u16=packed_u16)
        classes, dmin_blk, dmax_blk, free_ok = self.classify_refined(
            block_origins, pyramid, R, t, intr_s)
        band_flat, free_w, edge_flat = self.slab_masks(
            block_origins, classes, dmin_blk, dmax_blk, free_ok, R, t, obs_weight)

        # On the card one kernel launch updates the frame's whole band; on
        # the CPU the plain version goes in trips of ``chunk`` rows, which
        # bounds its temporaries.
        scal = self.band_scalars(intr, R, obs_weight)
        band_trip = None if slabs.tsdf.is_cuda else self.chunk
        for ids in self._trips(band_flat, band_trip):
            self.update_band(slabs, block_origins, ids, sample, R, t, scal)
        # Edge updates carry a per-voxel visibility mask, so unlike
        # whole-block FREE weights they cannot batch across frames.
        for ids in self._trips(edge_flat, self.edge_chunk):
            self.update_edge(slabs, block_origins, ids, R, t, intr_s, obs_weight)

        free_weights += free_w

    def finish(self, run) -> None:
        """Apply the run's summed free weights."""
        self.apply_free_weights(*run)

