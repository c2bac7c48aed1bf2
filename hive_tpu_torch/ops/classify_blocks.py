"""The frame's block classification: CUDA kernel, plain version, wrappers.

Replaces ``hive_tpu/ops/pallas_refine.py:_build_kernel`` (the refine pass's
5x5 window reduce, called through ``query_flat_pyramid_pallas`` from
``refine_band``) together with the XLA code around it in
``hive_tpu/ops/tsdf_sparse.py``: ``project_corners`` (:718), the level pick
and cell clamp, the pyramid reduce, ``classes_from_bounds`` (:780),
``classify`` (:829) and ``refine_band`` (:940).

Every voxel block's 8 corners are projected into the camera; the pixel
AABB picks a level of the frame's min/max/valid depth pyramid, and the
block's depth window over those cells gives its class (SKIP, FREE, BAND,
FREE_EDGE). Two passes, each one kernel launch over all blocks on the card:

* **pass 1** (:data:`PASS1`: 2x2 cells at the covering level). With a
  compaction cap, only frustum candidates are queried: non-candidates are
  SKIP, the first ``cap`` candidates in block order take their class and
  the rest stay BAND.
* **refine** (:data:`REFINE`: 5x5 cells two levels finer). The first
  ``cap`` BAND blocks in block order are classified again in place, except
  those not in front of the camera; at SUB > 1 it also gives each block's
  refined depth window and free precondition, with the conservative
  defaults (-inf, +inf, False) where a block was not refined.

The caps are applied by rank: the ids that ``nonzero(mask)[:cap]`` would
keep are exactly the blocks whose inclusive prefix count of ``mask`` is
``<= cap``, so a ``cumsum`` on the device takes the place of the
reference's compactions and nothing waits for the host.

The plain version (any device; the CPU path, the tests and the card's
check) runs the ops of ``hive_tpu``'s closures: on the CPU only over the
blocks a pass selects, on the card over every block, selected by masks so
that it waits for no host sync. The kernel (``csrc/classify_blocks.cu``) keeps a block
from its origin to its class in registers and reads the pyramid only for
the blocks whose class depends on it. Both give the same classes and
windows bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from hive_tpu_torch.ops import cuda_build

# Block classes (``SparseTSDFVolume``'s).
SKIP, FREE, BAND, FREE_EDGE = 0, 1, 2, 3

# (taps per axis, pyramid level bias) of the two passes.
PASS1, REFINE = (2, 0), (5, -2)

# Kernel launches (not plain-version calls) of each pass since the last reset.
pass1_launches = 0
refine_launches = 0

# Layout of ``scal``: the world-to-camera rotation (3 x 3, row-major), its
# translation, then fx, fy, cx, cy.
NUM_SCALARS = 16


class Geometry(NamedTuple):
    """What the classification holds fixed for one frame size and volume."""
    height: int
    width: int
    trunc: float                        # truncation margin (f32 where used)
    corner: Tuple[float, float, float]  # a block's extent along x, y, z (f32 values)
    layout: Tuple[np.ndarray, np.ndarray, np.ndarray]  # pyramid_layout(height, width)


def classify_scalars(R: torch.Tensor, t: torch.Tensor, intr) -> torch.Tensor:
    """The (16,) f32 ``scal`` of one frame, on the device of ``R``."""
    return torch.cat([R.reshape(9), t.reshape(3),
                      torch.stack(tuple(intr)).reshape(4)]).to(torch.float32)


def _camera(scal: torch.Tensor):
    """(R, t, (fx, fy, cx, cy)) as views of ``scal``."""
    return scal[:9].view(3, 3), scal[9:12], tuple(scal[12:16])


# -- the plain version -----------------------------------------------------------

def project_corners(origins, R, t, intr, geom: Geometry):
    """Per-block camera-space hull bounds from the 8 block corners:
    (in_front, z_min, z_max, u0, u1, v0, v1, outside_frustum), where
    ``outside_frustum`` is an exact hull test against the four image-border
    planes (2 px margin), valid for blocks that straddle or sit behind the
    camera plane."""
    fx, fy, cx, cy = intr
    width, height = geom.width, geom.height
    bx_, by_, bz_ = origins[:, 0], origins[:, 1], origins[:, 2]

    for k in range(8):
        # Corner k = 4*x + 2*y + z of the block.
        ox, oy, oz = (c if (k >> (2 - a)) & 1 else 0.0 for a, c in enumerate(geom.corner))
        cxw, cyw, czw = bx_ + ox, by_ + oy, bz_ + oz
        x = R[0, 0] * cxw + R[0, 1] * cyw + R[0, 2] * czw + t[0]
        y = R[1, 0] * cxw + R[1, 1] * cyw + R[1, 2] * czw + t[1]
        z = R[2, 0] * cxw + R[2, 1] * cyw + R[2, 2] * czw + t[2]

        safe_z = torch.clamp(z, min=1e-6)
        us = fx * x / safe_z + cx
        vs = fy * y / safe_z + cy

        lin_l = fx * x + (cx + 2.0) * z
        lin_r = fx * x + (cx - width - 2.0) * z
        lin_t = fy * y + (cy + 2.0) * z
        lin_b = fy * y + (cy - height - 2.0) * z

        if k == 0:
            z_min = z_max = z
            u0 = u1 = us
            v0 = v1 = vs
            l_max, r_min, t_max, b_min = lin_l, lin_r, lin_t, lin_b
        else:
            z_min = torch.minimum(z_min, z)
            z_max = torch.maximum(z_max, z)
            u0 = torch.minimum(u0, us)
            u1 = torch.maximum(u1, us)
            v0 = torch.minimum(v0, vs)
            v1 = torch.maximum(v1, vs)
            l_max = torch.maximum(l_max, lin_l)
            r_min = torch.minimum(r_min, lin_r)
            t_max = torch.maximum(t_max, lin_t)
            b_min = torch.minimum(b_min, lin_b)

    in_front = z_min > 1e-6
    outside_frustum = ((z_max <= 1e-6) | (l_max < 0) | (r_min > 0)
                       | (t_max < 0) | (b_min > 0))
    return in_front, z_min, z_max, u0, u1, v0, v1, outside_frustum


def pyramid_cell_bounds(layout, u0, u1, v0, v1, height: int, width: int,
                        level_bias: int):
    """Covering-level cell ranges for per-block pixel AABBs: the level pick
    and cell clamping of the plain query (the kernel repeats it op for op).

    The MAX edge widens by the sampling paths' +0.5 px nearest-pixel
    rounding before the level pick and cell clamp (``round(u)`` lands one
    pixel past ``floor(u1)`` whenever ``frac(u1) >= 0.5``); the MIN edge needs
    no margin.

    :return: (off, w_l, cu0, cu1, cv0, cv1) int32 tensors.
    """
    device = u0.device
    num_levels = len(layout[0])
    offsets, widths, heights = (torch.as_tensor(a, device=device) for a in layout)

    u1 = u1 + 0.5
    v1 = v1 + 0.5

    extent = torch.maximum(u1 - u0, v1 - v0)
    level = torch.clamp(
        torch.ceil(torch.log2(torch.clamp(extent, min=1.0))).to(torch.int32)
        + level_bias, 0, num_levels - 1).long()

    off = offsets[level]
    w_l = widths[level]
    h_l = heights[level]
    shift = level.to(torch.int32)  # cell size = 1 << level

    def cell(c, size, limit):
        return torch.minimum(torch.clamp(c, 0, size - 1).to(torch.int32) >> shift,
                             limit - 1)

    return (off, w_l, cell(u0, width, w_l), cell(u1, width, w_l),
            cell(v0, height, h_l), cell(v1, height, h_l))


def decode_cell_fields(dmin_mm: torch.Tensor, dmax_units: torch.Tensor):
    """Reduced integer cell fields -> (dmin m, dmax m) floats; the decode is
    monotone, so it commutes with min/max reductions."""
    dmin = dmin_mm.to(torch.float32) * 1e-3
    units = dmax_units.to(torch.float32)
    dmax = torch.where(units == 0.0, -float("inf"),
                       torch.where(units >= 32767.0, float("inf"),
                                   units * 2e-3))
    return dmin, dmax


def query_flat_pyramid(pyramid, layout, u0, u1, v0, v1, height: int, width: int,
                       grid: int = 2, level_bias: int = 0):
    """Conservative (dmin, dmax, all_valid) over per-block AABBs.

    ``grid=2, level_bias=0`` (pass 1) queries the level whose cell covers
    the AABB extent with 2x2 cells; ``grid=5, level_bias=-2`` (the refine
    pass) queries 5x5 cells two levels finer. Cells past the AABB clamp onto
    the last covered cell (duplicate reads are conservative). The cells
    reduce as integers (min of the u16 min field, max of the 15-bit max
    field, AND of the valid bit), then decode once.
    """
    if grid < (1 << max(0, -level_bias)) + 1:
        raise ValueError(f"grid={grid} cannot cover an AABB at level bias "
                         f"{level_bias}; need >= "
                         f"{(1 << max(0, -level_bias)) + 1}")

    off, w_l, cu0, cu1, cv0, cv1 = pyramid_cell_bounds(
        layout, u0, u1, v0, v1, height, width, level_bias)
    mn = mx = vbit = None
    for i in range(grid):
        cv = torch.minimum(cv0 + i, cv1)
        for j in range(grid):
            cu = torch.minimum(cu0 + j, cu1)
            g = pyramid[(off + cv * w_l + cu).long()]
            cmin = g & 0xFFFF
            cmax = (g >> 16) & 0x7FFF
            cvalid = (g >> 31) & 1
            if mn is None:
                mn, mx, vbit = cmin, cmax, cvalid
            else:
                mn = torch.minimum(mn, cmin)
                mx = torch.maximum(mx, cmax)
                vbit = vbit & cvalid
    dmin, dmax = decode_cell_fields(mn, mx)
    return dmin, dmax, vbit == 1


def overlaps_image(u0, u1, v0, v1, geom: Geometry):
    """Some voxel of the AABB may round to a pixel of the image (half-pixel
    rounding: u in [-0.5, 0) rounds into column 0)."""
    return ((u1 >= -0.5) & (u0 <= geom.width - 0.5)
            & (v1 >= -0.5) & (v0 <= geom.height - 0.5))


def fully_inside(u0, u1, v0, v1, geom: Geometry):
    """Every voxel of the AABB rounds to a pixel of the image (half-pixel
    rounding: ties at width - 0.5 round half to even, hence strict <)."""
    return ((u0 >= 0) & (u1 < geom.width - 0.5)
            & (v0 >= 0) & (v1 < geom.height - 0.5))


def classes_from_bounds(in_front, z_min, z_max, u0, u1, v0, v1, outside_frustum,
                        dmin, dmax, all_valid, geom: Geometry):
    trunc = geom.trunc
    # Half-pixel rounding: a voxel at u in [-0.5, 0) rounds into column
    # 0, one at u in [width-0.5, width) rounds out; ``overlaps`` admits
    # everything that could round in, ``inside`` guarantees it.
    overlaps = overlaps_image(u0, u1, v0, v1, geom)
    inside = fully_inside(u0, u1, v0, v1, geom)

    classes = torch.full(in_front.shape, BAND, dtype=torch.int32, device=in_front.device)
    free = in_front & inside & all_valid & (z_max < dmin - trunc)
    classes = torch.where(free, FREE, classes)

    free_edge = (in_front & ~inside & overlaps & all_valid
                 & (z_max < dmin - trunc))
    classes = torch.where(free_edge, FREE_EDGE, classes)

    no_surface = dmax == -float("inf")
    behind = in_front & (z_min > dmax + trunc)
    skip = ((in_front & ~overlaps) | (in_front & no_surface) | behind
            | (~in_front & outside_frustum))
    return torch.where(skip, SKIP, classes).to(torch.int32)


def pass1_candidates(in_front, u0, u1, v0, v1, outside_frustum, geom: Geometry):
    """Pass 1's compaction candidates: in front and overlapping the image
    (without the half-pixel margin), or not in front and not proven outside."""
    overlaps = (u1 >= 0) & (u0 < geom.width) & (v1 >= 0) & (v0 < geom.height)
    return (in_front & overlaps) | (~in_front & ~outside_frustum)


def cap_candidates(classes, candidate, cap: int):
    """The first ``cap`` candidates in block order keep their class, the
    rest stay BAND (non-candidates are SKIP in ``classes`` already)."""
    rank = torch.cumsum(candidate, 0, dtype=torch.int32)
    return torch.where(candidate & (rank > cap), BAND, classes)


def band_rank(classes):
    """The inclusive count of BAND blocks up to each block, int32."""
    return torch.cumsum(classes == BAND, 0, dtype=torch.int32)


def _selected_ids(mask):
    """The ids of ``mask`` on the CPU, where ``nonzero`` waits for nothing,
    so that only those blocks are evaluated; None on the card, where every
    block is evaluated and the mask selects, so that nothing waits for the
    host."""
    return torch.nonzero(mask).reshape(-1) if mask.device.type == "cpu" else None


def _spread(mask, ids, values, default):
    """Per block: ``values`` where ``mask``, else ``default``. ``values``
    holds every block (``ids`` None) or just the blocks ``ids`` of ``mask``."""
    if ids is None:
        return torch.where(mask, values, default)
    out = (default.clone() if isinstance(default, torch.Tensor)
           else torch.full(mask.shape, default, dtype=values.dtype))
    out[ids] = values
    return out


def _classes_and_window(bounds, pyramid, geom: Geometry, grid_bias):
    """The classes of ``bounds`` (:func:`project_corners`) from their pyramid
    window at ``grid_bias``: (classes, (dmin, dmax, all_valid))."""
    _, _, _, u0, u1, v0, v1, _ = bounds
    window = query_flat_pyramid(pyramid, geom.layout, u0, u1, v0, v1, geom.height, geom.width,
                                *grid_bias)
    return classes_from_bounds(*bounds, *window, geom), window


def classify_pass1_plain(origins, scal, pyramid, geom: Geometry, cap: int):
    """The plain PyTorch version of :func:`classify_pass1`."""
    R, t, intr = _camera(scal)
    bounds = project_corners(origins, R, t, intr, geom)
    if cap >= origins.shape[0]:
        return _classes_and_window(bounds, pyramid, geom, PASS1)[0]
    in_front, _, _, u0, u1, v0, v1, outside = bounds
    candidate = pass1_candidates(in_front, u0, u1, v0, v1, outside, geom)
    # The first ``cap`` candidates take their class, the other candidates
    # stay BAND, and every other block is SKIP.
    keep = candidate & (torch.cumsum(candidate, 0, dtype=torch.int32) <= cap)
    ids = _selected_ids(keep)
    classes, _ = _classes_and_window(bounds if ids is None else tuple(b[ids] for b in bounds),
                                     pyramid, geom, PASS1)
    return _spread(keep, ids, classes, torch.where(candidate, BAND, SKIP).to(torch.int32))


def classify_refine_plain(classes, origins, scal, pyramid, geom: Geometry, cap: int,
                          windows: bool):
    """The plain PyTorch version of :func:`classify_refine`."""
    R, t, intr = _camera(scal)
    selected = (classes == BAND) & (band_rank(classes) <= cap)
    ids = _selected_ids(selected)
    bounds = project_corners(origins if ids is None else origins[ids], R, t, intr, geom)
    refined, (dmin, dmax, all_valid) = _classes_and_window(bounds, pyramid, geom, REFINE)
    in_front, _, _, u0, u1, v0, v1, _ = bounds
    # Straddling blocks keep their pass-1 class (BAND) and the defaults.
    classes.copy_(_spread(selected, ids, torch.where(in_front, refined, BAND), classes))
    if not windows:
        return None, None, None
    inf = float("inf")
    return (_spread(selected, ids, torch.where(in_front, dmin, -inf), -inf),
            _spread(selected, ids, torch.where(in_front, dmax, inf), inf),
            _spread(selected, ids, in_front & fully_inside(u0, u1, v0, v1, geom) & all_valid,
                    False))


# -- the kernel ------------------------------------------------------------------

_COMMON_ARGS = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_void_p] + [ctypes.c_int32] * 3
                + [ctypes.c_float] * 4)
_ARGTYPES = {
    "pass1": _COMMON_ARGS + [ctypes.c_void_p] * 3,
    "refine": _COMMON_ARGS + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
              + [ctypes.c_void_p] * 4,
}


def _launch(entry: str, origins, scal, pyramid, geom: Geometry, *outputs):
    global pass1_launches, refine_launches
    lib = cuda_build.load("classify_blocks")
    fn = getattr(lib, f"classify_{entry}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[entry]

    layout = np.ascontiguousarray(np.concatenate(geom.layout), dtype=np.int32)
    # The runtime API launches on the current device: make the tensors' own
    # device current (another device's context cannot use their pointers).
    with torch.cuda.device(origins.device):
        err = fn(origins.data_ptr(), origins.shape[0], scal.data_ptr(), pyramid.data_ptr(),
                 pyramid.numel(), layout.ctypes.data, len(geom.layout[0]), geom.height,
                 geom.width, geom.trunc, *geom.corner, *outputs,
                 torch.cuda.current_stream(origins.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"classify_blocks {entry} kernel launch failed: CUDA error {err}")
    if entry == "pass1":
        pass1_launches += 1
    else:
        refine_launches += 1


def _check(origins, scal, pyramid, *others) -> bool:
    """Checks the inputs; True for CPU tensors (the plain version), False
    for CUDA tensors (the kernel)."""
    device = origins.device
    if not all(x.device == device for x in (scal, pyramid, *others)):
        raise ValueError("origins, scalars, pyramid and classes must share a device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if origins.dim() != 2 or origins.shape[1] != 3 or origins.dtype != torch.float32:
        raise ValueError("origins must be (nb, 3) float32")
    if origins.shape[0] == 0:
        raise ValueError("there must be at least one block")
    if scal.shape != (NUM_SCALARS,) or scal.dtype != torch.float32:
        raise ValueError(f"scal must be ({NUM_SCALARS},) float32")
    if pyramid.dim() != 1 or pyramid.dtype != torch.int32:
        raise ValueError("pyramid must be a 1-D int32 tensor")
    if device.type == "cpu":
        return True
    if not all(x.is_contiguous() for x in (origins, scal, pyramid, *others)):
        raise ValueError("origins, scalars, pyramid and classes must be contiguous")
    return False


def classify_pass1(origins, scal, pyramid, geom: Geometry, cap: int) -> torch.Tensor:
    """Pass-1 classes (nb,) int32 of every block: the kernel for CUDA
    tensors, the plain version for CPU tensors.

    ``origins`` (nb, 3) f32 block origins (world); ``scal`` (16,) f32
    (:func:`classify_scalars`); ``pyramid`` the frame's flat int32 pyramid;
    ``cap`` the compaction capacity (``>= nb``: every block is queried)."""
    if _check(origins, scal, pyramid):
        return classify_pass1_plain(origins, scal, pyramid, geom, cap)
    nb = origins.shape[0]
    classes = torch.empty((nb,), dtype=torch.int32, device=origins.device)
    if cap >= nb:
        _launch("pass1", origins, scal, pyramid, geom, classes.data_ptr(), None)
        return classes
    candidate = torch.empty((nb,), dtype=torch.bool, device=origins.device)
    _launch("pass1", origins, scal, pyramid, geom, classes.data_ptr(), candidate.data_ptr())
    return cap_candidates(classes, candidate, cap)


def classify_refine(classes, origins, scal, pyramid, geom: Geometry, cap: int,
                    windows: bool):
    """The refine pass: re-classify the first ``cap`` BAND blocks of
    ``classes`` (nb,) int32 in place with 5x5 cells two levels finer (a block
    not in front of the camera keeps BAND). Returns (dmin_blk, dmax_blk,
    free_ok_blk) (nb,) when ``windows``, else (None, None, None). The kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if classes.shape != (origins.shape[0],) or classes.dtype != torch.int32:
        raise ValueError("classes must be (nb,) int32")
    if _check(origins, scal, pyramid, classes):
        return classify_refine_plain(classes, origins, scal, pyramid, geom, cap, windows)
    nb, device = origins.shape[0], origins.device
    rank = band_rank(classes)
    out = ((torch.empty((nb,), dtype=torch.float32, device=device),
            torch.empty((nb,), dtype=torch.float32, device=device),
            torch.empty((nb,), dtype=torch.bool, device=device)) if windows
           else (None, None, None))
    _launch("refine", origins, scal, pyramid, geom, classes.data_ptr(), rank.data_ptr(), cap,
            *(None if x is None else x.data_ptr() for x in out))
    return out
