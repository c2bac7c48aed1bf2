"""Isosurface extraction from a TSDF volume: marching tetrahedra.

Counterpart of ``hive_tpu/ops/marching.py`` (``extract_isosurface`` :690,
``extract_isosurface_blocked`` :1008, ``check_blocked_colour_addressing``
:770, ``weld_and_assemble`` :881), in three passes:

1. **Active cubes (device)** — cubes whose 8 corners are all observed and
   straddle the zero level set, from the dense observed/inside planes (the
   block-major state is transposed once; at the budget's 320M voxels the
   boolean planes are a few hundred MB of card memory). Sorted linear cube
   ids, the order every emission path shares.
2. **Triangle emission (device, chunked)** — each active cube splits into 6
   tetrahedra around the main diagonal; a 16-case table gives up to two
   triangles per tet, vertices interpolate along tet edges, orientation
   follows the per-tet SDF gradient. Each emitted vertex leaves the device
   as three 32-bit lanes: the weld key's lo corner, colour | edge code, and
   16-bit edge fraction | oct-encoded normal.
3. **Weld (host)** — vertices on one grid edge weld exactly; the native
   weld (``hive_tpu_torch.native``) decodes positions, colours and averaged
   normals for the unique vertices.

The float arithmetic of pass 2 is the JAX package's, operation for
operation (with the one multiply-add XLA fuses written as an FMA), so both
packages emit the same faces, positions and colours from the same state.
Normals can differ by one step of their 8-bit oct code: XLA's CPU ``rsqrt``
is an approximation that rounds differently from ``torch.rsqrt``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hive_tpu_torch import on_device

# ---------------------------------------------------------------------------
# Static geometry tables.
# ---------------------------------------------------------------------------

# Cube corner offsets; corner id bit layout: bit2 = dx, bit1 = dy, bit0 = dz.
CORNER_OFFSETS = np.array([
    [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
], dtype=np.int32)

# Six tetrahedra per cube, all sharing the main diagonal (corner 0 → corner 7).
TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype=np.int32)

# The 6 edges of a tetrahedron as (local corner a, local corner b) slot pairs.
TET_EDGES = np.array([
    [0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3],
], dtype=np.int32)

# For each of the 16 inside/outside sign cases (bit i set = tet corner i is
# inside, i.e. sdf < 0): up to two triangles, each as 3 edge slots. -1 = none.
_N = -1
TET_TRIANGLE_TABLE = np.array([
    [[_N, _N, _N], [_N, _N, _N]],  # 0000
    [[0, 1, 2], [_N, _N, _N]],     # 0001: corner 0 inside
    [[0, 3, 4], [_N, _N, _N]],     # 0010: corner 1 inside
    [[1, 3, 4], [1, 4, 2]],        # 0011: corners 0, 1
    [[1, 3, 5], [_N, _N, _N]],     # 0100: corner 2 inside
    [[0, 3, 5], [0, 5, 2]],        # 0101: corners 0, 2
    [[0, 1, 5], [0, 5, 4]],        # 0110: corners 1, 2
    [[2, 4, 5], [_N, _N, _N]],     # 0111: corner 3 outside
    [[2, 4, 5], [_N, _N, _N]],     # 1000: corner 3 inside
    [[0, 4, 5], [0, 5, 1]],        # 1001: corners 0, 3
    [[0, 2, 5], [0, 5, 3]],        # 1010: corners 1, 3
    [[1, 3, 5], [_N, _N, _N]],     # 1011: corner 2 outside
    [[1, 2, 4], [1, 4, 3]],        # 1100: corners 2, 3
    [[0, 3, 4], [_N, _N, _N]],     # 1101: corner 1 outside
    [[0, 1, 2], [_N, _N, _N]],     # 1110: corner 0 outside
    [[_N, _N, _N], [_N, _N, _N]],  # 1111
], dtype=np.int32)

# Lane-flat static index maps. 36 lanes cover both per-tet spaces:
# edge space  e = tet*6 + edge_slot; vert space  w = tet*6 + tri*3 + vert.
_LANE_TET36 = np.repeat(np.arange(6), 6)                       # lane -> tet
_LANE_J36 = np.tile(np.arange(6), 6)                           # lane -> slot 0..5
_EDGE_A = TETS[_LANE_TET36, TET_EDGES[_LANE_J36, 0]]           # lane -> corner id
_EDGE_B = TETS[_LANE_TET36, TET_EDGES[_LANE_J36, 1]]
_TAB6_FLAT = TET_TRIANGLE_TABLE.reshape(16, 6).reshape(-1)     # (96,)
_SWAP36 = (np.arange(36) // 3) * 3 + np.array([0, 2, 1])[np.arange(36) % 3]
_TRI_OF_LANE36 = np.arange(36) // 3                            # vert lane -> tri 0..11
_TET_OF_TRI12 = np.arange(12) // 2                             # tri -> tet

# Per-lane edge direction codes: per-axis corner delta d in {-1, 0, +1}
# packed as (d+1) into 2-bit fields (x in bits [0:2], y [2:4], z [4:6]).
# The snap code 0b010101 (= 21) is the all-zero delta.
_EDGE_DELTA = (CORNER_OFFSETS[_EDGE_B] - CORNER_OFFSETS[_EDGE_A])  # (36, 3)


def _encode_edge_delta(d):
    return ((d[:, 0] + 1) | ((d[:, 1] + 1) << 2) | ((d[:, 2] + 1) << 4)).astype(np.int64)


_CODE_FWD = _encode_edge_delta(_EDGE_DELTA)                    # (36,)
_CODE_BWD = _encode_edge_delta(-_EDGE_DELTA)
_CODE_SNAP = 0b010101

# Static per-tet SDF-gradient coefficients (adjugate of the tet edge vectors).
_E1 = (CORNER_OFFSETS[TETS[:, 1]] - CORNER_OFFSETS[TETS[:, 0]]).astype(np.float64)
_E2 = (CORNER_OFFSETS[TETS[:, 2]] - CORNER_OFFSETS[TETS[:, 0]]).astype(np.float64)
_E3 = (CORNER_OFFSETS[TETS[:, 3]] - CORNER_OFFSETS[TETS[:, 0]]).astype(np.float64)
_C23 = np.cross(_E2, _E3)
_C31 = np.cross(_E3, _E1)
_C12 = np.cross(_E1, _E2)
_DET = np.einsum("ij,ij->i", _E1, _C23)
_GC1 = (_C23 / _DET[:, None]).astype(np.float32)               # (6, 3)
_GC2 = (_C31 / _DET[:, None]).astype(np.float32)
_GC3 = (_C12 / _DET[:, None]).astype(np.float32)

EMISSION_LANES = ("klo", "colcode", "fracnrm")


class _Tables:
    """The static tables as tensors on one device."""

    def __init__(self, device):
        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.edge_a, self.edge_b = t(_EDGE_A), t(_EDGE_B)
        self.tab6 = t(_TAB6_FLAT)
        self.lane_tet, self.lane_j = t(_LANE_TET36), t(_LANE_J36)
        self.swap, self.tri_of_lane = t(_SWAP36), t(_TRI_OF_LANE36)
        self.tet_of_tri = t(_TET_OF_TRI12)
        self.tets = t(TETS)
        self.code_fwd, self.code_bwd = t(_CODE_FWD), t(_CODE_BWD)
        self.corner_offsets = t(CORNER_OFFSETS)
        self.offs_a = [t(CORNER_OFFSETS[_EDGE_A, a], torch.float32) for a in range(3)]
        self.offs_b = [t(CORNER_OFFSETS[_EDGE_B, a], torch.float32) for a in range(3)]
        self.gc = [t(g, torch.float32) for g in (_GC1, _GC2, _GC3)]


# ---------------------------------------------------------------------------
# Pass 1: active cubes.
# ---------------------------------------------------------------------------

def _cube_corner_reduce(observed, inside):
    """(X, Y, Z) observed/inside planes -> (X-1, Y-1, Z-1) active-cube mask;
    the 8-corner AND/OR reductions factor separably over the three axes."""
    all_observed = observed
    any_inside = inside
    all_inside = inside

    for axis in range(3):
        lo = tuple(slice(0, -1) if a == axis else slice(None) for a in range(3))
        hi = tuple(slice(1, None) if a == axis else slice(None) for a in range(3))
        all_observed = all_observed[lo] & all_observed[hi]
        any_inside = any_inside[lo] | any_inside[hi]
        all_inside = all_inside[lo] & all_inside[hi]

    return all_observed & any_inside & ~all_inside


def decode_active_coords(lin: torch.Tensor, dims) -> torch.Tensor:
    """Linear cube ids (over the (X-1, Y-1, Z-1) cube grid) -> (A, 3) coords."""
    cy, cz = dims[1] - 1, dims[2] - 1
    return torch.stack([torch.div(lin, cy * cz, rounding_mode="floor"),
                        torch.div(lin, cz, rounding_mode="floor") % cy,
                        lin % cz], dim=-1)


def _active_cubes(observed, inside) -> torch.Tensor:
    """Sorted linear active-cube ids of dense (X, Y, Z) planes."""
    return torch.nonzero(_cube_corner_reduce(observed, inside).reshape(-1)).reshape(-1)


def blocked_to_dense(blocked: torch.Tensor, grid_blocks, block_size) -> torch.Tensor:
    """(nb, BV) z-major block rows (canonical x-major block order) ->
    (X, Y, Z), keeping the dtype."""
    nbx, nby, nbz = grid_blocks
    bx, by, bz = block_size
    a = blocked.reshape(nbx, nby, nbz, bz, bx, by).permute(0, 4, 1, 5, 2, 3)
    return a.reshape(nbx * bx, nby * by, nbz * bz)


# ---------------------------------------------------------------------------
# Pass 2: triangle emission.
# ---------------------------------------------------------------------------

def _state_voxel_address(x, y, z, *, grid_blocks, block_size):
    """Global voxel coords -> (block id, in-block offset) for the block-major
    sparse state: block = ((x//Bx)*nby + y//By)*nbz + z//Bz, in-block order
    z-major (i = iz*Bx*By + ix*By + iy)."""
    _, nby, nbz = grid_blocks
    bx, by, bz = block_size
    block = (torch.div(x, bx, rounding_mode="floor") * nby
             + torch.div(y, by, rounding_mode="floor")) * nbz \
        + torch.div(z, bz, rounding_mode="floor")
    off = ((z % bz) * bx + (x % bx)) * by + (y % by)
    return block, off


def _corner_lin(cube_idx, dims, tables):
    """(M, 3) cube base indices -> (M, 8) global dense corner ids."""
    _, Y, Z = dims
    base = (cube_idx[:, 0] * Y + cube_idx[:, 1]) * Z + cube_idx[:, 2]
    co = tables.corner_offsets
    off_lin = (co[:, 0] * Y + co[:, 1]) * Z + co[:, 2]
    return base[:, None] + off_lin[None, :]


def _pack_colour(channels):
    """Three (...) float colour planes -> r | g << 8 | b << 16 (int64)."""
    packed = 0
    for shift, c in zip((0, 8, 16), channels):
        packed = packed | (torch.clamp(torch.round(c.to(torch.float32)), 0, 255)
                           .to(torch.int64) << shift)
    return packed


def _emit_core(s8, packed8, corner_lin, cube_idx, tables):
    """Emit triangles for (M, 3) active cubes, lane-flat.

    Inputs: s8 (M, 8) f32 signed distances, packed8 (M, 8) int64 colours,
    corner_lin (M, 8) int64 global corner ids (the weld keys). Returns the
    (3, 3*T) int64 lane matrix of the T valid triangles' vertices — klo,
    colour | edge code << 24, frac16 | oct normal << 16 — in cube then lane
    order (the order the JAX package's compaction keeps).
    """
    T = tables
    f32 = torch.float32
    ea, eb = T.edge_a, T.edge_b

    sa = s8[:, ea]                                                       # (M, 36)
    sb = s8[:, eb]
    la = corner_lin[:, ea]
    lb = corner_lin[:, eb]

    denom = sa - sb
    frac = sa / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)       # t: a -> b
    frac = torch.clamp(frac, 0.0, 1.0)

    # Snap crossings that land (within eps) on a grid corner onto it, and
    # canonicalise their weld key to that corner.
    snap_a = frac <= 1e-5
    snap_b = frac >= 1.0 - 1e-5
    frac = torch.where(snap_a, 0.0, torch.where(snap_b, 1.0, frac))

    def lerp_pos(axis):
        a, b = T.offs_a[axis], T.offs_b[axis]
        return (cube_idx[:, axis, None].to(f32) + a[None, :]) + frac * (b - a)[None, :]

    # Positions only orient triangles; the host rebuilds them from the weld
    # key and fraction.
    px, py, pz = lerp_pos(0), lerp_pos(1), lerp_pos(2)                   # (M, 36)

    col36 = 0
    for shift in (0, 8, 16):
        ch = ((packed8 >> shift) & 0xFF).to(f32)
        ca, cb = ch[:, ea], ch[:, eb]
        # One fused multiply-add, as XLA contracts ``ca + frac * (cb - ca)``
        # (torch.addcmul is an FMA on both devices), so both packages round
        # the interpolated channel the same way.
        c = torch.clamp(torch.round(torch.addcmul(ca, frac, cb - ca)), 0, 255)
        c = c.to(torch.int64)
        col36 = col36 | (c << shift)                                     # (M, 36)

    kmin = torch.minimum(la, lb)
    klo = torch.where(snap_a, la, torch.where(snap_b, lb, kmin))
    fwd = klo == la

    code36 = torch.where(snap_a | snap_b, _CODE_SNAP,
                         torch.where(fwd, T.code_fwd[None, :], T.code_bwd[None, :]))

    # Edge fraction re-measured along the canonical (klo -> khi) direction.
    frac_c = torch.where(fwd, frac, 1.0 - frac)

    inside8 = (s8 < 0.0).to(torch.int64)
    tets = T.tets
    case = (inside8[:, tets[:, 0]] | (inside8[:, tets[:, 1]] << 1)
            | (inside8[:, tets[:, 2]] << 2) | (inside8[:, tets[:, 3]] << 3))  # (M, 6)
    case_l = case[:, T.lane_tet]                                         # (M, 36)
    vert_sel = T.tab6[case_l * 6 + T.lane_j[None, :]]                    # (M, 36)
    valid36 = vert_sel >= 0
    eidx = T.lane_tet[None, :] * 6 + torch.clamp(vert_sel, min=0)

    def sel(a):
        return torch.gather(a, 1, eidx)

    v_px, v_py, v_pz = sel(px), sel(py), sel(pz)                         # (M, 36)
    v_col = sel(col36)
    v_klo = sel(klo)
    v_code = sel(code36)
    v_frac = sel(frac_c)

    # Orientation: flip triangles whose normal opposes the per-tet SDF
    # gradient (inside is negative).
    ds1 = s8[:, tets[:, 1]] - s8[:, tets[:, 0]]                          # (M, 6)
    ds2 = s8[:, tets[:, 2]] - s8[:, tets[:, 0]]
    ds3 = s8[:, tets[:, 3]] - s8[:, tets[:, 0]]

    def grad(axis):
        return (ds1 * T.gc[0][None, :, axis] + ds2 * T.gc[1][None, :, axis]
                + ds3 * T.gc[2][None, :, axis])

    gx, gy, gz = grad(0), grad(1), grad(2)                               # (M, 6)

    p0x, p1x, p2x = v_px[:, 0::3], v_px[:, 1::3], v_px[:, 2::3]          # (M, 12)
    p0y, p1y, p2y = v_py[:, 0::3], v_py[:, 1::3], v_py[:, 2::3]
    p0z, p1z, p2z = v_pz[:, 0::3], v_pz[:, 1::3], v_pz[:, 2::3]
    e1x, e1y, e1z = p1x - p0x, p1y - p0y, p1z - p0z
    e2x, e2y, e2z = p2x - p0x, p2y - p0y, p2z - p0z
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x

    gxt = gx[:, T.tet_of_tri]                                            # (M, 12)
    gyt = gy[:, T.tet_of_tri]
    gzt = gz[:, T.tet_of_tri]
    flip = (nx * gxt + ny * gyt + nz * gzt) < 0.0                        # (M, 12)
    flip36 = flip[:, T.tri_of_lane]                                      # (M, 36)

    def unflip(a):
        return torch.where(flip36, a[:, T.swap], a)

    v_col = unflip(v_col)
    v_klo = unflip(v_klo)
    v_code = unflip(v_code)
    v_frac = unflip(v_frac)

    # Per-vertex normal: the (outward) tet gradient, oct-encoded 8+8 bits.
    gxl, gyl, gzl = (g[:, T.lane_tet] for g in (gx, gy, gz))
    inv_len = torch.rsqrt(gxl * gxl + gyl * gyl + gzl * gzl + 1e-20)
    nxl, nyl, nzl = gxl * inv_len, gyl * inv_len, gzl * inv_len

    l1 = torch.clamp(torch.abs(nxl) + torch.abs(nyl) + torch.abs(nzl), min=1e-12)
    ox, oy = nxl / l1, nyl / l1
    fold_x = (1.0 - torch.abs(oy)) * torch.where(ox >= 0, 1.0, -1.0)
    fold_y = (1.0 - torch.abs(ox)) * torch.where(oy >= 0, 1.0, -1.0)
    ox = torch.where(nzl < 0, fold_x, ox)
    oy = torch.where(nzl < 0, fold_y, oy)
    ex = torch.clamp(torch.round((ox + 1.0) * 127.5), 0, 255).to(torch.int64)
    ey = torch.clamp(torch.round((oy + 1.0) * 127.5), 0, 255).to(torch.int64)
    v_nrm = ex | (ey << 8)

    # Drop degenerate triangles (two vertices sharing one weld key).
    k0, k1, k2 = v_klo[:, 0::3], v_klo[:, 1::3], v_klo[:, 2::3]          # (M, 12)
    c0, c1, c2 = v_code[:, 0::3], v_code[:, 1::3], v_code[:, 2::3]
    dup = (((k0 == k1) & (c0 == c1)) | ((k1 == k2) & (c1 == c2))
           | ((k0 == k2) & (c0 == c2)))
    tri_valid = valid36[:, 0::3] & ~dup                                  # (M, 12)

    idx_tri = torch.nonzero(tri_valid.reshape(-1)).reshape(-1)
    # Vertex lane w = tri*3 + vert within a row of 36, so the (M, 36)
    # row-major flattening IS the per-vertex order of (M, 12) triangles.
    idxv = (idx_tri[:, None] * 3 + torch.arange(3, device=idx_tri.device)).reshape(-1)

    def gather_flat(a):
        return a.reshape(-1)[idxv]

    fq = torch.clamp(torch.round(v_frac * 65535.0), 0, 65535).to(torch.int64)
    return torch.stack([gather_flat(v_klo),
                        gather_flat(v_col | (v_code << 24)),
                        gather_flat(fq | (v_nrm << 16))])


def _empty_mesh() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The (vertices, faces, colors, normals) tuple of an empty extraction."""
    return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
            np.zeros((0, 3), np.uint8), np.zeros((0, 3), np.float32))


def check_blocked_colour_addressing(num_voxels: int) -> None:
    """Refuse volumes past the JAX package's int32 colour-address limit.

    The port addresses with int64, but keeps the JAX package's refusal
    (``hive_tpu/ops/marching.py:770``) so both packages accept the same
    volumes.
    """
    if 3 * num_voxels >= 2 ** 31:
        raise NotImplementedError(
            f"blocked extraction addresses colour as (block*3+ch)*BV+off in "
            f"int32; {num_voxels:,d} voxels overflows it (limit ~715M)")


def _extract(lin, emits, dims, origin, voxel_size: float, chunk_size: int):
    """Chunked emission over sorted active-cube ids, then the host weld.

    ``emits``: (device, emit) pairs; chunk i goes to ``emits[i % len]``, its
    ids copied to that device and the emission queued with it current.
    Emission keeps the cubes' order, so the lanes, taken back in chunk
    order, are the same stream whatever the split."""
    if lin.numel() == 0:
        return _empty_mesh()
    parts = []
    for i, start in enumerate(range(0, lin.numel(), chunk_size)):
        device, emit = emits[i % len(emits)]
        with on_device(device):
            cube_idx = decode_active_coords(lin[start:start + chunk_size].to(device), dims)
            parts.append(emit(cube_idx).cpu())
    lanes = torch.cat(parts, dim=1).numpy()
    flat = {"klo": lanes[0].astype(np.int32),
            "colcode": lanes[1].astype(np.uint32),
            "fracnrm": lanes[2].astype(np.uint32)}
    return weld_and_assemble(flat, dims, origin, voxel_size)


def extract_isosurface(tsdf, weight, color, origin, voxel_size: float,
                       chunk_size: int = 1 << 16):
    """Extract the zero level set of a dense TSDF volume.

    :param tsdf: (X, Y, Z) signed distances (tensor; its device runs passes
        1 and 2).
    :param weight: (X, Y, Z) observation weights (0 = never observed).
    :param color: RGB as channel planes (3, X, Y, Z) or channel-last
        (X, Y, Z, 3).
    :param origin: (3,) world position of voxel (0, 0, 0).
    :param voxel_size: edge length of a voxel in meters.
    :return: (vertices (V, 3) f32 world coords, faces (F, 3) int64,
        vertex colors (V, 3) uint8, vertex normals (V, 3) f32).
    """
    tsdf = torch.as_tensor(tsdf)
    weight = torch.as_tensor(weight, device=tsdf.device)
    color = torch.as_tensor(color, device=tsdf.device)
    dims = tuple(tsdf.shape)
    tables = _Tables(tsdf.device)

    lin = _active_cubes(weight > 0.0, tsdf < 0.0)

    if color.shape == (*dims, 3):
        planes = [color[..., ch].reshape(-1) for ch in range(3)]
    else:
        planes = [color[ch].reshape(-1) for ch in range(3)]
    color_flat = _pack_colour(planes)
    tsdf_flat = tsdf.reshape(-1)

    def emit(cube_idx):
        corner_lin = _corner_lin(cube_idx, dims, tables)
        s8 = tsdf_flat[corner_lin].to(torch.float32)
        return _emit_core(s8, color_flat[corner_lin], corner_lin, cube_idx, tables)

    return _extract(lin, [(tsdf.device, emit)], dims, origin, voxel_size, chunk_size)


def extract_isosurface_blocked(tsdf_b, weight_b, color_b, *, grid_blocks,
                               block_size, origin, voxel_size: float,
                               chunk_size: int = 1 << 16, devices=None):
    """Extract the zero level set straight from block-major sparse state
    (tsdf/weight ``(nb, BV)``, colour ``(nb, 3*BV)`` channel segments,
    canonical x-major block order). Emission gathers its cube corners from
    the blocked arrays; only the boolean active-cube planes go dense.

    :param devices: the devices of a mesh (one may repeat): the state is
        copied once to each, and chunk i of the active cubes emits on
        ``devices[i % len(devices)]``, each chunk a power of two of at
        least 512 and at most ``chunk_size`` cubes that splits the cubes
        evenly where it can (``hive_tpu``'s ``get_mesh_sharded`` sizing).
        Default: the state's device alone, in chunks of ``chunk_size``.
    :return: (vertices (V, 3) f32 world coords, faces (F, 3) int64,
        vertex colors (V, 3) uint8, vertex normals (V, 3) f32).
    """
    grid_blocks = tuple(int(g) for g in grid_blocks)
    block_size = tuple(int(b) for b in block_size)
    dims = tuple(g * b for g, b in zip(grid_blocks, block_size))
    check_blocked_colour_addressing(int(np.prod(dims)))
    bv = int(np.prod(block_size))

    observed = weight_b > 0
    inside = observed & (tsdf_b < 0)
    lin = _active_cubes(blocked_to_dense(observed, grid_blocks, block_size),
                        blocked_to_dense(inside, grid_blocks, block_size))
    del observed, inside

    def emitter(device):
        tables = _Tables(device)
        tsdf_flat = tsdf_b.reshape(-1).to(device)
        color_flat = color_b.reshape(-1).to(device)

        def emit(cube_idx):
            xyz = cube_idx[:, :, None] + tables.corner_offsets.T[None]   # (M, 3, 8)
            block, off = _state_voxel_address(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                              grid_blocks=grid_blocks,
                                              block_size=block_size)
            s8 = tsdf_flat[block * bv + off].to(torch.float32)
            packed8 = _pack_colour([color_flat[(block * 3 + ch) * bv + off]
                                    for ch in range(3)])
            return _emit_core(s8, packed8, _corner_lin(cube_idx, dims, tables),
                              cube_idx, tables)

        return emit

    if devices is None:
        devices = [tsdf_b.device]
    else:
        devices = [torch.device(d) for d in devices]
        per_device = -(-lin.numel() // len(devices))
        chunk_size = min(chunk_size, 1 << max(9, (max(per_device, 1) - 1).bit_length()))
    replicas = {d: emitter(d) for d in dict.fromkeys(devices)}
    return _extract(lin, [(d, replicas[d]) for d in devices], dims, origin, voxel_size,
                    chunk_size)


# ---------------------------------------------------------------------------
# Pass 3: host weld.
# ---------------------------------------------------------------------------

def weld_and_assemble(flat, dims, origin, voxel_size: float):
    """Host-side weld + mesh assembly over the emission lanes ``flat``
    (``klo`` int32, ``colcode`` / ``fracnrm`` uint32): the native one-pass
    weld when g++ is available, else the numpy pipeline.

    :return: (vertices (V, 3) f32 world coords, faces (F, 3) int64,
        vertex colors (V, 3) uint8, vertex normals (V, 3) f32).
    """
    from hive_tpu_torch.native import extract_assemble, weld_unique

    native = extract_assemble(flat["klo"], flat["colcode"], flat["fracnrm"],
                              dims, voxel_size, np.asarray(origin, np.float64))
    if native is not None:
        return native

    # Numpy fallback. Weld key: (lo corner id, 6-bit edge direction code).
    code_all = flat["colcode"] >> 24
    keys = (flat["klo"].astype(np.uint64) << np.uint64(6)) | code_all
    first_idx, inverse = weld_unique(keys)

    packed = flat["colcode"][first_idx]
    colors = np.stack([packed & 0xFF, (packed >> 8) & 0xFF,
                       (packed >> 16) & 0xFF], axis=-1).astype(np.uint8)

    # Rebuild positions for the unique vertices from the lo corner, the edge
    # code's per-axis deltas and the dequantised fraction.
    klo_u = flat["klo"][first_idx].astype(np.int64)
    code_u = packed >> 24
    frac_u = ((flat["fracnrm"][first_idx] & 0xFFFF).astype(np.float32)
              * np.float32(1.0 / 65535.0))
    YZ = dims[1] * dims[2]
    pos = np.empty((len(first_idx), 3), np.float32)
    for axis, lo in enumerate((klo_u // YZ, (klo_u // dims[2]) % dims[1],
                               klo_u % dims[2])):
        delta = ((code_u >> (2 * axis)) & 3).astype(np.float32) - 1.0
        pos[:, axis] = lo.astype(np.float32) + frac_u * delta

    vertices = (pos * voxel_size + np.asarray(origin)).astype(np.float32)
    faces = inverse.reshape(-1, 3).astype(np.int64)

    # 8+8 oct normals expanded to the snorm16x2 layout (x * 257 maps 0..255
    # onto 0..65535 exactly).
    p8 = flat["fracnrm"] >> 16
    nrm16 = ((p8 & 0xFF) * np.uint32(257)) | (((p8 >> 8) * np.uint32(257)) << 16)
    normals = _decode_oct_average(nrm16, inverse, len(first_idx))

    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return vertices, faces[ok], colors, normals


def _decode_oct_average(packed, inverse, num_unique: int) -> np.ndarray:
    """Decode per-emitted-vertex oct normals and average them per welded
    vertex (native single pass when available)."""
    from hive_tpu_torch.native import oct_average

    native = oct_average(packed, inverse, num_unique)
    if native is not None:
        return native

    ux = (packed & 0xFFFF).astype(np.float32) * (2.0 / 65535.0) - 1.0
    uy = ((packed >> 16) & 0xFFFF).astype(np.float32) * (2.0 / 65535.0) - 1.0

    nz = 1.0 - np.abs(ux) - np.abs(uy)
    neg = nz < 0.0
    fold_x = (1.0 - np.abs(uy)) * np.where(ux >= 0.0, 1.0, -1.0)
    fold_y = (1.0 - np.abs(ux)) * np.where(uy >= 0.0, 1.0, -1.0)
    nx = np.where(neg, fold_x, ux).astype(np.float32)
    ny = np.where(neg, fold_y, uy).astype(np.float32)

    acc = np.empty((num_unique, 3), np.float32)
    for c, comp in enumerate((nx, ny, nz)):
        acc[:, c] = np.bincount(inverse, weights=comp, minlength=num_unique)

    length = np.sqrt(np.einsum("ij,ij->i", acc, acc))
    acc /= np.where(length < 1e-12, 1.0, length)[:, None]
    return acc
