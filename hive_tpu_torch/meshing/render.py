"""Triangle rasterisation on the card (z-buffered, barycentric).

Counterpart of ``hive_tpu/meshing/render.py``: ``render_mesh``,
``render_scene`` and ``_sample_texture_bilinear``, with the same results —
the uint8 image and the float32 depth (0 where empty), pixel centres at
integer coordinates, perspective-correct interpolation through 1/z, the
``1e-8`` / ``1e-6`` / ``1e-12`` guards, and a strict ``>`` z-test, so that
where two triangles tie the lower face index wins.

The reference walks every triangle over every pixel (a ``lax.scan``): its
work is pixels x triangles. Here the work follows the triangles' footprints:

1. the vertices project in float32 as XLA:CPU rounds ``x @ M.T`` (one
   fused multiply-add chain from the first term);
2. each drawable face (all three depths above 1e-6, |area| above 1e-12)
   gets the pixels the reference's rounding can put inside it (below);
3. the candidate (face, pixel) pairs are made in chunks, and each is
   evaluated with the reference's arithmetic: the edge functions
   ``a*b - c*d`` as XLA:CPU contracts them, ``fma(a, b, -(c*d))``, the
   barycentrics as true divisions by the area, 1/z as
   ``fma(b2, iz2, fma(b0, iz0, b1*iz1))``;
4. one ``scatter_reduce`` amax per chunk keeps, per pixel, the largest key
   (1/z's float32 bits high, the inverted face index low): the largest 1/z,
   and of equal ones the lowest face, as the reference's strict ``>`` scan;
5. the winner's attributes are re-interpolated per pixel with the same
   operations, then divided by 1/z.

The footprint. A float32 edge function ``fma(a, b, -(c*d))`` rounds its
two differences, its product and its sum: it is off by at most
``8u |e| |P - v|`` (u = 2^-24, e the edge, v the vertex it subtracts), so a
pixel P the reference puts inside lies within ``delta = 8u max|P - v|`` of
the inner side of every edge: in the triangle offset by ``delta``. That
triangle reaches ``delta / sin(a/2) <= 2 delta / s`` beyond the face (s the
sine of its smallest angle), so with ``c = 32u`` (a factor 2 to spare):

- a face with ``s > 2c`` takes its pixel bounding box widened on each side
  by ``max(1, ceil(c * diam / (s - c)))`` pixels (diam its longest edge);
  that is one pixel unless ``s < c * (diam + 1)``;
- a thinner face (an edge-on face projects to a near-line) takes the band
  of pixels within ``h + c * R`` of its longest edge's line across the
  frame (h its height over that edge, R a bound on |P - v| over the
  frame): its offset triangle lies in that band however far it reaches,
  and pixel centres on the line far beyond the face do come out inside.

A float32 fused multiply-add is ``core.numerics.fma_f32``, correctly
rounded on the card and the CPU alike, as XLA:CPU's FMA rounds. The
reference pads faces and vertices to powers of two for its jit cache; the
padding faces are degenerate and draw nothing, so none is needed here.
Textures are sampled on the device in float64, numpy's promotion of the
reference's float32 UVs minus int64 texel indices, in numpy's order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.core.numerics import fma_f32
from hive_tpu_torch.meshing.mesh import Scene, TriangleMesh

# Candidate (face, pixel) pairs evaluated at once.
CHUNK_CANDIDATES = 1 << 23

_FACE_MASK = 0xFFFFFFFF


def _matmul_t(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m.T`` for (N, 3) x (3, 3) as XLA:CPU rounds it: an FMA chain
    from the first term."""
    out = x[:, 0:1] * m[:, 0]
    out = fma_f32(x[:, 1:2], m[:, 1], out)
    return fma_f32(x[:, 2:3], m[:, 2], out)


def _edge(a, b, c, d) -> torch.Tensor:
    """``a*b - c*d`` as XLA:CPU contracts it: ``fma(a, b, -(c*d))``."""
    return fma_f32(a, b, -(c * d))


def _interpolate(b0, b1, b2, v0, v1, v2) -> torch.Tensor:
    """``b0*v0 + b1*v1 + b2*v2`` as XLA:CPU contracts it."""
    return fma_f32(b2, v2, fma_f32(b0, v0, b1 * v1))


class _Faces:
    """Per-face quantities of the reference's scan body, for a subset of
    faces."""

    def __init__(self, screen, inv_depth, attrs, faces):
        p = screen[faces]                                    # (F, 3, 2)
        self.x0, self.y0 = p[:, 0, 0], p[:, 0, 1]
        self.x1, self.y1 = p[:, 1, 0], p[:, 1, 1]
        self.x2, self.y2 = p[:, 2, 0], p[:, 2, 1]
        self.inv_z = inv_depth[faces]                        # (F, 3)
        self.attrs = attrs[faces]                            # (F, 3, C)
        self.area = _edge(self.x1 - self.x0, self.y2 - self.y0,
                          self.y1 - self.y0, self.x2 - self.x0)

    def barycentrics(self, f, xs, ys):
        """b0, b1, b2 of faces ``f`` (indices into this subset) at pixel
        centres (xs, ys), as the reference computes them."""
        x0, y0, x1, y1, x2, y2 = (v[f] for v in (self.x0, self.y0, self.x1, self.y1,
                                                 self.x2, self.y2))
        w0 = _edge(x2 - x1, ys - y1, y2 - y1, xs - x1)
        w1 = _edge(x0 - x2, ys - y2, y0 - y2, xs - x2)
        w2 = _edge(x1 - x0, ys - y0, y1 - y0, xs - x0)
        area = self.area[f]
        safe_area = torch.where(area.abs() < 1e-12, 1e-12, area)
        return w0 / safe_area, w1 / safe_area, w2 / safe_area


# The footprint's rounding margin, 32u (see the module docstring).
_MARGIN = 32 * 2.0 ** -24


class _Strips(NamedTuple):
    """Per-face candidate pixels: ``n_major`` lines from ``lo_major`` along
    the major axis (x, or y where ``transposed``), each ``n_minor`` pixels
    from ``floor(base + slope * major)`` along the other axis. A box has
    slope 0; a band follows a line."""

    transposed: torch.Tensor
    lo_major: torch.Tensor
    n_major: torch.Tensor
    n_minor: torch.Tensor
    base: torch.Tensor
    slope: torch.Tensor


def _footprints(tri: _Faces, drawable: torch.Tensor, height: int, width: int) -> _Strips:
    """The pixels each drawable face's arithmetic can put inside it: a
    widened bounding box, or for a near-line face a band along its line
    (the module docstring derives both)."""
    xs = torch.stack([tri.x0, tri.x1, tri.x2], 1).double()
    ys = torch.stack([tri.y0, tri.y1, tri.y2], 1).double()
    drawable = drawable & torch.isfinite(xs).all(dim=1) & torch.isfinite(ys).all(dim=1)
    xs, ys = torch.where(drawable[:, None], xs, 0.0), torch.where(drawable[:, None], ys, 0.0)

    # Edge i runs from vertex i + 1 to vertex i + 2, opposite vertex i.
    dx = torch.roll(xs, -2, 1) - torch.roll(xs, -1, 1)
    dy = torch.roll(ys, -2, 1) - torch.roll(ys, -1, 1)
    lengths = torch.hypot(dx, dy)
    cross = ((xs[:, 1] - xs[:, 0]) * (ys[:, 2] - ys[:, 0])
             - (ys[:, 1] - ys[:, 0]) * (xs[:, 2] - xs[:, 0])).abs()
    ordered = torch.sort(lengths, dim=1).values
    diam, longest = lengths.max(dim=1)
    sine = cross / torch.clamp(ordered[:, 2] * ordered[:, 1], min=1e-300)
    thin = sine <= 2 * _MARGIN

    # Boxes: the bounding box of pixel centres, widened.
    pad = torch.ceil(_MARGIN * diam / torch.clamp(sine - _MARGIN, min=_MARGIN))
    pad = torch.where(thin, 0.0, torch.clamp(pad, 1, width + height))
    lo_x = torch.clamp(torch.floor(xs.min(dim=1).values) - pad, 0, width)
    hi_x = torch.clamp(torch.ceil(xs.max(dim=1).values) + pad, -1, width - 1)
    lo_y = torch.clamp(torch.floor(ys.min(dim=1).values) - pad, 0, height)
    hi_y = torch.clamp(torch.ceil(ys.max(dim=1).values) + pad, -1, height - 1)

    # Bands: within h + c * R of the longest edge's line, across the frame.
    rows = torch.arange(len(xs), device=xs.device)
    ex, ey = dx[rows, longest], dy[rows, longest]
    ax, ay = torch.roll(xs, -1, 1)[rows, longest], torch.roll(ys, -1, 1)[rows, longest]
    reach = (xs.abs() + ys.abs()).max(dim=1).values + width + height
    half_width = cross / torch.clamp(diam, min=1e-300) + _MARGIN * reach
    transposed = ey.abs() > ex.abs()
    run = torch.where(transposed, ey, ex)
    rise = torch.where(transposed, ex, ey)
    slope = rise / torch.where(run == 0, 1.0, run)
    k = torch.ceil(half_width * diam / torch.clamp(run.abs(), min=1e-300))
    n_band = 2 * k + 2
    full = n_band >= torch.where(transposed, width, height)
    band = thin & ~full & drawable
    # A band too wide for the frame is the whole frame.
    lo_x, lo_y = (torch.where(thin & full, 0.0, v) for v in (lo_x, lo_y))
    hi_x = torch.where(thin & full, width - 1.0, hi_x)
    hi_y = torch.where(thin & full, height - 1.0, hi_y)

    box_w = torch.clamp(hi_x - lo_x + 1, min=0)
    box_h = torch.clamp(hi_y - lo_y + 1, min=0)
    n_major = torch.where(band, torch.where(transposed, height, width), box_w) * drawable
    return _Strips(
        transposed=band & transposed,
        lo_major=torch.where(band, 0.0, lo_x).long(),
        n_major=n_major.long(),
        n_minor=torch.where(band, n_band, box_h).long(),
        base=torch.where(band, torch.where(transposed, ax - ay * slope, ay - ax * slope) - k,
                         lo_y),
        slope=torch.where(band, slope, 0.0))


def _rasterize(vertices: torch.Tensor, faces: torch.Tensor, attrs: torch.Tensor,
               K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, height: int,
               width: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Rasterise (V, 3) float32 vertices / (F, 3) int64 faces with (V, C)
    float32 attributes on their device.

    :return: ((H, W, C) float32 attributes, 0 where nothing was hit; (H, W)
        float32 depth, 0 where empty; the number of candidate pixels
        evaluated).
    """
    device = vertices.device
    cam = _matmul_t(vertices, R) + t.reshape(3)
    depth = cam[:, 2]
    safe_depth = torch.where(depth.abs() < 1e-8, 1e-8, depth)
    uvw = _matmul_t(cam, K)
    screen = uvw[:, :2] / safe_depth[:, None]
    inv_depth = torch.ones_like(safe_depth) / safe_depth
    tri_attrs = attrs * inv_depth[:, None]

    tri = _Faces(screen, inv_depth, tri_attrs, faces)
    strips = _footprints(tri, (depth[faces] > 1e-6).all(dim=1) & (tri.area.abs() > 1e-12),
                         height, width)
    counts = strips.n_major * strips.n_minor

    keep = torch.nonzero(counts > 0)[:, 0]
    counts = counts[keep]
    transposed, lo_major, n_minor, base, slope = (
        v[keep] for v in (strips.transposed, strips.lo_major, strips.n_minor, strips.base,
                          strips.slope))
    ends = torch.cumsum(counts, 0)
    ends_host = ends.cpu().numpy()
    total = int(ends_host[-1]) if len(ends_host) else 0

    zkey = torch.zeros(height * width, dtype=torch.int64, device=device)
    inverted = _FACE_MASK - keep                             # lower face, larger key
    first = 0
    while first < len(keep):
        before = int(ends_host[first - 1]) if first else 0
        last = max(int(np.searchsorted(ends_host, before + CHUNK_CANDIDATES, side="right")),
                   first + 1)
        n = int(ends_host[last - 1]) - before
        local = torch.repeat_interleave(torch.arange(first, last, device=device),
                                        counts[first:last], output_size=n)
        offset = torch.arange(before, before + n, device=device) - (ends[local] - counts[local])
        major = lo_major[local] + offset // n_minor[local]
        minor = (torch.floor(base[local] + slope[local] * major).long()
                 + offset % n_minor[local])
        swap = transposed[local]
        px, py = torch.where(swap, minor, major), torch.where(swap, major, minor)
        on_frame = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        px, py = torch.clamp(px, 0, width - 1), torch.clamp(py, 0, height - 1)
        f = keep[local]
        b0, b1, b2 = tri.barycentrics(f, px.float(), py.float())
        inv_z = tri.inv_z[f]
        pix_inv_z = _interpolate(b0, b1, b2, inv_z[:, 0], inv_z[:, 1], inv_z[:, 2])
        hit = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (pix_inv_z > 0) & on_frame
        key = (pix_inv_z.view(torch.int32).long() << 32) | inverted[local]
        zkey.scatter_reduce_(0, py * width + px, torch.where(hit, key, 0), reduce="amax")
        first = last

    out_attr = torch.zeros((height * width, attrs.shape[1]), dtype=torch.float32, device=device)
    out_depth = torch.zeros(height * width, dtype=torch.float32, device=device)
    pixels = torch.nonzero(zkey > 0)[:, 0]
    if len(pixels):
        won = zkey[pixels]
        face = _FACE_MASK - (won & _FACE_MASK)
        zbuf = torch.clamp((won >> 32).int().view(torch.float32), min=1e-12)
        b0, b1, b2 = tri.barycentrics(face, (pixels % width).float(),
                                      (pixels // width).float())
        a = tri.attrs[face]
        pix_attr = _interpolate(b0[:, None], b1[:, None], b2[:, None], a[:, 0], a[:, 1], a[:, 2])
        out_attr[pixels] = pix_attr / zbuf[:, None]
        out_depth[pixels] = torch.ones_like(zbuf) / zbuf
    return (out_attr.reshape(height, width, -1), out_depth.reshape(height, width), total)


def _sample_texture_bilinear(texture: torch.Tensor, uv: torch.Tensor,
                             covered: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample an (TH, TW, 3+) uint8 texture at (H, W, 2) float32
    UVs (bottom-left origin, see meshing/texture.py); uncovered pixels give
    0. float64, as numpy promotes the reference's arithmetic."""
    th, tw = texture.shape[:2]
    tex = texture[..., :3].to(torch.float32)

    # u * tw: pack_textures puts texel centres at integer p with u = p / tw.
    us = torch.clamp(torch.clamp(uv[..., 0], 0.0, 1.0) * tw, 0.0, tw - 1)
    vs = torch.clamp((1.0 - torch.clamp(uv[..., 1], 0.0, 1.0)) * th, 0.0, th - 1)

    u0 = torch.floor(us).long()
    v0 = torch.floor(vs).long()
    u1 = torch.clamp(u0 + 1, max=tw - 1)
    v1 = torch.clamp(v0 + 1, max=th - 1)
    fu = (us.double() - u0)[..., None]
    fv = (vs.double() - v0)[..., None]

    sample = ((1 - fv) * ((1 - fu) * tex[v0, u0] + fu * tex[v0, u1])
              + fv * ((1 - fu) * tex[v1, u0] + fu * tex[v1, u1]))
    return torch.where(covered[..., None], sample, 0.0)


def render_mesh(mesh: TriangleMesh, camera_matrix: np.ndarray, rotation: np.ndarray,
                translation: np.ndarray, width: int, height: int,
                device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Render a mesh from a camera.

    Textured meshes (``mesh.uv`` + ``mesh.texture``, no vertex colours)
    rasterise perspective-correct per-pixel UVs and bilinearly sample the
    texture; vertex-coloured meshes interpolate their colours; others are
    grey (180).

    :param camera_matrix: (3, 3) intrinsics.
    :param rotation: (3, 3) world-to-camera rotation.
    :param translation: (3, 1) world-to-camera translation.
    :param device: where it renders; default ``cuda:0``.
    :return: ((H, W, 3) uint8 image, (H, W) float32 depth, 0 where empty).
    """
    return _render(mesh, camera_matrix, rotation, translation, width, height,
                   get_device(device))[:2]


def _render(mesh, camera_matrix, rotation, translation, width, height, device):
    """``render_mesh`` on ``device``, with the number of candidate pixels
    evaluated."""
    if mesh.is_empty:
        return (np.zeros((height, width, 3), np.uint8),
                np.zeros((height, width), np.float32), 0)

    textured = (mesh.vertex_colors is None and mesh.uv is not None
                and mesh.texture is not None)
    if textured:
        attrs = np.asarray(mesh.uv[:, :2], dtype=np.float32)
    elif mesh.vertex_colors is not None:
        attrs = np.asarray(mesh.vertex_colors[:, :3], dtype=np.float32)
    else:
        attrs = np.full((len(mesh.vertices), 3), 180.0, dtype=np.float32)

    def on_device(array, dtype):
        return torch.as_tensor(np.ascontiguousarray(array), device=device).to(dtype)

    attr_image, depth, candidates = _rasterize(
        on_device(np.asarray(mesh.vertices, np.float32), torch.float32),
        on_device(np.asarray(mesh.faces), torch.int64),
        on_device(attrs, torch.float32),
        on_device(np.asarray(camera_matrix, np.float32), torch.float32),
        on_device(np.asarray(rotation, np.float32), torch.float32),
        on_device(np.asarray(translation, np.float32), torch.float32),
        height, width)

    if textured:
        image = _sample_texture_bilinear(on_device(mesh.texture, torch.uint8), attr_image,
                                         covered=depth > 0)
    else:
        image = attr_image
    # np.clip(image, 0, 255).astype(np.uint8)
    return torch.clamp(image, 0, 255).to(torch.uint8).cpu().numpy(), depth.cpu().numpy(), candidates


def render_scene(scene: Scene, camera_matrix: np.ndarray, rotation: np.ndarray,
                 translation: np.ndarray, width: int, height: int,
                 device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Render every mesh of a scene into one image: each renders alone, and
    the nearest depth wins (a mesh later in the scene only where strictly
    nearer)."""
    return render_scene_counted(scene, camera_matrix, rotation, translation, width, height,
                                device)[:2]


def render_scene_counted(scene: Scene, camera_matrix: np.ndarray, rotation: np.ndarray,
                         translation: np.ndarray, width: int, height: int,
                         device=None) -> Tuple[np.ndarray, np.ndarray, int]:
    """``render_scene``, with the number of candidate (face, pixel) pairs
    its meshes evaluated: the rasteriser's work for the view."""
    device = get_device(device)
    image = np.zeros((height, width, 3), np.uint8)
    depth = np.zeros((height, width), np.float32)
    candidates = 0

    for mesh in scene.geometry.values():
        mesh_image, mesh_depth, count = _render(mesh, camera_matrix, rotation, translation,
                                                width, height, device)
        candidates += count
        closer = (mesh_depth > 0) & ((depth == 0) | (mesh_depth < depth))
        image[closer] = mesh_image[closer]
        depth[closer] = mesh_depth[closer]

    return image, depth, candidates
