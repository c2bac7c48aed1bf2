"""SIFT on tensors, at OpenCV's defaults: the detector and descriptor that
``hive_tpu`` runs as ``cv2.SIFT_create(nfeatures=...).detectAndCompute``
(``hive_tpu/pose_optimisation.py:234``, ``hive_tpu/sfm.py:55``).

The steps follow OpenCV 5.0.0's ``sift.dispatch.cpp`` / ``sift.simd.hpp``:

- the base: the grey image as float32, doubled with ``INTER_LINEAR`` (what
  ``INTER_LINEAR_EXACT`` falls back to for float input), blurred by
  ``sqrtf(1.6f^2 - 4 * 0.5f^2)``;
- the Gaussian pyramid: three layers an octave plus three, each layer the
  previous one blurred by the incremental sigma; each next octave the
  nearest-neighbour half of layer 3; the difference-of-Gaussian layers;
- the extrema of the 3x3x3 neighbourhoods above ``floor(0.5 * 0.04 / 3 *
  255)``, refined by up to five Newton steps, then the contrast and edge
  tests;
- one keypoint for each peak of the smoothed 36-bin orientation histogram
  at or above 0.8 of its highest;
- duplicates removed, the best ``nfeatures`` by response kept (ties at the
  cut kept too), coordinates halved (octave -1), then the mask applied;
- the 4x4x8 descriptor with trilinear spreading, clipped at 0.2,
  renormalised, scaled by 512 and saturated to uint8, stored as float32.

Every stage works on whole tensors on the image's device: the candidates,
keypoints and window samples are batched, never looped over one by one.

The blur reproduces OpenCV's float separable filter to the bit: the row
pass accumulates ``fma(x_k, k_k, s)`` tap by tap from the left, the column
pass ``fma(x_{+k} + x_{-k}, k_k, s)`` from the centre out, each FMA correctly
rounded (``core.numerics.fma_f32``); the columns past OpenCV's last whole
vector take its scalar loop's separate roundings. ``fastAtan2`` and ``magnitude`` follow OpenCV's FMA forms the
same way. ``exp``, ``sqrt``, ``pow``, ``sin`` and ``cos`` run in float64 and
round once, so they give the same float32 on every device and every split
of the work. The Newton steps, the tests and the histograms run in plain
float32; OpenCV's vectorised build fuses some of those multiply-adds and
uses its own ``exp``, so a keypoint near a threshold can fall the other way
(``tests/test_torch_sift.py`` states the shares that agree). The orientation
and descriptor histograms add each window's samples in OpenCV's order
(``ops.ordered_hist``), on the card as on the CPU, so the card's keypoints
and descriptors equal the CPU's bit for bit.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from hive_tpu_torch.core.numerics import f32, fma_f32
from hive_tpu_torch.ops.ordered_hist import ordered_hist

N_OCTAVE_LAYERS = 3
CONTRAST_THRESHOLD = 0.04
EDGE_THRESHOLD = 10.0
SIGMA = 1.6
FIRST_OCTAVE = -1
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_HIST_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 3 * ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_HIST_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0

_F32_EPS = float(np.finfo(np.float32).eps)


def _chunk_samples(device: torch.device) -> int:
    """Samples of one chunk of keypoint windows (keypoints x window pixels):
    a few chunks on the card, whose memory holds them; smaller on the
    host."""
    return 1 << 24 if device.type == "cuda" else 1 << 21


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of float32 ``x`` in float64, rounded once to float32: the
    correctly rounded result (but in rare double-rounding cases) on every
    device, where float32 kernels differ by an ulp between vector and
    scalar paths, and so between runs that split the work differently."""
    return fn(x.double()).float()


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` divided on ``a``'s device (a CUDA tensor divided by a host
    scalar is multiplied by its reciprocal instead)."""
    return a / torch.full_like(a, b)


# ---------------------------------------------------------------------------
# Grey conversion and the pyramid.
# ---------------------------------------------------------------------------

def rgb_to_grey(rgb: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)`` of uint8 RGB (..., 3):
    OpenCV 5's 15-bit fixed point, ``(9798 R + 19235 G + 3735 B + 2^14) >>
    15``."""
    x = rgb[..., :3].to(torch.int32)
    y = (x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + 16384) >> 15
    return y.to(torch.uint8)


def _cv_round(x: float) -> int:
    """OpenCV's ``cvRound`` of a double: to nearest, ties to even."""
    return int(np.rint(x))


def gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_32F)`` with the size that
    ``GaussianBlur`` picks for float images, ``cvRound(sigma * 8 + 1) | 1``."""
    # getGaussianKernelBitExact: double arithmetic on the half kernel, the
    # centre tap 1, the sum doubled, then each tap times 1 / sum.
    n = _cv_round(sigma * 4 * 2 + 1) | 1
    scale2 = -0.125 / (sigma * sigma)
    half = [math.exp(float(x * x) * scale2) for x in range(1 - n, 0, 2)]
    total = 0.0
    for t in half:
        total += t
    total = total * 2 + 1.0
    inv = 1.0 / total
    taps = [t * inv for t in half]
    return np.array(taps + [inv] + taps[::-1], np.float32)


@functools.lru_cache(maxsize=None)
def _reflect101(length: int, r: int) -> np.ndarray:
    """OpenCV's ``BORDER_REFLECT_101`` source index of each position in
    [-r, length + r), for any overhang."""
    index = np.arange(-r, length + r)
    if length == 1:
        return np.zeros_like(index)
    period = 2 * length - 2
    index = np.remainder(index, period)
    return np.where(index >= length, period - index, index)


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(image, (0, 0), sigma, sigma)`` of a 2-D float32
    image, bit for bit: OpenCV's row pass, then its symmetric column pass,
    with ``BORDER_REFLECT_101``."""
    kernel = gaussian_kernel(sigma)
    n = len(kernel)
    r = n // 2
    height, width = image.shape
    device = image.device

    # OpenCV's vector loops fuse each multiply-add (a correctly rounded
    # float32 FMA here); the columns past the last whole vector (4 lanes in
    # the row pass, 8 in the column pass) take its scalar loop, which rounds
    # the product and the sum apart.
    row_vec, col_vec = width // 4 * 4, width // 8 * 8
    taps = torch.tensor(kernel, dtype=torch.float64, device=device)[:, None]

    cols = torch.from_numpy(_reflect101(width, r)).to(device)
    padded = image[:, cols]
    acc = torch.zeros((height, row_vec), dtype=torch.float32, device=device)
    tail = padded[:, row_vec:width] * float(kernel[0])
    for k in range(n):
        acc = fma_f32(padded[:, k:k + row_vec], taps[k], acc)
        if k and width > row_vec:
            tail = tail + padded[:, row_vec + k:width + k] * float(kernel[k])
    acc = torch.cat([acc, tail], dim=1)

    rows = torch.from_numpy(_reflect101(height, r)).to(device)
    padded = acc[rows]
    out = padded[r:r + height, :col_vec] * float(kernel[r])
    tail = padded[r:r + height, col_vec:] * float(kernel[r])
    pair = torch.empty((height, width), dtype=torch.float32, device=device)
    for k in range(1, r + 1):
        torch.add(padded[r + k:r + k + height], padded[r - k:r - k + height], out=pair)
        out = fma_f32(pair[:, :col_vec], taps[r + k], out)
        if width > col_vec:
            tail = tail + pair[:, col_vec:] * float(kernel[r + k])
    return torch.cat([out, tail], dim=1)


def resize_linear_2x(image: torch.Tensor) -> torch.Tensor:
    """``cv2.resize`` of a 2-D float32 image to twice its size with
    ``INTER_LINEAR``: the horizontal pass, then the vertical; output ``d``
    samples ``(d + 0.5) / 2 - 0.5`` clamped to the edges, as ``a + (b - a) *
    t`` in one float32 FMA (OpenCV 5.0.0's IPP path; the same arithmetic as
    ``models.maskrcnn.resize_linear_f32``)."""
    def axis_pass(x: torch.Tensor, axis: int) -> torch.Tensor:
        n_in = x.shape[axis]
        pos = (np.arange(2 * n_in) + 0.5) * 0.5 - 0.5
        low = np.floor(pos).astype(np.int64)
        frac = pos - low
        frac[low < 0] = 0.0
        low = np.maximum(low, 0)
        frac[low >= n_in - 1] = 0.0
        low = np.minimum(low, n_in - 1)
        high = np.minimum(low + 1, n_in - 1)
        shape = [1, 1]
        shape[axis] = 2 * n_in
        t = torch.from_numpy(frac.astype(np.float32).reshape(shape)).to(x.device)
        low_t = torch.from_numpy(low).to(x.device)
        high_t = torch.from_numpy(high).to(x.device)
        a = torch.index_select(x, axis, low_t)
        b = torch.index_select(x, axis, high_t)
        return fma_f32(b - a, t, a)

    return axis_pass(axis_pass(image, 1), 0)


def octave_sigmas() -> List[float]:
    """The incremental blur of each layer of an octave over the one below
    (``buildGaussianPyramid``); entry 0 is the base's total sigma."""
    sig = [SIGMA]
    k = 2.0 ** (1.0 / N_OCTAVE_LAYERS)
    for i in range(1, N_OCTAVE_LAYERS + 3):
        prev = k ** (i - 1) * SIGMA
        total = prev * k
        sig.append(math.sqrt(total * total - prev * prev))
    return sig


def base_image(grey: torch.Tensor) -> torch.Tensor:
    """``createInitialImage``: the uint8 grey image as float32, doubled and
    blurred to sigma 1.6 (the input is assumed blurred by 0.5)."""
    sigma = np.float32(SIGMA)
    init = np.float32(0.5)
    sig_diff = np.sqrt(max(sigma * sigma - init * init * np.float32(4), np.float32(0.01)))
    return gaussian_blur(resize_linear_2x(grey.float()), float(np.float32(sig_diff)))


def num_octaves(height: int, width: int) -> int:
    """OpenCV's octave count for a ``height x width`` input (base doubled)."""
    return _cv_round(math.log(min(2 * height, 2 * width)) / math.log(2.0) - 2) - FIRST_OCTAVE


def gaussian_pyramid(base: torch.Tensor, octaves: int) -> List[torch.Tensor]:
    """Per octave, its ``N_OCTAVE_LAYERS + 3`` Gaussian layers (L, H, W)."""
    sig = octave_sigmas()
    pyramid = []
    for o in range(octaves):
        if o == 0:
            layers = [base]
        else:
            prev = pyramid[-1][N_OCTAVE_LAYERS]
            layers = [prev[0:(prev.shape[0] // 2) * 2:2, 0:(prev.shape[1] // 2) * 2:2]
                      .contiguous()]
        for i in range(1, N_OCTAVE_LAYERS + 3):
            layers.append(gaussian_blur(layers[-1], sig[i]))
        pyramid.append(torch.stack(layers))
    return pyramid


def dog_pyramid(gaussians: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per octave, the ``N_OCTAVE_LAYERS + 2`` difference-of-Gaussian layers."""
    return [g[1:] - g[:-1] for g in gaussians]


# ---------------------------------------------------------------------------
# Keypoints.
# ---------------------------------------------------------------------------

@dataclass
class SiftFeatures:
    """Keypoints and descriptors on the device, in OpenCV's units: ``xy``
    (N, 2) pixel coordinates, ``size``, ``angle`` (degrees), ``response``
    and ``octave`` (OpenCV's packed int) of shape (N,), ``descriptors`` (N,
    128) float32 holding whole numbers in [0, 255]."""

    xy: torch.Tensor
    size: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    descriptors: torch.Tensor

    def __len__(self) -> int:
        return int(self.xy.shape[0])

    @property
    def pt(self) -> np.ndarray:
        """The keypoints' (x, y) on the host, float32: ``kp.pt`` of each."""
        return self.xy.cpu().numpy()


class _Flat:
    """A list of (L, H, W) stacks as one flat buffer, with each stack's
    offset and size, so that samples from all octaves gather at once."""

    def __init__(self, stacks: List[torch.Tensor]):
        device = stacks[0].device
        self.data = torch.cat([s.reshape(-1) for s in stacks])
        sizes = [s.numel() for s in stacks]
        self.offset = torch.tensor(np.cumsum([0] + sizes[:-1]), dtype=torch.int64,
                                   device=device)
        self.height = torch.tensor([s.shape[1] for s in stacks], dtype=torch.int64,
                                   device=device)
        self.width = torch.tensor([s.shape[2] for s in stacks], dtype=torch.int64,
                                  device=device)

    def at(self, octave, layer, row, col) -> torch.Tensor:
        h, w = self.height[octave], self.width[octave]
        return self.data[self.offset[octave] + (layer * h + row) * w + col]


def _window3(d: torch.Tensor, op) -> torch.Tensor:
    """``op`` over each 3x3x3 neighbourhood of a (L, H, W) stack: (L-2,
    H-2, W-2)."""
    d = op(op(d[:-2], d[1:-1]), d[2:])
    d = op(op(d[:, :-2], d[:, 1:-1]), d[:, 2:])
    return op(op(d[..., :-2], d[..., 1:-1]), d[..., 2:])


def _find_extrema(dogs: List[torch.Tensor]) -> torch.Tensor:
    """(M, 4) int64 (octave, layer, row, col) of the DoG extrema that
    ``findScaleSpaceExtrema`` starts a refinement from."""
    threshold = math.floor(0.5 * CONTRAST_THRESHOLD / N_OCTAVE_LAYERS * 255)
    found = []
    for o, d in enumerate(dogs):
        _, h, w = d.shape
        if h <= 2 * IMG_BORDER or w <= 2 * IMG_BORDER:
            continue
        hi, lo = _window3(d, torch.maximum), _window3(d, torch.minimum)
        centre = d[1:-1, 1:-1, 1:-1]
        keep = ((centre > threshold) & (centre >= hi)) | ((centre < -threshold) & (centre <= lo))
        inner = torch.zeros_like(keep)
        inner[:, IMG_BORDER - 1:h - IMG_BORDER - 1, IMG_BORDER - 1:w - IMG_BORDER - 1] = True
        idx = torch.nonzero(keep & inner)
        idx = idx + 1
        found.append(torch.cat([torch.full_like(idx[:, :1], o), idx], dim=1))
    if not found:
        return torch.zeros((0, 4), dtype=torch.int64, device=dogs[0].device)
    return torch.cat(found)


_NEIGHBOURS = [(dl, dr, dc) for dl in (-1, 0, 1) for dr in (-1, 0, 1) for dc in (-1, 0, 1)]


def _derivatives(flat: _Flat, o, layer, r, c):
    """The gradient and Hessian of the DoG at integer positions
    (``adjustLocalExtrema``'s finite differences, in float32), from one
    gather of each position's 3x3x3 neighbourhood."""
    img_scale = f32(1.0 / 255)
    deriv_scale = f32(img_scale * 0.5)
    cross_scale = f32(img_scale * 0.25)

    h, w = flat.height[o], flat.width[o]
    steps = torch.tensor(_NEIGHBOURS, dtype=torch.int64, device=o.device)
    base = flat.offset[o] + (layer * h + r) * w + c
    index = base[:, None] + steps[:, 0] * (h * w)[:, None] + steps[:, 1] * w[:, None] + steps[:, 2]
    cube = flat.data[index]

    def v(dl, dr, dc):
        return cube[:, (dl + 1) * 9 + (dr + 1) * 3 + dc + 1]

    centre = v(0, 0, 0)
    dx = (v(0, 0, 1) - v(0, 0, -1)) * deriv_scale
    dy = (v(0, 1, 0) - v(0, -1, 0)) * deriv_scale
    ds = (v(1, 0, 0) - v(-1, 0, 0)) * deriv_scale
    v2 = centre * 2
    dxx = (v(0, 0, 1) + v(0, 0, -1) - v2) * img_scale
    dyy = (v(0, 1, 0) + v(0, -1, 0) - v2) * img_scale
    dss = (v(1, 0, 0) + v(-1, 0, 0) - v2) * img_scale
    dxy = (v(0, 1, 1) - v(0, 1, -1) - v(0, -1, 1) + v(0, -1, -1)) * cross_scale
    dxs = (v(1, 0, 1) - v(1, 0, -1) - v(-1, 0, 1) + v(-1, 0, -1)) * cross_scale
    dys = (v(1, 1, 0) - v(1, -1, 0) - v(-1, 1, 0) + v(-1, -1, 0)) * cross_scale
    return centre, (dx, dy, ds), (dxx, dyy, dss, dxy, dxs, dys)


def _solve3(grad, hess):
    """``Matx33f::solve(dD, DECOMP_LU)``: Cramer's rule in float32, zero
    where the determinant is zero."""
    b0, b1, b2 = grad
    dxx, dyy, dss, dxy, dxs, dys = hess
    a00, a01, a02 = dxx, dxy, dxs
    a10, a11, a12 = dxy, dyy, dys
    a20, a21, a22 = dxs, dys, dss
    det = (a00 * (a11 * a22 - a21 * a12) - a01 * (a10 * a22 - a20 * a12)
           + a02 * (a10 * a21 - a20 * a11))
    ok = det != 0
    d = 1 / torch.where(ok, det, torch.ones_like(det))
    x0 = d * (b0 * (a11 * a22 - a12 * a21) - a01 * (b1 * a22 - a12 * b2)
              + a02 * (b1 * a21 - a11 * b2))
    x1 = d * (a00 * (b1 * a22 - a12 * b2) - b0 * (a10 * a22 - a12 * a20)
              + a02 * (a10 * b2 - b1 * a20))
    x2 = d * (a00 * (a11 * b2 - b1 * a21) - a01 * (a10 * b2 - b1 * a20)
              + b0 * (a10 * a21 - a11 * a20))
    zero = torch.zeros_like(det)
    return (torch.where(ok, x0, zero), torch.where(ok, x1, zero), torch.where(ok, x2, zero))


def _refine(flat: _Flat, start: torch.Tensor):
    """``adjustLocalExtrema`` for all candidates at once. Returns the
    survivors' (octave, layer, row, col) and their offsets (xc, xr, xi) and
    contrast."""
    o, layer, r, c = start.unbind(1)
    device = start.device
    idx = torch.arange(len(start), device=device)
    done_idx, done_pos, done_off = [], [], []
    for _ in range(MAX_INTERP_STEPS):
        if len(idx) == 0:
            break
        _, grad, hess = _derivatives(flat, o, layer, r, c)
        x0, x1, x2 = _solve3(grad, hess)
        xc, xr, xi = -x0, -x1, -x2
        converged = (xi.abs() < 0.5) & (xr.abs() < 0.5) & (xc.abs() < 0.5)
        done_idx.append(idx[converged])
        done_pos.append(torch.stack([o, layer, r, c], 1)[converged])
        done_off.append(torch.stack([xc, xr, xi], 1)[converged])
        big = float(np.float32(np.iinfo(np.int32).max // 3))
        go = ~converged & (xi.abs() <= big) & (xr.abs() <= big) & (xc.abs() <= big)
        o, layer, r, c = o[go], layer[go], r[go], c[go]
        xc, xr, xi, idx = xc[go], xr[go], xi[go], idx[go]
        c = c + torch.round(xc).long()
        r = r + torch.round(xr).long()
        layer = layer + torch.round(xi).long()
        h, w = flat.height[o], flat.width[o]
        inside = ((layer >= 1) & (layer <= N_OCTAVE_LAYERS) & (c >= IMG_BORDER)
                  & (c < w - IMG_BORDER) & (r >= IMG_BORDER) & (r < h - IMG_BORDER))
        o, layer, r, c, idx = o[inside], layer[inside], r[inside], c[inside], idx[inside]

    pos = torch.cat(done_pos) if done_pos else start[:0]
    off = torch.cat(done_off) if done_off else torch.zeros((0, 3), device=device)
    o, layer, r, c = pos.unbind(1)
    xc, xr, xi = off.unbind(1)
    centre, grad, hess = _derivatives(flat, o, layer, r, c)
    t = fma_f32(grad[2], xi, fma_f32(grad[1], xr, grad[0] * xc))
    contr = fma_f32(centre, f32(1.0 / 255), t * 0.5)
    dxx, dyy, _, dxy, _, _ = hess
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    keep = ((contr.abs() * N_OCTAVE_LAYERS >= f32(CONTRAST_THRESHOLD)) & (det > 0)
            & (tr * tr * f32(EDGE_THRESHOLD) < f32((EDGE_THRESHOLD + 1) ** 2) * det))
    return pos[keep], off[keep], contr[keep]


def _fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``fastAtan2`` in degrees, [0, 360): its polynomial with the
    FMAs of its vectorised form."""
    deg = 180 / math.pi
    p1, p3 = f32(0.9997878412794807 * f32(deg)), f32(-0.3258083974640975 * f32(deg))
    p5, p7 = f32(0.1555786518463281 * f32(deg)), f32(-0.04432655554792128 * f32(deg))
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + f32(np.finfo(np.float64).eps))
    cc = c * c
    a = fma_f32(fma_f32(fma_f32(cc, p7, p5), cc, p3), cc, p1) * c
    a = torch.where(ax >= ay, a, 90 - a)
    a = torch.where(x < 0, 180 - a, a)
    return torch.where(y < 0, 360 - a, a)


def _magnitude(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``magnitude``: ``sqrt(fma(x, x, y * y))``."""
    return _rounded(torch.sqrt, fma_f32(x, x, y * y))


def _radius_chunks(radius: torch.Tensor, per_pixel: int = 1):
    """Index chunks of keypoints, sorted by window radius, each with the
    largest radius in it; a chunk holds about ``_chunk_samples`` samples."""
    order = torch.argsort(radius, stable=True)
    sorted_radius = radius[order].cpu().numpy()
    start = 0
    while start < len(order):
        r = int(sorted_radius[min(len(order) - 1, start)])
        side = 2 * r + 1
        count = max(1, _chunk_samples(radius.device) // (side * side * per_pixel))
        end = min(len(order), start + count)
        r = int(sorted_radius[end - 1])
        yield order[start:end], r
        start = end


def _window(r: int, device):
    """The (i, j) row and column offsets of a (2r+1)^2 window, row-major."""
    grid = torch.arange(-r, r + 1, device=device)
    return grid.repeat_interleave(2 * r + 1), grid.repeat(2 * r + 1)


def _orientation_histograms(gauss: _Flat, o, layer, r, c, scl_octv) -> torch.Tensor:
    """``calcOrientationHist`` of each keypoint: the smoothed (N, 36)
    histograms."""
    n = ORI_HIST_BINS
    device = r.device
    radius = torch.round(scl_octv * f32(ORI_RADIUS)).long()
    sigma = scl_octv * f32(ORI_SIG_FCTR)
    expf_scale = -1 / ((sigma * 2) * sigma)
    hist = torch.zeros((len(r), n), dtype=torch.float32, device=device)
    for sel, rmax in _radius_chunks(radius):
        di, dj = _window(rmax, device)
        k_o, k_l, k_r, k_c = o[sel, None], layer[sel, None], r[sel, None], c[sel, None]
        k_rad = radius[sel, None]
        y, x = k_r + di, k_c + dj
        rows, cols = gauss.height[k_o], gauss.width[k_o]
        valid = ((di.abs() <= k_rad) & (dj.abs() <= k_rad) & (y > 0) & (y < rows - 1)
                 & (x > 0) & (x < cols - 1))
        y = torch.where(valid, y, torch.ones_like(y))
        x = torch.where(valid, x, torch.ones_like(x))
        dx = gauss.at(k_o, k_l, y, x + 1) - gauss.at(k_o, k_l, y, x - 1)
        dy = gauss.at(k_o, k_l, y - 1, x) - gauss.at(k_o, k_l, y + 1, x)
        weight = _rounded(torch.exp, (di * di + dj * dj).float() * expf_scale[sel, None])
        ori = _fast_atan2(dy, dx)
        mag = _magnitude(dx, dy)
        bins = torch.round(ori * f32(n / 360)).long()
        bins = torch.where(bins >= n, bins - n, bins)
        bins = torch.where(bins < 0, bins + n, bins)
        value = torch.where(valid, weight * mag, torch.zeros_like(mag))
        hist[sel] = ordered_hist(torch.where(valid, bins, torch.zeros_like(bins)).int(),
                                 value, n)

    # [1 4 6 4 1] / 16, circular: OpenCV's vector order for the first 32
    # bins, its scalar order for the rest.
    t0 = hist
    s1 = torch.roll(hist, 1, 1) + torch.roll(hist, -1, 1)
    s2 = torch.roll(hist, 2, 1) + torch.roll(hist, -2, 1)
    vector = (t0 * f32(6 / 16) + s1 * 0.25) + s2 * 0.0625
    scalar = (s2 * 0.0625 + s1 * 0.25) + t0 * f32(6 / 16)
    vector[:, 32:] = scalar[:, 32:]
    return vector


def _orientations(hist: torch.Tensor):
    """The keypoint index and angle of each histogram peak at or above 0.8
    of the histogram's highest."""
    n = ORI_HIST_BINS
    omax = hist.max(dim=1, keepdim=True).values
    thr = omax * f32(ORI_PEAK_RATIO)
    left, right = torch.roll(hist, 1, 1), torch.roll(hist, -1, 1)
    peak = (hist > left) & (hist > right) & (hist >= thr)
    kp, j = torch.nonzero(peak, as_tuple=True)
    hl, hj, hr = left[kp, j], hist[kp, j], right[kp, j]
    bin_ = j.float() + 0.5 * (hl - hr) / ((hl - 2 * hj) + hr)
    bin_ = torch.where(bin_ < 0, n + bin_, torch.where(bin_ >= n, bin_ - n, bin_))
    angle = fma_f32(-bin_, f32(360 / n), 360.0)
    angle = torch.where((angle - 360).abs() < _F32_EPS, torch.zeros_like(angle), angle)
    return kp, angle


def _lexsort(keys) -> torch.Tensor:
    """The permutation sorting by ``keys`` (first key first), each a
    (tensor, descending) pair; stable."""
    order = torch.arange(len(keys[0][0]), device=keys[0][0].device)
    for key, descending in reversed(keys):
        order = order[torch.sort(key[order], stable=True, descending=descending)[1]]
    return order


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """(N, 1) float32 sums of squares of (N, 128) rows, in one fixed order
    (the halves added pairwise): ``sum`` reduces in another order on the
    card than on the CPU, which rounded a descriptor entry the other way."""
    acc = x * x
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc


def _descriptors(gauss: _Flat, xy, size, angle, octave) -> torch.Tensor:
    """``calcSIFTDescriptor`` of each final keypoint: (N, 128) float32."""
    d, n = DESCR_WIDTH, DESCR_HIST_BINS
    device = xy.device
    count = len(xy)
    out = torch.zeros((count, d * d * n), dtype=torch.float32, device=device)
    if count == 0:
        return out

    octv = octave & 255
    octv = torch.where(octv < 128, octv, octv - 256)
    layer = (octave >> 8) & 255
    scale = torch.where(octv >= 0, 1.0 / torch.pow(2.0, octv.float()),
                        torch.pow(2.0, (-octv).float())).float()
    scl = size * scale * 0.5
    ptf = xy * scale[:, None]
    level = octv - FIRST_OCTAVE
    ori = 360 - angle
    ori = torch.where((ori - 360).abs() < _F32_EPS, torch.zeros_like(ori), ori)

    pt_x, pt_y = torch.round(ptf[:, 0]).long(), torch.round(ptf[:, 1]).long()
    rad_ori = ori * f32(math.pi / 180)
    hist_width = scl * f32(DESCR_SCL_FCTR)
    cos_t = _rounded(torch.cos, rad_ori) / hist_width
    sin_t = _rounded(torch.sin, rad_ori) / hist_width
    radius = torch.round(hist_width * f32(1.4142135623730951) * f32((d + 1) * 0.5)).long()
    rows, cols = gauss.height[level], gauss.width[level]
    diag = torch.sqrt(rows.double() ** 2 + cols.double() ** 2).long()
    radius = torch.minimum(radius, diag)
    bins_per_rad = f32(n / 360)
    exp_scale = f32(-1.0 / (d * d * 0.5))
    hist_len = (d + 2) * (d + 2) * (n + 2)

    for sel, rmax in _radius_chunks(radius, per_pixel=8):
        di, dj = _window(rmax, device)
        di_f, dj_f = di.float(), dj.float()
        k_cos, k_sin = cos_t[sel, None], sin_t[sel, None]
        c_rot = dj_f * k_cos - di_f * k_sin
        r_rot = dj_f * k_sin + di_f * k_cos
        rbin = (r_rot + d // 2) - 0.5
        cbin = (c_rot + d // 2) - 0.5
        k_lev, k_l = level[sel, None], layer[sel, None]
        y, x = pt_y[sel, None] + di, pt_x[sel, None] + dj
        k_rows, k_cols = rows[sel, None], cols[sel, None]
        k_rad = radius[sel, None]
        valid = ((di.abs() <= k_rad) & (dj.abs() <= k_rad) & (rbin > -1) & (rbin < d)
                 & (cbin > -1) & (cbin < d) & (y > 0) & (y < k_rows - 1) & (x > 0)
                 & (x < k_cols - 1))
        y = torch.where(valid, y, torch.ones_like(y))
        x = torch.where(valid, x, torch.ones_like(x))
        dx = gauss.at(k_lev, k_l, y, x + 1) - gauss.at(k_lev, k_l, y, x - 1)
        dy = gauss.at(k_lev, k_l, y - 1, x) - gauss.at(k_lev, k_l, y + 1, x)
        weight = _rounded(torch.exp, (c_rot * c_rot + r_rot * r_rot) * exp_scale)
        obin = (_fast_atan2(dy, dx) - ori[sel, None]) * bins_per_rad
        mag = _magnitude(dx, dy) * weight
        mag = torch.where(valid, mag, torch.zeros_like(mag))

        r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
        rbin, cbin, obin = rbin - r0, cbin - c0, obin - o0
        r0, c0, o0 = r0.long(), c0.long(), o0.long()
        o0 = torch.where(o0 < 0, o0 + n, o0)
        o0 = torch.where(o0 >= n, o0 - n, o0)
        v_r1 = mag * rbin
        v_r0 = mag - v_r1
        v_rc11 = v_r1 * cbin
        v_rc10 = v_r1 - v_rc11
        v_rc01 = v_r0 * cbin
        v_rc00 = v_r0 - v_rc01
        v_rco111 = v_rc11 * obin
        v_rco110 = v_rc11 - v_rco111
        v_rco101 = v_rc10 * obin
        v_rco100 = v_rc10 - v_rco101
        v_rco011 = v_rc01 * obin
        v_rco010 = v_rc01 - v_rco011
        v_rco001 = v_rc00 * obin
        v_rco000 = v_rc00 - v_rco001
        base = ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0
        base = torch.where(valid, base, torch.zeros_like(base))
        steps = [0, 1, n + 2, n + 3, (d + 2) * (n + 2), (d + 2) * (n + 2) + 1,
                 (d + 3) * (n + 2), (d + 3) * (n + 2) + 1]
        values = [v_rco000, v_rco001, v_rco010, v_rco011, v_rco100, v_rco101, v_rco110,
                  v_rco111]
        # Sample-major, then the eight corners in OpenCV's order.
        index = torch.stack([base + s for s in steps], dim=2).reshape(len(sel), -1)
        value = torch.stack(values, dim=2).reshape(len(sel), -1)
        hist = ordered_hist(index.int(), value, hist_len)

        hist = hist.reshape(len(sel), d + 2, d + 2, n + 2)[:, 1:d + 1, 1:d + 1]
        wrapped = hist[..., :n].clone()
        wrapped[..., 0] += hist[..., n]
        wrapped[..., 1] += hist[..., n + 1]
        dst = wrapped.reshape(len(sel), d * d * n)
        nrm2 = _sum_squares(dst)
        thr = _rounded(torch.sqrt, nrm2) * f32(DESCR_MAG_THR)
        dst = torch.minimum(dst, thr)
        nrm2 = _sum_squares(dst)
        factor = f32(INT_DESCR_FCTR) / torch.clamp(_rounded(torch.sqrt, nrm2), min=_F32_EPS)
        out[sel] = torch.clamp(torch.round(dst * factor), 0, 255)
    return out


def detect_and_compute(grey: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       nfeatures: int = 0) -> SiftFeatures:
    """``cv2.SIFT_create(nfeatures).detectAndCompute(grey, mask)`` on the
    tensor's device.

    :param grey: (H, W) uint8 grey image.
    :param mask: optional (H, W) uint8; keypoints where it is 0 are dropped
        (after the ``nfeatures`` cut, as OpenCV drops them).
    :param nfeatures: keep the best this many by response (0: all).
    """
    if grey.dim() != 2:
        raise ValueError(f"detect_and_compute takes a 2-D grey image; got {tuple(grey.shape)}")
    device = grey.device
    height, width = grey.shape
    gaussians = gaussian_pyramid(base_image(grey), num_octaves(height, width))
    dogs = dog_pyramid(gaussians)
    dog_flat, gauss_flat = _Flat(dogs), _Flat(gaussians)

    pos, off, contr = _refine(dog_flat, _find_extrema(dogs))
    o, layer, r, c = pos.unbind(1)
    xc, xr, xi = off.unbind(1)
    scale_o = torch.pow(2.0, o.float())
    kp_x = (c.float() + xc) * scale_o
    kp_y = (r.float() + xr) * scale_o
    size_factor = _rounded(lambda e: torch.pow(2.0, e),
                           _div(layer.float() + xi, float(N_OCTAVE_LAYERS)))
    scl_octv = size_factor * f32(SIGMA)
    kp_size = scl_octv * scale_o * 2
    packed = (o + (layer << 8)
              + (torch.round((xi.double() + 0.5) * 255).long() << 16)).to(torch.int64)

    hist = _orientation_histograms(gauss_flat, o, layer, r, c, scl_octv)
    kp, angle = _orientations(hist)
    xy = torch.stack([kp_x[kp], kp_y[kp]], 1)
    size, response, octave = kp_size[kp], contr[kp].abs(), packed[kp]

    # removeDuplicatedSorted: sort by (x, y, -size, angle, -response, -octave)
    order = _lexsort([(xy[:, 0], False), (xy[:, 1], False), (size, True), (angle, False),
                      (response, True), (octave, True)])
    xy, size, angle, response, octave = (xy[order], size[order], angle[order],
                                         response[order], octave[order])
    if len(xy) > 1:
        same = ((xy[1:] == xy[:-1]).all(dim=1) & (size[1:] == size[:-1])
                & (angle[1:] == angle[:-1]))
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=device), ~same])
        xy, size, angle, response, octave = (xy[keep], size[keep], angle[keep],
                                             response[keep], octave[keep])

    # retainBest: the nfeatures-th response, and every keypoint tied with it.
    if 0 < nfeatures < len(xy):
        cut = torch.sort(response, descending=True).values[nfeatures - 1]
        keep = response >= cut
        xy, size, angle, response, octave = (xy[keep], size[keep], angle[keep],
                                             response[keep], octave[keep])

    # Octave -1 back to the input's scale.
    xy = xy * 0.5
    size = size * 0.5
    octave = (octave & ~255) | ((octave + FIRST_OCTAVE) & 255)

    if mask is not None:
        mr = torch.clamp((xy[:, 1] + 0.5).long(), 0, height - 1)
        mc = torch.clamp((xy[:, 0] + 0.5).long(), 0, width - 1)
        keep = mask.to(device)[mr, mc] != 0
        xy, size, angle, response, octave = (xy[keep], size[keep], angle[keep],
                                             response[keep], octave[keep])

    descriptors = _descriptors(gauss_flat, xy, size, angle, octave)
    return SiftFeatures(xy.contiguous(), size, angle, response, octave.to(torch.int32),
                        descriptors)
