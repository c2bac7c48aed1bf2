"""Mask R-CNN (ResNet-50 FPN) person instance segmentation in PyTorch.

Counterpart of ``hive_tpu/models/maskrcnn.py``: the same inference graph,
with the same fixed budgets (``PRE_NMS_TOP_N`` candidates a level,
``POST_NMS_TOP_N`` proposals, ``DETECTIONS_TOP_N`` detections, masks for
the first ``MASK_TOP_N``) and masked (score = -inf) slots, so the results
are the reference's: the RPN's one-shot matrix NMS (:func:`fast_nms`, not
greedy), exact greedy NMS for the detections as a fixed loop of argmaxes
(:func:`greedy_nms_topk`), and its ROIAlign (:func:`pyramid_roi_align`): a fixed
``CROP`` window per ROI at its FPN level, ``aligned=False`` sample
positions clamped to the window, separable hat-function weights and a 2x2
average. The modules keep the reference's names, so one
``maskrcnn_coco.npz`` serves both packages (:func:`load_params`;
:func:`convert_torch_checkpoint` writes it from torchvision's checkpoint).

Tensors are NCHW in the convolutions, NHWC in ROIAlign and the box head.
Where the reference's ROIAlign contracts the whole window with the hat
weights (two einsums), only two weights of each are non-zero, so here each
sample gathers its four taps from the ROI's own level (all ROIs of a batch
in one gather from the concatenated levels) and combines them rows first,
as the einsums do. The forward runs a batch of frames; top-k is a stable
sort (``jax.lax.top_k`` keeps the lower index first on ties, and -inf
slots tie often), the greedy NMS one argmax a step for the whole batch.

Arithmetic follows XLA:CPU where it rounds otherwise than plain torch: a
division by a constant is a multiply by its float32 reciprocal, and the
folded batch norm's ``x * scale + bias`` is one FMA (``torch.addcmul``).
The model is float32 (the reference's has no dtype). On the card the
convolutions are cuDNN's and the dense layers cuBLAS's, the counterparts of
XLA's; the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hive_tpu_torch import get_device
from hive_tpu_torch.models.flax_layers import (Conv, Dense, FlaxModule, FoldedBN,
                                               fan_in_params, load_flax_params)
from hive_tpu_torch.ops.resize import resize

# COCO class index for "person" in the 91-class torchvision head.
PERSON_CLASS = 1
NUM_CLASSES = 91

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

# Fixed budgets (static shapes), as the reference's.
PRE_NMS_TOP_N = 512      # RPN candidates per level
POST_NMS_TOP_N = 512     # proposals kept for the box head
DETECTIONS_TOP_N = 100   # final detections
MASK_TOP_N = 32          # detections that get masks
CROP = 48                # ROIAlign window side at the assigned level
SCORE_THRESHOLD = 0.5    # a detection is a person from this score on

# The RPN's anchors, torchvision's: one size a level (P2..P6), three ratios.
ANCHOR_STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)

BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)

# check_params' shaping of the heads (see there).
CLASS_GAIN = 0.1
PERSON_GAIN = 5.0
PERSON_BIAS = 7.0
MASK_GAIN = 4.0

# The weights file in $WEIGHTS_PATH, shared with hive_tpu.
WEIGHTS_FILENAME = "maskrcnn_coco.npz"


def _reciprocal(value: float) -> float:
    """The float32 reciprocal XLA multiplies by where the reference divides
    by the constant ``value``."""
    return float(np.float32(1.0) / np.float32(value))


_LOG2_RECIPROCAL = _reciprocal(float(np.log(np.float32(2.0))))


# ---------------------------------------------------------------------------
# Backbone: ResNet-50 with folded (frozen) batch norm.
# ---------------------------------------------------------------------------

class Bottleneck(FlaxModule):
    """torchvision's bottleneck: the stride on the 3x3 conv, a projection
    shortcut in the first block of a stage."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(in_features, features, 1, use_bias=False)
        self.bn1 = FoldedBN(features)
        self.conv2 = Conv(features, features, 3, stride, ((1, 1), (1, 1)), use_bias=False)
        self.bn2 = FoldedBN(features)
        self.conv3 = Conv(features, features * 4, 1, use_bias=False)
        self.bn3 = FoldedBN(features * 4)
        if downsample:
            self.downsample_conv = Conv(in_features, features * 4, 1, stride, use_bias=False)
            self.downsample_bn = FoldedBN(features * 4)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + x)


# (blocks, width) of the four stages.
_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


class ResNet50(FlaxModule):
    """Returns C2..C5 (strides 4, 8, 16, 32)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, ((3, 3), (3, 3)), use_bias=False)
        self.bn1 = FoldedBN(64)
        self.stages = []
        in_features = 64
        for stage, (blocks, features) in enumerate(_STAGES):
            names = []
            for i in range(blocks):
                name = f"layer{stage + 1}_{i}"
                stride = 2 if stage > 0 and i == 0 else 1
                self.add_module(name, Bottleneck(in_features, features, stride, i == 0))
                in_features = features * 4
                names.append(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        # flax's max_pool pads with -inf, as max_pool2d does.
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats


class FPN(FlaxModule):
    """Top-down feature pyramid: P2..P5 (the top-down path a nearest x2
    resize, ``jax.image.resize``'s), P6 a stride-2 subsample of P5."""

    def __init__(self):
        super().__init__()
        for i, c in enumerate((256, 512, 1024, 2048)):
            self.add_module(f"inner{i}", Conv(c, 256, 1))
            self.add_module(f"layer{i}", Conv(256, 256, 3))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"inner{i}")(c) for i, c in enumerate(feats)]
        outs = [None] * 4
        prev = outs[3] = laterals[3]
        for i in (2, 1, 0):
            prev = laterals[i] + resize(prev, laterals[i].shape, "nearest")
            outs[i] = prev
        ps = [getattr(self, f"layer{i}")(o) for i, o in enumerate(outs)]
        return ps + [ps[3][:, :, ::2, ::2]]


class RPNHead(FlaxModule):
    """The shared RPN head: three anchors (aspect ratios) a position."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(256, 256, 3)
        self.cls_logits = Conv(256, 3, 1)
        self.bbox_pred = Conv(256, 3 * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level, (B, H * W * A) logits and (B, H * W * A, 4) deltas in
        the anchors' (row, column, anchor) order."""
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            b = t.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return logits, deltas


class BoxHead(FlaxModule):
    def __init__(self):
        super().__init__()
        self.fc6 = Dense(7 * 7 * 256, 1024)
        self.fc7 = Dense(1024, 1024)
        self.cls_score = Dense(1024, NUM_CLASSES)
        self.bbox_pred = Dense(1024, NUM_CLASSES * 4)

    def forward(self, x: torch.Tensor):
        """(N, 7, 7, 256) NHWC ROI features (flattened in that order, as the
        converter orders fc6's columns) -> class logits and box deltas."""
        x = F.relu(self.fc6(x.reshape(x.shape[0], -1)))
        x = F.relu(self.fc7(x))
        return self.cls_score(x), self.bbox_pred(x)


class BlockDeconv2x(FlaxModule):
    """torch's ConvTranspose2d(k=2, s=2): each input pixel writes its own
    2x2 output block, ``out[2h + d, 2w + e] = x[h, w] . kernel[:, d, e]``
    (the reference's einsum). Kernel (c_in, 2, 2, out) there, (c_in, out,
    2, 2) here."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features, 2, 2), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def flax_shape(self, name):
        c_in, out = self.kernel.shape[:2]
        return (c_in, 2, 2, out) if name == "kernel" else tuple(self.bias.shape)

    def to_torch(self, name, array):
        return array.transpose(0, 3, 1, 2) if name == "kernel" else array

    def fan_in(self, name):
        return int(self.kernel.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.kernel, self.bias, stride=2)


class MaskHead(FlaxModule):
    def __init__(self):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}", Conv(256, 256, 3))
        self.conv5_mask = BlockDeconv2x(256, 256)
        self.mask_fcn_logits = Conv(256, NUM_CLASSES, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 256, 14, 14) -> (N, 91, 28, 28) logits."""
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


# ---------------------------------------------------------------------------
# Box utilities (fixed shapes; a leading batch axis is carried through).
# ---------------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the ``k`` largest, largest
    first, equal values in index order (``torch.topk`` leaves their order
    unspecified)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)):
    """Standard R-CNN box decoding. anchors / deltas: (..., 4) xyxy /
    txtytwth; the log-size deltas clipped at ``BBOX_XFORM_CLIP``."""
    wx, wy, ww, wh = (_reciprocal(w) for w in weights)
    ax0, ay0, ax1, ay1 = anchors.unbind(-1)
    aw = ax1 - ax0
    ah = ay1 - ay0
    acx = torch.addcmul(ax0, aw, torch.full_like(aw, 0.5))
    acy = torch.addcmul(ay0, ah, torch.full_like(ah, 0.5))

    dx = deltas[..., 0] * wx
    dy = deltas[..., 1] * wy
    dw = torch.clamp(deltas[..., 2] * ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] * wh, max=BBOX_XFORM_CLIP)

    cx = torch.addcmul(acx, dx, aw)
    cy = torch.addcmul(acy, dy, ah)
    half_w = torch.exp(dw) * aw * 0.5
    half_h = torch.exp(dh) * ah * 0.5
    return torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=-1)


def clip_boxes(boxes: torch.Tensor, width: float, height: float) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0.clamp(0, width), y0.clamp(0, height),
                        x1.clamp(0, width), y1.clamp(0, height)], dim=-1)


def box_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU."""
    area_a = (torch.clamp(boxes_a[..., 2] - boxes_a[..., 0], min=0)
              * torch.clamp(boxes_a[..., 3] - boxes_a[..., 1], min=0))
    area_b = (torch.clamp(boxes_b[..., 2] - boxes_b[..., 0], min=0)
              * torch.clamp(boxes_b[..., 3] - boxes_b[..., 1], min=0))
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    x0 = torch.maximum(a[..., 0], b[..., 0])
    y0 = torch.maximum(a[..., 1], b[..., 1])
    x1 = torch.minimum(a[..., 2], b[..., 2])
    y1 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def fast_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """One-shot matrix NMS (YOLACT-style): a box is kept unless a
    higher-scoring box overlaps it above the threshold, even one that is
    itself suppressed (so it drops more than greedy NMS). Boxes (..., N,
    4), scores (..., N) -> keep (..., N) in input order."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_sorted = torch.take_along_dim(boxes, order[..., None], dim=-2)
    iou = torch.triu(box_iou_matrix(boxes_sorted, boxes_sorted), diagonal=1)
    keep_sorted = iou.amax(dim=-2) <= iou_threshold
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def greedy_nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, k: int):
    """Exact greedy NMS as ``k`` steps: take the running argmax (the first
    on ties), then set it and every box overlapping it above the threshold
    to -inf. Boxes (..., N, 4), scores (..., N) -> (indices, validity), each
    (..., k): a slot is valid when its pick was above -inf."""
    iou = box_iou_matrix(boxes, boxes)
    left = scores.clone()
    picks, valid = [], []
    for _ in range(k):
        i = torch.argmax(left, dim=-1, keepdim=True)
        valid.append(torch.gather(left, -1, i) > -math.inf)
        picks.append(i)
        row = torch.take_along_dim(iou, i[..., None], dim=-2)[..., 0, :]
        left = left.masked_fill(row > iou_threshold, -math.inf).scatter(-1, i, -math.inf)
    return torch.cat(picks, dim=-1), torch.cat(valid, dim=-1)


# ---------------------------------------------------------------------------
# ROIAlign: fixed windows, separable hat weights.
# ---------------------------------------------------------------------------

def _hat_taps(pos: torch.Tensor):
    """The two non-zero hat weights ``max(0, 1 - |pos - i|)`` of window
    positions ``pos`` in [0, CROP - 1]: (low index, its weight, high index,
    its weight), the high weight 0 at the window's last index."""
    low = torch.floor(pos)
    w_low = torch.clamp(1.0 - torch.abs(pos - low), min=0)
    w_high = torch.clamp(1.0 - torch.abs(pos - (low + 1.0)), min=0)
    low = low.long()
    w_high = torch.where(low + 1 <= CROP - 1, w_high, torch.zeros_like(w_high))
    return low, w_low, torch.clamp(low + 1, max=CROP - 1), w_high


def roi_align_rows(table: torch.Tensor, base: torch.Tensor, height: torch.Tensor,
                   width: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """The reference's ``roi_align`` for ROIs on NHWC levels flattened to
    the rows of ``table`` (pixels, C): ROI ``n`` reads the level that starts
    at row ``base[n]``, ``height[n]`` x ``width[n]`` pixels (each at least
    ``CROP``), with its box (xyxy) in that level's coordinates.

    :return: (N, out_size, out_size, C); 2x2 samples a bin.
    """
    n = boxes.shape[0]
    s = out_size * 2
    x0, y0, x1, y1 = boxes.unbind(-1)
    bw = torch.clamp(x1 - x0, min=1e-3)
    bh = torch.clamp(y1 - y0, min=1e-3)

    # The window's origin, clamped so the window stays inside the level.
    cy = torch.minimum(torch.clamp(torch.floor(y0 - 1.0), min=0), (height - CROP).to(y0.dtype))
    cx = torch.minimum(torch.clamp(torch.floor(x0 - 1.0), min=0), (width - CROP).to(x0.dtype))

    # aligned=False sample positions (no half-pixel shift), relative to the
    # window and clamped to it.
    steps = (torch.arange(s, dtype=torch.float32, device=boxes.device) + 0.5) / s
    py = torch.clamp(torch.addcmul(y0[:, None], steps[None, :], bh[:, None]) - cy[:, None],
                     0.0, CROP - 1.0)
    px = torch.clamp(torch.addcmul(x0[:, None], steps[None, :], bw[:, None]) - cx[:, None],
                     0.0, CROP - 1.0)
    y_low, wy_low, y_high, wy_high = _hat_taps(py)
    x_low, wx_low, x_high, wx_high = _hat_taps(px)
    rows = (cy.long()[:, None] + torch.stack([y_low, y_high])) * width[:, None]   # (2, N, s)
    cols = cx.long()[:, None] + torch.stack([x_low, x_high])                      # (2, N, s)
    origin = base[:, None, None]

    def taps(r: int, c: int) -> torch.Tensor:   # (N, s_y, s_x, C)
        return table[origin + rows[r][:, :, None] + cols[c][:, None, :]]

    # Rows first, then columns, as the reference's two einsums contract.
    wy = (wy_low[:, :, None, None], wy_high[:, :, None, None])
    wx = (wx_low[:, None, :, None], wx_high[:, None, :, None])
    samples = None
    for c in (0, 1):
        column = taps(0, c).mul_(wy[0]).add_(taps(1, c).mul_(wy[1]))
        column.mul_(wx[c])
        samples = column if samples is None else samples.add_(column)
    # The 2x2 average.
    return samples.view(n, out_size, 2, out_size, 2, -1).mean(dim=(2, 4))


def pyramid_roi_align(pyramid: Sequence[torch.Tensor], boxes: torch.Tensor,
                      out_size: int) -> torch.Tensor:
    """FPN level assignment (torchvision's LevelMapper, k = floor(4 +
    log2(sqrt(area) / 224 + 1e-9)) clamped to P2..P5) and ROIAlign of each
    box at its level only (the reference computes all four and selects).

    :param pyramid: P2..P5 (more are ignored), each (B, C, H, W).
    :param boxes: (B, N, 4) canvas boxes.
    :return: (B, N, out_size, out_size, C)
    """
    b, n = boxes.shape[:2]
    device = boxes.device
    # Each level NHWC and zero-padded to at least CROP, as the reference
    # pads levels smaller than its window; all four as rows of one table.
    levels, bases, heights, widths = [], [0], [], []
    for p in pyramid[:4]:
        p = F.pad(p, (0, max(0, CROP - p.shape[3]), 0, max(0, CROP - p.shape[2])))
        heights.append(p.shape[2])
        widths.append(p.shape[3])
        levels.append(p.permute(0, 2, 3, 1).reshape(-1, p.shape[1]))
        bases.append(bases[-1] + levels[-1].shape[0])
    table = torch.cat(levels)

    flat = boxes.reshape(-1, 4)
    areas = (torch.clamp(flat[:, 2] - flat[:, 0], min=0)
             * torch.clamp(flat[:, 3] - flat[:, 1], min=0))
    # jnp.log2 is log(x) / log(2), the division a reciprocal multiply.
    log2 = torch.log(torch.sqrt(areas) * _reciprocal(224.0) + 1e-9) * _LOG2_RECIPROCAL
    level = torch.floor(4.0 + log2)
    level = torch.clamp(level, 2, 5).long() - 2

    extents = torch.tensor([bases[:4], heights, widths], dtype=torch.long, device=device)
    base, height, width = extents[:, level]
    base = base + torch.arange(b, device=device).repeat_interleave(n) * height * width
    # Boxes / stride: a power of two, exact.
    scale = torch.exp2(-(level + 2).to(flat.dtype))[:, None]
    out = roi_align_rows(table, base, height, width, flat * scale, out_size)
    return out.view(b, n, *out.shape[1:])


# ---------------------------------------------------------------------------
# Anchors.
# ---------------------------------------------------------------------------

def make_anchors(level_shapes):
    """Per-level (H*W*A, 4) xyxy anchor arrays (torchvision convention)."""
    all_levels = []
    for (h, w), stride, size in zip(level_shapes, ANCHOR_STRIDES, ANCHOR_SIZES):
        ws = np.asarray([size * math.sqrt(1.0 / r) for r in ANCHOR_RATIOS])
        hs = np.asarray([size * math.sqrt(r) for r in ANCHOR_RATIOS])
        base = np.stack([-ws / 2, -hs / 2, ws / 2, hs / 2], axis=1)  # (A, 4)
        base = np.round(base)

        sx = (np.arange(w) * stride).astype(np.float32)
        sy = (np.arange(h) * stride).astype(np.float32)
        cx, cy = np.meshgrid(sx, sy)
        shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)

        anchors = (shifts + base[None]).reshape(-1, 4).astype(np.float32)
        all_levels.append(anchors)
    return all_levels


# ---------------------------------------------------------------------------
# Full model.
# ---------------------------------------------------------------------------

class MaskRCNN(FlaxModule):
    """Inference graph: a batch of normalised canvases -> fixed-size
    detection arrays."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50()
        self.fpn = FPN()
        self.rpn_head = RPNHead()
        self.box_head = BoxHead()
        self.mask_head = MaskHead()
        self._anchors: Dict[tuple, List[torch.Tensor]] = {}

    def anchors(self, level_shapes, device) -> List[torch.Tensor]:
        key = (tuple(level_shapes), str(device))
        if key not in self._anchors:
            self._anchors[key] = [torch.from_numpy(a).to(device)
                                  for a in make_anchors(level_shapes)]
        return self._anchors[key]

    def forward(self, images: torch.Tensor, image_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """
        :param images: (B, 3, H, W) normalised float32 canvases.
        :param image_hw: the scaled image's extent in the canvas.
        :return: ``boxes`` (B, D, 4), ``scores`` (B, D), ``valid`` (B, D)
            and ``masks`` (B, M, 28, 28), the sigmoid person masks of the
            first M detections.
        """
        b = images.shape[0]
        pyramid = self.fpn(self.body(images))
        logits, deltas = self.rpn_head(pyramid)
        anchors = self.anchors([p.shape[2:] for p in pyramid], images.device)
        img_h, img_w = (float(v) for v in image_hw)

        # RPN proposals: a fixed budget per level.
        prop_boxes, prop_scores = [], []
        for s, d, a in zip(logits, deltas, anchors):
            top_s, top_i = top_k(s, min(PRE_NMS_TOP_N, s.shape[1]))
            boxes = decode_boxes(a[top_i], torch.take_along_dim(d, top_i[..., None], dim=1))
            boxes = clip_boxes(boxes, img_w, img_h)
            wh_ok = ((boxes[..., 2] - boxes[..., 0] >= 1e-2)
                     & (boxes[..., 3] - boxes[..., 1] >= 1e-2))
            top_s = torch.where(wh_ok, top_s, -math.inf)
            keep = fast_nms(boxes, top_s, 0.7)
            prop_boxes.append(boxes)
            prop_scores.append(torch.where(keep, top_s, -math.inf))
        top_s, top_i = top_k(torch.cat(prop_scores, dim=1), POST_NMS_TOP_N)
        proposals = torch.take_along_dim(torch.cat(prop_boxes, dim=1), top_i[..., None], dim=1)
        proposals_valid = top_s > -math.inf

        # Box head.
        box_feats = pyramid_roi_align(pyramid, proposals, 7)
        cls_scores, box_deltas = self.box_head(box_feats.flatten(0, 1))
        probs = torch.softmax(cls_scores, dim=-1).view(b, -1, NUM_CLASSES)
        person_scores = probs[..., PERSON_CLASS]
        person_deltas = box_deltas.view(b, -1, NUM_CLASSES, 4)[:, :, PERSON_CLASS]
        person_boxes = clip_boxes(decode_boxes(proposals, person_deltas,
                                               weights=(10.0, 10.0, 5.0, 5.0)), img_w, img_h)
        person_scores = torch.where(
            proposals_valid & (person_scores > 0.05)
            & (person_boxes[..., 2] - person_boxes[..., 0] >= 1e-2)
            & (person_boxes[..., 3] - person_boxes[..., 1] >= 1e-2),
            person_scores, -math.inf)

        det_idx, det_valid = greedy_nms_topk(person_boxes, person_scores, 0.5, DETECTIONS_TOP_N)
        det_boxes = torch.take_along_dim(person_boxes, det_idx[..., None], dim=1)
        det_scores = torch.where(det_valid, torch.gather(person_scores, 1, det_idx), 0.0)

        # Mask head on the first MASK_TOP_N detections.
        mask_feats = pyramid_roi_align(pyramid, det_boxes[:, :MASK_TOP_N], 14)
        mask_logits = self.mask_head(mask_feats.flatten(0, 1).permute(0, 3, 1, 2))
        masks = torch.sigmoid(mask_logits[:, PERSON_CLASS]).view(b, -1, 28, 28)
        return {"boxes": det_boxes, "scores": det_scores, "valid": det_valid, "masks": masks}


# ---------------------------------------------------------------------------
# Cost.
# ---------------------------------------------------------------------------

def maskrcnn_flops(canvas_hw: Tuple[int, int], batch: int = 1) -> int:
    """Floating-point operations of one MaskRCNN forward on a batch of
    canvases (H, W multiples of 64): 2 per multiply-add of every conv,
    dense layer and the mask head's deconv, and ROIAlign's bilinear
    samples as this port computes them (a channel of a sample: four taps
    weighted, 6 multiplies and 3 adds; a bin: the 2x2 average, 3 adds and
    a divide). Norms, softmax, box decoding and the NMSs are left out."""
    h, w = canvas_hw
    flops = 0

    def conv(cin, cout, k, oh, ow):
        nonlocal flops
        flops += 2 * cin * cout * k * k * oh * ow

    conv(3, 64, 7, h // 2, w // 2)
    size, cin = (h // 4, w // 4), 64
    for stage, (blocks, width) in enumerate(_STAGES):
        for i in range(blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            out = (size[0] // stride, size[1] // stride)
            conv(cin, width, 1, *size)
            conv(width, width, 3, *out)
            conv(width, 4 * width, 1, *out)
            if i == 0:
                conv(cin, 4 * width, 1, *out)
            size, cin = out, 4 * width
    levels = [(h // 2 ** k, w // 2 ** k) for k in (2, 3, 4, 5, 6)]
    for c, (lh, lw) in zip((256, 512, 1024, 2048), levels):
        conv(c, 256, 1, lh, lw)                                  # inner
        conv(256, 256, 3, lh, lw)                                # layer
    for lh, lw in levels:                                        # RPN head
        conv(256, 256, 3, lh, lw)
        conv(256, 3 + 12, 1, lh, lw)
    rois, masks = POST_NMS_TOP_N, MASK_TOP_N
    flops += 2 * rois * (7 * 7 * 256 * 1024 + 1024 * 1024 + 1024 * NUM_CLASSES * 5)
    for count, side in ((rois, 7), (masks, 14)):                 # ROIAlign
        flops += count * side * side * 256 * (4 * 9 + 4)
    for _ in range(4):
        flops += masks * 2 * 256 * 256 * 9 * 14 * 14             # mask_fcn1-4
    flops += masks * 2 * 256 * 256 * 4 * 14 * 14                # conv5_mask
    flops += masks * 2 * 256 * NUM_CLASSES * 28 * 28             # mask_fcn_logits
    return batch * flops


# ---------------------------------------------------------------------------
# Inference wrapper (canvas and host paste).
# ---------------------------------------------------------------------------

def canvas_geometry(input_hw: Tuple[int, int], canvas_min_side: int = 800,
                    canvas_max_side: int = 1344):
    """(scale, scaled (h, w), canvas (h, w)) of the reference's canvas: the
    frame scaled so its short side is ``canvas_min_side`` unless its long
    side would pass ``canvas_max_side``, in a canvas padded to multiples
    of 64."""
    h, w = input_hw
    scale = min(canvas_min_side / min(h, w), canvas_max_side / max(h, w))
    scaled = (int(round(h * scale)), int(round(w * scale)))
    return float(scale), scaled, (-(-scaled[0] // 64) * 64, -(-scaled[1] // 64) * 64)


def resize_linear_f32(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=cv2.INTER_LINEAR)``
    of a 2-D float32 image, as OpenCV 5.0.0 computes it through its IPP
    path: the horizontal pass, then the vertical; output ``d`` samples
    ``(d + 0.5) * in / out - 0.5`` (float64), clamped to the edge pixels;
    its fraction ``t`` rounded to float32; ``a + (b - a) * t`` as one
    float32 FMA (emulated in float64)."""
    def axis_pass(x: np.ndarray, axis: int, n_out: int) -> np.ndarray:
        n_in = x.shape[axis]
        if n_out == n_in:
            return x
        pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        low = np.floor(pos).astype(np.int64)
        frac = pos - low
        frac[low < 0] = 0.0
        low = np.maximum(low, 0)
        frac[low >= n_in - 1] = 0.0
        low = np.minimum(low, n_in - 1)
        high = np.minimum(low + 1, n_in - 1)
        shape = [1, 1]
        shape[axis] = n_out
        t = frac.astype(np.float32).astype(np.float64).reshape(shape)
        a, b = np.take(x, low, axis), np.take(x, high, axis)
        return (a + (b - a).astype(np.float64) * t).astype(np.float32)

    image = np.asarray(image, np.float32)
    return axis_pass(axis_pass(image, 1, width), 0, height)


class MaskRCNNDetector:
    """Person detection on a fixed canvas for frames of one size: the
    frames resized and normalised on the model's device, a batched forward,
    boxes and masks mapped back to the frame on the host."""

    def __init__(self, model: MaskRCNN, input_hw: Tuple[int, int] = (480, 640),
                 canvas_min_side: int = 800, canvas_max_side: int = 1344):
        self.model = model
        self.device = next(model.parameters()).device
        self.input_hw = tuple(input_hw)
        self.scale, self.scaled_hw, self.canvas_hw = canvas_geometry(
            input_hw, canvas_min_side, canvas_max_side)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._inv_std = torch.from_numpy(np.float32(1.0) / IMAGENET_STD).to(self.device)

    def canvas(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB on the device -> (B, 3, h, w) canvases."""
        b = frames.shape[0]
        (sh, sw), (ch, cw) = self.scaled_hw, self.canvas_hw
        img = frames.float() * _reciprocal(255.0)
        img = resize(img, (b, sh, sw, 3), "bilinear")
        img = (img - self._mean) * self._inv_std
        return F.pad(img.permute(0, 3, 1, 2), (0, cw - sw, 0, ch - sh))

    @torch.inference_mode()
    def forward(self, frames: np.ndarray) -> Dict[str, np.ndarray]:
        """(B, H, W, 3) uint8 RGB -> the model's fixed-size outputs on the
        host, canvas coordinates."""
        if tuple(frames.shape[1:3]) != self.input_hw:
            raise ValueError(f"frames of {frames.shape[1:3]}, the detector's are {self.input_hw}")
        images = self.canvas(torch.from_numpy(np.ascontiguousarray(frames)).to(self.device))
        out = self.model(images, self.scaled_hw)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def select(self, out: Dict[str, np.ndarray], i: int) -> Dict[str, np.ndarray]:
        """Frame ``i``'s person detections in ``forward``'s outputs: boxes,
        scores and masks at input scale, score-ordered; masks cover the
        first MASK_TOP_N detections, as the aligned ``mask_boxes`` /
        ``masks``."""
        keep = out["valid"][i] & (out["scores"][i] >= SCORE_THRESHOLD)
        keep_m = keep[:MASK_TOP_N]
        boxes = out["boxes"][i]
        return {"boxes": boxes[keep] / self.scale, "scores": out["scores"][i][keep],
                "mask_boxes": boxes[:MASK_TOP_N][keep_m] / self.scale,
                "masks": out["masks"][i][keep_m]}

    def detect_batch(self, frames: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """(B, H, W, 3) uint8 RGB -> each frame's :meth:`select`."""
        out = self.forward(frames)
        return [self.select(out, i) for i in range(len(frames))]

    def _pasted(self, det: Dict[str, np.ndarray]):
        """(region, probability) of each mask in score order: its box
        rounded outwards and clipped to the frame (boxes left empty are
        skipped), the mask resized to it as ``cv2.resize`` does."""
        h, w = self.input_hw
        for (x0, y0, x1, y1), mask in zip(det["mask_boxes"], det["masks"]):
            x0i, y0i = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
            x1i, y1i = min(int(np.ceil(x1)), w), min(int(np.ceil(y1)), h)
            if x1i > x0i and y1i > y0i:
                yield ((slice(y0i, y1i), slice(x0i, x1i)),
                       resize_linear_f32(mask, x1i - x0i, y1i - y0i))

    def paste(self, det: Dict[str, np.ndarray]) -> np.ndarray:
        """One frame's detections -> (H, W) uint8 ids (0 background, 1..N
        by score; a pixel keeps the first instance that claims it)."""
        instance = np.zeros(self.input_hw, dtype=np.uint8)
        next_id = 1
        for region, probability in self._pasted(det):
            pixels = instance[region]
            pixels[(probability > 0.5) & (pixels == 0)] = next_id
            next_id += 1
            if next_id > 255:
                break
        return instance

    def threshold_distance(self, det: Dict[str, np.ndarray]) -> np.ndarray:
        """(H, W) float32: the least |probability - 0.5| of the masks
        pasted at each pixel (inf where none is). Where it is within the
        masks' tolerance, two forwards equal within that tolerance may
        threshold a pixel differently. For checks only (the tests and
        ``chip_smoke.py`` compare instance ids away from such pixels);
        segmentation does not call it."""
        distance = np.full(self.input_hw, np.inf, dtype=np.float32)
        for region, probability in self._pasted(det):
            np.minimum(distance[region], np.abs(probability - 0.5), out=distance[region])
        return distance

    def instance_masks(self, frames: np.ndarray) -> List[np.ndarray]:
        """(B, H, W, 3) uint8 RGB -> (H, W) uint8 instance ids per frame."""
        return [self.paste(det) for det in self.detect_batch(frames)]


# ---------------------------------------------------------------------------
# Weights.
# ---------------------------------------------------------------------------

def load_params(weights, device=None) -> MaskRCNN:
    """The float32 MaskRCNN on ``device`` (default ``cuda:0``) with the
    weights of ``hive_tpu``'s npz (a path, an ``np.load`` or a flat
    mapping). Refuses a missing or unused key (``KeyError``) or a wrong
    shape (``ValueError``)."""
    with torch.device(get_device(device)):
        model = MaskRCNN().eval()
    if isinstance(weights, (str, os.PathLike)):
        with np.load(weights) as flat:
            return load_flax_params(model, flat, network="Mask R-CNN")
    return load_flax_params(model, weights, network="Mask R-CNN")


def check_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Informative random weights for checks: ``fan_in_params`` of the
    MaskRCNN (He-scaled kernels, norm scales 1 + N(0, 0.1), biases N(0,
    0.1)). Trained weights detect a person above the 0.5 threshold; random
    ones do not (a 91-way softmax gives ~0.011), so the heads are shaped:

    * each residual branch's last norm scale (``bn3``) is x0.2, so the
      backbone's activations stay bounded through its 16 blocks;
    * the class logits' kernel is centred over its inputs (the ReLU
      features it reads are all positive, so an uncentred row adds a large
      common offset) and x``CLASS_GAIN``; its person column x``PERSON_GAIN``
      more, with bias ``PERSON_BIAS``: the person probability then spreads
      over (0, 1) across proposals, a few of them over 0.5 after NMS;
    * the box regression's and the RPN's deltas are x0.1, so boxes stay
      near their anchors and proposals;
    * the person channel of the mask logits is centred the same way and
      x``MASK_GAIN``, so masks hold both sides of 0.5 with few values
      near it.
    """
    with torch.device("meta"):
        flat = fan_in_params(MaskRCNN(), seed)
    for path, host in flat.items():
        if path.endswith("bn3/scale"):
            host *= np.float32(0.2)
        if path.endswith(("bbox_pred/kernel", "bbox_pred/bias")):
            host *= np.float32(0.1)
    kernel = flat["box_head/cls_score/kernel"]
    kernel -= kernel.mean(axis=0, keepdims=True)
    kernel *= np.float32(CLASS_GAIN)
    kernel[:, PERSON_CLASS] *= np.float32(PERSON_GAIN)
    flat["box_head/cls_score/bias"][PERSON_CLASS] = np.float32(PERSON_BIAS)
    person = flat["mask_head/mask_fcn_logits/kernel"][..., PERSON_CLASS]
    flat["mask_head/mask_fcn_logits/kernel"][..., PERSON_CLASS] = \
        (person - person.mean()) * np.float32(MASK_GAIN)
    return flat


# ---------------------------------------------------------------------------
# torchvision checkpoint conversion.
# ---------------------------------------------------------------------------

def _fold_bn(state, prefix: str):
    """torchvision's FrozenBatchNorm2d (eps 1e-5) as a scale and bias."""
    gamma = state[f"{prefix}.weight"]
    beta = state[f"{prefix}.bias"]
    mean = state[f"{prefix}.running_mean"]
    var = state[f"{prefix}.running_var"]
    scale = gamma / np.sqrt(var + 1e-5)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def _first(state, *names: str) -> str:
    for name in names:
        if name in state:
            return name
    raise KeyError(f"none of {names} in checkpoint")


def convert_torch_checkpoint(torch_checkpoint_path: str, output_path: str) -> Dict[str, np.ndarray]:
    """Convert a torchvision ``maskrcnn_resnet50_fpn`` state dict into the
    flat npz that ``hive_tpu`` and this port both read, with the same keys
    and arrays as ``hive_tpu``'s converter: conv kernels HWIO, dense
    kernels (in, out), FrozenBatchNorm folded to scale and bias (eps
    1e-5), fc6's input columns reordered CHW -> HWC, the deconv kernel (C,
    2, 2, O). Takes the classic layouts and the Conv2dNormActivation ones
    of newer torchvision; every tensor must be consumed."""
    from hive_tpu_torch.models.convert_utils import TrackedState, WriteOnceDict, iter_flat_numpy

    state = torch.load(torch_checkpoint_path, map_location="cpu", weights_only=False)
    if not isinstance(state, dict) or "backbone.body.conv1.weight" not in state:
        state = state.get("model", state.get("state_dict", state))
    state = TrackedState(iter_flat_numpy(state), name="Mask R-CNN checkpoint")
    out: Dict[str, np.ndarray] = WriteOnceDict()

    def conv(src: str, dst: str, bias: bool = True):
        out[f"{dst}/kernel"] = np.transpose(state[src], (2, 3, 1, 0))
        if bias:
            out[f"{dst}/bias"] = state[src.replace("weight", "bias")]

    def bn(src: str, dst: str):
        out[f"{dst}/scale"], out[f"{dst}/bias"] = _fold_bn(state, src)

    def dense(src: str, dst: str):
        out[f"{dst}/kernel"] = state[f"{src}.weight"].T
        out[f"{dst}/bias"] = state[f"{src}.bias"]

    conv("backbone.body.conv1.weight", "body/conv1", bias=False)
    bn("backbone.body.bn1", "body/bn1")
    for stage, (blocks, _) in enumerate(_STAGES):
        for i in range(blocks):
            src, dst = f"backbone.body.layer{stage + 1}.{i}", f"body/layer{stage + 1}_{i}"
            for c in (1, 2, 3):
                conv(f"{src}.conv{c}.weight", f"{dst}/conv{c}", bias=False)
                bn(f"{src}.bn{c}", f"{dst}/bn{c}")
            if i == 0:
                conv(f"{src}.downsample.0.weight", f"{dst}/downsample_conv", bias=False)
                bn(f"{src}.downsample.1", f"{dst}/downsample_bn")

    for i in range(4):
        conv(_first(state, f"backbone.fpn.inner_blocks.{i}.weight",
                    f"backbone.fpn.inner_blocks.{i}.0.weight"), f"fpn/inner{i}")
        conv(_first(state, f"backbone.fpn.layer_blocks.{i}.weight",
                    f"backbone.fpn.layer_blocks.{i}.0.weight"), f"fpn/layer{i}")

    conv(_first(state, "rpn.head.conv.weight", "rpn.head.conv.0.0.weight"), "rpn_head/conv")
    conv("rpn.head.cls_logits.weight", "rpn_head/cls_logits")
    conv("rpn.head.bbox_pred.weight", "rpn_head/bbox_pred")

    # fc6's input columns from torch's (C, 7, 7) flatten to the (7, 7, C) one.
    w6 = state["roi_heads.box_head.fc6.weight"]
    out["box_head/fc6/kernel"] = w6.reshape(1024, 256, 7, 7).transpose(2, 3, 1, 0).reshape(-1, 1024)
    out["box_head/fc6/bias"] = state["roi_heads.box_head.fc6.bias"]
    dense("roi_heads.box_head.fc7", "box_head/fc7")
    dense("roi_heads.box_predictor.cls_score", "box_head/cls_score")
    dense("roi_heads.box_predictor.bbox_pred", "box_head/bbox_pred")

    for i in range(4):
        conv(_first(state, f"roi_heads.mask_head.mask_fcn{i + 1}.weight",
                    f"roi_heads.mask_head.{i}.0.weight"), f"mask_head/mask_fcn{i + 1}")
    # The deconv: torch (in, out, kh, kw) -> (in, kh, kw, out).
    out["mask_head/conv5_mask/kernel"] = np.transpose(
        state["roi_heads.mask_predictor.conv5_mask.weight"], (0, 2, 3, 1))
    out["mask_head/conv5_mask/bias"] = state["roi_heads.mask_predictor.conv5_mask.bias"]
    conv("roi_heads.mask_predictor.mask_fcn_logits.weight", "mask_head/mask_fcn_logits")

    # BN trip counters carry no learned state.
    state.assert_fully_consumed(ignore=(r"num_batches_tracked$",))
    np.savez(output_path, **out)
    logging.info(f"Converted Mask R-CNN checkpoint written to {output_path}")
    return dict(out)
