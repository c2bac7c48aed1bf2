"""Person instance segmentation.

Counterpart of ``hive_tpu/models/segmentation.py``, with the same mask
contract (0 = background, 1..N = instances, uint8) and its three backends,
picked by the weights in ``$WEIGHTS_PATH`` as ``PersonSegmenter`` picks
them (:215-278):

* **Mask R-CNN** (:mod:`hive_tpu_torch.models.maskrcnn`) from
  ``maskrcnn_coco.npz``: instances in score order, a batch of frames a
  forward on the device.
* **The U-Net** (:func:`build_unet`) from ``person_unet.npz``: a person
  probability, thresholded, split into 8-connected components.
* **Motion** without weights: OpenCV's MOG2 background subtractor, a 5x5
  morphological open and close, and 8-connected components. The card's
  machine has no OpenCV, so here MOG2 and the morphology run in torch on
  the pipeline's device, vectorised over pixels with a loop over the five
  mixture modes, in OpenCV's float32 operation order (its CPU path is a
  scalar loop per pixel, ``bgfg_gaussmix2.cpp``), so the masks are
  OpenCV's bit for bit.

Components are labelled on the host with scipy and renumbered into
OpenCV's order (:func:`instances_from_foreground`).
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from torch import nn

from hive_tpu_torch import get_device
from hive_tpu_torch.core.numerics import f32
from hive_tpu_torch.models import maskrcnn
from hive_tpu_torch.models.flax_layers import (Conv, FlaxModule, GroupNorm, fan_in_params,
                                               load_flax_params)

_FLT_EPSILON = float(np.finfo(np.float32).eps)


def open_close(fg: torch.Tensor) -> torch.Tensor:
    """``cv2.morphologyEx`` with a 5x5 rectangle: the open, then the close
    with ``iterations=3``, on (B, H, W) bool masks.

    OpenCV's default border neither erodes nor dilates, like the -inf
    padding of max pooling; three 5x5 iterations are one 13x13.
    """
    def dilate(x, size):
        return F.max_pool2d(x, size, stride=1, padding=size // 2)

    def erode(x, size):
        return -dilate(-x, size)

    x = fg[:, None].to(torch.float32)
    x = dilate(erode(x, 5), 5)              # open
    x = erode(dilate(x, 13), 13)            # close, iterations=3
    return x[:, 0] > 0.5


class _MotionBackend:
    """Dynamic-object masks from background subtraction (no weights needed).

    MOG2 as ``cv2.createBackgroundSubtractorMOG2(history=200,
    varThreshold=32, detectShadows=True)`` builds it, with OpenCV's other
    defaults. The state lives on ``device``, one column per pixel: five
    modes, each with a weight, a BGR mean and a variance (float32), the
    count of modes in use, and the frame count.

    Stateful: frames must arrive in video order. The background model warms up
    on the first frames, so its caller runs a priming pass over the first
    batch before emitting masks.
    """

    NMIXTURES = 5
    HISTORY = 200
    VAR_THRESHOLD = 32.0                # Tb
    BACKGROUND_RATIO = f32(0.9)        # TB
    VAR_THRESHOLD_GEN = 9.0             # Tg
    VAR_INIT, VAR_MIN, VAR_MAX = 15.0, 4.0, 75.0
    CT = f32(0.05)                     # complexity reduction prior
    SHADOW_VALUE = 127
    SHADOW_THRESHOLD = 0.5              # tau

    def __init__(self, min_area_fraction: float = 0.001, device=None):
        self.device = get_device(device)
        self.min_area_fraction = min_area_fraction
        self._primed = False
        self.nframes = 0
        self.shape = None
        self.weight = self.variance = self.mean = self.modes_used = None

    def _initialize(self, shape):
        n = shape[0] * shape[1]
        k = self.NMIXTURES
        self.shape = shape
        self.nframes = 0
        self.weight = torch.zeros((k, n), dtype=torch.float32, device=self.device)
        self.variance = torch.zeros((k, n), dtype=torch.float32, device=self.device)
        self.mean = torch.zeros((k, 3, n), dtype=torch.float32, device=self.device)
        self.modes_used = torch.zeros(n, dtype=torch.int32, device=self.device)

    def _swap(self, i: int, j: int, where: torch.Tensor):
        """Swap modes ``i`` and ``j`` (weight, variance, mean) where set."""
        for state in (self.weight, self.variance, self.mean):
            a, b = state[i].clone(), state[j]
            w = where if state.dim() == 2 else where[None]
            state[i] = torch.where(w, b, a)
            state[j] = torch.where(w, a, b)

    def apply(self, bgr: torch.Tensor) -> torch.Tensor:
        """One MOG2 step with the automatic learning rate.

        :param bgr: (H, W, 3) uint8 BGR frame on the backend's device.
        :return: (H, W) uint8: 0 background, 127 shadow, 255 foreground.
        """
        if self.nframes == 0 or tuple(bgr.shape[:2]) != self.shape:
            self._initialize(tuple(bgr.shape[:2]))
        self.nframes += 1
        rate = 1.0 / min(2 * self.nframes, self.HISTORY)
        alpha = f32(rate)
        alpha1 = f32(np.float32(1.0) - np.float32(alpha))
        prune = f32(-rate * self.CT)
        tb, tg, big_tb = self.VAR_THRESHOLD, self.VAR_THRESHOLD_GEN, self.BACKGROUND_RATIO

        data = bgr.reshape(-1, 3).T.to(torch.float32)            # (3, N)
        weights, variances, means = self.weight, self.variance, self.mean
        n = data.shape[1]
        nmodes = self.modes_used.clone()
        fits = torch.zeros(n, dtype=torch.bool, device=self.device)
        background = torch.zeros_like(fits)
        total = torch.zeros(n, dtype=torch.float32, device=self.device)
        alpha_t = torch.full((n,), alpha, dtype=torch.float32, device=self.device)

        for mode in range(self.NMIXTURES):
            # The loop bound is the pixel's mode count as pruning leaves it.
            active = nmodes > mode
            weight = weights[mode] * alpha1 + prune
            test = active & ~fits
            var = variances[mode]
            diff = means[mode] - data
            dist2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
            background |= test & (total < big_tb) & (dist2 < var * tb)
            match = test & (dist2 < var * tg)

            fitted = weight + alpha
            k = torch.div(alpha_t, fitted)
            new_var = torch.clamp(var + k * (dist2 - var), self.VAR_MIN, self.VAR_MAX)
            means[mode] = torch.where(match[None], means[mode] - k * diff, means[mode])
            variances[mode] = torch.where(match, new_var, var)
            weight = torch.where(match, fitted, weight)
            fits |= match

            # The matched mode bubbles up past modes of no larger weight.
            position = torch.full((n,), mode, dtype=torch.int32, device=self.device)
            moving = match
            for i in range(mode, 0, -1):
                moving = moving & (weight >= weights[i - 1])
                self._swap(i, i - 1, moving)
                position -= moving.to(torch.int32)

            pruned = active & (weight < -prune)
            weight = torch.where(pruned, torch.zeros_like(weight), weight)
            nmodes -= pruned.to(torch.int32)
            for j in range(mode + 1):
                weights[j] = torch.where(active & (position == j), weight, weights[j])
            total = torch.where(active, total + weight, total)

        # Renormalise; a pixel that matched nothing gets zero weights.
        inverse = torch.where(total.abs() > _FLT_EPSILON,
                              torch.div(torch.ones_like(total), total),
                              torch.zeros_like(total))
        for j in range(self.NMIXTURES):
            weights[j] = torch.where(nmodes > j, weights[j] * inverse, weights[j])

        # A pixel that matched no mode gets a new one (replacing the weakest
        # when all are in use), bubbled up past modes of no larger weight.
        new = ~fits
        full = nmodes == self.NMIXTURES
        slot = torch.where(full, nmodes - 1, nmodes)
        nmodes = torch.where(new & ~full, nmodes + 1, nmodes)
        only = nmodes == 1
        for j in range(self.NMIXTURES):
            here = new & (slot == j)
            weights[j] = torch.where(here, torch.where(only, 1.0, alpha), weights[j])
            weights[j] = torch.where(new & ~only & (slot > j), weights[j] * alpha1, weights[j])
            variances[j] = torch.where(here, self.VAR_INIT, variances[j])
            means[j] = torch.where(here[None], data, means[j])
        moving = new
        for i in range(self.NMIXTURES - 1, 0, -1):
            here = moving & (slot == i)
            swap = here & ~(weights[i - 1] > alpha)
            self._swap(i, i - 1, swap)
            slot = slot - swap.to(torch.int32)
            moving = moving & ~(here & ~swap)
        self.modes_used = nmodes

        shadow = self._shadows(data, nmodes, ~background)
        mask = torch.where(background, 0, torch.where(shadow, self.SHADOW_VALUE, 255))
        return mask.to(torch.uint8).reshape(self.shape)

    def _shadows(self, data, nmodes, todo):
        """OpenCV's ``detectShadowGMM``: a pixel is a shadow of a background
        mode if it is that mode's mean scaled by a in [tau, 1] within the
        mode's variance. Modes are read in order until their weights pass
        the background ratio."""
        tb, tau = self.VAR_THRESHOLD, self.SHADOW_THRESHOLD
        shadow = torch.zeros_like(todo)
        seen = torch.zeros_like(data[0])
        for mode in range(self.NMIXTURES):
            active = todo & (nmodes > mode)
            mean = self.mean[mode]
            numerator = data[0] * mean[0] + data[1] * mean[1] + data[2] * mean[2]
            denominator = mean[0] * mean[0] + mean[1] * mean[1] + mean[2] * mean[2]
            zero = active & (denominator == 0)
            a = torch.div(numerator, denominator)
            scaled = a * mean - data
            dist2a = scaled[0] * scaled[0] + scaled[1] * scaled[1] + scaled[2] * scaled[2]
            hit = (active & ~zero & (numerator <= denominator)
                   & (numerator >= denominator * tau)
                   & (dist2a < self.variance[mode] * tb * a * a))
            shadow |= hit
            go_on = active & ~zero & ~hit
            seen = torch.where(go_on, seen + self.weight[mode], seen)
            todo = go_on & ~(seen > self.BACKGROUND_RATIO)
        return shadow

    def prime(self, frames: torch.Tensor):
        """Warm up the background model (first batch, replayed in reverse so
        frame 0 still gets a usable mask).

        :param frames: (B, H, W, 3) uint8 RGB on the backend's device.
        """
        for frame in frames.flip(0):
            self.apply(frame.flip(-1))

        self._primed = True

    def foreground(self, frames: torch.Tensor) -> torch.Tensor:
        """MOG2 over ``frames`` in order, the shadow label dropped, then
        :func:`open_close`.

        :param frames: (B, H, W, 3) uint8 RGB on the backend's device.
        :return: (B, H, W) bool foreground.
        """
        return open_close(torch.stack([self.apply(frame.flip(-1)) >= 200 for frame in frames]))

    def instances(self, fg: np.ndarray) -> np.ndarray:
        """(H, W) bool foreground -> (H, W) uint8 instance ids
        (:func:`instances_from_foreground`)."""
        return instances_from_foreground(fg, self.min_area_fraction)


def instances_from_foreground(fg: np.ndarray, min_area_fraction: float) -> np.ndarray:
    """(H, W) bool foreground -> (H, W) uint8 instance ids, numbered as
    ``cv2.connectedComponents(..., connectivity=8)`` numbers them: by the
    first 2x2 block, in a raster scan of blocks, that holds one of their
    pixels. Components under ``min_area_fraction`` of the frame are
    dropped, and ids stop at 255."""
    labels, count = ndimage.label(fg, structure=np.ones((3, 3), dtype=bool))
    instance_mask = np.zeros(fg.shape, dtype=np.uint8)
    if count == 0:
        return instance_mask

    rows, cols = np.nonzero(labels)
    component = labels[rows, cols]
    block = (rows // 2) * ((fg.shape[1] + 1) // 2) + cols // 2
    first_block = np.full(count + 1, np.iinfo(np.int64).max)
    np.minimum.at(first_block, component, block)
    sizes = np.bincount(component, minlength=count + 1)

    lookup = np.zeros(count + 1, dtype=np.uint8)
    next_id = 1
    for label in np.argsort(first_block[1:], kind="stable") + 1:
        if sizes[label] < min_area_fraction * fg.size:
            continue

        if next_id > 255:
            break
        lookup[label] = next_id
        next_id += 1

    instance_mask[rows, cols] = lookup[component]
    return instance_mask


# ---------------------------------------------------------------------------
# The U-Net.
# ---------------------------------------------------------------------------

class ConvBlock(FlaxModule):
    """Two 3x3 convs, each followed by flax's GroupNorm(num_groups=8)
    (epsilon 1e-6) and a ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, 3)
        self.GroupNorm_0 = GroupNorm(features, num_groups=8, epsilon=1e-6)
        self.Conv_1 = Conv(features, features, 3)
        self.GroupNorm_1 = GroupNorm(features, num_groups=8, epsilon=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class ConvTranspose2x(FlaxModule):
    """``flax.linen.ConvTranspose(features, (2, 2), strides=(2, 2))`` with
    its defaults (``padding="SAME"``, ``transpose_kernel=False``): a
    correlation of the stride-2 dilated input padded by one on each side,
    so ``out[2i + d] = x[i] . kernel[1 - d]``, torch's transposed
    convolution with the kernel flipped. Kernel (2, 2, in, out) there, (in,
    out, 2, 2) here."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features, 2, 2), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def flax_shape(self, name):
        c_in, out = self.kernel.shape[:2]
        return (2, 2, c_in, out) if name == "kernel" else tuple(self.bias.shape)

    def to_torch(self, name, array):
        return array[::-1, ::-1].transpose(2, 3, 0, 1) if name == "kernel" else array

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.kernel, self.bias, stride=2)


# The U-Net's width at full resolution; it doubles at each level.
_BASE_FEATURES = 32
# A pixel is a person where the U-Net's probability passes this.
PERSON_THRESHOLD = 0.5


class UNet(FlaxModule):
    """The reference's small U-Net (4 down, 4 up) emitting a 1-channel
    person logit map; modules named as flax names them in ``build_unet``."""

    def __init__(self):
        super().__init__()
        f = _BASE_FEATURES
        widths = [3] + [f << level for level in range(5)]
        for level in range(5):
            self.add_module(f"ConvBlock_{level}", ConvBlock(widths[level], widths[level + 1]))
        for k, level in enumerate(reversed(range(4))):
            self.add_module(f"ConvTranspose_{k}", ConvTranspose2x(f << (level + 1), f << level))
            self.add_module(f"ConvBlock_{5 + k}", ConvBlock(f << (level + 1), f << level))
        self.Conv_0 = Conv(f, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W), H and W multiples of 16 -> (B, 1, H, W) logits."""
        skips = []
        for level in range(4):
            x = getattr(self, f"ConvBlock_{level}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.ConvBlock_4(x)
        for k, level in enumerate(reversed(range(4))):
            x = getattr(self, f"ConvTranspose_{k}")(x)
            x = getattr(self, f"ConvBlock_{5 + k}")(torch.cat([x, skips[level]], dim=1))
        return self.Conv_0(x)


def build_unet(device=None) -> UNet:
    """The U-Net on ``device`` (default ``cuda:0``), parameters zero until
    loaded."""
    with torch.device(get_device(device)):
        return UNet().eval()


def unet_check_params(seed: int = 0) -> dict:
    """Informative random U-Net weights for checks (``fan_in_params``)."""
    with torch.device("meta"):
        return fan_in_params(UNet(), seed)


def unet_flops(hw, batch: int = 1) -> int:
    """Floating-point operations of one UNet forward on a batch at ``hw``
    (multiples of 16): 2 per multiply-add of every conv and transposed
    conv. GroupNorm, pooling and the sigmoid are left out."""
    h, w = hw
    f = _BASE_FEATURES
    flops = 0
    widths = [3] + [f << level for level in range(5)]
    for level in range(5):                                   # down path and bottleneck
        cin, cout = widths[level], widths[level + 1]
        flops += 2 * 9 * (cin + cout) * cout * (h >> level) * (w >> level)
    for level in reversed(range(4)):                         # up path
        cout = f << level
        pixels = (h >> level) * (w >> level)
        flops += 2 * (2 * cout) * cout * pixels                # 2x2/2 transposed conv
        flops += 2 * 9 * (2 * cout + cout) * cout * pixels     # ConvBlock on the concat
    flops += 2 * f * h * w                                   # the 1x1 head
    return batch * flops


# What a weights file that cannot be read or does not fit its model raises.
_LOAD_ERRORS = (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile)


class _UNetBackend:
    """Batched inference of the U-Net person segmenter on the device."""

    INPUT_MULTIPLE = 16  # four 2x poolings

    def __init__(self, weights_path: str, device=None):
        self.model = build_unet(device)
        self.device = next(self.model.parameters()).device
        with np.load(weights_path) as flat:
            load_flax_params(self.model, flat, network="U-Net")

    def inputs(self, batch: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB -> the network's (B, 3, H', W') input on
        the device: / 255, zero-padded to multiples of 16."""
        h, w = batch.shape[1:3]
        images = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device).float()
        images = torch.div(images, torch.full_like(images, 255.0)).permute(0, 3, 1, 2)
        return F.pad(images, (0, -w % self.INPUT_MULTIPLE, 0, -h % self.INPUT_MULTIPLE))

    @torch.inference_mode()
    def person_probabilities(self, batch: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB -> (B, H, W) person probability in [0, 1]
        on the device, cropped back from the padded input."""
        h, w = batch.shape[1:3]
        return torch.sigmoid(self.model(self.inputs(batch))[:, 0, :h, :w])


class _MaskRCNNBackend:
    """Instance masks from Mask R-CNN, a batch of frames a forward. The
    model is loaded once; a detector (its canvas) is made per frame shape."""

    def __init__(self, weights_path: str, device=None):
        self.model = maskrcnn.load_params(weights_path, device)
        self._detectors = {}

    def _detector(self, input_hw) -> "maskrcnn.MaskRCNNDetector":
        det = self._detectors.get(input_hw)
        if det is None:
            det = self._detectors[input_hw] = maskrcnn.MaskRCNNDetector(self.model, input_hw)
        return det

    def segment_batch(self, batch: np.ndarray) -> List[np.ndarray]:
        return self._detector(tuple(batch.shape[1:3])).instance_masks(batch)


class PersonSegmenter:
    """Produces per-frame instance masks (0 = background, 1..N = people)."""

    def __init__(self, weights_path: Optional[str] = None, device=None):
        """The reference's choice of backend: Mask R-CNN from
        ``$WEIGHTS_PATH/maskrcnn_coco.npz`` unless ``weights_path`` asks for
        the U-Net; the U-Net from ``weights_path`` (default
        ``$WEIGHTS_PATH/person_unet.npz``); else motion. A weights file that
        cannot be read or does not fit its model is passed over with a
        warning; an error of the device is not caught.

        :param weights_path: U-Net weights, which select that backend.
        :param device: where the models, MOG2 and the morphology run;
            default ``cuda:0``.
        """
        weights_dir = os.environ.get("WEIGHTS_PATH", "weights")
        # An explicitly passed weights_path is a request for the U-Net
        # backend: it must not be overridden by an ambient Mask R-CNN file.
        explicit_unet = weights_path is not None
        if weights_path is None:
            weights_path = os.path.join(weights_dir, "person_unet.npz")

        self._maskrcnn: Optional[_MaskRCNNBackend] = None
        self._unet: Optional[_UNetBackend] = None

        maskrcnn_path = os.path.join(weights_dir, maskrcnn.WEIGHTS_FILENAME)
        if not explicit_unet and os.path.isfile(maskrcnn_path):
            try:
                self._maskrcnn = _MaskRCNNBackend(maskrcnn_path, device)
                logging.info(f"Person segmentation: Mask R-CNN backend ({maskrcnn_path}).")
            except _LOAD_ERRORS as exc:
                logging.warning(f"Could not load Mask R-CNN weights ({exc}); "
                                f"trying the U-Net backend.")

        if self._maskrcnn is None and os.path.isfile(weights_path):
            try:
                self._unet = _UNetBackend(weights_path, device)
                logging.info(f"Person segmentation: U-Net backend ({weights_path}).")
            except _LOAD_ERRORS as exc:
                logging.warning(f"Could not load U-Net weights ({exc}); "
                                f"falling back to motion masks.")
        elif explicit_unet and not os.path.isfile(weights_path):
            logging.warning(f"Requested U-Net weights not found at "
                            f"{weights_path}; falling back to motion masks.")

        if self._maskrcnn is None and self._unet is None:
            logging.info("Person segmentation: motion (MOG2) fallback backend "
                         "(no model weights found).")

        self._classical = _MotionBackend(device=device)

    @property
    def backend(self) -> str:
        """``"maskrcnn"``, ``"unet"`` or ``"motion"``."""
        if self._maskrcnn is not None:
            return "maskrcnn"
        return "unet" if self._unet is not None else "motion"

    def predict_batch(self, batch: np.ndarray) -> List[np.ndarray]:
        """(B, H, W, 3) RGB → list of (H, W) uint8 instance-id masks.

        With the motion backend, batches must arrive in video order.
        """
        if self._maskrcnn is not None:
            return self._maskrcnn.segment_batch(batch)

        if self._unet is not None:
            probabilities = self._unet.person_probabilities(batch).cpu().numpy()
            return [self._instances_from_probability(p) for p in probabilities]

        frames = torch.from_numpy(np.ascontiguousarray(batch)).to(self._classical.device)
        if not self._classical._primed:
            self._classical.prime(frames)

        foreground = self._classical.foreground(frames).cpu().numpy()
        return [self._classical.instances(fg) for fg in foreground]

    def _instances_from_probability(self, probability: np.ndarray) -> np.ndarray:
        """(H, W) person probability -> instance ids: the 8-connected
        components over PERSON_THRESHOLD in OpenCV's order, those under
        0.1% of the frame dropped."""
        return instances_from_foreground(probability > PERSON_THRESHOLD, 0.001)
