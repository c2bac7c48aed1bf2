"""LaMa image inpainting (big-lama, Fast Fourier Convolutions) in PyTorch.

Counterpart of ``hive_tpu/models/lama.py``: the released big-lama
generator (``FFCResNetGenerator``: ngf 64, 3 downsamples, 18 FFC residual
blocks at a 0.75 global ratio, no local Fourier unit, reflect padding,
sigmoid output), its batched inference (:class:`LamaInpainter`), the folder
driver with the reference's TELEA fallback (:func:`lama_inpaint_folder`)
and the checkpoint converter (:func:`convert_torch_checkpoint`). The
modules keep the reference's names, so one ``big-lama.npz`` serves both
packages (:func:`load_params`). Tensors are NCHW.

The dtypes follow the reference's: every convolution casts its input and
kernel to ``dtype`` (bf16 in :class:`LamaInpainter`) and returns ``dtype``;
a folded batch norm's float32 parameters promote its output to float32;
the Fourier unit transforms in float32 (``rfft2`` / ``irfft2``, ``norm=
"ortho"``) and runs its 1x1 conv in ``dtype`` over ``[all-real | all-imag]``
channel blocks; the head's sigmoid and the composite are float32. The
decoder's transposed convolutions are ``F.conv_transpose2d`` on the torch
layout of the kernel, the same sum as the reference's zero-interleave and
flipped VALID convolution without its zero terms. On the card the
convolutions are cuDNN's and the FFTs cuFFT's, the counterparts of XLA's;
the JAX package has no Pallas kernel here.

The reference thresholds the hole at ``mask > 127`` (:meth:`LamaInpainter.
inpaint_batch`) and keeps known depth at ``mask <= 127``
(:func:`lama_inpaint_folder`), while HIVE's masks hold instance ids 1..N:
with fewer than 128 instances LaMa is given no hole. The port does the
same, for parity (ROADMAP.md Queue 3 item 3).
"""

from __future__ import annotations

import logging
import os
from os.path import join as pjoin
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hive_tpu_torch import get_device
from hive_tpu_torch.models.flax_layers import (Conv, FlaxModule, FoldedBN, load_flax_params,
                                               random_flax_params, tree_order)

WEIGHTS_FILENAME = "big-lama.npz"

# The released configuration (saic-mdal/lama configs big-lama).
BASE_FEATURES = 64
NUM_DOWNSAMPLES = 3
NUM_BLOCKS = 18
GLOBAL_RATIO = 0.75


def reflect_conv(in_features: int, features: int, kernel_size: int, stride: int,
                 dtype: torch.dtype, use_bias: bool = False) -> Conv:
    """A VALID convolution; the caller reflect-pads its input."""
    return Conv(in_features, features, kernel_size, stride, ((0, 0), (0, 0)), use_bias=use_bias,
                dtype=dtype)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """``jnp.pad(mode="reflect")`` on H and W (no edge repeat)."""
    return F.pad(x, (p, p, p, p), mode="reflect") if p else x


class FourierUnit(FlaxModule):
    """rfft2 -> 1x1 conv + folded BN + ReLU over [re | im] blocks -> irfft2."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.conv = Conv(2 * features, 2 * features, 1, use_bias=False, dtype=dtype)
        self.bn = FoldedBN(2 * features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        freq = torch.fft.rfft2(x.float(), dim=(-2, -1), norm="ortho")
        y = F.relu(self.bn(self.conv(torch.cat([freq.real, freq.imag], dim=1)))).float()
        freq = torch.complex(y[:, :self.features], y[:, self.features:])
        return torch.fft.irfft2(freq, s=(h, w), dim=(-2, -1), norm="ortho").to(x.dtype)


class SpectralTransform(FlaxModule):
    """The global branch: 1x1 bottleneck -> Fourier unit -> 1x1 expand."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        half = features // 2
        self.conv1 = Conv(in_features, half, 1, use_bias=False, dtype=dtype)
        self.bn1 = FoldedBN(half)
        self.fu = FourierUnit(half, dtype)
        self.conv2 = Conv(half, features, 1, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return self.conv2(y + self.fu(y))


class FFCBnAct(FlaxModule):
    """torch ``FFC_BN_ACT``: cross-connected local / global convolutions,
    folded BN and ReLU on each output part. ``in_global`` channels of the
    input are global (0: no global input); ``ratio_gout`` sets the output
    split."""

    def __init__(self, in_local: int, in_global: int, features: int, ratio_gout: float,
                 kernel: int = 3, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_global = int(features * ratio_gout)
        self.out_local = features - self.out_global
        self.pad = kernel // 2

        def conv(cin, cout):
            return reflect_conv(cin, cout, kernel, stride, dtype)

        if self.out_local > 0:
            self.convl2l = conv(in_local, self.out_local)
            if in_global:
                self.convg2l = conv(in_global, self.out_local)
            self.bn_l = FoldedBN(self.out_local)
        if self.out_global > 0:
            self.convl2g = conv(in_local, self.out_global)
            if in_global:
                self.convg2g = SpectralTransform(in_global, self.out_global, dtype)
            self.bn_g = FoldedBN(self.out_global)

    def forward(self, x_local: torch.Tensor, x_global: Optional[torch.Tensor]):
        padded_local = reflect_pad(x_local, self.pad)
        y_local = y_global = None
        if self.out_local > 0:
            y_local = self.convl2l(padded_local)
            if x_global is not None:
                y_local = y_local + self.convg2l(reflect_pad(x_global, self.pad))
            y_local = F.relu(self.bn_l(y_local))
        if self.out_global > 0:
            y_global = self.convl2g(padded_local)
            if x_global is not None:
                y_global = y_global + self.convg2g(x_global)
            y_global = F.relu(self.bn_g(y_global))
        return y_local, y_global


class FFCResNetBlock(FlaxModule):
    def __init__(self, features: int, ratio: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        out_global = int(features * ratio)
        out_local = features - out_global
        self.conv1 = FFCBnAct(out_local, out_global, features, ratio, dtype=dtype)
        self.conv2 = FFCBnAct(out_local, out_global, features, ratio, dtype=dtype)

    def forward(self, x_local: torch.Tensor, x_global: torch.Tensor):
        y_local, y_global = self.conv2(*self.conv1(x_local, x_global))
        return x_local + y_local, x_global + y_global


class ConvTranspose3x3(FlaxModule):
    """torch's ``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``, no
    bias, in ``dtype``. The reference stores the kernel of its equivalent
    zero-interleave + VALID 3x3 convolution, spatially flipped, (3, 3, in,
    out); torch's layout is (in, out, 3, 3), unflipped."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features, 3, 3), requires_grad=False)
        self.dtype = dtype

    def flax_shape(self, name):
        c_in, out = self.kernel.shape[:2]
        return (3, 3, c_in, out)

    def to_torch(self, name, array):
        return array[::-1, ::-1].transpose(2, 3, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.kernel.to(self.dtype), stride=2,
                                  padding=1, output_padding=1)


class DeconvBN(FlaxModule):
    """The decoder's 2x upsampling: transposed convolution, folded BN (the
    deconvolution's bias folded in), ReLU."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvTranspose3x3(in_features, features, dtype)
        self.bn = FoldedBN(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class LamaGenerator(FlaxModule):
    """big-lama's ``FFCResNetGenerator`` (defaults: the released
    configuration). Takes a float32 RGB image in [0, 1] (B, 3, H, W) and a
    0/1 hole mask (B, 1, H, W), H and W multiples of 2 ** num_downsamples,
    and returns the float32 image with the hole filled by the prediction."""

    def __init__(self, base_features: int = BASE_FEATURES, num_downsamples: int = NUM_DOWNSAMPLES,
                 num_blocks: int = NUM_BLOCKS, global_ratio: float = GLOBAL_RATIO,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_downsamples = num_downsamples
        self.num_blocks = num_blocks
        self.stem = FFCBnAct(4, 0, base_features, 0.0, kernel=7, dtype=dtype)

        features, in_local, in_global = base_features, base_features, 0
        for i in range(num_downsamples):
            gout = global_ratio if i == num_downsamples - 1 else 0.0
            down = FFCBnAct(in_local, in_global, features * 2, gout, stride=2, dtype=dtype)
            self.add_module(f"down{i}", down)
            features *= 2
            in_local, in_global = down.out_local, down.out_global

        for i in range(num_blocks):
            self.add_module(f"block{i}", FFCResNetBlock(features, global_ratio, dtype))

        for i in range(num_downsamples):
            self.add_module(f"up{i}", DeconvBN(features, features // 2, dtype))
            features //= 2

        self.head = reflect_conv(features, 3, 7, 1, dtype, use_bias=True)

    def forward(self, image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        known = 1.0 - mask
        x = torch.cat([image * known, mask], dim=1)
        y_local, y_global = self.stem(x, None)
        for i in range(self.num_downsamples):
            y_local, y_global = getattr(self, f"down{i}")(y_local, y_global)
        for i in range(self.num_blocks):
            y_local, y_global = getattr(self, f"block{i}")(y_local, y_global)
        y = torch.cat([y_local, y_global], dim=1)
        for i in range(self.num_downsamples):
            y = getattr(self, f"up{i}")(y)
        y = torch.sigmoid(self.head(reflect_pad(y, 3)).float())
        return image * known + y * mask


def lama_flops(hw: Tuple[int, int], batch: int = 1) -> int:
    """Multiply-adds x 2 of the released generator's convolutions at an
    (H, W) input, as the port computes them: the transposed convolutions without
    the zero terms of the reference's zero-interleaved formulation (which
    does 4x their work), and no count for the FFTs, the norms or the
    element-wise work."""
    h, w = hw

    def conv(cin, cout, k, oh, ow):
        return 2 * cin * cout * k * k * oh * ow

    flops = conv(4, BASE_FEATURES, 7, h, w)
    features, cl, cg = BASE_FEATURES, BASE_FEATURES, 0
    for i in range(NUM_DOWNSAMPLES):
        h, w = h // 2, w // 2
        out = features * 2
        og = int(out * GLOBAL_RATIO) if i == NUM_DOWNSAMPLES - 1 else 0
        flops += conv(cl, out - og, 3, h, w) + conv(cl, og, 3, h, w)
        features, cl, cg = out, out - og, og

    half = cg // 2
    fh, fw = h, w // 2 + 1
    spectral = (conv(cg, half, 1, h, w) + conv(2 * half, 2 * half, 1, fh, fw)
                + conv(half, cg, 1, h, w))
    ffc = conv(cl, cl, 3, h, w) + conv(cg, cl, 3, h, w) + conv(cl, cg, 3, h, w) + spectral
    flops += NUM_BLOCKS * 2 * ffc

    for _ in range(NUM_DOWNSAMPLES):
        flops += conv(features, features // 2, 3, h, w)  # over the input pixels
        features //= 2
        h, w = h * 2, w * 2
    flops += conv(features, 3, 7, h, w)
    return batch * flops


# ---------------------------------------------------------------------------
# Weights.
# ---------------------------------------------------------------------------

def build_generator(device=None, dtype: torch.dtype = torch.bfloat16, **config) -> LamaGenerator:
    """An uninitialised generator on ``device`` (default ``cuda:0``);
    ``config`` overrides the released configuration."""
    with torch.device(get_device(device)):
        return LamaGenerator(dtype=dtype, **config).eval()


def load_params(model: LamaGenerator, weights) -> LamaGenerator:
    """Load ``hive_tpu``'s ``big-lama.npz`` (a path, an ``np.load`` or a
    flat mapping) into ``model``. Refuses a missing or unused key
    (``KeyError``) or a wrong shape (``ValueError``)."""
    if isinstance(weights, (str, os.PathLike)):
        with np.load(weights) as flat:
            return load_flax_params(model, flat, network="LaMa")
    return load_flax_params(model, weights, network="LaMa")


def reference_random_params(**config) -> Dict[str, np.ndarray]:
    """The reference's weights-absent initialisation of the generator
    (``flax_layers.random_flax_params``)."""
    with torch.device("meta"):
        return random_flax_params(LamaGenerator(**config))


# check_params: the scale of each residual branch's output norms. At 0.2
# the full-width generator's logits reach +-30 and the sigmoid saturates.
_RESIDUAL_GAIN = 0.1
# check_params: the head's kernel scale. The full-width generator's hole
# then spreads over about 0.03-0.98 (std 0.23), the small test net's over
# 0.26-0.76.
_HEAD_GAIN = 1.5


def check_params(seed: int = 0, **config) -> Dict[str, np.ndarray]:
    """Informative random weights for checks, drawn in the tree's order
    from ``np.random.default_rng(seed)``: kernels at std sqrt(2 / fan_in),
    norm scales 1 + N(0, 0.1), biases N(0, 0.1). Two departures keep the
    network as stable as a trained one: the second FFC of each residual
    block has its norm scales x``_RESIDUAL_GAIN`` (at full scale the
    activations and bf16's roundings grow through the 18 blocks), and the
    head's kernel is x``_HEAD_GAIN``, so the sigmoid works away from 0 and
    1, where a wrong layer would saturate out of sight."""
    with torch.device("meta"):
        model = LamaGenerator(**config)
    rng = np.random.default_rng(seed)
    flat = {}
    for path, module, name in tree_order(model):
        host = rng.standard_normal(module.flax_shape(name), dtype=np.float32)
        if name == "scale":
            host = np.float32(1.0) + np.float32(0.1) * host
        elif name == "bias":
            host *= np.float32(0.1)
        else:
            host *= np.float32(np.sqrt(2.0 / module.fan_in(name)))
        if "/conv2/bn_" in path and path.endswith("/scale"):
            host *= np.float32(_RESIDUAL_GAIN)
        if path == "head/kernel":
            host *= np.float32(_HEAD_GAIN)
        flat[path] = host
    return flat


# ---------------------------------------------------------------------------
# Inference.
# ---------------------------------------------------------------------------

def weights_path() -> str:
    return os.path.join(os.environ.get("WEIGHTS_PATH", "weights"), WEIGHTS_FILENAME)


class LamaInpainter:
    """Batched big-lama inference on the card (or the CPU, if asked), in
    bf16 with float32 norms, FFTs and output, as the reference's
    ``LamaInpainter``. Weights come from ``$WEIGHTS_PATH/big-lama.npz``;
    without the file the generator takes the reference's random
    initialisation (:func:`lama_inpaint_folder` falls back to TELEA
    instead, as the reference does)."""

    PAD_MULTIPLE = 8

    def __init__(self, device=None, dtype: torch.dtype = torch.bfloat16,
                 params: Optional[Dict[str, np.ndarray]] = None):
        self.device = get_device(device)
        self.model = build_generator(self.device, dtype)
        if params is None:
            if os.path.isfile(weights_path()):
                logging.info(f"Loading LaMa weights from {weights_path()}")
                params = np.load(weights_path())
            else:
                logging.warning(f"LaMa weights not found at {weights_path()}; using random "
                                f"initialisation.")
                params = reference_random_params()
        load_params(self.model, params)

    @staticmethod
    def has_weights() -> bool:
        return os.path.isfile(weights_path())

    def inputs(self, images: np.ndarray, masks: np.ndarray):
        """The generator's inputs for (B, H, W, 3) uint8 RGB frames and
        (B, H, W) uint8 masks (hole where ``mask > 127``), on the device:
        as the reference, the image / 255 reflect-padded (numpy's
        ``reflect``) to a multiple of 8 and the mask zero-padded, on the
        host."""
        h, w = images.shape[1:3]
        pad_h, pad_w = -h % self.PAD_MULTIPLE, -w % self.PAD_MULTIPLE

        image = images.astype(np.float32) / 255.0
        image = np.pad(image, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
        hole = (masks > 127).astype(np.float32)
        hole = np.pad(hole, ((0, 0), (0, pad_h), (0, pad_w)), mode="constant")
        return (torch.from_numpy(image).to(self.device).permute(0, 3, 1, 2),
                torch.from_numpy(hole).to(self.device)[:, None])

    @torch.inference_mode()
    def forward(self, images: np.ndarray, masks: np.ndarray) -> torch.Tensor:
        """The generator's float32 (B, 3, H, W) output on the device for
        :meth:`inputs`' frames, cropped back to (H, W)."""
        h, w = images.shape[1:3]
        return self.model(*self.inputs(images, masks))[:, :, :h, :w]

    def inpaint_batch(self, images: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """:meth:`forward`'s frames as (B, H, W, 3) uint8: ``clip(x * 255,
        0, 255)`` truncated, as the reference."""
        out = self.forward(images, masks).permute(0, 2, 3, 1)
        return torch.clamp(out * 255.0, 0, 255).to(torch.uint8).cpu().numpy()


# Frames a LaMa batch holds on the card.
BATCH_SIZE = 8


def lama_inpaint_folder(image_dir: str, mask_dir: str, output_dir: str, depth: bool = False,
                        device=None):
    """Inpaint every image of a folder with its same-stem mask, as the
    reference's ``lama_inpaint_folder``:

    * depth maps (``depth=True``) are inpainted with TELEA on their
      ``/ 256`` uint8 image, scaled back by 256, and keep their values
      where ``mask <= 127``;
    * RGB frames go through LaMa in batches on ``device`` (default
      ``cuda:0``) when ``$WEIGHTS_PATH/big-lama.npz`` exists, and through
      TELEA otherwise, with the reference's warning.

    Frames are written as the reference's ``cv2.imwrite`` writes them:
    JPEG at quality 95, or PNG.
    """
    from hive_tpu_torch.image_codecs import CV2_JPEG_QUALITY, write_image
    from hive_tpu_torch.image_processing import TELEA_RADIUS, inpaint_telea
    from hive_tpu_torch.io import load_image
    from hive_tpu_torch.utils import tqdm_imap

    os.makedirs(output_dir, exist_ok=True)
    filenames = sorted(os.listdir(image_dir))

    def read(filename: str):
        mask = load_image(pjoin(mask_dir, f"{Path(filename).stem}.png"))
        return load_image(pjoin(image_dir, filename)), mask

    def write(filename: str, image: np.ndarray):
        write_image(pjoin(output_dir, filename), image, CV2_JPEG_QUALITY)

    use_lama = not depth and LamaInpainter.has_weights()
    if not LamaInpainter.has_weights():
        logging.warning("LaMa weights unavailable; inpainting with TELEA instead.")

    if not use_lama:
        def process(filename: str):
            image, mask = read(filename)
            if depth:
                result = inpaint_telea((image / 256).astype(np.uint8), mask, TELEA_RADIUS)
                result = (result.astype(np.float32) * 256).astype(image.dtype)
                result[mask <= 127] = image[mask <= 127]
            else:
                result = inpaint_telea(image, mask, TELEA_RADIUS)
            write(filename, result)

        tqdm_imap(process, filenames)
        return

    inpainter = LamaInpainter(device)
    for start in range(0, len(filenames), BATCH_SIZE):
        names = filenames[start:start + BATCH_SIZE]
        frames, masks = zip(*tqdm_imap(read, names, show_progress=False))
        results = inpainter.inpaint_batch(np.stack(frames), np.stack(masks))
        tqdm_imap(lambda args: write(*args), list(zip(names, results)), show_progress=False)


# ---------------------------------------------------------------------------
# Checkpoint conversion (the released big-lama -> the shared npz).
# ---------------------------------------------------------------------------

def _fold_bn_arrays(gamma, beta, mean, var, conv_bias=None, eps=1e-5):
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    if conv_bias is not None:
        bias = bias + conv_bias * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _deinterleave(n: int) -> np.ndarray:
    """Channel permutation: [re_0..re_{n-1} | im_0..im_{n-1}] index j ->
    torch's interleaved index (2j for re, 2(j - n) + 1 for im)."""
    idx = np.empty(2 * n, np.int64)
    idx[:n] = 2 * np.arange(n)
    idx[n:] = 2 * np.arange(n) + 1
    return idx


def _fourier_conv_from_torch(weight: np.ndarray) -> np.ndarray:
    """torch FourierUnit ``conv_layer`` (2co, 2ci, 1, 1) over interleaved
    re/im -> the HWIO kernel over [re | im] channel blocks."""
    co2, ci2 = weight.shape[:2]
    w = weight[np.ix_(_deinterleave(co2 // 2), _deinterleave(ci2 // 2))]
    return np.transpose(w, (2, 3, 1, 0))


def _deconv_kernel_from_torch(weight: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d weight (in, out, kh, kw) -> the HWIO kernel of
    the reference's zero-interleave + VALID conv (spatially flipped)."""
    return np.transpose(weight[:, :, ::-1, ::-1], (2, 3, 0, 1))


def convert_torch_checkpoint(torch_checkpoint_path: str, output_path: str,
                             base_features: int = BASE_FEATURES,
                             num_downsamples: int = NUM_DOWNSAMPLES,
                             num_blocks: int = NUM_BLOCKS,
                             global_ratio: float = GLOBAL_RATIO) -> Dict[str, np.ndarray]:
    """Convert a released big-lama checkpoint (pytorch-lightning
    ``best.ckpt`` or a bare generator state dict) into the flat npz that
    ``hive_tpu`` and this port both read, with ``hive_tpu``'s keys and
    arrays: BatchNorms folded into scale / bias, the Fourier unit's conv and
    BN de-interleaved to [re | im] blocks, deconvolution kernels flipped.

    The generator's ``nn.Sequential`` indices (saic-mdal/lama
    ``FFCResNetGenerator``): pad, stem FFC, ``num_downsamples`` downsampling
    FFCs, ``num_blocks`` residual blocks, concat, (deconv, bn, relu) per
    upsample, pad, head conv, sigmoid.
    """
    from hive_tpu_torch.models.convert_utils import TrackedState, WriteOnceDict

    raw = torch.load(torch_checkpoint_path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]

    sd = {}
    for key, value in raw.items():
        if key.startswith("generator."):
            key = key[len("generator."):]
        if key.startswith("model."):
            sd[key] = np.asarray(value.detach().numpy() if hasattr(value, "detach") else value)

    sd = TrackedState(sd, name="big-lama generator")
    out = WriteOnceDict()

    def put_conv(src, dst):
        out[f"{dst}/kernel"] = np.transpose(sd[src], (2, 3, 1, 0))

    def put_bn(src_prefix, dst, conv_bias=None, permute=None):
        arrays = [sd[f"{src_prefix}.{name}"]
                  for name in ("weight", "bias", "running_mean", "running_var")]
        if permute is not None:
            arrays = [a[permute] for a in arrays]
        out[f"{dst}/scale"], out[f"{dst}/bias"] = _fold_bn_arrays(*arrays, conv_bias=conv_bias)

    def put_spectral(src, dst):
        put_conv(f"{src}.conv1.0.weight", f"{dst}/conv1")
        put_bn(f"{src}.conv1.1", f"{dst}/bn1")
        weight = sd[f"{src}.fu.conv_layer.weight"]
        out[f"{dst}/fu/conv/kernel"] = _fourier_conv_from_torch(weight)
        put_bn(f"{src}.fu.bn", f"{dst}/fu/bn", permute=_deinterleave(weight.shape[0] // 2))
        put_conv(f"{src}.conv2.weight", f"{dst}/conv2")

    def put_ffc_bn_act(src, dst, has_global_in, has_global_out):
        put_conv(f"{src}.ffc.convl2l.weight", f"{dst}/convl2l")
        if has_global_in:
            put_conv(f"{src}.ffc.convg2l.weight", f"{dst}/convg2l")
        put_bn(f"{src}.bn_l", f"{dst}/bn_l")
        if has_global_out:
            put_conv(f"{src}.ffc.convl2g.weight", f"{dst}/convl2g")
            if has_global_in:
                put_spectral(f"{src}.ffc.convg2g", f"{dst}/convg2g")
            put_bn(f"{src}.bn_g", f"{dst}/bn_g")

    put_ffc_bn_act("model.1", "stem", False, False)

    idx = 2
    for i in range(num_downsamples):
        put_ffc_bn_act(f"model.{idx}", f"down{i}", False, i == num_downsamples - 1)
        idx += 1

    for i in range(num_blocks):
        for conv_name in ("conv1", "conv2"):
            put_ffc_bn_act(f"model.{idx}.{conv_name}", f"block{i}/{conv_name}", True, True)
        idx += 1

    idx += 1  # ConcatTupleLayer
    for i in range(num_downsamples):
        out[f"up{i}/conv/kernel"] = _deconv_kernel_from_torch(sd[f"model.{idx}.weight"])
        bias = sd[f"model.{idx}.bias"] if f"model.{idx}.bias" in sd else None
        put_bn(f"model.{idx + 1}", f"up{i}/bn", conv_bias=bias)
        idx += 3  # deconv, bn, relu

    idx += 1  # ReflectionPad2d
    put_conv(f"model.{idx}.weight", "head")
    out["head/bias"] = sd[f"model.{idx}.bias"]

    # Every generator tensor is consumed exactly once (BN trip counters
    # carry no learned state).
    sd.assert_fully_consumed(ignore=(r"num_batches_tracked$",))

    np.savez(output_path, **dict(out))
    logging.info(f"Converted big-lama checkpoint written to {output_path}")
    return dict(out)
