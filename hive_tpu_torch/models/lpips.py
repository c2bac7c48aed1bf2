"""LPIPS (AlexNet variant) in PyTorch.

Counterpart of ``hive_tpu/models/lpips.py``: five AlexNet feature taps, each
normalised to unit length over its channels, the squared difference
weighted per channel by the learned linear heads, averaged over the pixels
and summed over the taps (Zhang et al. 2018, v0.1 weights). The modules
keep the reference's names, so one ``lpips_alex.npz`` serves both packages;
:func:`convert_torch_checkpoint` writes it from torchvision's AlexNet and the
``lpips`` package's linear heads, and :func:`check_params` makes check
weights in that layout from a seed. ``hive_tpu_torch.metrics.lpips`` scores
with it.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hive_tpu_torch import get_device
from hive_tpu_torch.models.flax_layers import Conv, FlaxModule, load_flax_params

WEIGHTS_FILENAME = "lpips_alex.npz"

# LPIPS ScalingLayer constants (PerceptualSimilarity lpips/lpips.py).
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)

# AlexNet's feature stack: (in, features, kernel, stride, padding, pool_before).
_CONVS = [(3, 64, 11, 4, 2, False), (64, 192, 5, 1, 2, True), (192, 384, 3, 1, 1, True),
          (384, 256, 3, 1, 1, False), (256, 256, 3, 1, 1, False)]


class LPIPSAlex(FlaxModule):
    """Distance between two batches of [-1, 1] RGB images (N, 3, H, W) ->
    (N,). The linear heads are the top-level parameters ``lin0``..``lin4``,
    as in the reference's tree."""

    def __init__(self):
        super().__init__()
        for i, (cin, features, kernel, stride, pad, _) in enumerate(_CONVS):
            self.add_module(f"conv{i}", Conv(cin, features, kernel, stride, ((pad, pad),) * 2))
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(features),
                                                            requires_grad=False))
        # torch.tensor, not torch.from_numpy: the buffers follow a
        # ``torch.device`` context, as the parameters do.
        self.register_buffer("shift", torch.tensor(_SHIFT)[:, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[:, None, None])

    def taps(self, x: torch.Tensor):
        x = (x - self.shift) / self.scale
        outs = []
        for i, (*_, pool) in enumerate(_CONVS):
            if pool:
                x = F.max_pool2d(x, 3, stride=2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            outs.append(x)
        return outs

    def forward(self, image_a: torch.Tensor, image_b: torch.Tensor) -> torch.Tensor:
        def unit(t):
            return t / (torch.sqrt(torch.sum(t ** 2, dim=1, keepdim=True)) + 1e-10)

        total = 0.0
        for i, (ta, tb) in enumerate(zip(self.taps(image_a), self.taps(image_b))):
            diff = (unit(ta) - unit(tb)) ** 2
            weights = getattr(self, f"lin{i}")[:, None, None]
            total = total + torch.mean(torch.sum(diff * weights, dim=1), dim=(1, 2))
        return total


class LPIPSScorer:
    """LPIPS distance of two uint8 RGB images (any equal size) on the card
    (or the CPU, if asked)."""

    def __init__(self, params, device=None):
        self.device = get_device(device)
        with torch.device(self.device):
            self.model = LPIPSAlex().eval()
        if isinstance(params, (str, os.PathLike)):
            with np.load(params) as flat:
                load_flax_params(self.model, flat, network="LPIPS")
        else:
            load_flax_params(self.model, params, network="LPIPS")

    @torch.inference_mode()
    def __call__(self, image_a: np.ndarray, image_b: np.ndarray) -> float:
        def prepare(image):
            x = np.asarray(image, np.float32) / np.float32(127.5) - np.float32(1.0)
            return torch.from_numpy(x).to(self.device).permute(2, 0, 1)[None]

        return float(self.model(prepare(image_a), prepare(image_b))[0])


def check_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Informative random weights in the converted file's layout
    (``conv{i}/kernel`` HWIO, ``conv{i}/bias``, ``lin{i}``), drawn from
    ``np.random.default_rng(seed)``: kernels at std sqrt(2 / fan_in), biases
    N(0, 0.1), and the linear heads |N(0, 1)| (LPIPS's learned heads are
    non-negative, so the distance is too)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for i, (cin, features, kernel, *_) in enumerate(_CONVS):
        fan_in = cin * kernel * kernel
        flat[f"conv{i}/kernel"] = (rng.standard_normal((kernel, kernel, cin, features),
                                                       dtype=np.float32)
                                   * np.float32(np.sqrt(2.0 / fan_in)))
        flat[f"conv{i}/bias"] = rng.standard_normal(features, dtype=np.float32) * np.float32(0.1)
    for i, (_, features, *_) in enumerate(_CONVS):
        flat[f"lin{i}"] = np.abs(rng.standard_normal(features, dtype=np.float32))
    return flat


def load_scorer(weights_filename: str = WEIGHTS_FILENAME, *,
                device=None) -> Optional[LPIPSScorer]:
    """The scorer with ``$WEIGHTS_PATH/<weights_filename>``, or ``None``
    without the file (or with a file that does not load, with a warning).

    :param device: where the scorer runs; default ``cuda:0``.
    """
    from hive_tpu_torch.models.segmentation import _LOAD_ERRORS

    path = os.path.join(os.environ.get("WEIGHTS_PATH", "weights"), weights_filename)
    if not os.path.isfile(path):
        return None
    try:
        return LPIPSScorer(path, device)
    except _LOAD_ERRORS as exc:
        logging.warning(f"Could not load LPIPS weights ({exc}).")
        return None


def convert_torch_checkpoint(alexnet_path: str, lpips_lin_path: str,
                             output_path: str) -> Dict[str, np.ndarray]:
    """Convert torchvision's AlexNet and the lpips v0.1 linear heads into
    the flat npz that ``hive_tpu`` and this port both read.

    :param alexnet_path: torchvision's ``alexnet-owt-*.pth`` state dict
        (``features.{0,3,6,8,10}.weight/bias``).
    :param lpips_lin_path: the lpips package's ``weights/v0.1/alex.pth``
        (``lin{i}.model.1.weight`` 1x1 convs).
    """
    from hive_tpu_torch.models.convert_utils import TrackedState, WriteOnceDict, iter_flat_numpy

    alexnet = TrackedState(iter_flat_numpy(torch.load(alexnet_path, map_location="cpu",
                                                      weights_only=False)),
                           name="torchvision AlexNet")
    lins = TrackedState(iter_flat_numpy(torch.load(lpips_lin_path, map_location="cpu",
                                                   weights_only=False)),
                        name="lpips v0.1 linear heads")

    out = WriteOnceDict()
    for i, src in enumerate([0, 3, 6, 8, 10]):
        out[f"conv{i}/kernel"] = np.transpose(alexnet[f"features.{src}.weight"], (2, 3, 1, 0))
        out[f"conv{i}/bias"] = alexnet[f"features.{src}.bias"]

    for i in range(5):
        key = f"lin{i}.model.1.weight"
        if key not in lins:  # some releases omit the dropout module index
            key = f"lin{i}.model.0.weight"
        out[f"lin{i}"] = lins[key].reshape(-1)

    # LPIPS taps only the five feature convs; the classifier is unused.
    alexnet.assert_fully_consumed(ignore=(r"^classifier\.",))
    lins.assert_fully_consumed()

    np.savez(output_path, **dict(out))
    logging.info(f"Converted LPIPS weights written to {output_path}")
    return dict(out)
