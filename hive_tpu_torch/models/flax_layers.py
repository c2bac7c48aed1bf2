"""Leaf modules whose parameters are leaves of a ``hive_tpu`` Flax tree.

The port's networks (DPT-Hybrid, Mask R-CNN, the person U-Net, big-lama) keep the
reference's module names, so the parameters of a module here are the leaves
of ``hive_tpu``'s Flax tree at the same ``/``-joined path, and one converted
npz serves both packages (:func:`load_flax_params`). Each leaf module maps
its parameters between Flax's layout (HWIO conv kernels, (in, out) dense
kernels) and torch's. Tensors are NCHW inside.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FlaxModule(nn.Module):
    """A module whose parameters are leaves of the reference's Flax tree.
    By default a parameter has the same layout in both."""

    def flax_shape(self, name: str) -> Tuple[int, ...]:
        return tuple(getattr(self, name).shape)

    def to_torch(self, name: str, array: np.ndarray) -> np.ndarray:
        return array

    def fan_in(self, name: str) -> int:
        return int(np.prod(self.flax_shape(name)[:-1]))


def same_pad(k: int, s: int) -> Tuple[int, int]:
    """timm "same" padding, low side first: (2, 3) for 7x7/2, (0, 1) for
    3x3/2, (k - 1) / 2 on both sides at stride 1."""
    total = max(k - s, 0) if s > 1 else k - 1
    return total // 2, total - total // 2


class Conv(FlaxModule):
    """``flax.linen.Conv`` (HWIO kernel there, OIHW here): the input and the
    kernel cast to ``dtype``, the bias added after the convolution in
    ``dtype``. ``padding`` is ((top, bottom), (left, right)); by default
    flax's "SAME" at stride 1, which is also what it gives a 1x1 kernel at
    stride 2."""

    def __init__(self, in_features: int, features: int, kernel_size: int, strides: int = 1,
                 padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(features, in_features, kernel_size, kernel_size),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(features), requires_grad=False)
                     if use_bias else None)
        self.strides = strides
        if padding is None:  # flax "SAME" at stride 1
            padding = (same_pad(kernel_size, 1),) * 2
        self.padding = padding
        self.dtype = dtype

    def flax_shape(self, name):
        shape = tuple(getattr(self, name).shape)
        return (shape[2], shape[3], shape[1], shape[0]) if name == "kernel" else shape

    def to_torch(self, name, array):
        return array.transpose(3, 2, 0, 1) if name == "kernel" else array

    def weight(self) -> torch.Tensor:
        return self.kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = self.padding
        x = x.to(self.dtype)
        pad = 0
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
        y = F.conv2d(x, self.weight().to(self.dtype), stride=self.strides, padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class Dense(FlaxModule):
    """``flax.linen.Dense`` ((in, out) kernel there, (out, in) here),
    computed in ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(features, in_features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.dtype = dtype

    def flax_shape(self, name):
        return tuple(self.kernel.shape[::-1]) if name == "kernel" else tuple(self.bias.shape)

    def to_torch(self, name, array):
        return array.T if name == "kernel" else array

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)


class GroupNorm(FlaxModule):
    """``flax.linen.GroupNorm(num_groups, epsilon)``: float32 out, whatever
    comes in. DPT's stem sets 32 groups and epsilon 1e-5; flax's own
    epsilon is 1e-6."""

    def __init__(self, features: int, num_groups: int = 32, epsilon: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.num_groups = num_groups
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.scale, self.bias, eps=self.epsilon)


class FoldedBN(FlaxModule):
    """Per-channel scale and bias (FrozenBatchNorm folded at conversion):
    ``x * scale + bias`` as one FMA, as XLA:CPU fuses it."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addcmul(self.bias[:, None, None], x, self.scale[:, None, None])


def flax_leaves(model: nn.Module) -> Iterator[Tuple[str, FlaxModule, str]]:
    """(Flax path, owning module, parameter name) of every parameter of
    ``model``, the path relative to ``model`` as in the reference's tree."""
    for module_name, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            yield "/".join([*module_name.split("."), name] if module_name else [name]), module, name


def tree_order(model: nn.Module):
    """:func:`flax_leaves` in the order in which ``jax.tree_util`` visits
    the reference's tree (its dict keys sorted at every level)."""
    return sorted(flax_leaves(model), key=lambda leaf: tuple(leaf[0].split("/")))


def random_flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The reference's weights-absent initialisation
    (``hive_tpu/models/initialisation.py``) without JAX, leaf for leaf and
    bit for bit: norm scales 1, biases 0, everything else N(0, 1) * 0.02
    from one ``np.random.default_rng(0)`` in the tree's order. Build
    ``model`` on the meta device: only its shapes are read."""
    rng = np.random.default_rng(0)
    flat = {}
    for path, module, name in tree_order(model):
        shape = module.flax_shape(name)
        if name == "scale":
            flat[path] = np.ones(shape, np.float32)
        elif name == "bias":
            flat[path] = np.zeros(shape, np.float32)
        else:
            host = rng.standard_normal(shape, dtype=np.float32)
            host *= 0.02
            flat[path] = host
    return flat


def load_flax_params(model: nn.Module, flat, network: str = "DPT") -> nn.Module:
    """Load ``hive_tpu``'s flat ``a/b/c`` -> array mapping (a dict, or the
    ``np.load`` of its npz) into ``model`` (a port module, the paths
    relative to it), transposing conv and dense kernels and reshaping the
    attention's. Refuses a missing or unused key (``KeyError``) or a wrong
    shape (``ValueError``), naming it and ``network``."""
    leaves = {path: (module, name) for path, module, name in flax_leaves(model)}
    keys = set(flat.files if hasattr(flat, "files") else flat)
    missing, unused = sorted(set(leaves) - keys), sorted(keys - set(leaves))
    if missing or unused:
        raise KeyError(f"{network} parameters do not fit the model: missing {missing}, "
                       f"unused {unused}")
    for path, (module, name) in leaves.items():
        array = np.asarray(flat[path], dtype=np.float32)
        if array.shape != module.flax_shape(name):
            raise ValueError(f"{network} parameter {path} has shape {array.shape}, the model "
                             f"expects {module.flax_shape(name)}")
        param = getattr(module, name)
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(module.to_torch(name, array), order="C")))
    return model


def fan_in_params(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Random weights for checks, drawn from ``np.random.default_rng(seed)``
    in the order of ``model``'s parameters (build it on the meta device):
    kernels at std sqrt(2 / fan_in), norm scales 1 + N(0, 0.1), biases N(0,
    0.1)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, module, name in flax_leaves(model):
        host = rng.standard_normal(module.flax_shape(name), dtype=np.float32)
        if name == "scale":
            host = np.float32(1.0) + np.float32(0.1) * host
        elif name == "bias":
            host *= np.float32(0.1)
        else:
            host *= np.float32(np.sqrt(2.0 / module.fan_in(name)))
        flat[path] = host
    return flat
