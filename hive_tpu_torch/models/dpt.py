"""DPT-Hybrid monocular depth estimation in PyTorch.

Counterpart of ``hive_tpu/models/dpt.py``: the same network ("Vision
Transformers for Dense Prediction", Ranftl et al. 2021, hybrid variant), a
ResNetV2 R50 stem (weight-standardised convs and GroupNorm) feeding a
ViT-B/16 encoder, with reassemble and RefineNet-style fusion decoding and
the NYU metric-depth head. The modules keep the reference's names, so the
parameters of a module here are the leaves of ``hive_tpu``'s Flax tree at
the same ``/``-joined path, and one converted ``dpt_hybrid_nyu.npz`` serves
both packages (:func:`load_flax_params`). Tensors are NCHW inside.

Mixed precision follows the reference module by module rather than
globally: each conv, dense layer and the attention compute in ``dtype``
(bf16 for inference, parameters stay float32); a GroupNorm promotes to
float32, so the stem's activations stay float32 between its convs; the
ViT's residual stream is float32 (the patch embedding has no ``dtype``);
from the readout on, the decoder runs in ``dtype``; the output is float32.

On the card the convolutions are cuDNN's, the dense layers cuBLAS's and the
attention ``F.scaled_dot_product_attention``, the counterparts of XLA's
convolution, dot and flax's einsum attention; the JAX package has no Pallas
kernel here.
"""

from __future__ import annotations

import copy
import logging
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hive_tpu_torch import get_device, on_device
from hive_tpu_torch.models import flax_layers
from hive_tpu_torch.models.flax_layers import (Conv, Dense, FlaxModule, GroupNorm, same_pad,
                                               load_flax_params, tree_order)
from hive_tpu_torch.ops.resize import prepare_model_input, resize
from hive_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch
from hive_tpu_torch.parallel.runtime import runtime_mesh

# NYU head calibration: depth = 1 / (scale * head_output + shift).
NYU_SCALE = 0.000305
NYU_SHIFT = 0.1378

# Width of the full model's stem output, the patch embedding's input.
_STEM_OUT = 1024
# ViT-B/16 on the hybrid stem: width (also the readout's), blocks, heads;
# the position embedding's grid (384 x 384 training) and the blocks whose
# tokens the decoder reads. The decoder's width.
_DIM, _DEPTH, _HEADS = 768, 12, 12
_GRID = (24, 24)
_HOOKS = (8, 11)
_FEATURES = 256

# The weights file in $WEIGHTS_PATH, shared with hive_tpu.
WEIGHTS_FILENAME = "dpt_hybrid_nyu.npz"
# DPTDepthEstimator's default mesh: the pipeline's runtime mesh.
_RUNTIME_MESH = object()

# check_flax_params: the scale of each residual branch, about 1/sqrt(2 * 12)
# for the ViT's 12 blocks (as GPT-2 initialises its residual projections).
_RESIDUAL_GAIN = 0.2


# ---------------------------------------------------------------------------
# Leaf modules (the shared ones are in flax_layers).
# ---------------------------------------------------------------------------

class StdConv(Conv):
    """Conv2D with weight standardisation (BiT / ResNetV2): the kernel
    standardised in float32 over (kh, kw, in), population variance, eps
    1e-8, then cast; timm "same" padding; no bias."""

    def __init__(self, in_features: int, features: int, kernel_size: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        pad = same_pad(kernel_size, strides)
        super().__init__(in_features, features, kernel_size, strides, padding=(pad, pad),
                         use_bias=False, dtype=dtype)

    def weight(self) -> torch.Tensor:
        kernel = self.kernel.float()
        mean = kernel.mean(dim=(1, 2, 3), keepdim=True)
        var = kernel.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        return (kernel - mean) / torch.sqrt(var + 1e-8)


class HeadsIn(Dense):
    """The attention's query, key and value projections: a DenseGeneral to
    (heads, head_dim) there, (dim, heads, head_dim) kernels."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, dim, dtype)
        self.num_heads = num_heads

    def flax_shape(self, name):
        dim = self.kernel.shape[1]
        heads = (self.num_heads, dim // self.num_heads)
        return (dim, *heads) if name == "kernel" else heads

    def to_torch(self, name, array):
        return array.reshape(array.shape[0], -1).T if name == "kernel" else array.reshape(-1)

    def fan_in(self, name):
        return int(self.kernel.shape[1])


class HeadsOut(Dense):
    """The attention's output projection: a DenseGeneral from (heads,
    head_dim) there, a (heads, head_dim, dim) kernel."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, dim, dtype)
        self.num_heads = num_heads

    def flax_shape(self, name):
        dim = self.kernel.shape[0]
        return ((self.num_heads, dim // self.num_heads, dim) if name == "kernel"
                else tuple(self.bias.shape))

    def to_torch(self, name, array):
        return array.reshape(-1, array.shape[-1]).T if name == "kernel" else array


class LayerNorm(FlaxModule):
    """``flax.linen.LayerNorm()``: epsilon 1e-6 (torch's default is 1e-5)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, eps=1e-6)


# ---------------------------------------------------------------------------
# ResNetV2 stem, R50 layout (3, 4, 9).
# ---------------------------------------------------------------------------

class Bottleneck(FlaxModule):
    """The post-activation bottleneck of timm's hybrid backbone: each conv
    followed by its own GroupNorm, a projection shortcut with its norm,
    ReLU after the residual add. Float32 out."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_features = features * 4
        if in_features != out_features or strides != 1:
            self.conv_proj = StdConv(in_features, out_features, 1, strides, dtype)
            self.gn_proj = GroupNorm(out_features)
        else:
            self.conv_proj = None
        self.conv1 = StdConv(in_features, features, 1, dtype=dtype)
        self.gn1 = GroupNorm(features)
        self.conv2 = StdConv(features, features, 3, strides, dtype)
        self.gn2 = GroupNorm(features)
        self.conv3 = StdConv(features, out_features, 1, dtype=dtype)
        self.gn3 = GroupNorm(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.conv_proj is None else self.gn_proj(self.conv_proj(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(y + shortcut)


class ResNetV2Stem(FlaxModule):
    """The R50 hybrid stem: root and three stages; returns the /4, /8 and
    /16 features."""

    def __init__(self, block_sizes: Sequence[int] = (3, 4, 9), width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_root = StdConv(3, width, 7, 2, dtype)
        self.gn_root = GroupNorm(width)
        self.stages = []
        in_features = width
        for stage, num_blocks in enumerate(block_sizes):
            names = []
            for block in range(num_blocks):
                name = f"stage{stage + 1}_block{block + 1}"
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(name, Bottleneck(in_features, width * 2 ** stage, strides, dtype))
                in_features = width * 2 ** stage * 4
                names.append(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor):
        y = F.relu(self.gn_root(self.conv_root(x)))
        # timm "same" max-pool: 3x3/2 on an even side pads (0, 1).
        y = F.max_pool2d(F.pad(y, (0, 1, 0, 1), value=-math.inf), 3, 2)
        features = []
        for names in self.stages:
            for name in names:
                y = getattr(self, name)(y)
            features.append(y)
        return features


# ---------------------------------------------------------------------------
# ViT encoder.
# ---------------------------------------------------------------------------

class MultiHeadDotProductAttention(FlaxModule):
    """flax's self-attention: the query scaled by 1/sqrt(head_dim) before
    the product, all in ``dtype``."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query = HeadsIn(dim, num_heads, dtype)
        self.key = HeadsIn(dim, num_heads, dtype)
        self.value = HeadsIn(dim, num_heads, dtype)
        self.out = HeadsOut(dim, num_heads, dtype)
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape

        def heads(proj):
            return proj(x).view(b, n, self.num_heads, -1).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        # 1/sqrt(head_dim) is a power of two for ViT-B's 64: exact in bf16.
        q = q / torch.full((), math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)
        y = F.scaled_dot_product_attention(q, k, v, scale=1.0)
        return self.out(y.transpose(1, 2).reshape(b, n, dim))


class TransformerBlock(FlaxModule):
    def __init__(self, dim: int = _DIM, num_heads: int = _HEADS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadDotProductAttention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, dim * 4, dtype)
        self.mlp_fc2 = Dense(dim * 4, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        # Exact (erf) GELU, as the reference.
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class HybridViT(FlaxModule):
    """ResNetV2 stem and ViT-B encoder; returns the stem's /4 and /8
    features, the tokens after the two hooked blocks and the token grid."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnet = ResNetV2Stem(dtype=dtype)
        # No dtype in the reference: float32 on the stem's float32 output.
        self.patch_embed = Conv(_STEM_OUT, _DIM, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, _DIM), requires_grad=False)
        self.pos_embed = nn.Parameter(torch.zeros(1, _GRID[0] * _GRID[1] + 1, _DIM),
                                      requires_grad=False)
        for i in range(_DEPTH):
            self.add_module(f"block{i}", TransformerBlock(dtype=dtype))

    def fan_in(self, name):
        return 1

    def forward(self, x: torch.Tensor):
        layer1, layer2, stem_out = self.resnet(x)
        b, _, h16, w16 = stem_out.shape
        tokens = self.patch_embed(stem_out).flatten(2).transpose(1, 2)

        # The grid part of the position embedding, resized bilinearly to the
        # token grid.
        cls_pos = self.pos_embed[:, :1]
        grid_pos = self.pos_embed[:, 1:].reshape(1, *_GRID, _DIM)
        grid_pos = resize(grid_pos, (1, h16, w16, _DIM), "bilinear")
        tokens = tokens + grid_pos.reshape(1, h16 * w16, _DIM).to(tokens.dtype)
        cls = (self.cls_token + cls_pos).expand(b, 1, _DIM).to(tokens.dtype)
        tokens = torch.cat([cls, tokens], dim=1)

        hook_outputs = []
        for i in range(_DEPTH):
            tokens = getattr(self, f"block{i}")(tokens)
            if i in _HOOKS:
                hook_outputs.append(tokens)
        return layer1, layer2, hook_outputs[0], hook_outputs[1], (h16, w16)


# ---------------------------------------------------------------------------
# DPT decoder: reassemble and fusion.
# ---------------------------------------------------------------------------

def _align_corners_table(in_n: int):
    """(lo, hi, frac) of a x2 align-corners resize of one axis, in float32
    as the reference computes them: output i samples i * (in - 1) / (out - 1)."""
    out_n = 2 * in_n
    pos = np.arange(out_n, dtype=np.float32) * np.float32(in_n - 1) / np.float32(out_n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_n - 1)
    return lo, hi, (pos - lo).astype(np.float32)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample with align_corners=True of an NCHW tensor, as
    the reference computes it: separable, H then W, ``frac`` cast to the
    activation dtype and ``a * (1 - frac) + b * frac`` in that dtype
    (``F.interpolate`` rounds otherwise in bf16)."""
    for axis in (2, 3):
        lo, hi, frac = _align_corners_table(x.shape[axis])
        shape = [1] * x.ndim
        shape[axis] = len(frac)
        frac = torch.from_numpy(frac).to(x.device, x.dtype).view(shape)
        a = x.index_select(axis, torch.from_numpy(lo).to(x.device))
        b = x.index_select(axis, torch.from_numpy(hi).to(x.device))
        x = a * (1 - frac) + b * frac
    return x


class ResidualConvUnit(FlaxModule):
    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(features, features, 3, dtype=dtype)
        self.conv2 = Conv(features, features, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(FlaxModule):
    """A fusion step: the skip's residual unit (``rcu1``, absent from the
    top block, which has no skip), ``rcu2``, the x2 upsample, a 1x1 conv."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 with_skip: bool = True):
        super().__init__()
        self.rcu1 = ResidualConvUnit(features, dtype) if with_skip else None
        self.rcu2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv(features, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.rcu1(skip)
        return self.out_conv(upsample2x_align_corners(self.rcu2(x)))


class DPTHybrid(FlaxModule):
    """The full DPT-Hybrid depth network with the NYU head: (B, 3, H, W)
    normalised float32 images, H and W multiples of 32, in; (B, H, W)
    float32 non-negative inverse-depth logits out."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = HybridViT(dtype=dtype)
        for i in (3, 4):
            self.add_module(f"reassemble{i}_readout", Dense(2 * _DIM, _DIM, dtype))
            self.add_module(f"reassemble{i}_project", Conv(_DIM, _DIM, 1, dtype=dtype))
        # A plain stride-2 conv with padding 1 in the released model.
        self.reassemble4_downsample = Conv(_DIM, _DIM, 3, 2, ((1, 1), (1, 1)), dtype=dtype)
        for i, width in enumerate((256, 512, _DIM, _DIM), start=1):
            self.add_module(f"scratch_rn{i}", Conv(width, _FEATURES, 3, use_bias=False,
                                                   dtype=dtype))
        for i in (4, 3, 2, 1):
            self.add_module(f"fusion{i}", FeatureFusionBlock(_FEATURES, dtype, with_skip=i != 4))
        self.head_conv1 = Conv(_FEATURES, _FEATURES // 2, 3, dtype=dtype)
        self.head_conv2 = Conv(_FEATURES // 2, 32, 3, dtype=dtype)
        self.head_conv3 = Conv(32, 1, 1, dtype=dtype)

    def tokens_to_spatial(self, tokens: torch.Tensor, i: int, h16: int, w16: int):
        """The "project" readout: [patches, cls] concatenated in that order,
        a dense layer and GELU, back to the token grid."""
        cls, patches = tokens[:, :1], tokens[:, 1:]
        merged = torch.cat([patches, cls.expand_as(patches)], dim=-1)
        projected = F.gelu(getattr(self, f"reassemble{i}_readout")(merged))
        return projected.transpose(1, 2).reshape(-1, _DIM, h16, w16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer1, layer2, tokens3, tokens4, (h16, w16) = self.encoder(x)
        r3 = self.reassemble3_project(self.tokens_to_spatial(tokens3, 3, h16, w16))
        r4 = self.reassemble4_project(self.tokens_to_spatial(tokens4, 4, h16, w16))
        r4 = self.reassemble4_downsample(r4)

        path = self.fusion4(self.scratch_rn4(r4))
        path = self.fusion3(path, self.scratch_rn3(r3))
        path = self.fusion2(path, self.scratch_rn2(layer2))
        path = self.fusion1(path, self.scratch_rn1(layer1))

        y = upsample2x_align_corners(self.head_conv1(path))
        y = F.relu(self.head_conv2(y))
        y = F.relu(self.head_conv3(y))  # non-negative inverse-depth logits
        return y[:, 0].float()


# ---------------------------------------------------------------------------
# The weight carrier: hive_tpu's flat "a/b/c" -> array mapping.
# ---------------------------------------------------------------------------

def _flax_shapes(model: Optional[nn.Module]):
    """(path, module, name, Flax shape) of each leaf in the reference
    tree's order. Without a model, the full DPTHybrid, built on the meta
    device."""
    if model is None:
        with torch.device("meta"):
            model = DPTHybrid()
    return [(path, module, name, module.flax_shape(name))
            for path, module, name in tree_order(model)]


def random_flax_params() -> Dict[str, np.ndarray]:
    """The reference's weights-absent initialisation of the full DPTHybrid
    (``flax_layers.random_flax_params``)."""
    with torch.device("meta"):
        return flax_layers.random_flax_params(DPTHybrid())


def check_flax_params(model: Optional[nn.Module] = None, seed: int = 0) -> Dict[str, np.ndarray]:
    """Informative random weights for checks, drawn in the tree's order from
    ``np.random.default_rng(seed)``: kernels at std 1/sqrt(fan_in), norm
    scales 1 + N(0, 0.1), biases N(0, 0.1), the class token and position
    embedding N(0, 0.02) (the reference's own initialisation gives a
    near-constant depth, which would hide a wrong layer). Two departures
    keep the network as stable as a trained one:

    * each residual branch is scaled by ``_RESIDUAL_GAIN``: the bottleneck's
      last norm scale (``gn3``) and the attention's and MLP's output
      kernels. At full scale every block adds as much as it carries, and a
      bf16 rounding grows through the 28 residual blocks: the reference's
      own bf16 logits then land half their range from its float32 logits.
    * the head's last kernel is non-negative, so the logits are positive
      almost everywhere (as a trained head's are) instead of cut to zero by
      the final ReLU.
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for path, module, name, shape in _flax_shapes(model):
        host = rng.standard_normal(shape, dtype=np.float32)
        if name == "scale":
            host = np.float32(1.0) + np.float32(0.1) * host
        elif name == "bias":
            host *= np.float32(0.1)
        elif name in ("cls_token", "pos_embed"):
            host *= np.float32(0.02)
        else:
            host *= np.float32(1.0 / math.sqrt(module.fan_in(name)))
        if path.endswith(("gn3/scale", "attn/out/kernel", "mlp_fc2/kernel")):
            host *= np.float32(_RESIDUAL_GAIN)
        if path == "head_conv3/kernel":
            host = np.abs(host)
        flat[path] = host
    return flat


# ---------------------------------------------------------------------------
# Cost.
# ---------------------------------------------------------------------------

def dpt_flops(net_size: Tuple[int, int], batch: int = 1) -> int:
    """Floating-point operations of one DPTHybrid forward on a batch at
    ``net_size`` (H, W, multiples of 32): 2 per multiply-add of every conv
    and dense layer and of the attention's two products. Norms, GELU,
    softmax, resizes and adds are left out."""
    h, w = net_size
    flops = 0

    def conv(cin, cout, k, oh, ow):
        nonlocal flops
        flops += 2 * cin * cout * k * k * oh * ow

    conv(3, 64, 7, h // 2, w // 2)                           # conv_root
    size, cin = (h // 4, w // 4), 64                         # after the max-pool
    for stage, blocks in enumerate((3, 4, 9)):
        width = 64 * 2 ** stage
        for block in range(blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            out = (size[0] // stride, size[1] // stride)
            conv(cin, width, 1, *size)
            conv(width, width, 3, *out)
            conv(width, 4 * width, 1, *out)
            if block == 0:
                conv(cin, 4 * width, 1, *out)                # projection
            size, cin = out, 4 * width
    h16, w16 = h // 16, w // 16
    dim, n = _DIM, h16 * w16 + 1
    conv(_STEM_OUT, dim, 1, h16, w16)                        # patch_embed
    flops += 12 * 2 * (12 * n * dim * dim + 2 * n * n * dim)  # qkv, out, mlp; QK^T, AV
    flops += 2 * 2 * (n - 1) * 2 * dim * dim                 # readouts
    conv(dim, dim, 1, h16, w16)                              # reassemble3_project
    conv(dim, dim, 1, h16, w16)                              # reassemble4_project
    conv(dim, dim, 3, h // 32, w // 32)                      # reassemble4_downsample
    for cin_rn, div in ((256, 4), (512, 8), (dim, 16), (dim, 32)):
        conv(cin_rn, 256, 3, h // div, w // div)             # scratch_rn1-4
    for div, units in ((32, 1), (16, 2), (8, 2), (4, 2)):    # fusion4-1
        for _ in range(2 * units):
            conv(256, 256, 3, h // div, w // div)
        conv(256, 256, 1, 2 * h // div, 2 * w // div)
    conv(256, 128, 3, h // 2, w // 2)                        # head
    conv(128, 32, 3, h, w)
    conv(32, 1, 1, h, w)
    return batch * flops


# ---------------------------------------------------------------------------
# Inference.
# ---------------------------------------------------------------------------

class DPTDepthEstimator:
    """Batched DPT depth inference on the card (or the CPU, if asked), in
    bf16 activations with float32 parameters, the NYU head's calibration.

    Frames of any size are normalised and resized (cubic) to ``net_size``
    on the device, and the depth is resized back to the source size with a
    nearest resize. Weights come from ``$WEIGHTS_PATH/dpt_hybrid_nyu.npz``
    (``hive_tpu``'s converted npz; :func:`convert_torch_checkpoint` writes
    it from the released checkpoint); without the file the model is
    initialised at random as the reference does, with the same values.

    With a device mesh (by default the pipeline's ``--num_devices`` mesh;
    ``mesh=None`` opts out) each batch splits over the mesh's devices, one
    replica of the model on each distinct device.
    """

    def __init__(self, net_size: Tuple[int, int] = (480, 640), device=None,
                 mesh=_RUNTIME_MESH):
        self.net_height, self.net_width = net_size
        self.device = get_device(device)
        with torch.device(self.device):
            self.model = DPTHybrid(dtype=torch.bfloat16).eval()
        load_flax_params(self.model, self._load_or_init_params())

        if mesh is _RUNTIME_MESH:
            mesh = runtime_mesh()
        self.mesh = mesh
        self._replicas: Dict[torch.device, nn.Module] = {}

    def _replica(self, device: torch.device) -> nn.Module:
        """The model on ``device``: ``self.model`` on its own device, else a
        copy made at first use (one per distinct device of a mesh)."""
        if device == self.device:
            return self.model
        if device not in self._replicas:
            self._replicas[device] = copy.deepcopy(self.model).to(device)
        return self._replicas[device]

    def _load_or_init_params(self):
        weights_path = os.path.join(os.environ.get("WEIGHTS_PATH", "weights"), WEIGHTS_FILENAME)
        if os.path.isfile(weights_path):
            logging.info(f"Loading DPT weights from {weights_path}")
            self.weights_loaded = True
            return np.load(weights_path)

        logging.warning(f"DPT weights not found at {weights_path}; using random "
                        f"initialisation (depth will be uncalibrated). Convert the released "
                        f"checkpoint with hive_tpu_torch.models.dpt.convert_torch_checkpoint.")
        self.weights_loaded = False
        return random_flax_params()

    def _forward(self, model: nn.Module, frames: torch.Tensor) -> torch.Tensor:
        """Metric depth (B, net H, net W) of uint8 frames on ``model``'s device."""
        images = prepare_model_input(frames, (self.net_height, self.net_width))
        inverse_depth = model(images.permute(0, 3, 1, 2))
        return 1.0 / torch.clamp_min(NYU_SCALE * inverse_depth + NYU_SHIFT, 1e-6)

    @torch.inference_mode()
    def predict_batch(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> (B, H, W) float32 metric depth (metres)."""
        b, h, w = frames.shape[:3]
        frames = np.ascontiguousarray(frames)
        if self.mesh is None:
            depth = self._forward(self.model, torch.from_numpy(frames).to(self.device))
        else:
            # Edge-pad (repeat the last frame): padding rows run the same
            # compute without touching the real outputs.
            padded = pad_to_multiple(frames, self.mesh.size, axis=0)
            padded[b:] = frames[b - 1]
            parts = []
            for part, d in zip(shard_batch(self.mesh, padded), self.mesh.devices):
                with on_device(d):
                    parts.append(self._forward(self._replica(d), part))
            depth = torch.cat([p.to(self.device) for p in parts])[:b]
        if depth.shape[1:] != (h, w):
            depth = resize(depth, (b, h, w), "nearest")
        return depth.cpu().numpy()


# ---------------------------------------------------------------------------
# Weight conversion (the released torch checkpoint -> the shared npz).
# ---------------------------------------------------------------------------

def convert_torch_checkpoint(torch_checkpoint_path: str, output_path: str):
    """Convert the released ``dpt_hybrid_nyu.pt`` (timm's hybrid ViT and
    DPT's scratch decoder) into the flat npz that ``hive_tpu`` and this
    port both read: the same keys and arrays as ``hive_tpu``'s converter
    (conv kernels OIHW -> HWIO, dense kernels transposed, the attention's
    qkv split into (dim, heads, head_dim) kernels)."""
    from hive_tpu_torch.models.convert_utils import (TrackedState, WriteOnceDict,
                                                     iter_flat_numpy)

    state = torch.load(torch_checkpoint_path, map_location="cpu")
    if "state_dict" in state:
        state = state["state_dict"]
    state = TrackedState(iter_flat_numpy(state), name="DPT checkpoint")
    params = WriteOnceDict()

    def conv(src: str, dst: str, bias: bool = True):
        params[f"{dst}/kernel"] = state[f"{src}.weight"].transpose(2, 3, 1, 0)
        if bias and f"{src}.bias" in state:
            params[f"{dst}/bias"] = state[f"{src}.bias"]

    def group_norm(src: str, dst: str):
        params[f"{dst}/scale"] = state[f"{src}.weight"]
        params[f"{dst}/bias"] = state[f"{src}.bias"]

    def dense(src: str, dst: str):
        params[f"{dst}/kernel"] = state[f"{src}.weight"].T
        if f"{src}.bias" in state:
            params[f"{dst}/bias"] = state[f"{src}.bias"]

    vit = "pretrained.model"
    resnet = f"{vit}.patch_embed.backbone"
    conv(f"{resnet}.stem.conv", "encoder/resnet/conv_root", bias=False)
    group_norm(f"{resnet}.stem.norm", "encoder/resnet/gn_root")
    for stage, num_blocks in enumerate((3, 4, 9)):
        for block in range(num_blocks):
            src = f"{resnet}.stages.{stage}.blocks.{block}"
            dst = f"encoder/resnet/stage{stage + 1}_block{block + 1}"
            for k in (1, 2, 3):
                group_norm(f"{src}.norm{k}", f"{dst}/gn{k}")
                conv(f"{src}.conv{k}", f"{dst}/conv{k}", bias=False)
            if f"{src}.downsample.conv.weight" in state:
                conv(f"{src}.downsample.conv", f"{dst}/conv_proj", bias=False)
                group_norm(f"{src}.downsample.norm", f"{dst}/gn_proj")

    conv(f"{vit}.patch_embed.proj", "encoder/patch_embed")
    params["encoder/cls_token"] = state[f"{vit}.cls_token"]
    params["encoder/pos_embed"] = state[f"{vit}.pos_embed"]

    dim, heads = 768, 12
    head_dim = dim // heads
    for i in range(12):
        src, dst = f"{vit}.blocks.{i}", f"encoder/block{i}"
        for norm in ("norm1", "norm2"):
            params[f"{dst}/{norm}/scale"] = state[f"{src}.{norm}.weight"]
            params[f"{dst}/{norm}/bias"] = state[f"{src}.{norm}.bias"]
        qkv_w = state[f"{src}.attn.qkv.weight"]  # (3 * dim, dim)
        qkv_b = state[f"{src}.attn.qkv.bias"]
        for j, name in enumerate(("query", "key", "value")):
            rows = slice(j * dim, (j + 1) * dim)
            params[f"{dst}/attn/{name}/kernel"] = qkv_w[rows].T.reshape(dim, heads, head_dim)
            params[f"{dst}/attn/{name}/bias"] = qkv_b[rows].reshape(heads, head_dim)
        params[f"{dst}/attn/out/kernel"] = \
            state[f"{src}.attn.proj.weight"].T.reshape(heads, head_dim, dim)
        params[f"{dst}/attn/out/bias"] = state[f"{src}.attn.proj.bias"]
        dense(f"{src}.mlp.fc1", f"{dst}/mlp_fc1")
        dense(f"{src}.mlp.fc2", f"{dst}/mlp_fc2")

    dense("pretrained.act_postprocess3.0.project.0", "reassemble3_readout")
    dense("pretrained.act_postprocess4.0.project.0", "reassemble4_readout")
    conv("pretrained.act_postprocess3.3", "reassemble3_project")
    conv("pretrained.act_postprocess4.3", "reassemble4_project")
    conv("pretrained.act_postprocess4.4", "reassemble4_downsample")

    for i in range(1, 5):
        conv(f"scratch.layer{i}_rn", f"scratch_rn{i}", bias=False)
    for i in (4, 3, 2, 1):
        src, dst = f"scratch.refinenet{i}", f"fusion{i}"
        # The top block takes no skip: its resConfUnit1 is never applied.
        units = (("resConfUnit2", "rcu2"),) if i == 4 else (("resConfUnit1", "rcu1"),
                                                            ("resConfUnit2", "rcu2"))
        for theirs, ours in units:
            conv(f"{src}.{theirs}.conv1", f"{dst}/{ours}/conv1")
            conv(f"{src}.{theirs}.conv2", f"{dst}/{ours}/conv2")
        conv(f"{src}.out_conv", f"{dst}/out_conv")

    conv("scratch.output_conv.0", "head_conv1")
    conv("scratch.output_conv.2", "head_conv2")
    conv("scratch.output_conv.4", "head_conv3")

    # refinenet4.resConfUnit1 is in the checkpoint but never applied; the
    # ViT's final norm and classifier are not part of DPT.
    state.assert_fully_consumed(ignore=(
        r"^scratch\.refinenet4\.resConfUnit1\.",
        r"^pretrained\.model\.norm\.",
        r"^pretrained\.model\.head\.",
        r"num_batches_tracked$",
    ))
    np.savez(output_path, **params)
    logging.info(f"Converted DPT checkpoint written to {output_path}")
