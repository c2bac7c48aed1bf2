"""DPT-Hybrid (hive_tpu_torch.models.dpt, hive_tpu_torch.ops.resize)
against hive_tpu's on the same inputs and weights: the resizes, each module
with the check weights (``dpt.check_flax_params``) carried from the Flax
tree, the full-width network's logits, tapped features and last fused map,
the random initialisation (bit for bit), and the converted-checkpoint route
through both packages.

The reference's own random weights give a near-constant depth (~7.2569 m),
which would hide a wrong layer, so the parity tests draw informative ones,
with residual branches as small against the stream as a trained network's,
so that bf16 moves the reference's own outputs by about one percent.
Tolerances, relative to the output's largest magnitude: float32 within
1e-4 for a module, 1e-3 for the full network (XLA's and torch's CPU
kernels sum in other orders); bf16 within BF16_TOL (XLA keeps some bf16
intermediates in float32, torch rounds each, so the two bf16 outputs are
about as far apart as each is from float32).
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from hive_tpu.models import dpt as jax_dpt
from hive_tpu.models.convert_utils import unflatten_params
from hive_tpu.ops import resize as jax_resize
from hive_tpu_torch.models import dpt
from hive_tpu_torch.ops import resize

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
NET = (64, 96)


def to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def flax_tree(flat):
    return unflatten_params(flat, leaf=jnp.asarray)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


# Max |difference| over max |reference|, by dtype, for a module. fp32:
# XLA's and torch's CPU kernels sum in other orders. bf16: the largest
# measured on these inputs is 0.0137 (the stem's /16 output); a single conv
# and the fusion blocks agree to 3e-5.
TOL = {"fp32": 1e-4, "bf16": 0.03}


def reference(make_flax, dtype, params, *args):
    """The flax module's output in ``dtype``, as float32 numpy arrays (a
    list)."""
    jd = DTYPES[dtype][0]
    out = jax.jit(make_flax(jd).apply)({"params": params},
                                       *(jnp.asarray(a).astype(jd) for a in args))
    return [np.asarray(o.astype(jnp.float32)) for o in (out if isinstance(out, list) else [out])]


# ---------------------------------------------------------------------------
# Resizes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((48, 64), (96, 128)), ((96, 128), (64, 96)),
                                     ((50, 70), (50, 70))], ids=["up", "down", "same"])
def test_cubic_input_resize_matches_jax(src, dst):
    """Keys cubic (a = -0.5), antialiased when downsampling; the same size
    is the identity (bit-equal to the jitted reference, whose normalisation
    fuses into an FMA). Normalised inputs in [-1, 1]: within 1e-5."""
    frames = np.random.default_rng(0).integers(0, 256, (2, *src, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(lambda f: jax_resize.prepare_model_input(f, dst))(
        jnp.asarray(frames)))
    got = resize.prepare_model_input(torch.from_numpy(frames), dst).numpy()
    assert got.shape == want.shape == (2, *dst, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if src == dst:
        np.testing.assert_array_equal(got, want)


def test_normalize_rounds_as_xla():
    """x * f32(1/255) - 0.5 as one FMA, then / 0.5: bit-equal."""
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(resize.normalize(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jax_resize.normalize)(jnp.asarray(x))))


@pytest.mark.parametrize("grid", [(4, 6), (6, 8), (30, 40)])
def test_position_embedding_resize_matches_jax(grid):
    """The 24 x 24 grid to the token grid, bilinear: a downsample (the
    triangle widened by 1/scale) under 24 x 24, within 1e-6."""
    pos = np.random.default_rng(1).standard_normal((1, 24, 24, 16)).astype(np.float32)
    shape = (1, *grid, 16)
    want = np.asarray(jax.image.resize(jnp.asarray(pos), shape, method="bilinear"))
    got = resize.resize(torch.from_numpy(pos), shape, "bilinear").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("src,dst", [((64, 96), (48, 64)), ((64, 96), (61, 95)),
                                     ((64, 96), (480, 640)), ((480, 640), (333, 517)),
                                     ((96, 128), (100, 130))])
def test_nearest_resize_back_matches_jax(src, dst):
    depth = np.random.default_rng(2).standard_normal(src).astype(np.float32)
    np.testing.assert_array_equal(
        resize.resize(torch.from_numpy(depth), dst, "nearest").numpy(),
        np.asarray(jax.image.resize(jnp.asarray(depth), dst, method="nearest")))


def test_keep_aspect_multiple_of_table():
    sizes = [(480, 640), (48, 64), (96, 128), (720, 1280), (1080, 1920), (640, 480),
             (1920, 1440), (256, 192), (37, 53), (300, 1000), (1000, 300), (1, 1)]
    for size in sizes:
        assert resize.keep_aspect_multiple_of(size) == jax_resize.keep_aspect_multiple_of(size)


# ---------------------------------------------------------------------------
# Modules, each against its flax twin with the weights carried over.
# ---------------------------------------------------------------------------

def _module_pair(case, td):
    """(flax module maker by dtype, port module, input channels, side)."""
    if case == "stdconv_7x7s2":
        return lambda jd: jax_dpt.StdConv(32, (7, 7), (2, 2), dtype=jd), \
            dpt.StdConv(3, 32, 7, 2, td), 3, 32
    if case == "stdconv_3x3s2":
        return lambda jd: jax_dpt.StdConv(32, (3, 3), (2, 2), dtype=jd), \
            dpt.StdConv(16, 32, 3, 2, td), 16, 16
    if case == "stdconv_1x1":
        return lambda jd: jax_dpt.StdConv(32, (1, 1), dtype=jd), dpt.StdConv(16, 32, 1, 1, td), \
            16, 16
    if case == "bottleneck_projection":
        return lambda jd: jax_dpt.Bottleneck(32, (2, 2), dtype=jd), \
            dpt.Bottleneck(64, 32, 2, td), 64, 16
    if case == "bottleneck_identity":
        return lambda jd: jax_dpt.Bottleneck(32, dtype=jd), dpt.Bottleneck(128, 32, 1, td), 128, 16
    if case == "stem":
        return (lambda jd: jax_dpt.ResNetV2Stem(block_sizes=(1, 1, 1), width=32, dtype=jd),
                dpt.ResNetV2Stem(block_sizes=(1, 1, 1), width=32, dtype=td), 3, 64)
    raise KeyError(case)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["stdconv_7x7s2", "stdconv_3x3s2", "stdconv_1x1",
                                  "bottleneck_projection", "bottleneck_identity", "stem"])
def test_conv_modules_match_flax(case, dtype):
    """Weight standardisation (float32, population variance, eps 1e-8);
    timm "same" padding, low side first ((2, 3) at 7x7/2, (0, 1) at 3x3/2);
    the stem's max-pool padded (0, 1) with -inf; GroupNorm (32 groups, eps
    1e-5) in float32. Within TOL."""
    make_flax, module, cin, size = _module_pair(case, DTYPES[dtype][1])
    flat = dpt.check_flax_params(module, seed=3)
    dpt.load_flax_params(module, flat)
    x = np.random.default_rng(4).standard_normal((2, size, size, cin)).astype(np.float32)
    wants = reference(make_flax, dtype, flax_tree(flat), x)
    with torch.no_grad():
        got = module(to_nchw(x))
    gots = got if isinstance(got, list) else [got]
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        w = w.transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        assert rel_err(g.float().numpy(), w) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_transformer_block_matches_flax(dtype):
    """LayerNorm eps 1e-6 (torch's default is 1e-5); the query scaled by
    1/sqrt(head_dim) before the product; exact (erf) GELU; the residual
    stream stays float32 (flax takes the softmax in bf16, the port's
    attention in float32). Within TOL."""
    td = DTYPES[dtype][1]
    module = dpt.TransformerBlock(dim=64, num_heads=4, dtype=td)
    flat = dpt.check_flax_params(module, seed=5)
    dpt.load_flax_params(module, flat)
    x = np.random.default_rng(6).standard_normal((2, 25, 64)).astype(np.float32)
    (want,) = reference(lambda jd: jax_dpt.TransformerBlock(dim=64, num_heads=4, dtype=jd),
                        dtype, flax_tree(flat), x)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < TOL[dtype]


def test_layer_norm_eps_is_flax_not_torch():
    """At a variance near 1e-5, eps 1e-6 and 1e-5 give visibly different
    outputs: the port takes flax's."""
    norm = dpt.LayerNorm(8)
    x = 3e-3 * np.random.default_rng(7).standard_normal((4, 8)).astype(np.float32)
    want = np.asarray(nn.LayerNorm().apply({"params": {"scale": jnp.ones(8), "bias": jnp.zeros(8)}},
                                           jnp.asarray(x)))
    with torch.no_grad():
        got = norm(torch.from_numpy(x)).numpy()
        torch_default = torch.nn.functional.layer_norm(torch.from_numpy(x), (8,)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(torch_default - want).max() > 1e-2


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("skip", [True, False], ids=["skip", "top"])
def test_fusion_block_matches_flax(dtype, skip):
    """The residual units, the align-corners x2 upsample (``frac`` in the
    activation dtype, a * (1 - frac) + b * frac, H then W) and the 1x1 conv.
    Within TOL."""
    td = DTYPES[dtype][1]
    module = dpt.FeatureFusionBlock(32, td, with_skip=skip)
    flat = dpt.check_flax_params(module, seed=8)
    dpt.load_flax_params(module, flat)
    rng = np.random.default_rng(9)
    inputs = [rng.standard_normal((2, 6, 8, 32)).astype(np.float32) for _ in range(1 + skip)]
    (want,) = reference(lambda jd: jax_dpt.FeatureFusionBlock(32, dtype=jd), dtype,
                        flax_tree(flat), *inputs)
    with torch.no_grad():
        got = module(*(to_nchw(a).to(td) for a in inputs))
    assert got.dtype == td
    assert rel_err(got.float().numpy(), want.transpose(0, 3, 1, 2)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_align_corners_upsample_matches_jax(dtype):
    """Within one rounding of the dtype (XLA fuses the blend into FMAs)."""
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(10).standard_normal((1, 15, 24, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_dpt._upsample2x_align_corners)(
        jnp.asarray(x).astype(jd)).astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = dpt.upsample2x_align_corners(to_nchw(x).to(td)).float().numpy()
    assert rel_err(got, want) < (1e-5 if dtype == "fp32" else 1e-2)


# ---------------------------------------------------------------------------
# The full-width network.
# ---------------------------------------------------------------------------

# The full network's outputs that are compared: the logits, the encoder's
# four taps and the decoder's last fused map (fusion1).
OUTPUTS = ("logits", "layer1", "layer2", "tokens3", "tokens4", "fusion1")
# Max |difference| over max |reference| for the full network. fp32: sums
# over 12 blocks and 16 bottlenecks (measured 2.6e-6). bf16: the largest
# measured is 0.0210 (tokens3; the logits 0.0174); a zeroed head gives 1.
FULL_TOL = {"fp32": 1e-3, "bf16": 0.04}


@pytest.fixture(scope="module")
def full_flat():
    return dpt.check_flax_params(seed=11)


@pytest.fixture(scope="module")
def full_images():
    frames = np.random.default_rng(12).integers(0, 256, (2, *NET, 3)).astype(np.uint8)
    return resize.normalize(torch.from_numpy(frames)).numpy()


@pytest.fixture(scope="module")
def flax_outputs(full_flat, full_images):
    """The reference's OUTPUTS by dtype, computed once: {name: (values as
    float32 NHWC / token arrays, dtype name)}."""
    cache = {}

    def forward(dtype):
        if dtype not in cache:
            model = jax_dpt.DPTHybrid(dtype=DTYPES[dtype][0])
            logits, state = jax.jit(lambda p, x: model.apply(
                {"params": p}, x,
                capture_intermediates=lambda mdl, _: mdl.name in ("encoder", "fusion1")))(
                flax_tree(full_flat), jnp.asarray(full_images))
            taps = state["intermediates"]["encoder"]["__call__"][0][:4]
            fused = state["intermediates"]["fusion1"]["__call__"][0]
            cache[dtype] = {name: (np.asarray(a.astype(jnp.float32)), str(a.dtype))
                            for name, a in zip(OUTPUTS, (logits, *taps, fused))}
        return cache[dtype]

    return forward


def full_network_mismatches(full_flat, full_images, flax_outputs, dtype, plant=None):
    """The OUTPUTS in which the port's full-width DPTHybrid differs from
    hive_tpu's in ``dtype``: in the dtype it computes them in (the
    reference's per-module casts: in bf16 the stem and the residual stream
    float32, the decoder bf16, the logits float32) or by FULL_TOL[dtype] or
    more. ``plant(model)`` plants a fault before the forward."""
    model = dpt.load_flax_params(dpt.DPTHybrid(dtype=DTYPES[dtype][1]), full_flat).eval()
    if plant is not None:
        plant(model)
    out = {}
    model.encoder.register_forward_hook(lambda m, i, o: out.update(zip(OUTPUTS[1:5], o), grid=o[4]))
    model.fusion1.register_forward_hook(lambda m, i, o: out.update(fusion1=o))
    with torch.no_grad():
        out["logits"] = model(to_nchw(full_images))
    assert out["grid"] == (NET[0] // 16, NET[1] // 16) and out["logits"].shape == (2, *NET)
    mismatches = []
    for name, (want, want_dtype) in flax_outputs(dtype).items():
        got = out[name]
        values = got.float().numpy()
        if values.ndim == 4:
            values = values.transpose(0, 2, 3, 1)
        assert values.shape == want.shape, name
        assert np.abs(want).max() > 0.1, name  # informative: not the near-zero head
        if str(got.dtype).removeprefix("torch.") != want_dtype or \
                not rel_err(values, want) < FULL_TOL[dtype]:
            mismatches.append(name)
    return mismatches


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_full_dpt_hybrid_matches_flax(full_flat, full_images, flax_outputs, dtype):
    """The full-width DPT-Hybrid at 64 x 96 (R50 stem (3, 4, 9), ViT-B/16:
    768 wide, 12 blocks, 12 heads, hooks 8 and 11; 256-wide fusion; NYU
    head): the readout concatenates [patches, cls] in that order, the /32
    downsample pads (1, 1). Every one of OUTPUTS in the reference's dtype
    and within FULL_TOL."""
    assert full_network_mismatches(full_flat, full_images, flax_outputs, dtype) == []


def _zero_head(model):
    model.head_conv3.kernel.zero_()
    model.head_conv3.bias.zero_()


def _stem_in_bf16(model):
    for module in model.encoder.resnet.modules():
        if isinstance(module, dpt.GroupNorm):
            module.register_forward_hook(lambda m, i, o: o.to(torch.bfloat16))


def _decoder_in_fp32(model):
    for name, module in model.named_children():
        if name != "encoder":
            for sub in module.modules():
                if isinstance(sub, (dpt.Conv, dpt.Dense)):
                    sub.dtype = torch.float32


@pytest.mark.parametrize("plant,caught", [(_zero_head, ["logits"]),
                                          (_stem_in_bf16, ["layer1", "layer2"]),
                                          (_decoder_in_fp32, ["fusion1"])],
                         ids=["zeroed_head", "stem_in_bf16", "decoder_in_fp32"])
def test_full_dpt_bf16_check_catches_planted_faults(full_flat, full_images, flax_outputs,
                                                    plant, caught):
    """The bf16 comparison above fails for a zeroed head (its logits are 0,
    1 from the reference's), for a stem whose activations are cast to bf16
    and for a decoder left in float32. The last two move the values by less
    than bf16's own noise (measured: layer2 0.0161 against 0.0128, fusion1
    0.0132 against 0.0126); the dtypes catch them."""
    mismatches = full_network_mismatches(full_flat, full_images, flax_outputs, "bf16", plant)
    assert set(caught) <= set(mismatches), mismatches


def test_dpt_flops_counts_every_product():
    """The analytic count equals the multiply-adds of every conv and dense
    layer and of the attention's two products, counted from the shapes of
    a forward; and the sizes the CLI and the graft entry use."""
    with torch.device("meta"):
        model = dpt.DPTHybrid()
    counted = []

    def hook(module, inputs, output):
        if isinstance(module, dpt.Conv):
            o, i, kh, kw = module.kernel.shape
            counted.append(2 * output.numel() * i * kh * kw)
        elif isinstance(module, dpt.Dense):
            counted.append(2 * output.numel() * module.kernel.shape[1])
        elif isinstance(module, dpt.MultiHeadDotProductAttention):
            b, n, d = output.shape
            counted.append(2 * 2 * b * n * n * d)

    for m in model.modules():
        m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, *NET, device="meta"))
    assert sum(counted) == dpt.dpt_flops(NET, 1)
    assert dpt.dpt_flops((480, 640), 8) == 8 * dpt.dpt_flops((480, 640))
    assert round(dpt.dpt_flops((480, 640)) / 1e9, 1) == 559.1
    assert round(dpt.dpt_flops((256, 320)) / 1e9, 1) == 138.8


def test_random_init_is_the_references_bit_for_bit():
    """``random_flax_params()`` equals ``fast_random_params`` on the
    reference model: the same 408 leaves, shapes and bits."""
    from flax import traverse_util
    from hive_tpu.models.initialisation import fast_random_params

    want = traverse_util.flatten_dict(
        fast_random_params(jax_dpt.DPTHybrid(dtype=jnp.bfloat16),
                           jnp.zeros((1, *NET, 3), jnp.float32)), sep="/")
    got = dpt.random_flax_params()
    assert sorted(got) == sorted(want) and len(got) == 408
    for key, value in want.items():
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)


def test_load_refuses_missing_unused_and_misshaped_keys():
    module = dpt.Bottleneck(64, 16)
    flat = dpt.check_flax_params(module)
    with pytest.raises(KeyError, match="missing \\['gn3/bias'\\]"):
        dpt.load_flax_params(module, {k: v for k, v in flat.items() if k != "gn3/bias"})
    with pytest.raises(KeyError, match="unused \\['extra/kernel'\\]"):
        dpt.load_flax_params(module, {**flat, "extra/kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="conv1/kernel"):
        dpt.load_flax_params(module, {**flat, "conv1/kernel": np.zeros((1, 1, 64, 8))})


def test_converted_checkpoint_route(tmp_path, monkeypatch):
    """The released checkpoint's layout (``make_fake_dpt_state_dict``)
    through both converters gives the same npz; the port's estimator on it
    equals ``hive_tpu``'s ``predict_batch`` at net size 64 x 96 on frames of
    another size (cubic resize in, nearest back), within 1 mm."""
    from hive_tpu.models.dpt import convert_torch_checkpoint as jax_convert
    from hive_tpu.models.selftest import make_fake_dpt_state_dict

    torch.save(make_fake_dpt_state_dict(), tmp_path / "dpt_hybrid_nyu.pt")
    jax_convert(str(tmp_path / "dpt_hybrid_nyu.pt"), str(tmp_path / "jax.npz"))
    dpt.convert_torch_checkpoint(str(tmp_path / "dpt_hybrid_nyu.pt"),
                                 str(tmp_path / "dpt_hybrid_nyu.npz"))
    (tmp_path / "dpt_hybrid_nyu.pt").unlink()
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "dpt_hybrid_nyu.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    frames = np.random.default_rng(13).integers(0, 256, (3, 50, 70, 3)).astype(np.uint8)
    ours = dpt.DPTDepthEstimator(net_size=NET, device="cpu")
    theirs = jax_dpt.DPTDepthEstimator(net_size=NET, mesh=None)
    assert ours.weights_loaded and theirs.weights_loaded
    got, want = ours.predict_batch(frames), theirs.predict_batch(frames)
    assert got.shape == want.shape == (3, 50, 70) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
