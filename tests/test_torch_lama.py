"""big-lama (hive_tpu_torch.models.lama) against hive_tpu's Flax LaMa.

Each module (the Fourier unit at odd and even widths, the FFC with and
without a global input, the residual block, the transposed convolution)
and the whole generator at ngf 8, 2 downsamples, 2 blocks, with the same
weights and inputs, in float32 and bf16, values and dtypes. Tolerances, measured here (XLA:CPU against torch's CPU kernels):

* float32: the generator's outputs agree within 1.8e-7 (``F32_ATOL`` 1e-5);
* bf16: the two packages round each bf16 conv alike, so the generator's
  outputs agree to 2.8e-7 on average; a rare conv output a bf16 ulp apart
  moves a few values by up to 4.9e-4 (``BF16_ATOL`` 1e-3,
  ``BF16_MEAN`` 1e-5).

Three planted faults are caught by those checks: re/im interleaved in the
Fourier unit (the torch layout, 1e-2 on average), a deconvolution kernel
left unflipped (6e-2), and the Fourier unit's transforms taking bf16 inputs
and outputs (3e-4 on average, 1.8e-3 at most). Also: the random
initialisation bit-equal to ``fast_random_params``, one npz from both
converters, ``LamaInpainter``'s padding and truncation, and
``lama_flops`` against a count of the convolutions run.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from hive_tpu.models import lama as jax_lama
from hive_tpu.models.convert_utils import unflatten_params
from hive_tpu_torch.models import lama
from hive_tpu_torch.models.flax_layers import Conv, fan_in_params

SMALL = dict(base_features=8, num_downsamples=2, num_blocks=2)
F32_ATOL = 1e-5
BF16_ATOL = 1e-3
BF16_MEAN = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().numpy()


def assert_close(got: np.ndarray, want: np.ndarray, precision: str):
    difference = np.abs(got - want)
    if precision == "f32":
        assert difference.max() <= F32_ATOL, difference.max()
    else:
        assert difference.max() <= BF16_ATOL, difference.max()
        assert difference.mean() <= BF16_MEAN, difference.mean()


def module_params(module: torch.nn.Module, seed: int = 0):
    """Fan-in weights for ``module`` (built on the meta device)."""
    flat = fan_in_params(module, seed)
    return flat, unflatten_params(flat, leaf=jnp.asarray)


def build(cls, precision, *args):
    with torch.device("meta"):
        meta = cls(*args, dtype=DTYPES[precision][0])
    flat, tree = module_params(meta)
    module = cls(*args, dtype=DTYPES[precision][0]).eval()
    lama.load_flax_params(module, flat)
    return module, tree


def inputs(*shapes, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("width", [12, 13])
def test_fourier_unit(precision, width):
    module, tree = build(lama.FourierUnit, precision, 6)
    (x,) = inputs((2, 10, width, 6))
    want = np.asarray(jax_lama.FourierUnit(6, dtype=DTYPES[precision][1]).apply(
        {"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = module(nchw(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert_close(nhwc(got), want, precision)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["block", "down_to_global"])
def test_ffc_bn_act(precision, layout):
    """(in_local, in_global, features, ratio_gout, kernel, stride)."""
    config = {"block": (4, 12, 16, 0.75, 3, 1), "down_to_global": (8, 0, 16, 0.75, 3, 2)}[layout]
    in_local, in_global, features, ratio, kernel, stride = config
    module, tree = build(lama.FFCBnAct, precision, *config)
    x_local, x_global = inputs((2, 12, 14, in_local), (2, 12, 14, max(in_global, 1)))
    reference = jax_lama.FFCBnAct(features, ratio, kernel=kernel, stride=stride,
                                  dtype=DTYPES[precision][1])
    want = reference.apply({"params": tree}, jnp.asarray(x_local),
                           jnp.asarray(x_global) if in_global else None)
    with torch.no_grad():
        got = module(nchw(x_local), nchw(x_global) if in_global else None)
    for ours, theirs in zip(got, want):
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert ours.dtype == torch.float32 and theirs.dtype == jnp.float32
            assert_close(nhwc(ours), np.asarray(theirs), precision)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_residual_block(precision):
    module, tree = build(lama.FFCResNetBlock, precision, 16, 0.75)
    x_local, x_global = inputs((2, 10, 12, 4), (2, 10, 12, 12))
    want = jax_lama.FFCResNetBlock(16, 0.75, dtype=DTYPES[precision][1]).apply(
        {"params": tree}, jnp.asarray(x_local), jnp.asarray(x_global))
    with torch.no_grad():
        got = module(nchw(x_local), nchw(x_global))
    for ours, theirs in zip(got, want):
        assert_close(nhwc(ours), np.asarray(theirs), precision)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_deconv_bn(precision):
    module, tree = build(lama.DeconvBN, precision, 12, 6)
    (x,) = inputs((2, 7, 9, 12))
    want = np.asarray(jax_lama.DeconvBN(6, dtype=DTYPES[precision][1]).apply(
        {"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = module(nchw(x))
    assert got.shape == (2, 6, 14, 18) and got.dtype == torch.float32
    assert_close(nhwc(got), want, precision)


# ---------------------------------------------------------------------------
# The generator.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def generator_case():
    """Check weights, two frames with holes, and hive_tpu's outputs."""
    flat = lama.check_params(0, **SMALL)
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (2, 36, 52, 3)).astype(np.float32)
    mask = np.zeros((2, 36, 52, 1), np.float32)
    mask[:, 8:20, 10:30] = 1
    mask[1, 20:30, 5:15] = 1
    want = {}
    for precision, (_, jax_dtype) in DTYPES.items():
        want[precision] = np.asarray(jax_lama.LamaGenerator(dtype=jax_dtype, **SMALL).apply(
            {"params": unflatten_params(flat, leaf=jnp.asarray)}, jnp.asarray(image),
            jnp.asarray(mask)))
    return flat, image, mask, want


def run_generator(case, precision):
    flat, image, mask, _ = case
    model = lama.LamaGenerator(dtype=DTYPES[precision][0], **SMALL).eval()
    lama.load_params(model, flat)
    with torch.no_grad():
        out = model(nchw(image), nchw(mask))
    assert out.dtype == torch.float32
    return nhwc(out)


def fill_error(case, precision):
    _, _, mask, want = case
    hole = mask[..., 0] > 0
    return np.abs(run_generator(case, precision) - want[precision])[hole]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_generator_matches_hive_tpu(generator_case, precision):
    """The hole holds the prediction (spread over 0.26-0.76: informative),
    known pixels pass through exactly."""
    _, image, mask, want = generator_case
    got = run_generator(generator_case, precision)
    assert_close(got, want[precision], precision)
    hole = mask[..., 0] > 0
    np.testing.assert_array_equal(got[~hole], image[~hole])
    assert want[precision][hole].max() - want[precision][hole].min() > 0.3


def interleaved_fourier_unit(self, x):
    """Fault: torch's interleaved re/im channel order."""
    h, w = x.shape[-2:]
    freq = torch.fft.rfft2(x.float(), dim=(-2, -1), norm="ortho")
    stacked = torch.stack([freq.real, freq.imag], dim=2).flatten(1, 2)
    y = torch.relu(self.bn(self.conv(stacked))).float().unflatten(1, (self.features, 2))
    return torch.fft.irfft2(torch.complex(y[:, :, 0], y[:, :, 1]), s=(h, w), dim=(-2, -1),
                            norm="ortho").to(x.dtype)


def bf16_fourier_unit(self, x):
    """Fault: the transforms take and give the conv's dtype."""
    h, w = x.shape[-2:]
    low = self.conv.dtype
    freq = torch.fft.rfft2(x.to(low).float(), dim=(-2, -1), norm="ortho")
    y = torch.relu(self.bn(self.conv(torch.cat([freq.real, freq.imag], dim=1)))).to(low).float()
    out = torch.fft.irfft2(torch.complex(y[:, :self.features], y[:, self.features:]), s=(h, w),
                           dim=(-2, -1), norm="ortho")
    return out.to(low).to(x.dtype)


@pytest.mark.parametrize("fault", ["interleaved_re_im", "unflipped_deconv", "bf16_fft"])
def test_planted_faults_are_caught(generator_case, monkeypatch, fault):
    if fault == "interleaved_re_im":
        monkeypatch.setattr(lama.FourierUnit, "forward", interleaved_fourier_unit)
    elif fault == "unflipped_deconv":
        monkeypatch.setattr(lama.ConvTranspose3x3, "to_torch",
                            lambda self, name, array: array.transpose(2, 3, 0, 1))
    else:
        monkeypatch.setattr(lama.FourierUnit, "forward", bf16_fourier_unit)
    error = fill_error(generator_case, "bf16")
    assert error.max() > BF16_ATOL or error.mean() > BF16_MEAN
    assert error.mean() > 10 * BF16_MEAN


def test_random_init_is_the_reference_init():
    """The weights-absent initialisation of the full generator, leaf for
    leaf and bit for bit."""
    from hive_tpu.models.initialisation import fast_random_params

    want = fast_random_params(jax_lama.LamaGenerator(), jnp.zeros((1, 64, 64, 3)),
                              jnp.zeros((1, 64, 64, 1)))
    want = {"/".join(key): np.asarray(value) for key, value in flatten_dict(want).items()}
    got = lama.reference_random_params()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_converters_write_one_npz(tmp_path):
    """Both converters on the reference selftest's fake big-lama
    checkpoint: the same keys and the same arrays, and the port loads it."""
    from hive_tpu.models.selftest import make_fake_biglama_state_dict

    path = str(tmp_path / "best.ckpt")
    torch.save(make_fake_biglama_state_dict(), path)
    want = jax_lama.convert_torch_checkpoint(path, str(tmp_path / "jax.npz"), **SMALL)
    got = lama.convert_torch_checkpoint(path, str(tmp_path / "torch.npz"), **SMALL)
    with np.load(tmp_path / "jax.npz") as theirs, np.load(tmp_path / "torch.npz") as ours:
        assert sorted(ours.files) == sorted(theirs.files) == sorted(want) == sorted(got)
        for key in theirs.files:
            assert ours[key].dtype == theirs[key].dtype, key
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    lama.load_params(lama.LamaGenerator(**SMALL), str(tmp_path / "torch.npz"))


def test_converter_refuses_a_drifted_checkpoint(tmp_path):
    from hive_tpu.models.selftest import make_fake_biglama_state_dict

    state = make_fake_biglama_state_dict()
    state["state_dict"]["generator.model.99.weight"] = torch.zeros(3)
    path = str(tmp_path / "best.ckpt")
    torch.save(state, path)
    with pytest.raises(ValueError, match="model.99.weight"):
        lama.convert_torch_checkpoint(path, str(tmp_path / "out.npz"), **SMALL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_inpaint_pads_and_truncates_as_hive_tpu(tmp_path, monkeypatch, precision):
    """A 37 x 53 frame (padded to 40 x 56: reflect for the image, zeros for
    the mask), hole where the mask > 127, the output x255 clipped and
    truncated: hive_tpu's uint8 frame, exactly in float32, within one level
    on a few values in bf16."""
    flat = lama.check_params(0, **SMALL)
    np.savez(tmp_path / "big-lama.npz", **flat)
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    monkeypatch.setattr(jax_lama, "LamaGenerator",
                        functools.partial(jax_lama.LamaGenerator, **SMALL))
    monkeypatch.setattr(lama, "LamaGenerator", functools.partial(lama.LamaGenerator, **SMALL))
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    mask = np.zeros((37, 53), np.uint8)
    mask[10:30, 30:] = 255
    mask[0:5, 0:5] = 128
    mask[20:25, 0:5] = 127                   # not a hole
    torch_dtype, jax_dtype = DTYPES[precision]
    want = jax_lama.LamaInpainter(dtype=jax_dtype).inpaint(image, mask)
    inpainter = lama.LamaInpainter("cpu", dtype=torch_dtype)
    got = inpainter.inpaint_batch(image[None], mask[None])[0]
    assert got.dtype == np.uint8 and got.shape == image.shape
    difference = np.abs(got.astype(int) - want.astype(int))
    if precision == "f32":
        assert difference.max() == 0
    else:
        assert difference.max() <= 1 and (difference > 0).mean() < 0.05
    batch = inpainter.inpaint_batch(np.stack([image, image[::-1]]), np.stack([mask, mask]))
    np.testing.assert_array_equal(batch[0], got)


def test_lama_flops_counts_the_convolutions():
    """``lama_flops`` equals a count of the full generator's convolutions as
    they run (2 x multiply-adds; the transposed ones over their input
    pixels), at 64 x 96."""
    model = lama.LamaGenerator().eval()
    counted = []

    def conv_hook(module, args, out):
        cout, cin, k = module.kernel.shape[:3]
        counted.append(2 * cin * cout * k * k * out.shape[-2] * out.shape[-1])

    def deconv_hook(module, args, out):
        cin, cout = module.kernel.shape[:2]
        counted.append(2 * cin * cout * 9 * args[0].shape[-2] * args[0].shape[-1])

    for module in model.modules():
        if isinstance(module, Conv):
            module.register_forward_hook(conv_hook)
        elif isinstance(module, lama.ConvTranspose3x3):
            module.register_forward_hook(deconv_hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 96), torch.zeros(1, 1, 64, 96))
    assert len(counted) == 1 + 4 + 18 * 2 * 6 + 3 + 1
    assert sum(counted) == lama.lama_flops((64, 96))
    assert lama.lama_flops((480, 640), batch=8) == 8 * lama.lama_flops((480, 640))
