"""The port's person segmenter (hive_tpu_torch.models.segmentation) against
OpenCV and hive_tpu: MOG2's raw 0 / 127 / 255 output bit for bit against
cv2's on seeded sequences (noise, a moving blob, a global dimming that makes
shadows, mode churn past the 200-frame history), the 5x5 open and close,
cv2's component numbering, whole instance masks against hive_tpu's
``PersonSegmenter`` without weights; the U-Net (each module and the whole
network with flax's own initialisation, float32 within 1e-4 of the output's
largest magnitude; its instance masks), the choice of backend by the
weights files, and a conversion through both CLIs with each weights file."""

import functools
import logging
import os
import sys
from unittest import mock

import cv2
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hive_tpu.models import maskrcnn as jax_maskrcnn
from hive_tpu.models import segmentation as jax_segmentation
from hive_tpu.models.segmentation import PersonSegmenter as JaxPersonSegmenter
from hive_tpu.pipeline import Pipeline as JaxPipeline
from hive_tpu_torch.io import HiveDataset
from hive_tpu_torch.models import maskrcnn
from hive_tpu_torch.models import segmentation
from hive_tpu_torch.models.flax_layers import load_flax_params
from hive_tpu_torch.models.segmentation import PersonSegmenter, _MotionBackend, open_close
from hive_tpu_torch.pipeline import Pipeline
from tests.test_adaptors import make_tum_dataset


def blob_sequence(seed, frames=24, height=48, width=64):
    """A textured wall with noise, a (200, 64, 64) blob crossing it, and the
    whole frame dimmed to 60% in the second half (shadows)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height, 0:width]
    wall = np.stack([xs * 3 % 256, ys * 5 % 256, (xs + ys) * 2 % 256], -1).astype(np.float64)
    out = []
    for i in range(frames):
        frame = wall * (0.6 if i > frames // 2 else 1.0)
        frame[(xs - 5 - 3 * i) ** 2 + (ys - height // 2) ** 2 < 64] = (200, 64, 64)
        out.append(np.clip(frame + rng.normal(0, 3, frame.shape), 0, 255).astype(np.uint8))
    return np.stack(out)


def churn_sequence(seed, kind, frames=230, height=12, width=16):
    """Past the history of 200 frames, where the learning rate is 1/200 and
    weak modes are pruned: pure noise (every mode replaced), a few colours
    per pixel (several live modes), and black pixels (zero means)."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 256, (6, height, width, 3))
    rows, cols = np.arange(height)[:, None], np.arange(width)[None]
    out = []
    for _ in range(frames):
        if kind == "noise":
            frame = rng.integers(0, 256, (height, width, 3))
        elif kind == "multimodal":
            frame = levels[rng.integers(0, 6, (height, width)), rows, cols]
        else:
            frame = np.where(rng.random((height, width, 1)) < 0.1, 0,
                             levels[1] + rng.normal(0, 2, (height, width, 3)))
        out.append(np.clip(frame, 0, 255).astype(np.uint8))
    return np.stack(out)


def assert_mog2_matches_opencv(frames_bgr):
    subtractor = cv2.createBackgroundSubtractorMOG2(history=200, varThreshold=32,
                                                    detectShadows=True)
    ours = _MotionBackend(device="cpu")
    seen = set()
    for i, frame in enumerate(frames_bgr):
        want = subtractor.apply(frame, learningRate=-1)
        got = ours.apply(torch.from_numpy(frame)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
        seen |= set(np.unique(want).tolist())
    return seen


def test_mog2_matches_opencv_with_blob_and_shadows():
    """The reference's own call order: the first batch replayed in reverse,
    then every frame in order, RGB turned to BGR. Bit-equal on every frame,
    and the sequence reaches all three labels."""
    frames = blob_sequence(0)
    bgr = np.concatenate([frames[:8][::-1], frames])[..., ::-1]
    assert assert_mog2_matches_opencv(np.ascontiguousarray(bgr)) == {0, 127, 255}


@pytest.mark.parametrize("kind", ["noise", "multimodal", "black_pixels"])
def test_mog2_matches_opencv_past_its_history(kind):
    assert_mog2_matches_opencv(churn_sequence(1, kind))


def test_open_and_close_match_opencv():
    """The 5x5 open, then the close with three iterations, at the borders
    too (OpenCV's default border neither erodes nor dilates)."""
    rng = np.random.default_rng(2)
    kernel = np.ones((5, 5), np.uint8)
    masks = (rng.random((4, 37, 53)) < np.array([0.05, 0.3, 0.6, 0.9])[:, None, None])
    got = open_close(torch.from_numpy(masks)).numpy()
    for fg, ours in zip(masks.astype(np.uint8), got):
        want = cv2.morphologyEx(cv2.morphologyEx(fg, cv2.MORPH_OPEN, kernel),
                                cv2.MORPH_CLOSE, kernel, iterations=3)
        np.testing.assert_array_equal(ours, want.astype(bool))


def test_component_order_is_opencvs():
    """cv2 numbers 8-connected components by their first 2x2 block in a
    raster scan of blocks, not by their first pixel: a lone pixel at (1, 0)
    comes before one at (0, 8)."""
    backend = _MotionBackend(device="cpu", min_area_fraction=0.0)
    fg = np.zeros((4, 10), bool)
    fg[1, 0] = fg[0, 8] = True
    expected = np.zeros((4, 10), np.uint8)
    expected[1, 0], expected[0, 8] = 1, 2
    np.testing.assert_array_equal(backend.instances(fg), expected)

    rng = np.random.default_rng(3)
    for shape in ((31, 45), (30, 44), (1, 9)):
        fg = rng.random(shape) < 0.1
        count, labels = cv2.connectedComponents(fg.astype(np.uint8), connectivity=8)
        assert count <= 256
        np.testing.assert_array_equal(backend.instances(fg), labels.astype(np.uint8))


def test_small_components_dropped_and_ids_capped():
    """Components under 0.1% of the frame are dropped; ids stop at 255."""
    fg = np.zeros((100, 100), bool)
    fg[0, 0] = True                          # 1 pixel < 10: dropped
    fg[10:14, 10:14] = True                  # 16 pixels: kept
    ids = _MotionBackend(device="cpu").instances(fg)
    assert ids[0, 0] == 0 and (ids[10:14, 10:14] == 1).all() and ids.max() == 1

    fg = np.zeros((64, 64), bool)
    fg[::2, ::2] = True                      # 1024 isolated pixels
    ids = _MotionBackend(device="cpu", min_area_fraction=0.0).instances(fg)
    assert ids.max() == 255 and (ids > 0).sum() == 255


def test_predict_batch_matches_hive_tpu(tmp_path, monkeypatch):
    """Batches of 8 in video order, as create_masks feeds them, without
    weights: the same uint8 instance masks as hive_tpu's segmenter."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    frames = blob_sequence(4, frames=20)
    theirs, ours = JaxPersonSegmenter(), PersonSegmenter(device="cpu")
    found = 0
    for start in range(0, len(frames), 8):
        batch = frames[start:start + 8]
        for got, want in zip(ours.predict_batch(batch), theirs.predict_batch(batch)):
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            found += int(want.max() > 0)
    assert found >= 8


# ---------------------------------------------------------------------------
# The U-Net.
# ---------------------------------------------------------------------------

UNET_TOL = 1e-4
# The last conv's gain in the weights of the instance-mask checks: flax's
# own initialisation gives logits within +-2, a probability near 0.5 almost
# everywhere; x20 spreads it over (0, 1) like a trained segmenter's.
UNET_HEAD_GAIN = 20.0


def flatten(tree) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(flax.core.unfreeze(tree)).items()}


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def unet_flat():
    """flax's own initialisation of the reference's U-Net, flattened as
    ``person_unet.npz`` holds it."""
    params = jax.jit(jax_segmentation.build_unet().init)(jax.random.PRNGKey(0),
                                                         jnp.zeros((1, 32, 32, 3)))
    return flatten(params["params"])


def informative(unet_flat) -> dict:
    return dict(unet_flat, **{"Conv_0/kernel": unet_flat["Conv_0/kernel"] * UNET_HEAD_GAIN})


def test_conv_transpose_matches_flax():
    """flax's ConvTranspose((2, 2), strides=(2, 2)) with its defaults: a
    correlation over the dilated input, so torch's transposed convolution
    takes the kernel flipped."""
    import flax.linen as nn

    x = np.random.default_rng(0).standard_normal((2, 6, 8, 32)).astype(np.float32)
    module = nn.ConvTranspose(16, (2, 2), strides=(2, 2))
    params = flatten(module.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    params["bias"] = np.random.default_rng(2).standard_normal(16).astype(np.float32)
    want = np.asarray(module.apply({"params": {k: jnp.asarray(v) for k, v in params.items()}},
                                   jnp.asarray(x)))
    port = load_flax_params(segmentation.ConvTranspose2x(32, 16), params, "U-Net")
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 12, 16, 16)
    assert rel_err(got, want) < UNET_TOL

    # Planted fault: torch's own convention (the kernel not flipped).
    with torch.no_grad():
        unflipped = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x.transpose(0, 3, 1, 2)),
            torch.from_numpy(np.ascontiguousarray(params["kernel"].transpose(2, 3, 0, 1))),
            torch.from_numpy(params["bias"]), stride=2)
    assert rel_err(unflipped.numpy().transpose(0, 2, 3, 1), want) > 0.1


def test_unet_modules_match_flax(unet_flat):
    """Each ConvBlock (two convs, GroupNorm(8) with flax's epsilon 1e-6)
    and the whole network, with flax's own initialisation."""
    tree = jax.tree.map(jnp.asarray, flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in unet_flat.items()}))
    x = np.random.default_rng(3).random((2, 48, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_segmentation.build_unet().apply)({"params": tree}, x))
    unet = load_flax_params(segmentation.UNet(), unet_flat, "U-Net")
    taps = {}

    def tap(name):
        def hook(module, inputs, output):
            taps[name] = (inputs[0], output)
        return hook

    for name, module in unet.named_children():
        if name.startswith("ConvBlock_"):
            module.register_forward_hook(tap(name))
    with torch.no_grad():
        got = unet(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert rel_err(got, want) < UNET_TOL
    assert len(taps) == 9
    for name, (inputs, output) in taps.items():
        block = {k.split("/", 1)[1]: v for k, v in unet_flat.items() if k.startswith(name + "/")}
        flax_block = _flax_conv_block(output.shape[1])
        ref = flax_block.apply({"params": flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in block.items()})},
            jnp.asarray(inputs.numpy().transpose(0, 2, 3, 1)))
        assert rel_err(output.numpy().transpose(0, 2, 3, 1), ref) < UNET_TOL, name


def _flax_conv_block(features):
    """The reference's ConvBlock (local to build_unet there), rebuilt."""
    import flax.linen as nn

    class ConvBlock(nn.Module):
        features: int

        @nn.compact
        def __call__(self, x):
            x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
            x = nn.relu(nn.GroupNorm(num_groups=8)(x))
            x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
            return nn.relu(nn.GroupNorm(num_groups=8)(x))

    return ConvBlock(features)


def write_npz(path, flat):
    np.savez(path, **flat)
    return str(path)


def test_unet_backend_matches_hive_tpu(tmp_path, unet_flat):
    """``person_probabilities`` (/ 255, padding to a multiple of 16, the
    sigmoid, the crop) of frames that are not multiples of 16, from one
    ``person_unet.npz`` in both packages: within 1e-4."""
    path = write_npz(tmp_path / "person_unet.npz", unet_flat)
    frames = np.random.default_rng(4).integers(0, 256, (3, 45, 61, 3)).astype(np.uint8)
    want = jax_segmentation._UNetBackend(path).person_probabilities(frames)
    got = segmentation._UNetBackend(path, "cpu").person_probabilities(frames).numpy()
    assert got.shape == want.shape == (3, 45, 61)
    np.testing.assert_allclose(got, want, atol=UNET_TOL, rtol=0)


def test_instances_from_probability_matches_hive_tpu():
    """Smooth random probability maps: components over 0.5, the small ones
    dropped, in OpenCV's order."""
    rng = np.random.default_rng(5)
    theirs = JaxPersonSegmenter.__new__(JaxPersonSegmenter)
    theirs.probability_threshold = 0.5
    ours = PersonSegmenter.__new__(PersonSegmenter)
    for shape in ((48, 64), (61, 45), (100, 120)):
        noise = cv2.GaussianBlur(rng.random(shape).astype(np.float32), (0, 0), 2.0)
        probability = (noise - noise.min()) / (noise.max() - noise.min())
        want = theirs._instances_from_probability(probability)
        assert want.max() >= 2
        np.testing.assert_array_equal(ours._instances_from_probability(probability), want)


def test_unet_instance_masks_match_hive_tpu(tmp_path, monkeypatch, unet_flat):
    """PersonSegmenter with ``person_unet.npz`` in $WEIGHTS_PATH (flax's
    initialisation, the last conv x UNET_HEAD_GAIN): the same instance ids
    as hive_tpu's, except where the probability lies within UNET_TOL of
    0.5."""
    write_npz(tmp_path / "person_unet.npz", informative(unet_flat))
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    frames = blob_sequence(6, frames=4)
    theirs, ours = JaxPersonSegmenter(), PersonSegmenter(device="cpu")
    assert ours.backend == "unet"
    probability = theirs._unet.person_probabilities(frames)
    for p, got, want in zip(probability, ours.predict_batch(frames), theirs.predict_batch(frames)):
        near = np.abs(p - 0.5) <= UNET_TOL
        assert want.max() >= 1 and near.sum() < 0.01 * near.size
        np.testing.assert_array_equal(got[~near], want[~near])


# ---------------------------------------------------------------------------
# The choice of backend.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("files,explicit,backend", [
    (("maskrcnn",), False, "maskrcnn"),
    (("unet",), False, "unet"),
    (("maskrcnn", "unet"), True, "unet"),
    (("broken_maskrcnn", "unet"), False, "unet"),
], ids=["maskrcnn", "unet", "explicit_unet_beats_maskrcnn", "bad_maskrcnn_falls_through"])
def test_backend_choice_matches_hive_tpu(tmp_path, monkeypatch, caplog, unet_flat, files,
                                         explicit, backend):
    """The reference's order: Mask R-CNN from maskrcnn_coco.npz unless a
    U-Net path is passed; the U-Net next; a file that fails the keyed load
    is passed over with a warning."""
    weights = tmp_path / "weights"
    weights.mkdir()
    unet_path = write_npz(weights / "person_unet.npz", unet_flat) if "unet" in files else None
    if "maskrcnn" in files:
        write_npz(weights / "maskrcnn_coco.npz", maskrcnn.check_params(0))
    if "broken_maskrcnn" in files:
        write_npz(weights / "maskrcnn_coco.npz", {"body/conv1/kernel": np.zeros(3, np.float32)})
    monkeypatch.setenv("WEIGHTS_PATH", str(weights))
    path = unet_path if explicit else None
    with caplog.at_level(logging.WARNING):
        ours = PersonSegmenter(path, device="cpu")
    assert ours.backend == backend
    if "broken_maskrcnn" in files:
        assert "Could not load Mask R-CNN weights" in caplog.text
        assert "missing" in caplog.text
    else:
        assert "Could not load" not in caplog.text
        theirs = JaxPersonSegmenter(path)
        assert (theirs._maskrcnn is not None, theirs._unet is not None) == \
            (backend == "maskrcnn", backend == "unet")


def test_device_errors_are_not_caught(tmp_path, monkeypatch):
    """Only a file that fails its load falls through: an error from the
    device while loading a good file reaches the caller."""
    write_npz(tmp_path / "maskrcnn_coco.npz", maskrcnn.check_params(0))
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))

    def fail(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(maskrcnn, "load_flax_params", fail)
    with pytest.raises(RuntimeError, match="CUDA error"):
        PersonSegmenter(device="cpu")


# ---------------------------------------------------------------------------
# A conversion through both CLIs with each weights file.
# ---------------------------------------------------------------------------

# The detectors' canvas in this test: 48 x 64 frames in a 192 x 256 canvas
# (the reference test's), not the 832 x 1088 canvas of the 800-pixel side.
SMALL_CANVAS = dict(canvas_min_side=160, canvas_max_side=224)


@pytest.mark.parametrize("backend", ["maskrcnn", "unet"])
def test_conversion_with_weights_matches_hive_tpu(tmp_path, monkeypatch, unet_flat, backend):
    """Each CLI converts one tiny TUM folder (5 frames, 64 x 48) with the
    weights file in $WEIGHTS_PATH and meshes the background: the masks are
    equal, and at least one frame holds an instance."""
    weights = tmp_path / "weights"
    weights.mkdir()
    if backend == "maskrcnn":
        write_npz(weights / "maskrcnn_coco.npz", maskrcnn.check_params(0))
        monkeypatch.setattr(jax_maskrcnn, "MaskRCNNDetector",
                            functools.partial(jax_maskrcnn.MaskRCNNDetector, **SMALL_CANVAS))
        monkeypatch.setattr(maskrcnn, "MaskRCNNDetector",
                            functools.partial(maskrcnn.MaskRCNNDetector, **SMALL_CANVAS))
    else:
        write_npz(weights / "person_unet.npz", informative(unet_flat))
    monkeypatch.setenv("WEIGHTS_PATH", str(weights))
    base = make_tum_dataset(tmp_path / "tum", num_frames=5)
    outputs = {}
    for name in ("jax", "torch"):
        out = outputs[name] = str(tmp_path / name)
        argv = ["--dataset_path", base, "--output_path", out, "--num_frames", "5",
                "--key_frame_threshold", "1.0", "--sdf_max_voxels", "200000", "--background_only",
                "--webxr_path", out + "_webxr", "--log_file", out + ".log"]
        if name == "jax":
            with mock.patch.object(sys, "argv", ["hive", *argv]):
                JaxPipeline.from_command_line().run(compress=False)
        else:
            Pipeline.from_command_line(argv, device="cpu").run(compress=False)
    ours = HiveDataset(outputs["torch"])
    masks = sorted(os.listdir(os.path.join(outputs["jax"], "mask")))
    assert sorted(os.listdir(os.path.join(outputs["torch"], "mask"))) == masks and len(masks) == 5
    theirs = np.stack([cv2.imread(os.path.join(outputs["jax"], "mask", m), cv2.IMREAD_UNCHANGED)
                       for m in masks])
    got = np.stack([ours.mask_dataset[i] for i in range(5)])
    np.testing.assert_array_equal(got, theirs)
    assert got.max() >= 1


def test_unet_flops_counts_every_product():
    """The analytic count equals the multiply-adds of every conv and
    transposed conv, counted from the shapes of a forward."""
    unet = segmentation.UNet().eval()
    counted = []

    def hook(module, inputs, output):
        if isinstance(module, segmentation.Conv):
            _, c_in, kh, kw = module.kernel.shape
            counted.append(2 * output.numel() * c_in * kh * kw)
        elif isinstance(module, segmentation.ConvTranspose2x):
            counted.append(2 * output.numel() * module.kernel.shape[0])

    for m in unet.modules():
        m.register_forward_hook(hook)
    with torch.no_grad():
        unet(torch.zeros(1, 3, 48, 64))
    assert sum(counted) == segmentation.unet_flops((48, 64))
    assert segmentation.unet_flops((480, 640), 8) == 8 * segmentation.unet_flops((480, 640))
