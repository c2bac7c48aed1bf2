"""Inpainting behind moving objects (``--inpainting_mode`` 1-4) against
hive_tpu and OpenCV 5.0.0.

* ``inpaint_telea`` is ``cv2.inpaint(..., cv2.INPAINT_TELEA)`` bit for bit
  on 8-bit RGB, 8-bit grey and 16-bit depth, at radius 30 (hive_tpu's) and
  3, for holes at the border, two holes, a one-pixel hole and a hole over
  most of the frame; ``dilate_ids`` is ``cv2.dilate`` bit for bit.
* Each mode converts the same TUM folder through both packages' adaptors:
  the inpainted JPEG bytes, the inpainted depth and the (blacked-out) masks
  are equal, and so are the ``profiling`` keys. The LaMa modes run a small
  generator (ngf 8, 2 downsamples, 2 blocks) with check weights as
  ``$WEIGHTS_PATH/big-lama.npz``, patched into both packages. The motion
  masks hold instance id 1, which LaMa's ``mask > 127`` reads as no hole
  (the reference's fault, mirrored): a second test writes a 255-valued
  hole into the masks and holds LaMa's fill to hive_tpu's within
  ``LAMA_LEVELS`` grey levels after JPEG.
* Mode 1 through both CLIs gives the same ``bg.glb``.
"""

import functools
import os
import sys
from os.path import join as pjoin
from unittest import mock

import cv2
import numpy as np
import pytest
from PIL import Image

from hive_tpu import dataset_adaptors as jax_adaptors
from hive_tpu.models import lama as jax_lama
from hive_tpu.options import COLMAPOptions as JaxCOLMAPOptions
from hive_tpu.options import InpaintingMode as JaxInpaintingMode
from hive_tpu_torch import dataset_adaptors
from hive_tpu_torch.image_processing import dilate_ids, inpaint_telea
from hive_tpu_torch.models import lama
from hive_tpu_torch.options import COLMAPOptions, InpaintingMode
from chip_smoke import write_tum_dataset
from tests.test_torch_adaptors import pillow

H, W = 48, 64
TUM_FRAMES = 10   # the first 8 prime the motion segmenter
SMALL = dict(base_features=8, num_downsamples=2, num_blocks=2)
# LaMa's fill through both packages, bf16: the two generators' outputs
# differ by up to ~1e-3 (tests/test_torch_lama.py), one grey level after
# x255 and truncation (measured here: 184 of a 20 x 24 hole's 1440 values
# differ, by 1, 0.02 levels on average). JPEG at quality 95 turns such a
# difference into a moved quantised coefficient, which changes its whole
# 8 x 8 block: measured up to 7 levels after decoding, 0.97 on average over
# the hole.
LAMA_LEVELS = 8
LAMA_MEAN_LEVELS = 2.0


def smooth_image(kind: str, seed: int = 0) -> np.ndarray:
    """A smooth pattern with noise: 'rgb' (H, W, 3) uint8, 'grey' (H, W)
    uint8, 'depth' (H, W) uint16 around 2 m in millimetres."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    channels = 3 if kind == "rgb" else 1
    top = 4000.0 if kind == "depth" else 255.0
    base = np.stack([(np.sin(xs / 7.0 + c) * 0.4 + np.cos(ys / 5.0 - c) * 0.4 + 0.5) * top
                     for c in range(channels)], -1)
    image = np.clip(base + rng.normal(0, top * 0.05, base.shape), 0, top)
    image = image.astype(np.uint16 if kind == "depth" else np.uint8)
    return image if kind == "rgb" else image[..., 0]


def hole(case: str) -> np.ndarray:
    mask = np.zeros((H, W), np.uint8)
    if case == "box":
        mask[10:25, 20:40] = 1
    elif case == "border":
        mask[0:12, 0:15] = 3
        mask[40:, 50:] = 255
    elif case == "two":
        mask[5:10, 5:12] = 255
        mask[30:44, 40:60] = 7
    elif case == "one_pixel":
        mask[20, 30] = 1
    elif case == "most":
        mask[4:, :-3] = 1
    elif case == "scattered":
        mask[np.random.default_rng(1).random((H, W)) < 0.1] = 2
    return mask


CASES = ["box", "border", "two", "one_pixel", "most", "scattered"]


@pytest.mark.parametrize("radius", [30, 3])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["rgb", "grey", "depth"])
def test_inpaint_telea_matches_cv2(kind, case, radius):
    image, mask = smooth_image(kind), hole(case)
    want = cv2.inpaint(image, mask, radius, cv2.INPAINT_TELEA)
    got = inpaint_telea(image, mask, radius)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got[mask == 0] == image[mask == 0]).all()
    if case != "most":
        assert (got[mask > 0] != image[mask > 0]).any()


def test_inpaint_telea_fuzz_matches_cv2():
    """Random sizes, images (noise and its running sums), holes and radii,
    half-integer radii included (cv2 rounds them)."""
    rng = np.random.default_rng(1)
    for trial in range(40):
        h, w = rng.integers(8, 60, 2)
        dtype, channels = [(np.uint8, 3), (np.uint8, 1), (np.uint16, 1)][trial % 3]
        top = np.iinfo(dtype).max + 1
        image = rng.integers(0, top, (h, w, channels))
        if trial % 2:
            image = np.cumsum(np.cumsum(image, 0), 1) % top
        image = image.astype(dtype)[..., 0] if channels == 1 else image.astype(dtype)
        mask = np.zeros((h, w), np.uint8)
        for _ in range(rng.integers(1, 5)):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            mask[y0:y0 + rng.integers(1, h // 2 + 2),
                 x0:x0 + rng.integers(1, w // 2 + 2)] = rng.integers(1, 256)
        radius = [1, 2, 3, 5, 10, 30, 0.4, 7.5][trial % 8]
        np.testing.assert_array_equal(inpaint_telea(image, mask, radius),
                                      cv2.inpaint(image, mask, radius, cv2.INPAINT_TELEA),
                                      err_msg=f"trial {trial}")


def test_inpaint_telea_refuses_other_layouts():
    with pytest.raises(ValueError, match="uint16 images of 1 channel"):
        inpaint_telea(np.zeros((4, 4, 3), np.uint16), np.ones((4, 4), np.uint8))
    with pytest.raises(ValueError, match="does not fit"):
        inpaint_telea(np.zeros((4, 4), np.uint8), np.ones((4, 5), np.uint8))


@pytest.mark.parametrize("seed", range(3))
def test_dilate_ids_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(1, 80, 2)
    mask = np.zeros((h, w), np.uint8)
    for _ in range(4):
        y, x = rng.integers(0, h), rng.integers(0, w)
        mask[y:y + rng.integers(1, 10), x:x + rng.integers(1, 10)] = rng.integers(1, 256)
    got = dilate_ids(mask)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.dilate(mask, np.ones((5, 5), np.uint8), iterations=5))


# ---------------------------------------------------------------------------
# Conversions through both packages.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tum") / "tum")
    write_tum_dataset(base, TUM_FRAMES, width=W, height=H)
    return base


@pytest.fixture
def small_lama(tmp_path, monkeypatch):
    """The small generator in both packages, with check weights written as
    ``$WEIGHTS_PATH/big-lama.npz`` (nothing else there: both segmenters
    take the motion backend)."""
    weights = tmp_path / "weights"
    weights.mkdir()
    np.savez(weights / "big-lama.npz", **lama.check_params(0, **SMALL))
    monkeypatch.setenv("WEIGHTS_PATH", str(weights))
    monkeypatch.setattr(jax_lama, "LamaGenerator",
                        functools.partial(jax_lama.LamaGenerator, **SMALL))
    monkeypatch.setattr(lama, "LamaGenerator", functools.partial(lama.LamaGenerator, **SMALL))


def convert_both(tum, root, mode: int):
    """Convert the TUM folder with each package in inpainting mode
    ``mode``; return the two output folders and the port's profiling."""
    outputs = {"jax": str(root / "jax"), "torch": str(root / "torch")}
    vocab = "colmap/vocab.bin"
    jax_profiling, profiling = {}, {}
    jax_adaptors.TUMAdaptor(base_path=tum, output_path=outputs["jax"],
                            colmap_options=JaxCOLMAPOptions(vocab_path=vocab)).convert(
        estimate_pose=False, estimate_depth=False,
        inpainting_mode=JaxInpaintingMode.from_integer(mode), profiling=jax_profiling)
    dataset_adaptors.TUMAdaptor(base_path=tum, output_path=outputs["torch"],
                                colmap_options=COLMAPOptions(vocab_path=vocab)).convert(
        estimate_pose=False, estimate_depth=False,
        inpainting_mode=InpaintingMode.from_integer(mode), profiling=profiling, device="cpu")
    assert list(profiling["timing"]["load_dataset"]) == \
        list(jax_profiling["timing"]["load_dataset"])
    return outputs


def assert_same_folder(outputs, name, exact_bytes: bool):
    names = sorted(os.listdir(pjoin(outputs["jax"], name)))
    assert sorted(os.listdir(pjoin(outputs["torch"], name))) == names
    assert len(names) == TUM_FRAMES
    for file in names:
        paths = [pjoin(outputs[p], name, file) for p in ("torch", "jax")]
        if exact_bytes:
            with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
                assert f.read() == g.read(), (name, file)
        ours, theirs = (pillow(path) for path in paths)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs, err_msg=f"{name}/{file}")


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_conversion_inpainting_matches_hive_tpu(tum, tmp_path, small_lama, mode):
    """The dilated masks (then blacked out), the inpainted RGB frames (the
    JPEG bytes cv2 writes at quality 95) and the inpainted depth maps are
    hive_tpu's, in every mode: with id-1 masks LaMa's RGB is the frame
    itself through the reference's x/255*255 truncation, and LaMa's depth
    branch keeps every value."""
    outputs = convert_both(tum, tmp_path, mode)
    for name in ("rgb_inpainted", "depth_inpainted", "mask_inpainted"):
        assert_same_folder(outputs, name, exact_bytes=name == "rgb_inpainted")
    for file in sorted(os.listdir(pjoin(outputs["torch"], "mask_inpainted"))):
        assert not pillow(pjoin(outputs["torch"], "mask_inpainted", file)).any()
    # The blob is masked (id 1) once the segmenter is primed: TELEA fills it.
    mask = pillow(pjoin(outputs["torch"], "mask", "000009.png"))
    assert mask.max() == 1
    depth, filled = (pillow(pjoin(outputs["torch"], folder, "000009.png"))
                     for folder in ("depth", "depth_inpainted"))
    if mode in (1, 2):
        assert (depth[mask > 0] == 1500).any() and (filled[mask > 0] > 1900).all()
    else:
        np.testing.assert_array_equal(filled, depth)


def test_lama_threshold_fault_is_mirrored(tmp_path, small_lama):
    """HIVE masks hold instance ids 1..N; the reference's LaMa reads a hole
    only where ``mask > 127``. Ids below 128 give LaMa no hole (the frame
    comes back through x/255*255 truncation), while TELEA fills them; a
    255 id is a hole to both. ROADMAP.md Queue 3 item 3."""
    image = smooth_image("rgb")
    ids = hole("two").clip(0, 7)                  # ids 7: below the threshold
    inpainter = lama.LamaInpainter("cpu")
    out = inpainter.inpaint_batch(image[None], ids[None])[0]
    truncated = np.clip(image.astype(np.float32) / 255.0 * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(out, truncated)
    assert (inpaint_telea(image, ids)[ids > 0] != image[ids > 0]).any()
    out = inpainter.inpaint_batch(image[None], (ids[None] > 0).astype(np.uint8) * 255)[0]
    assert (out[ids > 0] != truncated[ids > 0]).any()
    np.testing.assert_array_equal(out[ids == 0], truncated[ids == 0])


@pytest.mark.parametrize("mode", [3, 4])
def test_lama_with_a_real_hole_matches_hive_tpu(tum, tmp_path, small_lama, mode):
    """Masks holding a 255-valued blob: LaMa fills the RGB hole (mode 4)
    within ``LAMA_LEVELS`` (``LAMA_MEAN_LEVELS`` on average) of hive_tpu's
    fill, JPEG blocks away from the hole bit-equal; the depth branch fills
    the hole from the /256 image (TELEA) and is equal."""
    outputs = convert_both(tum, tmp_path, 0)
    blob = np.zeros((H, W), np.uint8)
    blob[14:34, 20:44] = 255
    for root in outputs.values():
        for file in os.listdir(pjoin(root, "mask")):
            Image.fromarray(blob).save(pjoin(root, "mask", file))
    jax_adaptors.TUMAdaptor(base_path=tum, output_path=outputs["jax"])._inpaint_frame_data(
        JaxInpaintingMode.from_integer(mode))
    dataset_adaptors.TUMAdaptor(base_path=tum, output_path=outputs["torch"])._inpaint_frame_data(
        InpaintingMode.from_integer(mode), device="cpu")

    assert_same_folder(outputs, "depth_inpainted", exact_bytes=False)
    depth, filled = (pillow(pjoin(outputs["torch"], folder, "000000.png"))
                     for folder in ("depth", "depth_inpainted"))
    grown = dilate_ids(blob) > 127
    assert (filled[~grown] == depth[~grown]).all() and (filled[grown] % 256 == 0).all()

    rgb = "rgb_inpainted"
    if mode == 3:
        assert_same_folder(outputs, rgb, exact_bytes=True)
        return
    # 16 x 16 MCUs that the grown hole does not touch decode alike.
    touched = grown.reshape(H // 16, 16, W // 16, 16).any(axis=(1, 3))
    away = ~np.kron(touched, np.ones((16, 16), bool))
    for file in sorted(os.listdir(pjoin(outputs["jax"], rgb))):
        ours, theirs = (pillow(pjoin(outputs[p], rgb, file)).astype(int)
                        for p in ("torch", "jax"))
        original = pillow(pjoin(outputs["torch"], "rgb", file)).astype(int)
        np.testing.assert_array_equal(ours[away], theirs[away], err_msg=file)
        difference = np.abs(ours - theirs)[grown]
        assert difference.max() <= LAMA_LEVELS, (file, difference.max())
        assert difference.mean() <= LAMA_MEAN_LEVELS, (file, difference.mean())
        assert np.abs(ours[grown] - original[grown]).mean() > 10, file


@pytest.fixture(scope="module")
def no_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("no_weights"))
    with mock.patch.dict(os.environ, {"WEIGHTS_PATH": path}):
        yield path


def test_mode_1_cli_same_background_mesh(tum, no_weights, tmp_path):
    """``--inpainting_mode 1`` through both CLIs (background only): the
    background is meshed from the inpainted folders, to the same
    ``bg.glb``."""
    from hive_tpu.meshing.gltf import load_glb as jax_load_glb
    from hive_tpu.pipeline import Pipeline as JaxPipeline
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.pipeline import Pipeline
    from tests.test_torch_pipeline import assert_same_scene

    def args(path):
        return ["--dataset_path", tum, "--output_path", path, "--num_frames", str(TUM_FRAMES),
                "--key_frame_threshold", "1.0", "--sdf_max_voxels", "100000",
                "--background_only", "--inpainting_mode", "1", "--webxr_path", path + "_webxr",
                "--log_file", path + ".log"]

    paths = {name: str(tmp_path / name) for name in ("jax", "torch")}
    with mock.patch.object(sys, "argv", ["hive", *args(paths["jax"])]):
        JaxPipeline.from_command_line().run(compress=False)
    pipeline = Pipeline.from_command_line(args(paths["torch"]), device="cpu")
    pipeline.run(compress=False)
    assert pipeline.profiling["timing"]["load_dataset"]["inpainting"] > 0
    for name in ("rgb_inpainted", "depth_inpainted", "mask_inpainted"):
        assert len(os.listdir(pjoin(paths["torch"], name))) == TUM_FRAMES
    ours, theirs = (load(pjoin(paths[p], "mesh", "bg.glb"))
                    for load, p in ((load_glb, "torch"), (jax_load_glb, "jax")))
    assert_same_scene(ours, theirs)
    assert len(ours.geometry["000000"].faces) > 10
