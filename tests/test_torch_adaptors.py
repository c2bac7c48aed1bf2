"""Conversion of TUM and Unreal inputs (hive_tpu_torch.dataset_adaptors)
against hive_tpu's on the same input folders: metadata, camera matrix and
trajectory equal; depth maps equal; the RGB frames' JPEG bytes equal; masks
equal, from each package's own conversion and when both packages segment
the same frames; the cache, the --static_camera branch, format sniffing and
the refusals of what is not ported."""

import json
import os
from os.path import join as pjoin

import numpy as np
import pytest
from PIL import Image

from hive_tpu import dataset_adaptors as jax_adaptors
from hive_tpu.io import create_masks as jax_create_masks
from hive_tpu.options import COLMAPOptions as JaxCOLMAPOptions
from hive_tpu.options import InpaintingMode as JaxInpaintingMode
from hive_tpu.options import StorageOptions as JaxStorageOptions
from hive_tpu_torch import dataset_adaptors
from hive_tpu_torch.io import HiveDataset, ImageFolderDataset, create_masks
from hive_tpu_torch.options import (COLMAPOptions, InpaintingMode, PipelineOptions,
                                    StorageOptions)
from tests.test_adaptors import make_tum_dataset


@pytest.fixture(autouse=True)
def no_weights(tmp_path, monkeypatch):
    """No segmentation weights: both packages take the motion backend."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "no_weights"))


def make_unreal_dataset(base, num_frames=12, width=64, height=48):
    """A gradient wall with a blob crossing it, depth around 1.5 m."""
    rng = np.random.default_rng(2)
    os.makedirs(pjoin(base, "colour"))
    os.makedirs(pjoin(base, "depth"))
    ys, xs = np.mgrid[0:height, 0:width]
    for i in range(num_frames):
        rgb = np.stack([xs * 4, ys * 5, np.full_like(xs, 90)], -1)
        rgb[(xs - 8 - 4 * i) ** 2 + (ys - 24) ** 2 < 50] = (200, 64, 64)
        rgb = np.clip(rgb + rng.normal(0, 3, rgb.shape), 0, 255).astype(np.uint8)
        Image.fromarray(rgb).save(pjoin(base, "colour", f"{i:06d}.png"))
        Image.fromarray(rng.integers(1400, 1600, (height, width)).astype(np.uint16)) \
            .save(pjoin(base, "depth", f"{i:06d}.png"))
    with open(pjoin(base, "info.json"), "w") as fh:
        json.dump({"num_frames": num_frames, "fps": 24.0, "width": width, "height": height}, fh)
    np.savetxt(pjoin(base, "camera.txt"), [[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]])
    poses = np.zeros((num_frames, 7))
    poses[:, 3] = 1.0
    poses[:, 4] = 0.05 * np.arange(num_frames)
    poses[:, :3] = 0.01 * rng.normal(size=(num_frames, 3))
    np.savetxt(pjoin(base, "trajectory.txt"), poses)
    return base


def convert_both(kind, root, estimate_depth=False, **options):
    """Convert one input folder with each package; return the two outputs.

    The packages' default COLMAP vocabulary paths differ (the port's lies
    under the user's home), so both get the same one: it is written into
    metadata.json."""
    if kind == "tum":
        base = make_tum_dataset(root / "tum", num_frames=5)
        frames = 5
    else:
        base = make_unreal_dataset(str(root / "unreal"))
        frames = 12
    cls = {"tum": "TUMAdaptor", "unreal": "UnrealAdaptor"}[kind]
    outputs = {"jax": str(root / "jax"), "torch": str(root / "torch")}
    vocab = "colmap/vocab.bin"
    getattr(jax_adaptors, cls)(base_path=base, output_path=outputs["jax"],
                               colmap_options=JaxCOLMAPOptions(vocab_path=vocab)).convert(
        estimate_pose=False, estimate_depth=estimate_depth, inpainting_mode=JaxInpaintingMode.Off,
        **options)
    profiling = {}
    dataset = getattr(dataset_adaptors, cls)(
        base_path=base, output_path=outputs["torch"],
        colmap_options=COLMAPOptions(vocab_path=vocab)).convert(
        estimate_pose=False, estimate_depth=estimate_depth, inpainting_mode=InpaintingMode.Off,
        profiling=profiling, device="cpu", **options)
    assert isinstance(dataset, HiveDataset) and dataset.num_frames == frames
    assert list(profiling["timing"]["load_dataset"]) == [
        "create_metadata", "copy_frames", "create_instance_segmentation_masks",
        "get_depth_maps", "get_camera_parameters", "inpainting"]
    return outputs


def pillow(path):
    with Image.open(path) as image:
        return np.asarray(image)


@pytest.mark.parametrize("kind", ["tum", "unreal"])
def test_conversion_matches_hive_tpu(tmp_path, kind):
    """The same files with the same contents: the RGB frames are the bytes
    Pillow writes at quality 75, 4:2:0, so the masks segmented from them
    are equal too."""
    outputs = convert_both(kind, tmp_path)
    for name in ("rgb", "depth", "mask"):
        assert sorted(os.listdir(pjoin(outputs["torch"], name))) == \
            sorted(os.listdir(pjoin(outputs["jax"], name)))
    assert os.listdir(pjoin(outputs["torch"], "rgb"))[0].endswith(".jpg")
    for name in sorted(os.listdir(pjoin(outputs["jax"], "rgb"))):
        with open(pjoin(outputs["torch"], "rgb", name), "rb") as f, \
                open(pjoin(outputs["jax"], "rgb", name), "rb") as g:
            assert f.read() == g.read(), name
    masks = sorted(os.listdir(pjoin(outputs["jax"], "mask")))
    for name in masks:
        ours, theirs = (pillow(pjoin(outputs[p], "mask", name)) for p in ("torch", "jax"))
        assert ours.dtype == theirs.dtype == np.uint8
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    if kind == "unreal":
        # The blob is found once the first batch of 8 has primed the segmenter.
        assert [pillow(pjoin(outputs["torch"], "mask", name)).max()
                for name in masks[9:]] == [1, 1, 1]

    with open(pjoin(outputs["torch"], "metadata.json")) as f, \
            open(pjoin(outputs["jax"], "metadata.json")) as g:
        assert json.load(f) == json.load(g)
    for name in ("camera_matrix.txt", "camera_trajectory.txt"):
        np.testing.assert_array_equal(np.loadtxt(pjoin(outputs["torch"], name)),
                                      np.loadtxt(pjoin(outputs["jax"], name)))
    for name in sorted(os.listdir(pjoin(outputs["jax"], "depth"))):
        ours, theirs = (pillow(pjoin(outputs[p], "depth", name)) for p in ("torch", "jax"))
        assert ours.dtype == theirs.dtype == np.uint16
        np.testing.assert_array_equal(ours, theirs)


def test_masks_match_on_the_same_frames(tmp_path):
    """Both packages' create_masks over the frames hive_tpu converted (the
    Pillow-written JPEGs), in batches of 8, masks written as 8-bit PNGs:
    equal arrays, and the blob found after priming."""
    outputs = convert_both("unreal", tmp_path)
    rgb = pjoin(outputs["jax"], "rgb")
    jax_create_masks(jax_adaptors.ImageFolderDataset(rgb), str(tmp_path / "jax_masks"))
    create_masks(ImageFolderDataset(rgb), str(tmp_path / "torch_masks"), device="cpu")
    names = sorted(os.listdir(tmp_path / "jax_masks"))
    assert names == sorted(os.listdir(tmp_path / "torch_masks")) and len(names) == 12
    for name in names:
        ours, theirs = (pillow(tmp_path / d / name) for d in ("torch_masks", "jax_masks"))
        assert ours.dtype == theirs.dtype == np.uint8
        np.testing.assert_array_equal(ours, theirs)
    assert [pillow(tmp_path / "jax_masks" / name).max() for name in names[9:]] == [1, 1, 1]


def test_for_colmap_masks(tmp_path):
    """The COLMAP mask contract: 255 keeps, 0 masks, named after the frame."""
    base = make_unreal_dataset(str(tmp_path / "unreal"))
    frames = ImageFolderDataset(pjoin(base, "colour"))
    create_masks(frames, str(tmp_path / "colmap"), for_colmap=True, device="cpu")
    names = sorted(os.listdir(tmp_path / "colmap"))
    assert names == [f"{name}.png" for name in frames.image_filenames]
    assert set(np.unique(pillow(tmp_path / "colmap" / names[-1]))) <= {0, 255}


def test_static_camera(tmp_path):
    outputs = convert_both("tum", tmp_path, static_camera=True)
    for name in ("camera_matrix.txt", "camera_trajectory.txt"):
        np.testing.assert_array_equal(np.loadtxt(pjoin(outputs["torch"], name)),
                                      np.loadtxt(pjoin(outputs["jax"], name)))
    trajectory = np.loadtxt(pjoin(outputs["torch"], "camera_trajectory.txt"))
    np.testing.assert_array_equal(trajectory, np.tile([0, 0, 0, 1.0, 0, 0, 0], (5, 1)))


def test_cache_reuse_and_no_cache(tmp_path):
    """A second conversion with the same metadata reuses the first; with
    no_cache it is deleted and written anew; an adaptor may not write into
    the folder it reads."""
    base = make_tum_dataset(tmp_path / "tum", num_frames=3)
    output = str(tmp_path / "converted")

    def convert(**options):
        return dataset_adaptors.TUMAdaptor(base_path=base, output_path=output).convert(
            estimate_pose=False, estimate_depth=False, inpainting_mode=InpaintingMode.Off,
            device="cpu", **options)

    convert()
    marker = pjoin(output, "rgb", "000000.jpg")
    mtime = os.path.getmtime(marker)
    os.utime(marker, (mtime - 100, mtime - 100))
    convert()
    assert os.path.getmtime(marker) == mtime - 100
    with open(pjoin(output, "stale.txt"), "w") as f:
        f.write("x")
    convert(no_cache=True)
    assert os.path.getmtime(marker) > mtime - 100
    assert not os.path.exists(pjoin(output, "stale.txt"))

    with pytest.raises(RuntimeError, match="different folder"):
        dataset_adaptors.TUMAdaptor(base_path=base, output_path=base + "/")


def test_get_dataset_sniffs_like_hive_tpu(tmp_path):
    """TUM is converted, an existing HIVE dataset is reused, and the
    StrayScanner and video layouts are recognised by both packages; with
    empty files both packages raise: the port when its demuxer finds no
    ``moov`` box; hive_tpu where its cv2 reads a 0-frame, 0 x 0 video or
    its numpy an empty odometry.csv."""
    tum = make_tum_dataset(tmp_path / "tum", num_frames=2)
    storage = StorageOptions(dataset_path=tum, output_path=str(tmp_path / "out"))
    dataset = dataset_adaptors.get_dataset(storage, pipeline_options=PipelineOptions(num_frames=2),
                                           device="cpu")
    assert isinstance(dataset, HiveDataset) and dataset.num_frames == 2
    reused = dataset_adaptors.get_dataset(StorageOptions(dataset_path="unused",
                                                         output_path=str(tmp_path / "out")))
    assert reused.num_frames == 2

    stray = tmp_path / "stray"
    for sub in ("depth", "confidence"):
        os.makedirs(stray / sub)
        (stray / sub / "000000.png").write_bytes(b"")
    for name in ("rgb.mp4", "camera_matrix.csv", "odometry.csv"):
        (stray / name).write_bytes(b"")
    video = tmp_path / "video"
    os.makedirs(video)
    (video / "clip.mp4").write_bytes(b"")
    for path in (stray, video, video / "clip.mp4"):
        assert jax_adaptors.TUMAdaptor.is_valid_folder_structure(str(path)) is False
        storage = StorageOptions(dataset_path=str(path), output_path=str(tmp_path / "x"))
        with pytest.raises(ValueError, match="no 'moov' box"):
            dataset_adaptors.get_dataset(storage, device="cpu")
        with pytest.raises((ValueError, ZeroDivisionError, IndexError)):
            jax_adaptors.get_dataset(JaxStorageOptions(dataset_path=str(path),
                                                       output_path=str(tmp_path / "y")))
    assert jax_adaptors.StrayScannerAdaptor.is_valid_folder_structure(str(stray))
    assert dataset_adaptors.StrayScannerAdaptor.is_valid_folder_structure(str(stray))
    assert jax_adaptors.VideoAdaptor.is_valid_folder_structure(str(video))
    assert dataset_adaptors.VideoAdaptor.is_valid_folder_structure(str(video))

    empty = tmp_path / "empty"
    os.makedirs(empty)
    (empty / "notes.txt").write_text("x")
    for path in (empty, tmp_path / "missing"):
        with pytest.raises(RuntimeError):
            dataset_adaptors.get_dataset(StorageOptions(dataset_path=str(path),
                                                        output_path=str(tmp_path / "y")))


def test_estimate_depth_conversion_matches_hive_tpu(tmp_path, monkeypatch):
    """With ``estimate_depth`` both packages write DPT-Hybrid depth maps at
    its weights-absent random initialisation (the same weights in both),
    here at a 64 x 96 net size in both: the policy would upsample these
    64 x 48 frames to a 480 x 640 forward. Depth PNGs within 1 mm; the
    metadata (``estimate_depth: true``) and masks equal."""
    from hive_tpu.ops import resize as jax_resize

    def net_size(*args, **kwargs):
        return 64, 96

    monkeypatch.setattr(jax_resize, "keep_aspect_multiple_of", net_size)
    monkeypatch.setattr(dataset_adaptors, "keep_aspect_multiple_of", net_size)
    outputs = convert_both("tum", tmp_path, estimate_depth=True)
    with open(pjoin(outputs["torch"], "metadata.json")) as f, \
            open(pjoin(outputs["jax"], "metadata.json")) as g:
        metadata = json.load(f)
        assert metadata == json.load(g) and metadata["estimate_depth"] is True
    for name in ("depth", "mask"):
        names = sorted(os.listdir(pjoin(outputs["jax"], name)))
        assert sorted(os.listdir(pjoin(outputs["torch"], name))) == names and len(names) == 5
        for png in names:
            ours, theirs = (pillow(pjoin(outputs[p], name, png)) for p in ("torch", "jax"))
            assert ours.dtype == theirs.dtype and ours.shape == theirs.shape == (48, 64)
            if name == "mask":
                np.testing.assert_array_equal(ours, theirs)
            else:
                assert ours.dtype == np.uint16 and theirs.min() > 1000
                np.testing.assert_allclose(ours.astype(int), theirs.astype(int), atol=1, rtol=0)


@pytest.mark.parametrize("option", ["estimate_pose"])
def test_unported_conversion_options_refused(tmp_path, option, monkeypatch):
    """``--estimate_pose`` without a COLMAP binary (refused here before)
    now runs PnP odometry as hive_tpu does: the same warning, the Kinect
    prior as the intrinsics, and on these random frames, which give no
    pose, the same constant-velocity trajectory in both packages."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "no_weights"))
    base = make_tum_dataset(tmp_path / "tum", num_frames=2)
    kwargs = dict(estimate_pose=False, estimate_depth=False, inpainting_mode=InpaintingMode.Off)
    kwargs[option] = True
    adaptor = dataset_adaptors.TUMAdaptor(
        base_path=base, output_path=str(tmp_path / "out"),
        colmap_options=COLMAPOptions(binary_path=str(tmp_path / "no_colmap")))
    ours = adaptor.convert(device="cpu", **kwargs)
    theirs = jax_adaptors.TUMAdaptor(base_path=base, output_path=str(tmp_path / "jax"),
                           colmap_options=JaxCOLMAPOptions(
                               binary_path=str(tmp_path / "no_colmap"))).convert(
        estimate_pose=True, estimate_depth=False, inpainting_mode=JaxInpaintingMode.Off)
    assert ours.metadata.estimate_pose and theirs.metadata.estimate_pose
    np.testing.assert_array_equal(ours.camera_matrix, theirs.camera_matrix)
    np.testing.assert_allclose(ours.camera_trajectory.values, theirs.camera_trajectory.values,
                               rtol=0, atol=1e-12)


def test_pipeline_run_takes_an_adaptor(tmp_path):
    """``Pipeline.run(adaptor=...)`` converts through the given adaptor (on
    the pipeline's device) instead of sniffing ``--dataset_path``."""
    from hive_tpu_torch.pipeline import Pipeline

    base = make_unreal_dataset(str(tmp_path / "unreal"), num_frames=3)
    out = str(tmp_path / "out")
    argv = ["--dataset_path", str(tmp_path / "not_a_dataset"), "--output_path", out,
            "--num_frames", "3", "--key_frame_threshold", "1.0", "--sdf_max_voxels", "100000",
            "--background_only", "--webxr_path", str(tmp_path / "webxr"),
            "--log_file", str(tmp_path / "log.txt")]
    pipeline = Pipeline.from_command_line(argv, device="cpu")
    pipeline.run(adaptor=dataset_adaptors.UnrealAdaptor(base_path=base, output_path=out),
                 compress=False)
    assert HiveDataset(out).rgb_dataset.image_filenames == ["000000.jpg", "000001.jpg",
                                                            "000002.jpg"]
    assert "create_instance_segmentation_masks" in pipeline.profiling["timing"]["load_dataset"]
    assert os.path.isfile(pjoin(out, "mesh", "bg.glb"))
