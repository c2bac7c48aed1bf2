"""The video adaptors of hive_tpu_torch (``VideoAdaptor``,
``StrayScannerAdaptor``, ``DeviceOrientation``, ``get_dataset`` and the CLI on
video inputs) against hive_tpu's on the same I_PCM and CAVLC I / P H.264,
Motion JPEG and MPEG-4 Part 2 fixtures (the last tests/test_adaptors.py's
own cv2-written video), which hive_tpu reads through cv2 5.0.0 and the port
through its own demuxer and H.264, Motion JPEG and MPEG-4 decoders: sizes,
metadata, frame counts and rates equal; frames and
the JPEG bytes ``copy_frames`` writes equal; camera matrices and
trajectories within 1e-12 (the same float64 operations; a bound, not
equality, in case scipy's and numpy's orders ever differ); depth maps equal
at each confidence level; converted folders and meshes equal."""

import json
import os
import shutil
import sys
from os.path import join as pjoin
from unittest import mock

import cv2
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from hive_tpu import dataset_adaptors as jax_adaptors
from hive_tpu.meshing.gltf import load_glb as jax_load_glb
from hive_tpu.options import COLMAPOptions as JaxCOLMAPOptions
from hive_tpu.options import PipelineOptions as JaxPipelineOptions
from hive_tpu.options import StorageOptions as JaxStorageOptions
from hive_tpu.pipeline import Pipeline as JaxPipeline
from hive_tpu_torch import dataset_adaptors
from hive_tpu_torch.image_codecs import encode_jpeg
from hive_tpu_torch.meshing.gltf import load_glb
from hive_tpu_torch.options import COLMAPOptions, PipelineOptions, StorageOptions
from hive_tpu_torch.pipeline import Pipeline
from hive_tpu_torch.video import color, h264, mp4
from tests.test_adaptors import make_video_dataset

VOCAB = "colmap/vocab.bin"   # the packages' defaults differ; metadata.json holds it
TRAJECTORY_TOL = 1e-12


@pytest.fixture(autouse=True)
def no_weights(tmp_path, monkeypatch):
    """No segmentation weights: both packages take the motion backend."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "no_weights"))


def scene_rgb(num_frames, width, height, seed=2):
    """A gradient wall with a blob crossing it, as RGB frames."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height, 0:width]
    frames = []
    for i in range(num_frames):
        rgb = np.stack([xs * 255 // width, ys * 255 // height, np.full_like(xs, 90)], -1)
        rgb[(xs - width // 8 - 4 * i) ** 2 + (ys - height // 2) ** 2 < width] = (200, 64, 64)
        frames.append(np.clip(rgb + rng.normal(0, 3, rgb.shape), 0, 255).astype(np.uint8))
    return frames


def scene_frames(num_frames, width, height, seed=2):
    """The same frames as YUV planes."""
    return [color.rgb_to_yuv420(rgb) for rgb in scene_rgb(num_frames, width, height, seed)]


def make_video(path, num_frames=6, width=64, height=48, **options):
    h264.write_h264_mp4(str(path), scene_frames(num_frames, width, height),
                        h264.PcmPlanner(width, height), **options)
    return str(path)


def make_cavlc_video(path, num_frames=6, width=64, height=48, seed=5):
    """The same scene as CAVLC H.264 with I and P slices (the seeded
    exerciser's mix of macroblock types, references and slices)."""
    h264.write_h264_mp4(str(path), scene_frames(num_frames, width, height),
                        h264.Exerciser(width, height, seed, gop=4))
    return str(path)


def make_mjpeg_video(path, num_frames=6, width=64, height=48):
    """The same scene as Motion JPEG (the port's ``encode_jpeg``, 4:2:0) in
    the mp4v / 0x6C entry cv2's MJPG writer uses."""
    samples = [encode_jpeg(rgb, 90) for rgb in scene_rgb(num_frames, width, height)]
    mp4.write_mp4(str(path), mp4.mjpeg_entry(width, height), samples, width=width,
                  height=height, timescale=30, durations=[1] * num_frames)
    return str(path)


def make_stray(base, num_frames=5, width=96, height=72, depth_hw=(24, 32), roll_deg=-90.0,
               writer=make_video):
    """A Stray Scanner capture at the app's 4:3 proportions: rgb.mp4 (I_PCM,
    or ``writer``'s), uint16 millimetre depth and 0-2 confidence PNGs,
    camera_matrix.csv and odometry.csv (timestamp, frame, x, y, z, qx, qy,
    qz, qw), the first pose rolled by ``roll_deg``."""
    rng = np.random.default_rng(4)
    os.makedirs(pjoin(base, "depth"))
    os.makedirs(pjoin(base, "confidence"))
    writer(pjoin(base, "rgb.mp4"), num_frames, width, height)
    for i in range(num_frames):
        depth = 1500 + rng.integers(-20, 20, depth_hw)
        cv2.imwrite(pjoin(base, "depth", f"{i:06d}.png"), depth.astype(np.uint16))
        cv2.imwrite(pjoin(base, "confidence", f"{i:06d}.png"),
                    rng.choice([0, 1, 2, 2], depth_hw).astype(np.uint8))
    np.savetxt(pjoin(base, "camera_matrix.csv"),
               [[0.8 * width, 0, width / 2], [0, 0.8 * width, height / 2], [0, 0, 1]],
               delimiter=",")
    with open(pjoin(base, "odometry.csv"), "w") as f:
        f.write("timestamp, frame, x, y, z, qx, qy, qz, qw\n")
        for i in range(num_frames):
            q = Rotation.from_euler("xyz", [0.01 * i, 0.02, np.deg2rad(roll_deg)]).as_quat()
            f.write(", ".join(repr(float(x)) for x in
                              (i / 30, i, 0.01 * i, 0.002 * i, -0.003 * i, *q)) + "\n")
    return str(base)


def metadata_json(adaptor, tmp_path, name):
    path = str(tmp_path / f"{name}.json")
    adaptor.get_metadata(estimate_pose=True, estimate_depth=True).save(path)
    with open(path) as f:
        return json.load(f)


def same_files(ours, theirs):
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names and names
    for name in names:
        with open(pjoin(ours, name), "rb") as f, open(pjoin(theirs, name), "rb") as g:
            assert f.read() == g.read(), name


def png(path):
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("resize_to", [None, 160])
@pytest.mark.parametrize("layout", [{}, dict(reorder=True), dict(rotation=90),
                                    dict(edit_frames=2)],
                         ids=["in_order", "out_of_order", "rotated_90", "edit"])
def test_video_adaptor_matches_hive_tpu(tmp_path, layout, resize_to):
    video = make_video(tmp_path / "clip.mp4", num_frames=6, **layout)
    ours = dataset_adaptors.VideoAdaptor(video, str(tmp_path / "ours"), resize_to=resize_to,
                                         colmap_options=COLMAPOptions(vocab_path=VOCAB),
                                         device="cpu")
    theirs = jax_adaptors.VideoAdaptor(video, str(tmp_path / "theirs"), resize_to=resize_to,
                                       colmap_options=JaxCOLMAPOptions(vocab_path=VOCAB))
    assert (ours.target_width, ours.target_height, ours.num_frames, ours.fps) == \
        (theirs.target_width, theirs.target_height, theirs.num_frames, theirs.fps)
    assert ours.num_frames == 6 - layout.get("edit_frames", 0)
    assert metadata_json(ours, tmp_path, "ours") == metadata_json(theirs, tmp_path, "theirs")
    for index in (0, ours.num_frames // 2, ours.num_frames - 1):
        np.testing.assert_array_equal(ours.get_frame(index), theirs.get_frame(index))
    for adaptor, name in ((ours, "ours_rgb"), (theirs, "theirs_rgb")):
        os.makedirs(tmp_path / name)
        adaptor.copy_frames(str(tmp_path / name), file_extension="jpg")
    same_files(str(tmp_path / "ours_rgb"), str(tmp_path / "theirs_rgb"))
    with pytest.raises(NotImplementedError, match="estimate_pose"):
        ours.get_camera_matrix()


@pytest.mark.parametrize("roll_deg", [0.0, -90.0, 90.0, 180.0])
def test_stray_scanner_adaptor_matches_hive_tpu(tmp_path, roll_deg):
    """Each of the four orientations: the orientation, the (swapped) target
    size, the camera matrix and trajectory, the depth maps at each
    confidence level (rotated before the float32 resize) and the frames
    (rotated, then resized)."""
    base = make_stray(tmp_path / "stray", roll_deg=roll_deg)
    for level in (0, 1, 2):
        ours = dataset_adaptors.StrayScannerAdaptor(
            base, str(tmp_path / "ours"), resize_to=64, depth_confidence_filter_level=level,
            device="cpu")
        theirs = jax_adaptors.StrayScannerAdaptor(
            base, str(tmp_path / "theirs"), resize_to=64, depth_confidence_filter_level=level)
        assert ours.device_orientation.name == theirs.device_orientation.name
        assert (ours.target_width, ours.target_height) == (theirs.target_width,
                                                           theirs.target_height)
        np.testing.assert_allclose(ours.get_camera_matrix(), theirs.get_camera_matrix(),
                                   rtol=0, atol=TRAJECTORY_TOL)
        np.testing.assert_allclose(ours.get_camera_trajectory().values,
                                   theirs.get_camera_trajectory().values, rtol=0,
                                   atol=TRAJECTORY_TOL)
        for index in range(ours.num_frames):
            got, want = ours.get_depth_map(index), theirs.get_depth_map(index)
            assert got.dtype == want.dtype == np.uint16
            np.testing.assert_array_equal(got, want)
    portrait = roll_deg in (-90.0, 90.0)
    assert (ours.target_width, ours.target_height) == ((48, 64) if portrait else (64, 48))
    for adaptor, name in ((ours, "ours_rgb"), (theirs, "theirs_rgb")):
        os.makedirs(tmp_path / name)
        adaptor.copy_frames(str(tmp_path / name), file_extension="jpg")
    same_files(str(tmp_path / "ours_rgb"), str(tmp_path / "theirs_rgb"))


def test_stray_scanner_without_orientation_fix_and_bad_confidence(tmp_path):
    base = make_stray(tmp_path / "stray", roll_deg=-90.0)
    ours = dataset_adaptors.StrayScannerAdaptor(base, str(tmp_path / "o"), fix_orientation=False,
                                                device="cpu")
    theirs = jax_adaptors.StrayScannerAdaptor(base, str(tmp_path / "t"), fix_orientation=False)
    assert ours.device_orientation.name == theirs.device_orientation.name == "Landscape"
    np.testing.assert_allclose(ours.get_camera_trajectory().values,
                               theirs.get_camera_trajectory().values, rtol=0,
                               atol=TRAJECTORY_TOL)
    for package in (dataset_adaptors, jax_adaptors):
        kwargs = dict(device="cpu") if package is dataset_adaptors else {}
        with pytest.raises(ValueError, match="Confidence filter"):
            package.StrayScannerAdaptor(base, str(tmp_path / "x"),
                                        depth_confidence_filter_level=3, **kwargs)


ANGLES = [0.0, 45.0, -45.0, 45.000001, -45.000001, 90.0, -90.0, 135.0, -135.0, 135.000001,
          -135.000001, 180.0, -180.0]


@pytest.mark.parametrize("degrees", [True, False])
def test_device_orientation_from_angle_matches_hive_tpu(degrees):
    for angle in ANGLES:
        value = angle if degrees else np.deg2rad(angle)
        ours = dataset_adaptors.DeviceOrientation.from_angle(value, degrees=degrees)
        theirs = jax_adaptors.DeviceOrientation.from_angle(value, degrees=degrees)
        assert ours.name == theirs.name, angle
        ours_code = dataset_adaptors.DeviceOrientation.to_opencv_rotation(ours)
        theirs_code = jax_adaptors.DeviceOrientation.to_opencv_rotation(theirs)
        assert ours_code == theirs_code, angle
    for package in (dataset_adaptors, jax_adaptors):
        with pytest.raises(ValueError, match="outside"):
            package.DeviceOrientation.from_angle(400.0, degrees=True)


def compare_converted(ours, theirs, depth_atol=0):
    with open(pjoin(ours, "metadata.json")) as f, open(pjoin(theirs, "metadata.json")) as g:
        assert json.load(f) == json.load(g)
    np.testing.assert_allclose(np.loadtxt(pjoin(ours, "camera_matrix.txt")),
                               np.loadtxt(pjoin(theirs, "camera_matrix.txt")), rtol=0,
                               atol=TRAJECTORY_TOL)
    np.testing.assert_allclose(np.loadtxt(pjoin(ours, "camera_trajectory.txt")),
                               np.loadtxt(pjoin(theirs, "camera_trajectory.txt")), rtol=0,
                               atol=TRAJECTORY_TOL)
    same_files(pjoin(ours, "rgb"), pjoin(theirs, "rgb"))
    for folder in ("depth", "mask"):
        names = sorted(os.listdir(pjoin(theirs, folder)))
        assert sorted(os.listdir(pjoin(ours, folder))) == names and names
        for name in names:
            got, want = png(pjoin(ours, folder, name)), png(pjoin(theirs, folder, name))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_allclose(got.astype(int), want.astype(int), rtol=0,
                                       atol=depth_atol if folder == "depth" else 0)


def test_get_dataset_converts_a_stray_capture_like_hive_tpu(tmp_path):
    """Ground-truth poses (no ``--estimate_pose``, so the orientation is
    fixed from the odometry): the converted folders are equal."""
    base = make_stray(tmp_path / "stray", roll_deg=-90.0)
    outputs = {name: str(tmp_path / name) for name in ("ours", "theirs")}
    ours = dataset_adaptors.get_dataset(
        StorageOptions(dataset_path=base, output_path=outputs["ours"]),
        COLMAPOptions(vocab_path=VOCAB), PipelineOptions(), resize_to=64,
        depth_confidence_filter_level=1, device="cpu")
    theirs = jax_adaptors.get_dataset(
        JaxStorageOptions(dataset_path=base, output_path=outputs["theirs"]),
        JaxCOLMAPOptions(vocab_path=VOCAB), JaxPipelineOptions(), resize_to=64,
        depth_confidence_filter_level=1)
    assert ours.num_frames == theirs.num_frames == 5
    assert (ours.metadata.width, ours.metadata.height) == (48, 64)
    compare_converted(outputs["ours"], outputs["theirs"])


def test_get_dataset_estimates_pose_and_depth_of_a_video_like_hive_tpu(tmp_path, monkeypatch):
    """A plain video with ``--estimate_pose --estimate_depth`` and no COLMAP
    binary: DPT-Hybrid depth at its weights-absent random initialisation
    (both packages' forwards at 64 x 96, as tests/test_torch_adaptors.py
    patches them) within 1 mm, the bf16 network's rounding; PnP odometry's
    trajectory on the same frames; equal frames and masks."""
    from hive_tpu.ops import resize as jax_resize

    def net_size(*args, **kwargs):
        return 64, 96

    monkeypatch.setattr(jax_resize, "keep_aspect_multiple_of", net_size)
    monkeypatch.setattr(dataset_adaptors, "keep_aspect_multiple_of", net_size)
    video = make_video(tmp_path / "clip.mp4", num_frames=4)
    outputs = {name: str(tmp_path / name) for name in ("ours", "theirs")}
    binary = str(tmp_path / "no_colmap")
    dataset_adaptors.get_dataset(
        StorageOptions(dataset_path=video, output_path=outputs["ours"]),
        COLMAPOptions(vocab_path=VOCAB, binary_path=binary),
        PipelineOptions(estimate_pose=True, estimate_depth=True), resize_to=64, device="cpu")
    jax_adaptors.get_dataset(
        JaxStorageOptions(dataset_path=video, output_path=outputs["theirs"]),
        JaxCOLMAPOptions(vocab_path=VOCAB, binary_path=binary),
        JaxPipelineOptions(estimate_pose=True, estimate_depth=True), resize_to=64)
    compare_converted(outputs["ours"], outputs["theirs"], depth_atol=1)


def test_motion_jpeg_video_converts_with_pose_and_depth_like_hive_tpu(tmp_path, monkeypatch):
    """A Motion JPEG clip (what cv2's MJPG writer stores in an .mp4) with
    ``--estimate_pose --estimate_depth`` and no COLMAP binary, as the CLI
    runs it on the card: the adaptor's frames and sizes, then the converted
    folders, as in the H.264 test above (DPT at 64 x 96, depth within
    1 mm)."""
    from hive_tpu.ops import resize as jax_resize

    def net_size(*args, **kwargs):
        return 64, 96

    monkeypatch.setattr(jax_resize, "keep_aspect_multiple_of", net_size)
    monkeypatch.setattr(dataset_adaptors, "keep_aspect_multiple_of", net_size)
    video = make_mjpeg_video(tmp_path / "clip.mp4", num_frames=4)
    ours = dataset_adaptors.VideoAdaptor(video, str(tmp_path / "a"), resize_to=64,
                                         colmap_options=COLMAPOptions(vocab_path=VOCAB),
                                         device="cpu")
    theirs = jax_adaptors.VideoAdaptor(video, str(tmp_path / "b"), resize_to=64,
                                       colmap_options=JaxCOLMAPOptions(vocab_path=VOCAB))
    assert (ours.target_width, ours.target_height, ours.num_frames, ours.fps) == \
        (theirs.target_width, theirs.target_height, theirs.num_frames, theirs.fps) == \
        (64, 48, 4, 30.0)
    for index in range(4):
        np.testing.assert_array_equal(ours.get_frame(index), theirs.get_frame(index))
    outputs = {name: str(tmp_path / name) for name in ("ours", "theirs")}
    binary = str(tmp_path / "no_colmap")
    dataset_adaptors.get_dataset(
        StorageOptions(dataset_path=video, output_path=outputs["ours"]),
        COLMAPOptions(vocab_path=VOCAB, binary_path=binary),
        PipelineOptions(estimate_pose=True, estimate_depth=True), resize_to=64, device="cpu")
    jax_adaptors.get_dataset(
        JaxStorageOptions(dataset_path=video, output_path=outputs["theirs"]),
        JaxCOLMAPOptions(vocab_path=VOCAB, binary_path=binary),
        JaxPipelineOptions(estimate_pose=True, estimate_depth=True), resize_to=64)
    compare_converted(outputs["ours"], outputs["theirs"], depth_atol=1)


def test_hive_tpu_mp4v_fixture_reads_and_converts_like_hive_tpu(tmp_path, monkeypatch):
    """tests/test_adaptors.py's make_video_dataset video (cv2's mp4v writer:
    MPEG-4 Part 2, 6 frames at 10 fps) through both packages' VideoAdaptor:
    equal metadata and frame count, every frame, the JPEG bytes
    copy_frames writes; then converted with ``--estimate_pose
    --estimate_depth`` and no COLMAP binary, as the I_PCM and Motion JPEG
    cases above (DPT at 64 x 96, depth within 1 mm)."""
    from hive_tpu.ops import resize as jax_resize

    def net_size(*args, **kwargs):
        return 64, 96

    monkeypatch.setattr(jax_resize, "keep_aspect_multiple_of", net_size)
    monkeypatch.setattr(dataset_adaptors, "keep_aspect_multiple_of", net_size)
    video = make_video_dataset(tmp_path / "data")
    assert mp4.read_track(video).codec == mp4.MPEG4
    ours = dataset_adaptors.VideoAdaptor(video, str(tmp_path / "a"),
                                         colmap_options=COLMAPOptions(vocab_path=VOCAB),
                                         device="cpu")
    theirs = jax_adaptors.VideoAdaptor(video, str(tmp_path / "b"),
                                       colmap_options=JaxCOLMAPOptions(vocab_path=VOCAB))
    assert (ours.target_width, ours.target_height, ours.num_frames, ours.fps) == \
        (theirs.target_width, theirs.target_height, theirs.num_frames, theirs.fps) == \
        (64, 48, 6, 10.0)
    assert ours.get_full_num_frames() == theirs.get_full_num_frames() == 6
    assert metadata_json(ours, tmp_path, "ours") == metadata_json(theirs, tmp_path, "theirs")
    for index in range(6):
        np.testing.assert_array_equal(ours.get_frame(index), theirs.get_frame(index))
    for adaptor, name in ((ours, "ours_rgb"), (theirs, "theirs_rgb")):
        os.makedirs(tmp_path / name)
        adaptor.copy_frames(str(tmp_path / name), file_extension="jpg")
    same_files(str(tmp_path / "ours_rgb"), str(tmp_path / "theirs_rgb"))
    outputs = {name: str(tmp_path / name) for name in ("ours", "theirs")}
    binary = str(tmp_path / "no_colmap")
    dataset_adaptors.get_dataset(
        StorageOptions(dataset_path=video, output_path=outputs["ours"]),
        COLMAPOptions(vocab_path=VOCAB, binary_path=binary),
        PipelineOptions(estimate_pose=True, estimate_depth=True), resize_to=64, device="cpu")
    jax_adaptors.get_dataset(
        JaxStorageOptions(dataset_path=video, output_path=outputs["theirs"]),
        JaxCOLMAPOptions(vocab_path=VOCAB, binary_path=binary),
        JaxPipelineOptions(estimate_pose=True, estimate_depth=True), resize_to=64)
    compare_converted(outputs["ours"], outputs["theirs"], depth_atol=1)


def test_cli_converts_and_meshes_a_stray_capture_like_hive_tpu(tmp_path):
    """``python -m hive_tpu_torch --dataset_path <capture>`` (the CLI's
    pipeline on the CPU) and hive_tpu's CLI: equal converted folders and an
    equal ``bg.glb``, fused from the capture's rotated poses."""
    base = make_stray(tmp_path / "stray", num_frames=4, roll_deg=-90.0)
    paths = {name: str(tmp_path / name) for name in ("ours", "theirs")}

    def args(path):
        return ["--dataset_path", base, "--output_path", path, "--key_frame_threshold", "1.0",
                "--sdf_max_voxels", "200000", "--background_only", "--disable_scaling",
                "--vocab_path", VOCAB, "--webxr_path", path + "_webxr", "--log_file",
                path + ".log"]

    with mock.patch.object(sys, "argv", ["hive", *args(paths["theirs"])]):
        JaxPipeline.from_command_line().run(compress=False)
    Pipeline.from_command_line(args(paths["ours"]), device="cpu").run(compress=False)
    compare_converted(paths["ours"], paths["theirs"])
    ours = load_glb(pjoin(paths["ours"], "mesh", "bg.glb"))
    theirs = jax_load_glb(pjoin(paths["theirs"], "mesh", "bg.glb"))
    assert ours.node_names == theirs.node_names
    for name in ours.node_names:
        got, want = ours.geometry[name], theirs.geometry[name]
        assert len(want.faces) > 0
        for attribute in ("faces", "vertices", "vertex_colors"):
            np.testing.assert_array_equal(getattr(got, attribute), getattr(want, attribute))
    shutil.rmtree(paths["ours"])


def test_cavlc_video_converts_with_pose_and_depth_like_hive_tpu(tmp_path, monkeypatch):
    """A CAVLC H.264 clip of I and P slices with ``--estimate_pose
    --estimate_depth`` and no COLMAP binary, as the CLI runs a phone's clip
    on the card: the adaptor's sizes, metadata, frames and the JPEG bytes
    copy_frames writes, then the converted folders, as for Motion JPEG
    above (DPT at 64 x 96, depth within 1 mm)."""
    from hive_tpu.ops import resize as jax_resize

    def net_size(*args, **kwargs):
        return 64, 96

    monkeypatch.setattr(jax_resize, "keep_aspect_multiple_of", net_size)
    monkeypatch.setattr(dataset_adaptors, "keep_aspect_multiple_of", net_size)
    video = make_cavlc_video(tmp_path / "clip.mp4", num_frames=5)
    ours = dataset_adaptors.VideoAdaptor(video, str(tmp_path / "a"), resize_to=64,
                                         colmap_options=COLMAPOptions(vocab_path=VOCAB),
                                         device="cpu")
    theirs = jax_adaptors.VideoAdaptor(video, str(tmp_path / "b"), resize_to=64,
                                       colmap_options=JaxCOLMAPOptions(vocab_path=VOCAB))
    assert (ours.target_width, ours.target_height, ours.num_frames, ours.fps) == \
        (theirs.target_width, theirs.target_height, theirs.num_frames, theirs.fps) == \
        (64, 48, 5, 30.0)
    assert metadata_json(ours, tmp_path, "ours") == metadata_json(theirs, tmp_path, "theirs")
    for index in range(5):
        np.testing.assert_array_equal(ours.get_frame(index), theirs.get_frame(index))
    for adaptor, name in ((ours, "ours_rgb"), (theirs, "theirs_rgb")):
        os.makedirs(tmp_path / name)
        adaptor.copy_frames(str(tmp_path / name), file_extension="jpg")
    same_files(str(tmp_path / "ours_rgb"), str(tmp_path / "theirs_rgb"))
    outputs = {name: str(tmp_path / name) for name in ("ours", "theirs")}
    binary = str(tmp_path / "no_colmap")
    dataset_adaptors.get_dataset(
        StorageOptions(dataset_path=video, output_path=outputs["ours"]),
        COLMAPOptions(vocab_path=VOCAB, binary_path=binary),
        PipelineOptions(estimate_pose=True, estimate_depth=True), resize_to=64, device="cpu")
    jax_adaptors.get_dataset(
        JaxStorageOptions(dataset_path=video, output_path=outputs["theirs"]),
        JaxCOLMAPOptions(vocab_path=VOCAB, binary_path=binary),
        JaxPipelineOptions(estimate_pose=True, estimate_depth=True), resize_to=64)
    compare_converted(outputs["ours"], outputs["theirs"], depth_atol=1)


def test_cli_converts_and_meshes_a_cavlc_stray_capture_like_hive_tpu(tmp_path):
    """A Stray Scanner capture whose rgb.mp4 is CAVLC H.264 with P slices
    (the app writes CABAC: tests/test_torch_h264_cabac.py): both CLIs give
    equal converted folders and an equal ``bg.glb``."""
    base = make_stray(tmp_path / "stray", num_frames=4, roll_deg=-90.0, writer=make_cavlc_video)
    paths = {name: str(tmp_path / name) for name in ("ours", "theirs")}

    def args(path):
        return ["--dataset_path", base, "--output_path", path, "--key_frame_threshold", "1.0",
                "--sdf_max_voxels", "200000", "--background_only", "--disable_scaling",
                "--vocab_path", VOCAB, "--webxr_path", path + "_webxr", "--log_file",
                path + ".log"]

    with mock.patch.object(sys, "argv", ["hive", *args(paths["theirs"])]):
        JaxPipeline.from_command_line().run(compress=False)
    Pipeline.from_command_line(args(paths["ours"]), device="cpu").run(compress=False)
    compare_converted(paths["ours"], paths["theirs"])
    ours = load_glb(pjoin(paths["ours"], "mesh", "bg.glb"))
    theirs = jax_load_glb(pjoin(paths["theirs"], "mesh", "bg.glb"))
    assert ours.node_names == theirs.node_names
    for name in ours.node_names:
        got, want = ours.geometry[name], theirs.geometry[name]
        assert len(want.faces) > 0
        for attribute in ("faces", "vertices", "vertex_colors"):
            np.testing.assert_array_equal(getattr(got, attribute), getattr(want, attribute))


def test_cli_refuses_a_b_slice_video_before_writing_anything(tmp_path):
    """A clip the port refuses, whose SPS codes fields (ROADMAP Queue 1 item
    9f-4; until B slices decoded, a clip with a B slice was the refused one,
    and before that a CABAC clip): the port's CLI refuses it naming the
    item, before its output folder exists."""
    import chip_smoke

    source = make_cavlc_video(tmp_path / "source.mp4", num_frames=3, height=64)
    track = mp4.read_track(source)
    length, _, pps = mp4.parse_avcc(track.config)
    with open(source, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(f.read(int(size)))
    clip = str(tmp_path / "fields.mp4")
    mp4.write_mp4(clip, mp4.avc1_entry(64, 64, chip_smoke.field_sps(64, 64), pps[0]), samples,
                  width=64, height=64, timescale=30, durations=[1] * 3, sync=[True, False, False])
    out = str(tmp_path / "out")
    with pytest.raises(mp4.UnsupportedVideoError, match="fields or MBAFF.*Queue 1 item 9f-4"):
        Pipeline.from_command_line(["--dataset_path", clip, "--output_path", out,
                                    "--estimate_pose", "--estimate_depth", "--webxr_path",
                                    out + "_webxr", "--log_file", out + ".log"],
                                   device="cpu").run()
    assert not os.path.exists(out)
