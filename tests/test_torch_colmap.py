"""COLMAP models and --estimate_pose (hive_tpu_torch.data.colmap_model,
io.COLMAPProcessor, dataset_adaptors) against hive_tpu's on the same inputs:
the .bin files byte for byte in both directions, the dense depth-map reader,
the command line, the camera parameters and the sparse depth maps equal, the
dense maps' nearest-exact resize equal to OpenCV 5.0.0's
INTER_NEAREST_EXACT, and a TUM folder converted and meshed with
--estimate_pose through both CLIs with a stand-in ``colmap`` executable."""

import json
import os
import sys
from os.path import join as pjoin
from unittest import mock

import cv2
import numpy as np
import pytest

from chip_smoke import write_colmap_stand_in
from hive_tpu.data import colmap_model as jax_cm
from hive_tpu.io import COLMAPProcessor as JaxCOLMAPProcessor
from hive_tpu.options import COLMAPOptions as JaxCOLMAPOptions
from hive_tpu.pipeline import Pipeline as JaxPipeline
from hive_tpu_torch import dataset_adaptors
from hive_tpu_torch.data import colmap_model as cm
from hive_tpu_torch.geometric import Trajectory
from hive_tpu_torch.io import COLMAPProcessor, HiveDataset, resize_nearest_exact
from hive_tpu_torch.meshing.gltf import load_glb
from hive_tpu_torch.options import COLMAPOptions
from hive_tpu_torch.pipeline import Pipeline
from tests.test_adaptors import make_tum_dataset


@pytest.fixture(autouse=True)
def no_weights(tmp_path, monkeypatch):
    """No segmentation weights: both packages take the motion backend."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "no_weights"))


def make_model(module, seed=3, num_images=4, num_points=30):
    rng = np.random.default_rng(seed)
    cameras = {1: module.ColmapCamera(1, "PINHOLE", 64, 48, np.array([58.0, 57.0, 31.5, 23.5])),
               2: module.ColmapCamera(2, "SIMPLE_RADIAL", 640, 480,
                                      np.array([580.0, 320.0, 240.0, 0.01]))}
    images = {}
    for i in range(1, num_images + 1):
        qvec = rng.normal(size=4)
        images[i] = module.ColmapImage(
            i, qvec / np.linalg.norm(qvec), rng.normal(size=3), 1, f"{i - 1:06d}.jpg",
            rng.uniform(0, 48, size=(7, 2)), rng.integers(-1, num_points, 7).astype(np.int64))
    points = {j: module.ColmapPoint3D(j, rng.normal(size=3), rng.integers(0, 256, 3), 0.25 * j)
              for j in range(num_points)}
    return cameras, images, points


def model_bytes(path):
    return {name: open(pjoin(path, name), "rb").read()
            for name in ("cameras.bin", "images.bin", "points3D.bin")}


def test_model_files_byte_equal_both_ways(tmp_path):
    for name, module in (("jax", jax_cm), ("torch", cm)):
        os.makedirs(tmp_path / name)
        module.write_model(str(tmp_path / name), *make_model(module))
    assert model_bytes(tmp_path / "torch") == model_bytes(tmp_path / "jax")
    for reader, writer in ((cm, "jax"), (jax_cm, "torch")):
        cameras, images, points = reader.read_model(str(tmp_path / writer))
        os.makedirs(tmp_path / f"again_{writer}")
        reader.write_model(str(tmp_path / f"again_{writer}"), cameras, images, points)
        assert model_bytes(tmp_path / f"again_{writer}") == model_bytes(tmp_path / writer)
    ours, theirs = cm.read_model(str(tmp_path / "jax")), jax_cm.read_model(str(tmp_path / "jax"))
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            for field in ("params", "qvec", "tvec", "xys", "point3d_ids", "xyz", "rgb"):
                if hasattr(b[key], field):
                    np.testing.assert_array_equal(getattr(a[key], field), getattr(b[key], field))
    np.testing.assert_array_equal(ours[1][2].rotation_matrix(), theirs[1][2].rotation_matrix())


def test_dense_depth_map_reader_matches(tmp_path):
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 4, (3, 37, 29)).astype(np.float32)  # (channels, height, width)
    path = str(tmp_path / "000000.jpg.geometric.bin")
    with open(path, "wb") as f:
        f.write(b"29&37&3&" + depth.tobytes())
    got, want = cm.read_colmap_depth_map(path), jax_cm.read_colmap_depth_map(path)
    assert got.shape == (37, 29, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_resize_nearest_exact_is_cv2s():
    """OpenCV 5.0.0 accumulates its source coordinate in float64, so its
    ties fall either way; the port's index maps are its own."""
    rng = np.random.default_rng(5)
    sizes = [((480, 640), (240, 320)), ((479, 641), (480, 640)), ((1080, 1920), (480, 640)),
             ((3, 5), (48, 64)), ((1, 1), (7, 9)), ((6, 2), (9, 7))]
    sizes += [(tuple(rng.integers(1, 300, 2)), tuple(rng.integers(1, 300, 2)))
              for _ in range(400)]
    for (h, w), (H, W) in sizes:
        image = rng.random((h, w)).astype(np.float32)
        want = cv2.resize(image, (int(W), int(H)), interpolation=cv2.INTER_NEAREST_EXACT)
        np.testing.assert_array_equal(resize_nearest_exact(image, (H, W)), want,
                                      err_msg=f"{h}x{w} -> {H}x{W}")


def processors(tmp_path, **options):
    """One COLMAP workspace with a model and frames, seen by both packages'
    processors."""
    images = tmp_path / "rgb"
    os.makedirs(images)
    for i in range(4):
        cv2.imwrite(str(images / f"{i:06d}.jpg"), np.zeros((48, 64, 3), np.uint8))
    workspace = tmp_path / "workspace"
    os.makedirs(workspace / "sparse" / "0")
    binary = tmp_path / "colmap"
    binary.write_text("#!/bin/sh\n")
    ours = COLMAPProcessor(str(images), str(workspace),
                           COLMAPOptions(binary_path=str(binary), vocab_path="v.bin", **options))
    theirs = JaxCOLMAPProcessor(str(images), str(workspace),
                                JaxCOLMAPOptions(binary_path=str(binary), vocab_path="v.bin",
                                                 **options))
    return ours, theirs, workspace


@pytest.mark.parametrize("options", [{}, {"dense": True, "quality": "medium"}],
                         ids=["default", "dense_medium"])
def test_get_command_matches(tmp_path, options):
    ours, theirs, _ = processors(tmp_path, **options)
    os.makedirs(ours.mask_path)
    assert ours.get_command() == theirs.get_command()


def test_camera_params_and_sparse_depth_match(tmp_path):
    """A model whose points project into the frames: the same intrinsics,
    trajectory (a missing frame interpolated) and splatted depth maps."""
    ours, theirs, workspace = processors(tmp_path)
    rng = np.random.default_rng(6)
    K = np.array([[58.0, 0, 31.5], [0, 57.0, 23.5], [0, 0, 1]])
    points = {j: cm.ColmapPoint3D(j, np.array([*rng.uniform(-0.8, 0.8, 2), rng.uniform(2, 3)]),
                                  np.array([1, 2, 3]), 0.1) for j in range(60)}
    images = {}
    for i in (0, 1, 3):  # frame 2 is not registered
        angle = 0.02 * i
        qvec = np.array([np.cos(angle / 2), 0, np.sin(angle / 2), 0])
        images[i + 1] = cm.ColmapImage(i + 1, qvec, np.array([0.05 * i, 0.01, 0.02]), 1,
                                       f"{i:06d}.jpg", rng.uniform(0, 48, (60, 2)),
                                       np.where(rng.random(60) < 0.8, np.arange(60), -1))
    cameras = {1: cm.ColmapCamera(1, "PINHOLE", 64, 48, np.array([58.0, 57.0, 31.5, 23.5]))}
    cm.write_model(str(workspace / "sparse" / "0"), cameras, images, points)

    (K_ours, traj_ours), (K_theirs, traj_theirs) = (
        ours.load_camera_params(), theirs.load_camera_params(raw_pose=True))
    np.testing.assert_array_equal(K_ours, K_theirs)
    np.testing.assert_array_equal(traj_ours.values, traj_theirs.values)
    np.testing.assert_array_equal(K_ours, K)
    assert len(traj_ours) == 4
    depth_ours = ours.get_sparse_depth_maps(K_ours, ours.load_camera_params()[1])
    depth_theirs = theirs.get_sparse_depth_maps(K_theirs, theirs.load_camera_params()[1])
    assert depth_ours.dtype == depth_theirs.dtype and (depth_ours > 0).sum() > 100
    np.testing.assert_array_equal(depth_ours, depth_theirs)


def test_dense_depth_maps_match(tmp_path):
    ours, theirs, workspace = processors(tmp_path, dense=True)
    folder = workspace / "dense" / "0" / "stereo" / "depth_maps"
    os.makedirs(folder)
    rng = np.random.default_rng(7)
    for i in range(4):
        for kind in ("geometric", "photometric"):
            depth = rng.uniform(-0.5, 5, (1, 37, 50)).astype(np.float32)
            with open(folder / f"{i:06d}.jpg.{kind}.bin", "wb") as f:
                f.write(b"50&37&1&" + depth.tobytes())
    for resize_to in ((48, 64), (74, 100)):
        got = ours.get_dense_depth_maps(resize_to=resize_to)
        np.testing.assert_array_equal(got, theirs.get_dense_depth_maps(resize_to=resize_to))
    assert got.shape == (4, 74, 100)


# ---------------------------------------------------------------------------
# --estimate_pose through both CLIs.
# ---------------------------------------------------------------------------

TUM_FRAMES = 5
STAND_IN_K = np.array([[58.0, 0.0, 31.5], [0.0, 58.0, 23.5], [0.0, 0.0, 1.0]])


def test_estimate_pose_through_both_clis(tmp_path):
    """A 5-frame TUM folder (a camera moving along x, a wall at 1 m),
    converted with --estimate_pose by each CLI with a stand-in ``colmap``
    that writes a sparse model of the staged frames (the CLI's --frame_step
    15 stages frames 0 and 4) from the ground truth in units of
    COLMAP_SCALE metres: the same camera_matrix.txt, the trajectory within
    1e-5 and back at metric scale, frames 1-3 interpolated, and equal bg.glb
    vertices and faces."""
    base = make_tum_dataset(tmp_path / "tum", num_frames=TUM_FRAMES)
    truth = dataset_adaptors.TUMAdaptor(base, str(tmp_path / "unused")).camera_trajectory
    stand_in = write_colmap_stand_in(str(tmp_path / "bin"), truth.values[:TUM_FRAMES],
                                     STAND_IN_K, (64, 48), depth=1.0, frame_step=15)
    outputs = {}
    for name in ("jax", "torch"):
        out = str(tmp_path / name)
        argv = ["--dataset_path", base, "--output_path", out, "--estimate_pose",
                "--binary_path", stand_in, "--vocab_path", "colmap/vocab.bin",
                "--key_frame_threshold", "1.0", "--sdf_max_voxels", "200000",
                "--background_only", "--webxr_path", out + "_webxr", "--log_file", out + ".log"]
        if name == "jax":
            with mock.patch.object(sys, "argv", ["hive", *argv]):
                JaxPipeline.from_command_line().run(compress=False)
        else:
            Pipeline.from_command_line(argv, device="cpu").run(compress=False)
        outputs[name] = out
        assert os.path.isfile(pjoin(out, "debug", "colmap", "workspace", "sparse", "0",
                                    "images.bin"))

    cameras = [np.loadtxt(pjoin(outputs[n], "camera_matrix.txt")) for n in ("torch", "jax")]
    np.testing.assert_array_equal(cameras[0], cameras[1])
    np.testing.assert_array_equal(cameras[0], STAND_IN_K)
    ours = Trajectory.load(pjoin(outputs["torch"], "camera_trajectory.txt")).values
    theirs = Trajectory.load(pjoin(outputs["jax"], "camera_trajectory.txt")).values
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    # Metric again: the ground truth's own motion (1 cm a frame), not 0.37 cm.
    np.testing.assert_allclose(ours, Trajectory(truth.values[:TUM_FRAMES]).normalise().values,
                               rtol=0, atol=1e-5)
    with open(pjoin(outputs["torch"], "metadata.json")) as f:
        assert json.load(f)["estimate_pose"] is True

    meshes = [next(iter(load_glb(pjoin(outputs[n], "mesh", "bg.glb")).geometry.values()))
              for n in ("torch", "jax")]
    assert len(meshes[0].vertices) > 100
    np.testing.assert_array_equal(meshes[0].faces, meshes[1].faces)
    np.testing.assert_array_equal(meshes[0].vertices, meshes[1].vertices)
    assert HiveDataset(outputs["torch"]).num_frames == TUM_FRAMES
