"""hive_tpu_torch's LLFF and HyperNeRF loaders and ``evaluate_renders``
against hive_tpu's on the CPU, over the synthetic captures of
tests/test_data_loaders.py (64 x 48 images).

Poses, intrinsics, splits, trajectories and images are held equal. The
scores of ``evaluate_renders`` are held to the metrics' tolerances
(tests/test_torch_render_metrics.py): SSIM within 1e-9, PSNR equal, LPIPS
NaN in both without weights and within 1e-4 relative with the same check
weights, MIFD within MIFD_RTOL (the port's SIFT and exact k-NN against
OpenCV's SIFT and FLANN, differences by design named in ROADMAP Queue 3);
the rendered PNGs decode to the same pixels.
"""

import os
from os.path import join as pjoin

import numpy as np
import pytest
import torch
from PIL import Image

from hive_tpu import metrics as jax_metrics
from hive_tpu.data import hypernerf as jax_hypernerf
from hive_tpu.data import llff as jax_llff
from hive_tpu.meshing.mesh import Scene as JaxScene
from hive_tpu.meshing.mesh import TriangleMesh as JaxMesh
from hive_tpu_torch import metrics
from hive_tpu_torch.data import hypernerf, llff
from hive_tpu_torch.io import load_image
from hive_tpu_torch.meshing.mesh import Scene, TriangleMesh
from tests.test_data_loaders import make_hypernerf_capture, make_llff_capture

MIFD_RTOL = 0.01


def _add_jpeg_level(path, factor, quality=90):
    """An ``images_<factor>`` folder of JPEGs (Pillow's bytes), as LLFF's
    downsampled captures ship."""
    folder = pjoin(path, f"images_{factor}")
    os.makedirs(folder)
    for name in sorted(os.listdir(pjoin(path, "images"))):
        image = Image.open(pjoin(path, "images", name))
        image.resize((image.width // factor, image.height // factor)).save(
            pjoin(folder, name.replace(".png", ".jpg")), quality=quality)


@pytest.mark.parametrize("factor", [None, 2, 4])
def test_llff_capture_loads_as_in_hive_tpu(tmp_path, factor):
    path = make_llff_capture(tmp_path / "llff")
    _add_jpeg_level(path, 2)
    want, got = jax_llff.LLFFDataset(path, factor), llff.LLFFDataset(path, factor)
    assert got.image_folder == want.image_folder and got.image_filenames == want.image_filenames
    for name in ("hwf", "bounds", "cam_to_world", "camera_matrix"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.get_trajectory().values, want.get_trajectory().values)
    assert got.num_images == want.num_images == 9
    for every in (8, 3):
        assert got.train_test_split(every) == want.train_test_split(every)
    for index in (0, 5):
        image = got.get_image(index)
        assert image.dtype == np.uint8
        np.testing.assert_array_equal(image, want.get_image(index))


def test_llff_pose_count_mismatch_raises(tmp_path):
    path = make_llff_capture(tmp_path / "llff", num_images=3)
    os.remove(pjoin(path, "images", "image002.png"))
    for package in (jax_llff, llff):
        with pytest.raises(RuntimeError, match="pose count"):
            package.LLFFDataset(path)


@pytest.mark.parametrize("scale", [1, 2])
def test_hypernerf_capture_loads_as_in_hive_tpu(tmp_path, scale):
    path = make_hypernerf_capture(tmp_path / "hn")
    if scale == 1:
        os.rename(pjoin(path, "rgb", "2x"), pjoin(path, "rgb", "1x"))
    with open(pjoin(path, "metadata.json"), "w") as fh:
        fh.write('{"000000": {"warp_id": 0}}')
    want = jax_hypernerf.HyperNeRFDataset(path, image_scale=scale)
    got = hypernerf.HyperNeRFDataset(path, image_scale=scale)
    assert got.all_ids == want.all_ids and got.metadata == want.metadata
    assert got.train_val_split() == want.train_val_split()
    assert (got.near, got.far, got.scene_scale) == (want.near, want.far, want.scene_scale)
    np.testing.assert_array_equal(got.scene_center, want.scene_center)
    for item_id in got.all_ids:
        g, w = got.cameras[item_id], want.cameras[item_id]
        assert (g.focal_length, g.image_size, g.skew) == (w.focal_length, w.image_size, w.skew)
        for name in ("camera_matrix", "world_to_camera", "principal_point", "radial_distortion"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert got.get_image_path(item_id) == want.get_image_path(item_id)
        np.testing.assert_array_equal(got.get_image(item_id), want.get_image(item_id))
    for ids in (None, got.val_ids):
        np.testing.assert_array_equal(got.get_trajectory(ids).values,
                                      want.get_trajectory(ids).values)


def _quad_and_triangle():
    """A quad textured with blurred noise (SIFT finds features on its
    renders) and a small textured triangle in front of it."""
    import cv2

    rng = np.random.default_rng(8)
    noise = ((rng.uniform(0, 1, (96, 96)) > 0.5) * 255).astype(np.uint8)
    texture = np.repeat(cv2.GaussianBlur(noise, (5, 5), 1.0)[..., None], 3, axis=2)
    quad = dict(vertices=np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float32),
                faces=np.array([[0, 1, 2], [0, 2, 3]]),
                uv=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), texture=texture)
    tri = dict(vertices=np.array([[-0.3, -0.2, 1.5], [0.4, -0.1, 1.6], [0, 0.4, 1.4]],
                                 np.float32),
               faces=np.array([[0, 1, 2]]), uv=rng.uniform(0, 1, (3, 2)).astype(np.float32),
               texture=rng.integers(0, 256, (8, 8, 3)).astype(np.uint8))
    return quad, tri


def _photograph(path, mesh):
    """Replace the capture's photos by hive_tpu's renders of ``mesh`` moved
    by two pixels, so that MIFD finds matches a few pixels apart."""
    from hive_tpu.geometric import get_pose_components
    from hive_tpu.meshing.render import render_mesh

    capture = jax_llff.LLFFDataset(path)
    height, width = int(capture.hwf[0]), int(capture.hwf[1])
    for view, name in enumerate(capture.image_filenames):
        R, t = get_pose_components(np.linalg.inv(capture.cam_to_world[view]))
        image, _ = render_mesh(mesh, capture.camera_matrix, R, t, width, height)
        Image.fromarray(np.roll(image, (2, -1), axis=(0, 1))).save(
            pjoin(capture.image_folder, name))


def _assert_results_close(got, want):
    assert set(got) == set(want)
    for metric in ("ssim", "psnr", "lpips", "mifd"):
        g, w = np.asarray(got[metric] + [got["mean"][metric]]), np.asarray(
            want[metric] + [want["mean"][metric]])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        g, w = g[~np.isnan(w)], w[~np.isnan(w)]
        tolerance = {"ssim": 1e-9, "psnr": 0.0, "lpips": 1e-4 * np.abs(w),
                     "mifd": MIFD_RTOL * np.abs(w)}[metric]
        assert (np.abs(g - w) <= tolerance).all(), (metric, g, w)


@pytest.fixture
def no_lpips_weights(tmp_path, monkeypatch):
    monkeypatch.setattr(metrics, "_lpips_models", {})
    monkeypatch.setattr(jax_metrics, "_lpips_model", None)
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "weights"))
    return tmp_path / "weights"


def test_evaluate_renders_matches_hive_tpu(tmp_path, no_lpips_weights):
    """A scene (a textured quad behind a textured triangle) and a
    single mesh, held-out views of a 9-image capture, without LPIPS weights
    (NaN, labelled) in both packages."""
    torch.set_num_threads(1)
    path = make_llff_capture(tmp_path / "llff")
    quad, tri = _quad_and_triangle()
    _photograph(path, JaxMesh(**quad))
    want_llff, got_llff = jax_llff.LLFFDataset(path), llff.LLFFDataset(path)
    jax_scene, scene = JaxScene(), Scene()
    for name, arrays in (("quad", quad), ("tri", tri)):
        jax_scene.add_geometry(JaxMesh(**arrays), node_name=name)
        scene.add_geometry(TriangleMesh(**arrays), node_name=name)
    _, test = got_llff.train_test_split()

    want = jax_llff.evaluate_renders(jax_scene, want_llff, test, str(tmp_path / "ref"))
    got = llff.evaluate_renders(scene, got_llff, test, str(tmp_path / "port"), device="cpu")
    _assert_results_close(got, want)
    assert np.isfinite(got["mifd"]).all() and np.isfinite(got["ssim"]).all()
    assert got["skipped"] == want["skipped"] == {"lpips": "skipped: weights absent"}
    for view in test:
        name = f"render_{view:03d}.png"
        np.testing.assert_array_equal(load_image(str(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "ref" / name)))

    want = jax_llff.evaluate_renders(JaxMesh(**quad), want_llff, [1])
    got = llff.evaluate_renders(TriangleMesh(**quad), got_llff, [1], device="cpu")
    _assert_results_close(got, want)


def test_evaluate_renders_with_lpips_weights_matches_hive_tpu(tmp_path, no_lpips_weights):
    from hive_tpu_torch.models import lpips as lpips_model

    no_lpips_weights.mkdir()
    np.savez(no_lpips_weights / lpips_model.WEIGHTS_FILENAME, **lpips_model.check_params(5))
    path = make_llff_capture(tmp_path / "llff", num_images=2)
    quad, _ = _quad_and_triangle()
    _photograph(path, JaxMesh(**quad))
    want = jax_llff.evaluate_renders(JaxMesh(**quad), jax_llff.LLFFDataset(path), [0, 1])
    got = llff.evaluate_renders(TriangleMesh(**quad), llff.LLFFDataset(path), [0, 1],
                                device="cpu")
    assert "skipped" not in got and np.isfinite(got["lpips"]).all()
    assert np.isfinite(got["mifd"]).all()
    _assert_results_close(got, want)
