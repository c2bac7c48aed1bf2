"""hive_tpu_torch's rasteriser, image metrics and depth helpers against
hive_tpu's on the CPU, on the same numpy inputs (64 x 48 images, a few
hundred triangles). The card against the CPU is
tests/test_torch_import.py::test_render_and_batch_metrics_on_card_equal_cpu
(that file imports no JAX, so it runs on the card's machine).

Tolerances, each with its reason:

- render: the uint8 image, the coverage, the float32 depth and the raw
  float32 attribute image equal (0 pixels differ), here and at 640 x 480
  on edge-on slivers: the port evaluates every pixel the reference's
  rounding can put inside a face (a widened box, or a band along a
  near-line face) with the reference's float32 operations and XLA:CPU's
  contractions (``render.py``'s docstring);
- ``psnr`` equal (the same float64 numpy); host ``ssim`` within 1e-9
  (cv2's float64 ``filter2D`` may take its DFT route for the 11x11 window,
  the port correlates separably);
- ``batch_ssim_psnr`` within 1e-5 of SSIM and 1e-4 dB of PSNR of
  hive_tpu's (float32 convolutions and means summed in other orders);
- ``median_filter``, ``get_bins``, ``bin_depth`` equal;
- ``mifd`` within MIFD_RTOL of hive_tpu's: the port's SIFT keeps
  92-97% of OpenCV's keypoints to the bit and all within 0.5 px, and its
  exact k-NN agrees with FLANN on 95% of queries (ROADMAP Queue 3, the
  feature layer's differences by design);
- ``lpips`` within 1e-4 relative of hive_tpu's with the same check weights
  (float32 convolutions of XLA and of torch).
"""

import types

import numpy as np
import pytest
import torch

from hive_tpu import image_processing as jax_image_processing
from hive_tpu import io as jax_io
from hive_tpu import metrics as jax_metrics
from hive_tpu.geometric import Trajectory as JaxTrajectory
from hive_tpu.meshing import render as jax_render
from hive_tpu.meshing.mesh import Scene as JaxScene
from hive_tpu.meshing.mesh import TriangleMesh as JaxMesh
from hive_tpu_torch import image_processing, io, metrics
from hive_tpu_torch.geometric import Trajectory
from hive_tpu_torch.meshing import render
from hive_tpu_torch.meshing.mesh import Scene, TriangleMesh

WIDTH, HEIGHT = 64, 48
K = np.array([[60.3, 0.0, 31.7], [0.0, 59.1, 23.2], [0.0, 0.0, 1.0]])
# See the module docstring.
MIFD_RTOL = 0.01


def _pose(seed):
    rng = np.random.default_rng(100 + seed)
    q = np.linalg.qr(np.eye(3) + 0.1 * rng.normal(size=(3, 3)))[0]
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q, rng.normal(0, 0.1, (3, 1))


def _triangles(seed, num_faces=300, textured=False):
    """Small triangles scattered 1-4 m in front of the camera, overlapping."""
    rng = np.random.default_rng(seed)
    centres = np.stack([rng.uniform(-1.5, 1.5, num_faces), rng.uniform(-1, 1, num_faces),
                        rng.uniform(1.0, 4.0, num_faces)], 1)
    vertices = (centres[:, None] + rng.normal(0, 0.15, (num_faces, 3, 3))).reshape(-1, 3)
    arrays = dict(vertices=vertices.astype(np.float32),
                  faces=np.arange(3 * num_faces).reshape(num_faces, 3))
    if textured:
        arrays.update(uv=rng.uniform(0, 1, (3 * num_faces, 2)).astype(np.float32),
                      texture=rng.integers(0, 256, (16, 24, 3)).astype(np.uint8))
    else:
        arrays.update(vertex_colors=rng.integers(0, 256, (3 * num_faces, 3)).astype(np.uint8))
    return arrays


def _quad(z, half, color):
    vertices = np.array([[-half, -half, z], [half, -half, z], [half, half, z],
                         [-half, half, z]], np.float32)
    return dict(vertices=vertices, faces=np.array([[0, 1, 2], [0, 2, 3]]),
                vertex_colors=np.tile(np.asarray(color, np.uint8), (4, 1)))


def _merge(*parts):
    offsets = np.cumsum([0] + [len(p["vertices"]) for p in parts[:-1]])
    return dict(vertices=np.concatenate([p["vertices"] for p in parts]),
                faces=np.concatenate([p["faces"] + o for p, o in zip(parts, offsets)]),
                vertex_colors=np.concatenate([p["vertex_colors"] for p in parts]))


def _assert_renders_equal(arrays, R=np.eye(3), t=np.zeros((3, 1)), min_covered=1):
    want_image, want_depth = jax_render.render_mesh(JaxMesh(**arrays), K, R, t, WIDTH, HEIGHT)
    got_image, got_depth = render.render_mesh(TriangleMesh(**arrays), K, R, t, WIDTH, HEIGHT,
                                              device="cpu")
    assert got_image.dtype == np.uint8 and got_depth.dtype == np.float32
    assert (want_depth > 0).sum() >= min_covered
    np.testing.assert_array_equal(got_depth > 0, want_depth > 0)
    np.testing.assert_array_equal(got_image, want_image)
    np.testing.assert_array_equal(got_depth, want_depth)
    return got_image, got_depth


@pytest.mark.parametrize("seed", range(4))
def test_vertex_coloured_triangles_render_as_hive_tpu(seed):
    R, t = _pose(seed)
    _assert_renders_equal(_triangles(seed), R, t, min_covered=1000)


@pytest.mark.parametrize("seed", range(2))
def test_textured_triangles_render_as_hive_tpu(seed):
    R, t = _pose(seed)
    _assert_renders_equal(_triangles(seed, textured=True), R, t, min_covered=1000)


def test_raw_attributes_and_depth_equal_the_scan():
    """The float32 attribute image before the uint8 cast, against the
    reference's scan itself (faces padded to its chunk)."""
    import jax.numpy as jnp

    arrays = _triangles(7)
    R, t = _pose(7)
    faces = np.concatenate([arrays["faces"], np.zeros((20, 3), np.int64)]).astype(np.int32)
    colours = arrays["vertex_colors"].astype(np.float32)
    want_attr, want_depth = (np.asarray(x) for x in jax_render._rasterize_device(
        jnp.asarray(arrays["vertices"]), jnp.asarray(faces), jnp.asarray(colours),
        jnp.asarray(K, jnp.float32), jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32),
        height=HEIGHT, width=WIDTH, chunk_size=64))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    got_attr, got_depth, candidates = render._rasterize(
        f32(arrays["vertices"]), torch.as_tensor(arrays["faces"]), f32(colours), f32(K),
        f32(R), f32(t), HEIGHT, WIDTH)
    np.testing.assert_array_equal(got_attr.numpy(), want_attr)
    np.testing.assert_array_equal(got_depth.numpy(), want_depth)
    # The footprint design: far fewer candidates than pixels x triangles.
    assert 0 < candidates < len(faces) * HEIGHT * WIDTH // 20


def test_ties_go_to_the_lower_face_index():
    """Two copies of a quad at one depth: the first drawn wins everywhere,
    as the reference's strict ``>`` z-test keeps it; a nearer quad still
    wins over both."""
    red, blue = _quad(2.0, 0.4, (255, 0, 0)), _quad(2.0, 0.4, (0, 0, 255))
    image, _ = _assert_renders_equal(_merge(red, blue), min_covered=100)
    assert image[HEIGHT // 2, WIDTH // 2].tolist() == [255, 0, 0]
    image, _ = _assert_renders_equal(_merge(blue, red), min_covered=100)
    assert image[HEIGHT // 2, WIDTH // 2].tolist() == [0, 0, 255]
    image, depth = _assert_renders_equal(_merge(red, _quad(1.0, 0.2, (0, 255, 0)), blue))
    assert image[HEIGHT // 2, WIDTH // 2].tolist() == [0, 255, 0]
    assert depth[HEIGHT // 2, WIDTH // 2] == pytest.approx(1.0, abs=1e-6)


def test_behind_and_straddling_the_camera_are_not_drawn():
    behind = _quad(-2.0, 1.0, (255, 255, 255))
    straddle = dict(vertices=np.array([[0, 0, 1.5], [0.5, 0, -1.0], [0, 0.5, 2.0]], np.float32),
                    faces=np.array([[0, 1, 2]]),
                    vertex_colors=np.full((3, 3), 200, np.uint8))
    near_plane = dict(vertices=np.array([[-1e-3, -1e-3, 1e-5], [1e-3, -1e-3, 1e-5],
                                         [0, 1e-3, 1e-5]], np.float32),
                      faces=np.array([[0, 1, 2]]), vertex_colors=np.full((3, 3), 90, np.uint8))
    _, depth = _assert_renders_equal(_merge(behind, straddle), min_covered=0)
    assert (depth == 0).all()
    # Just in front of the camera plane (1e-5 m, screen coordinates ~6e3 px
    # across): the whole frame is covered, by the same pixels as hive_tpu.
    _assert_renders_equal(near_plane, min_covered=HEIGHT * WIDTH)


def test_empty_mesh_renders_black():
    image, depth = render.render_mesh(TriangleMesh(), K, np.eye(3), np.zeros((3, 1)), WIDTH,
                                      HEIGHT, device="cpu")
    assert image.shape == (HEIGHT, WIDTH, 3) and not image.any() and not depth.any()


def test_degenerate_faces_draw_nothing_and_slivers_match():
    rng = np.random.default_rng(3)
    vertices = np.concatenate([
        np.array([[0, 0, 2], [0.5, 0.5, 2], [1.0, 1.0, 2]], np.float32),      # collinear
        np.array([[-0.5, -0.3, 2], [0.5, -0.3, 2], [0.5, -0.3 + 1e-6, 2]], np.float32),
        rng.uniform(-1, 1, (30, 3)).astype(np.float32) + [0, 0, 3]])
    faces = np.array([[0, 1, 2], [0, 0, 1], [2, 2, 2], [3, 4, 5]]
                     + [[6 + i, 7 + i, 8 + i] for i in range(0, 27, 3)])
    colours = rng.integers(0, 256, (len(vertices), 3)).astype(np.uint8)
    _assert_renders_equal(dict(vertices=vertices, faces=faces, vertex_colors=colours))
    _, depth = _assert_renders_equal(dict(vertices=vertices, faces=faces[:3],
                                          vertex_colors=colours), min_covered=0)
    assert not depth.any()


@pytest.mark.parametrize("sign", [1, -1])
def test_edge_on_slivers_at_vga_match_the_scan(sign):
    """Faces in the planes X = +-Y, which pass through the camera centre:
    each projects to a near-line (heights of float32 rounding) on the
    diagonal through pixel centres. The reference's rounding puts pixel
    centres on that line inside the face far beyond its bounding box; the
    port's band along the line evaluates them, so the scan's raw outputs
    are equal at 640 x 480 (a box widened by one pixel missed about half
    of the 480 diagonal pixels here)."""
    import jax.numpy as jnp

    width, height = 640, 480
    k = np.array([[525.0, 0.0, 320.0], [0.0, 525.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    rng = np.random.default_rng(3 + sign)
    num_faces = 128
    x = rng.uniform(-0.8, 0.8, (num_faces, 1)) + rng.uniform(-0.02, 0.02, (num_faces, 3))
    z = rng.uniform(1, 4, (num_faces, 1)) + rng.uniform(-0.02, 0.02, (num_faces, 3))
    vertices = np.stack([x, sign * x, z], -1).reshape(-1, 3).astype(np.float32)
    faces = np.arange(len(vertices)).reshape(-1, 3)
    colours = rng.integers(0, 256, (len(vertices), 3)).astype(np.float32)
    want_attr, want_depth = (np.asarray(v) for v in jax_render._rasterize_device(
        jnp.asarray(vertices), jnp.asarray(faces.astype(np.int32)), jnp.asarray(colours),
        jnp.asarray(k), jnp.eye(3, dtype=jnp.float32), jnp.zeros((3, 1), jnp.float32),
        height=height, width=width, chunk_size=64))
    got_attr, got_depth, candidates = render._rasterize(
        torch.as_tensor(vertices), torch.as_tensor(faces), torch.as_tensor(colours),
        torch.as_tensor(k), torch.eye(3), torch.zeros(3, 1), height, width)
    assert (want_depth > 0).sum() >= 400
    np.testing.assert_array_equal(got_depth.numpy(), want_depth)
    np.testing.assert_array_equal(got_attr.numpy(), want_attr)
    # A band of a few pixels across the frame per face, not the frame.
    assert candidates < num_faces * 8 * width


def test_a_big_grey_triangle_is_clipped_to_the_frame():
    """No colours, no texture: grey 180 (179 where the perspective division
    rounds below it, in both packages); a triangle far larger than the
    frame, seen at an angle."""
    arrays = dict(vertices=np.array([[-30, -20, 2.0], [40, -25, 6.0], [0, 40, 4.0]], np.float32),
                  faces=np.array([[0, 1, 2]]))
    image, _ = _assert_renders_equal(arrays, min_covered=HEIGHT * WIDTH)
    assert np.isin(image, [179, 180]).all()


def test_scene_composites_as_hive_tpu():
    parts = [_triangles(11, num_faces=120), _triangles(12, num_faces=120, textured=True)]
    jax_scene, scene = JaxScene(), Scene()
    for i, arrays in enumerate(parts):
        jax_scene.add_geometry(JaxMesh(**arrays), node_name=f"m{i}")
        scene.add_geometry(TriangleMesh(**arrays), node_name=f"m{i}")
    scene.add_geometry(TriangleMesh(), node_name="empty")
    R, t = _pose(11)
    want = jax_render.render_scene(jax_scene, K, R, t, WIDTH, HEIGHT)
    got = render.render_scene(scene, K, R, t, WIDTH, HEIGHT, device="cpu")
    assert (want[1] > 0).sum() > 500
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_texture_sampling_equals_numpy():
    rng = np.random.default_rng(5)
    texture = rng.integers(0, 256, (13, 17, 4)).astype(np.uint8)
    uv = rng.uniform(-0.1, 1.1, (HEIGHT, WIDTH, 2)).astype(np.float32)
    uv[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    covered = rng.random((HEIGHT, WIDTH)) > 0.3
    want = jax_render._sample_texture_bilinear(texture, uv, covered)
    got = render._sample_texture_bilinear(torch.from_numpy(texture), torch.from_numpy(uv),
                                          torch.from_numpy(covered))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Metrics.
# ---------------------------------------------------------------------------

def _image_pairs(seed, shape=(3, HEIGHT, WIDTH, 3)):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)
    return a, b


def test_psnr_and_ssim_match_hive_tpu():
    a, b = _image_pairs(0)
    for x, y in [(a[0], b[0]), (a[1], a[1]), (a[2, ..., 0], b[2, ..., 0]), (b[1], a[2])]:
        assert metrics.psnr(x, y) == jax_metrics.psnr(x, y)
        assert abs(metrics.ssim(x, y) - jax_metrics.ssim(x, y)) <= 1e-9
    assert metrics.psnr(a[1], a[1]) == float("inf")
    assert metrics.ssim(a[1], a[1]) == pytest.approx(1.0)


def test_batch_ssim_psnr_matches_hive_tpu_and_the_host():
    a, b = _image_pairs(1)
    want_ssim, want_psnr = jax_metrics.batch_ssim_psnr(a, b)
    got_ssim, got_psnr = metrics.batch_ssim_psnr(a, b, device="cpu")
    assert got_ssim.dtype == np.float32 and got_psnr.dtype == np.float32
    np.testing.assert_allclose(got_ssim, want_ssim, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_psnr, want_psnr, atol=1e-4, rtol=0)
    for i in range(len(a)):
        assert abs(got_ssim[i] - metrics.ssim(a[i], b[i])) <= 1e-5


def _textured(seed, shape=(96, 128)):
    """Blurred binary noise (SIFT finds features on it) and a copy shifted
    by a sub-pixel translation."""
    import cv2

    rng = np.random.default_rng(seed)
    image = cv2.GaussianBlur(((rng.uniform(0, 255, shape) > 127) * 255).astype(np.uint8),
                             (5, 5), 1.0)
    shift = np.float32([[1, 0, 2.3], [0, 1, -1.7]])
    return image, cv2.warpAffine(image, shift, shape[::-1])


def test_mifd_matches_hive_tpu():
    torch.set_num_threads(1)
    grey, moved = _textured(2)
    want = jax_metrics.mifd(grey, moved)
    got = metrics.mifd(grey, moved, device="cpu")
    assert want > 1.0
    assert abs(got - want) <= MIFD_RTOL * want
    assert metrics.mifd(grey, grey, device="cpu") == jax_metrics.mifd(grey, grey) == 0.0
    flat = np.full((64, 64), 90, np.uint8)
    assert np.isnan(metrics.mifd(flat, grey[:64, :64], device="cpu"))
    assert np.isnan(jax_metrics.mifd(flat, grey[:64, :64]))


def test_depth_errors_match_hive_tpu():
    rng = np.random.default_rng(4)
    target = rng.uniform(0, 5, (HEIGHT, WIDTH))
    target[rng.random(target.shape) < 0.2] = 0
    pred = target + rng.normal(0, 0.1, target.shape)
    mask = rng.random(target.shape) < 0.5
    for fn in ("depth_mae", "depth_rmse"):
        assert getattr(metrics, fn)(pred, target) == getattr(jax_metrics, fn)(pred, target)
        assert (getattr(metrics, fn)(pred, target, mask)
                == getattr(jax_metrics, fn)(pred, target, mask))


@pytest.fixture
def fresh_lpips(monkeypatch, tmp_path):
    """Both packages' LPIPS caches cleared, ``$WEIGHTS_PATH`` an empty
    folder."""
    monkeypatch.setattr(metrics, "_lpips_models", {})
    monkeypatch.setattr(jax_metrics, "_lpips_model", None)
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    return tmp_path


def test_lpips_with_check_weights_matches_hive_tpu(fresh_lpips):
    from hive_tpu_torch.models import lpips as lpips_model

    np.savez(fresh_lpips / lpips_model.WEIGHTS_FILENAME, **lpips_model.check_params(3))
    a, b = _image_pairs(6, shape=(2, 64, 80, 3))
    got = metrics.lpips(a[0], b[0], device="cpu")
    want = jax_metrics.lpips(a[0], b[0])
    assert got > 0 and abs(got - want) <= 1e-4 * want
    assert metrics.lpips_available("cpu") and metrics.lpips(a[1], a[1], device="cpu") == 0.0


def test_lpips_without_weights_is_nan_and_labelled(fresh_lpips, monkeypatch):
    """Without ``lpips_alex.npz`` both give NaN and label the column. By
    design the port never falls back to the pip ``lpips`` package (a package
    of finished models, absent on the card's machine): with one importable,
    hive_tpu scores with it and the port still gives NaN."""
    a, b = _image_pairs(7, shape=(2, 32, 32, 3))
    assert np.isnan(metrics.lpips(a[0], b[0], device="cpu"))
    assert np.isnan(jax_metrics.lpips(a[0], b[0]))
    table = {"ssim": [0.5], "lpips": [float("nan")] * 2}
    assert metrics.metric_skip_notes(table, "cpu") == jax_metrics.metric_skip_notes(table) == {
        "lpips": "skipped: weights absent"}

    class FakeLPIPS(torch.nn.Module):
        def forward(self, x, y):
            return (x - y).abs().mean().reshape(1, 1, 1, 1)

    monkeypatch.setitem(__import__("sys").modules, "lpips",
                        types.SimpleNamespace(LPIPS=lambda net: FakeLPIPS()))
    monkeypatch.setattr(metrics, "_lpips_models", {})
    monkeypatch.setattr(jax_metrics, "_lpips_model", None)
    assert np.isfinite(jax_metrics.lpips(a[0], b[0]))
    assert np.isnan(metrics.lpips(a[0], b[0], device="cpu"))


def test_lpips_scores_on_the_device_asked_for(fresh_lpips, monkeypatch):
    """One scorer per device: a CPU call after a call on another device
    builds and uses a scorer on the CPU (a stand-in scorer records where it
    was built; ``get_device`` passes any device through)."""
    from hive_tpu_torch.models import lpips as lpips_model

    built = []

    class Scorer:
        def __init__(self, device):
            self.device = device
            built.append(device)

        def __call__(self, a, b):
            return float(self.device.type == "cpu")

    monkeypatch.setattr(metrics, "get_device", torch.device)
    monkeypatch.setattr(lpips_model, "load_scorer", lambda device: Scorer(device))
    a, b = _image_pairs(8, shape=(2, 16, 16, 3))
    assert metrics.lpips(a[0], b[0], device="cuda:1") == 0.0
    assert metrics.lpips(a[0], b[0], device="cpu") == 1.0
    assert metrics.lpips_available("cpu") and metrics.lpips_available("cuda:1")
    assert metrics.lpips(a[1], b[1], device="cuda:1") == 0.0
    assert built == [torch.device("cuda", 1), torch.device("cpu")]


@pytest.mark.parametrize("table", [{"ssim": [0.5, 0.6], "lpips": [float("nan")] * 3},
                                   {"lpips": [0.1, float("nan")]},
                                   {"depth_mae": [float("nan")]}])
def test_metric_skip_notes_match_hive_tpu(fresh_lpips, monkeypatch, table):
    monkeypatch.setattr(jax_metrics, "_lpips_model", False)
    assert metrics.metric_skip_notes(table, "cpu") == jax_metrics.metric_skip_notes(table)
    assert not metrics.lpips_available("cpu")


# ---------------------------------------------------------------------------
# Depth filtering and binning, and the evaluation's dataset helpers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel_size", [3, 5, 7, 63])
def test_median_filter_matches_hive_tpu(kernel_size):
    rng = np.random.default_rng(kernel_size)
    depth = rng.uniform(0, 10, (HEIGHT, WIDTH)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0
    want = jax_image_processing.median_filter(depth, kernel_size)
    got = image_processing.median_filter(depth, kernel_size, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_median_filter_follows_numpy_dtypes():
    """float64 maps rescale in float64 and come back float32, as in numpy;
    a kernel wider than the map replicates its edges."""
    rng = np.random.default_rng(9)
    depth = rng.uniform(0.5, 4, (20, 30))
    for kernel_size in (7, 63):
        want = jax_image_processing.median_filter(depth, kernel_size)
        got = image_processing.median_filter(depth, kernel_size, device="cpu")
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_bins_and_binned_depth_match_hive_tpu():
    for args in [(0.0, 10.0, 128), (0.5, 4.0, 16)]:
        np.testing.assert_array_equal(image_processing.get_bins(*args),
                                      jax_image_processing.get_bins(*args))
    depth = np.concatenate([np.random.default_rng(1).uniform(0, 12, 200),
                            [0.0, 5.0, 10.0, 12.5]]).astype(np.float32).reshape(12, 17)
    for kwargs in [{}, dict(min_depth=0.5, max_depth=4.0, num_bins=16)]:
        want = jax_image_processing.bin_depth(depth, **kwargs)
        got = image_processing.bin_depth(depth, **kwargs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dataset_swaps_restore_as_in_hive_tpu():
    for package in (io, jax_io):
        dataset = types.SimpleNamespace(camera_matrix=np.eye(3), inpainted_rgb_dataset="rgb",
                                        inpainted_depth_dataset="depth")
        with package.temporary_camera_matrix(dataset, 2 * np.eye(3)):
            assert dataset.camera_matrix[0, 0] == 2
        assert dataset.camera_matrix[0, 0] == 1
        with pytest.raises(KeyError), package.disable_inpainted_data(dataset):
            assert dataset.inpainted_rgb_dataset is None
            assert dataset.inpainted_depth_dataset is None
            raise KeyError("restored even on an error")
        assert (dataset.inpainted_rgb_dataset, dataset.inpainted_depth_dataset) == ("rgb",
                                                                                  "depth")


def test_trajectory_plots_match_hive_tpu(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    rng = np.random.default_rng(2)
    values = np.concatenate([rng.normal(size=(12, 4)), np.cumsum(rng.normal(size=(12, 3)), 0)], 1)
    values[:, :4] /= np.linalg.norm(values[:, :4], axis=1, keepdims=True)
    other = values + np.concatenate([np.zeros((12, 4)), rng.normal(0, 0.1, (12, 3))], 1)
    for name, package in (("port", Trajectory), ("ref", JaxTrajectory)):
        package(values).plot(str(tmp_path / f"{name}_plot.png"))
        package(values).plot_comparison(package(other), str(tmp_path / f"{name}_cmp.png"))
    for kind in ("plot", "cmp"):
        assert ((tmp_path / f"port_{kind}.png").read_bytes()
                == (tmp_path / f"ref_{kind}.png").read_bytes())
    with pytest.raises(RuntimeError, match="lengths differ"):
        Trajectory(values).plot_comparison(Trajectory(values[:3]), str(tmp_path / "short.png"))
