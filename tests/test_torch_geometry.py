"""hive_tpu_torch host and geometry modules against hive_tpu on the same inputs:
core transforms, Trajectory, CameraMatrix, the PNG decoder (against Pillow),
dilate_mask, and the HIVE dataset read path."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from hive_tpu import geometric as jgeo
from hive_tpu.core import transforms as JT
from hive_tpu.image_processing import dilate_mask as jax_dilate
from hive_tpu.io import HiveDataset as JaxHiveDataset
from hive_tpu.options import MaskDilationOptions as JaxDilation
from hive_tpu_torch import geometric as tgeo
from hive_tpu_torch.core import transforms as TT
from hive_tpu_torch.image_processing import dilate_mask
from hive_tpu_torch.io import (HiveDataset, decode_png, load_raw_float32_image,
                               save_raw_float32_image)
from hive_tpu_torch.options import MaskDilationOptions
from tests.helpers import make_synthetic_hive_dataset

# fp32 on both sides: relative 1e-6 (a few ulp; XLA fuses multiply-adds the
# port evaluates as two roundings), absolute 1e-6 where a result cancels to ~0.
RTOL, ATOL = 1e-6, 1e-6


def _batch(seed=0, n=64):
    rng = np.random.default_rng(seed)
    q = Rotation.random(n, random_state=np.random.RandomState(seed)).as_quat().astype(np.float32)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return rng, q, t


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["quat_normalize", "quat_conjugate", "quat_to_matrix"])
def test_unary_quaternion_ops(name):
    _, q, _ = _batch()
    q = q * 1.7  # non-unit input for normalize
    _close(getattr(TT, name)(torch.as_tensor(q)), getattr(JT, name)(jnp.asarray(q)))


def test_quat_multiply_and_rotate():
    rng, q1, _ = _batch(1)
    _, q2, v = _batch(2)
    _close(TT.quat_multiply(torch.as_tensor(q1), torch.as_tensor(q2)),
           JT.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)))
    _close(TT.quat_rotate(torch.as_tensor(q1), torch.as_tensor(v)),
           JT.quat_rotate(jnp.asarray(q1), jnp.asarray(v)))


def test_matrix_to_quat_and_slerp():
    _, q0, _ = _batch(3)
    _, q1, _ = _batch(4)
    m = Rotation.from_quat(q0).as_matrix().astype(np.float32)
    _close(TT.matrix_to_quat(torch.as_tensor(m)), JT.matrix_to_quat(jnp.asarray(m)))
    t = np.linspace(0, 1, len(q0), dtype=np.float32)[:, None]
    _close(TT.quat_slerp(torch.as_tensor(q0), torch.as_tensor(q1), torch.as_tensor(t)),
           JT.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))


def test_se3_pose_algebra():
    _, q, t = _batch(5)
    _, q2, t2 = _batch(6)
    a = np.concatenate([q, t], -1)
    b = np.concatenate([q2, t2], -1)
    ta, tb, ja, jb = torch.as_tensor(a), torch.as_tensor(b), jnp.asarray(a), jnp.asarray(b)
    _close(TT.pose_to_matrix(ta), JT.pose_to_matrix(ja))
    m = np.array(JT.pose_to_matrix(ja))
    _close(TT.matrix_to_pose(torch.as_tensor(m)), JT.matrix_to_pose(jnp.asarray(m)))
    _close(TT.pose_inverse(ta), JT.pose_inverse(ja))
    _close(TT.pose_compose(ta, tb), JT.pose_compose(ja, jb))
    _close(TT.pose_relative(ta, tb), JT.pose_relative(ja, jb))


def test_projection_and_unprojection():
    rng, q, t = _batch(7, n=1)
    R = Rotation.from_quat(q[0]).as_matrix().astype(np.float32)
    K = np.array([[500.0, 0, 320.0], [0, 510.0, 240.0], [0, 0, 1]], np.float32)
    pts = (rng.normal(size=(256, 3)) + [0, 0, 5]).astype(np.float32)
    uv_t, d_t = TT.project_points(*(torch.as_tensor(x) for x in (pts, K, R, t[0])))
    uv_j, d_j = JT.project_points(*(jnp.asarray(x) for x in (pts, K, R, t[0])))
    _close(uv_t, uv_j, rtol=1e-5)
    _close(d_t, d_j)

    depth = rng.uniform(0.5, 4.0, size=(12, 16)).astype(np.float32)
    args = [torch.as_tensor(x) for x in (depth, K, R, t[0])]
    _close(TT.unproject_depth_map(*args, height=12, width=16),
           JT.unproject_depth_map(*(jnp.asarray(x) for x in (depth, K, R, t[0])),
                                  height=12, width=16), rtol=1e-5, atol=1e-5)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = R, t[0]
    _close(TT.view_frustum_points(torch.as_tensor(depth), torch.as_tensor(K),
                                  torch.as_tensor(pose)),
           JT.view_frustum_points(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(pose)),
           rtol=1e-5)


def test_trajectory_matches_jax_package():
    _, q, t = _batch(8, n=10)
    values = np.concatenate([q, t], -1).astype(np.float32)
    ours, ref = tgeo.Trajectory(values.copy()), jgeo.Trajectory(values.copy())
    for method in ("to_homogenous_transforms",):
        np.testing.assert_array_equal(getattr(ours, method)(), getattr(ref, method)())
    for method in ("inverse", "normalise", "normalise_position"):
        np.testing.assert_array_equal(getattr(ours, method)().values,
                                      getattr(ref, method)().values)
    np.testing.assert_array_equal(ours.calculate_rpe(ours.inverse())[0],
                                  ref.calculate_rpe(ref.inverse())[0])
    assert isinstance(ours.array(), torch.Tensor)
    np.testing.assert_array_equal(ours.array().numpy(), np.asarray(ref.array()))


def test_quaternion_class_and_camera_matrix():
    _, q, t = _batch(9, n=8)
    ours, ref = tgeo.Quaternion(q.T.copy()), jgeo.Quaternion(jnp.asarray(q.T))
    _close((ours * ours.conjugate()).values, (ref * ref.conjugate()).values)
    _close(ours.apply(t.T.copy()), ref.apply(jnp.asarray(t.T)))

    cam = tgeo.CameraMatrix(fx=525.0, fy=520.0, cx=319.5, cy=239.5, width=640, height=480)
    jcam = jgeo.CameraMatrix(fx=525.0, fy=520.0, cx=319.5, cy=239.5, width=640, height=480)
    np.testing.assert_array_equal(cam.matrix, jcam.matrix)
    np.testing.assert_array_equal(cam.scale((240, 320)).matrix, jcam.scale((240, 320)).matrix)
    assert cam.fov_y == jcam.fov_y


def _pil_png(array, mode=None, **save):
    buf = io.BytesIO()
    Image.fromarray(array, mode=mode).save(buf, format="PNG", **save)
    return buf.getvalue()


def _pil_load(blob):
    """What hive_tpu's ImageFolderDataset returns for a PNG."""
    with Image.open(io.BytesIO(blob)) as image:
        if image.mode == "I":
            image = image.convert("I;16")
        elif image.mode not in ("L", "I;16"):
            image = image.convert("RGB")
        return np.asarray(image)


_PNG_CASES = {
    "gray8": (lambda r: r.integers(0, 256, (37, 53), dtype=np.uint8), None),
    "gray16": (lambda r: r.integers(0, 65536, (37, 53)).astype(np.uint16), None),
    "rgb": (lambda r: r.integers(0, 256, (37, 53, 3), dtype=np.uint8), None),
    "rgba": (lambda r: r.integers(0, 256, (37, 53, 4), dtype=np.uint8), None),
    "gray_alpha": (lambda r: r.integers(0, 256, (37, 53, 2), dtype=np.uint8), "LA"),
    "smooth_rgb": (lambda r: np.stack([*np.meshgrid(np.arange(53), np.arange(37)),
                                       np.full((37, 53), 7)], -1).astype(np.uint8), None),
}


@pytest.mark.parametrize("case", sorted(_PNG_CASES))
@pytest.mark.parametrize("save", [{}, {"optimize": True}, {"compress_level": 1}],
                         ids=["default", "optimize", "level1"])
def test_png_decoder_matches_pillow(case, save):
    make, mode = _PNG_CASES[case]
    blob = _pil_png(make(np.random.default_rng(0)), mode=mode, **save)
    want, got = _pil_load(blob), decode_png(blob)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iterations,size", [(0, 3), (1, 3), (10, 3), (3, 5), (2, 2)])
def test_dilate_mask_matches_jax_package(iterations, size):
    rng = np.random.default_rng(iterations + size)
    mask = (rng.random((61, 83)) < 0.02).astype(np.uint8) * rng.integers(1, 4, (61, 83))
    want = jax_dilate(mask.astype(np.uint8), JaxDilation(num_iterations=iterations,
                                                         filter_size=size))
    got = dilate_mask(mask.astype(np.uint8), MaskDilationOptions(num_iterations=iterations,
                                                                 filter_size=size))
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)


def test_raw_float32_round_trip(tmp_path):
    image = np.random.default_rng(1).normal(size=(7, 9, 2)).astype(np.float32)
    save_raw_float32_image(tmp_path / "x.raw", image)
    np.testing.assert_array_equal(load_raw_float32_image(tmp_path / "x.raw"), image)


def test_hive_dataset_reads_like_jax_package(tmp_path):
    path = make_synthetic_hive_dataset(tmp_path / "ds", num_frames=5, width=64, height=48)
    ours, ref = HiveDataset(path), JaxHiveDataset(path)
    assert ours.num_frames == ref.num_frames and ours.metadata == ours.metadata
    np.testing.assert_array_equal(ours.camera_matrix, ref.camera_matrix)
    np.testing.assert_array_equal(ours.camera_trajectory.values, ref.camera_trajectory.values)
    for i in (0, 4):
        for name in ("rgb_dataset", "depth_dataset", "mask_dataset"):
            got, want = getattr(ours, name)[i], getattr(ref, name)[i]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for threshold in (0.0, 0.3, 1.0):
        assert (ours.select_key_frames(threshold, frame_step=1)
                == ref.select_key_frames(threshold, frame_step=1))
