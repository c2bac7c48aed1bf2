"""Isosurface extraction: the same block state, loaded into the port with
``load_state``, goes through both packages' extractors.

Faces and colours must be equal exactly, vertices within 1e-6 m. Normals:
99% of vertices within 1e-3 and every vertex within one step of the 8-bit
oct encoding (2/255 per component, doubled for the fold): XLA's CPU
``rsqrt`` is an approximation that rounds differently from ``torch.rsqrt``,
which can move a tet gradient's oct code by one step.
"""

import functools

import numpy as np
import pytest
import torch

from hive_tpu.ops.marching import extract_isosurface as jax_extract
from hive_tpu.ops.tsdf_sparse import SparseTSDFVolume as JaxSparseTSDFVolume
from hive_tpu_torch.ops import marching
from hive_tpu_torch.ops.marching import (check_blocked_colour_addressing,
                                         extract_isosurface)
from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume
from tests.test_tsdf import H, K, W, look_at_pose, render_sphere_depth

NORMAL_STEP = 4.0 / 255.0


@functools.lru_cache(maxsize=None)
def _jax_volume(dtype=None):
    """The reference volume, integrated once per dtype; tests only read it."""
    center = np.zeros(3)
    poses = np.stack([look_at_pose(eye, center) for eye in
                      [(0, 0, -2.0), (2.0, 0, 0), (0, 2.0, 0.01)]]).astype(np.float32)
    depths = np.stack([render_sphere_depth(center, 0.5, p) for p in poses])
    colors = np.random.default_rng(0).integers(0, 255, (3, H, W, 3)).astype(np.uint8)
    kw = {} if dtype is None else {"dtype": dtype}
    volume = JaxSparseTSDFVolume(np.array([[-0.9, 0.9]] * 3, np.float32),
                                 voxel_size=0.03, **kw)
    volume.integrate_frames(colors, depths, K, poses)
    return volume


def _assert_meshes_match(got, want):
    (v_p, f_p, c_p, n_p), (v_j, f_j, c_j, n_j) = got, want
    assert len(f_j) > 1000
    np.testing.assert_array_equal(f_p, f_j)
    np.testing.assert_array_equal(c_p, c_j)
    np.testing.assert_allclose(v_p, v_j, atol=1e-6, rtol=0)
    dn = np.abs(n_p - n_j).max(axis=1)
    assert (dn > 1e-3).mean() < 0.01
    assert dn.max() <= NORMAL_STEP


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_blocked_extraction_matches_on_shared_state(bf16):
    import jax.numpy as jnp

    ref = _jax_volume(jnp.bfloat16 if bf16 else None)
    ours = SparseTSDFVolume(ref.volume_bounds, voxel_size=ref.voxel_size, device="cpu",
                            dtype=torch.bfloat16 if bf16 else torch.float32)
    ours.load_state(*(np.asarray(x, np.float32) for x in ref.state))
    v_j, f_j, n_j, c_j = ref.get_mesh()
    v_p, f_p, n_p, c_p = ours.get_mesh()
    _assert_meshes_match((v_p, f_p, c_p, n_p), (v_j, f_j, c_j, n_j))


def test_dense_extraction_matches():
    ref = _jax_volume()
    tsdf, weight, color = ref.get_volume()
    want = jax_extract(tsdf, weight, color, origin=ref.origin, voxel_size=ref.voxel_size)
    got = extract_isosurface(torch.as_tensor(tsdf), torch.as_tensor(weight),
                             torch.as_tensor(color), origin=ref.origin,
                             voxel_size=ref.voxel_size)
    _assert_meshes_match(got, want)


def test_blocked_equals_dense_in_the_port():
    ref = _jax_volume()
    ours = SparseTSDFVolume(ref.volume_bounds, voxel_size=ref.voxel_size, device="cpu")
    ours.load_state(*(np.asarray(x) for x in ref.state))
    verts_b, faces_b, _, cols_b = ours.get_mesh()
    tsdf, weight, color = ours._dense()
    verts_d, faces_d, cols_d, _ = extract_isosurface(tsdf, weight, color, ours.origin,
                                                     ours.voxel_size, chunk_size=4096)
    np.testing.assert_array_equal(faces_b, faces_d)
    np.testing.assert_array_equal(cols_b, cols_d)
    np.testing.assert_allclose(verts_b, verts_d, atol=1e-6, rtol=0)


def test_numpy_weld_equals_native(monkeypatch):
    ref = _jax_volume()
    ours = SparseTSDFVolume(ref.volume_bounds, voxel_size=ref.voxel_size, device="cpu")
    ours.load_state(*(np.asarray(x) for x in ref.state))
    native = ours.get_mesh()

    import hive_tpu_torch.native as native_mod

    monkeypatch.setattr(native_mod, "extract_assemble", lambda *a, **k: None)
    monkeypatch.setattr(native_mod, "oct_average", lambda *a, **k: None)
    fallback = ours.get_mesh()
    np.testing.assert_array_equal(native[1], fallback[1])
    np.testing.assert_array_equal(native[3], fallback[3])
    np.testing.assert_allclose(native[0], fallback[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(native[2], fallback[2], atol=1e-5)


def test_empty_volume_extracts_nothing():
    volume = SparseTSDFVolume(np.array([[0, 1], [0, 1], [0, 1]], np.float32),
                              voxel_size=0.1, device="cpu")
    verts, faces, normals, colors = volume.get_mesh()
    assert verts.shape == (0, 3) and faces.shape == (0, 3) and colors.dtype == np.uint8


def test_colour_address_guard():
    check_blocked_colour_addressing(700_000_000)
    with pytest.raises(NotImplementedError):
        check_blocked_colour_addressing(716_000_000)
    assert marching.EMISSION_LANES == ("klo", "colcode", "fracnrm")
