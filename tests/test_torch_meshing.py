"""The foreground meshing modules against hive_tpu's on the same inputs:
triangulation (Delaunay and grid), face filtering, decimation (native QEM and
the clustering fallback), connected components, PLY, and texture crop / atlas
packing. Every result must be exactly equal."""

import numpy as np
import pytest

from hive_tpu.meshing import components as jax_components
from hive_tpu.meshing import decimate as jax_decimate
from hive_tpu.meshing import ply as jax_ply
from hive_tpu.meshing import texture as jax_texture
from hive_tpu.meshing import triangulate as jax_triangulate
from hive_tpu.native import get_native_lib as jax_native_lib
from hive_tpu.options import MeshFilteringOptions as JaxFilteringOptions
from hive_tpu_torch.meshing import components, decimate, ply, texture, triangulate
from hive_tpu_torch.meshing.mesh import TriangleMesh
from hive_tpu_torch.native import get_native_lib
from hive_tpu_torch.options import MeshFilteringOptions
from tests.test_meshing import make_icosphere


def assert_same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def both_options(**kwargs):
    return MeshFilteringOptions(**kwargs), JaxFilteringOptions(**kwargs)


def depth_scene(seed, h=48, w=64):
    """A blob at 1.5 m in front of a 2 m wall, 2% dropouts and a step edge."""
    rng = np.random.default_rng(seed)
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    mask = (us - w / 2) ** 2 + (vs - h / 2) ** 2 < (h / 3) ** 2
    depth = np.where(mask, 1.5, 2.0) + rng.normal(0, 0.003, (h, w))
    depth[:, : w // 5] += 0.5
    depth[rng.random((h, w)) < 0.02] = 0.0
    return mask, depth


def grid_mesh(seed, h=120, w=160):
    """A noisy disc meshed on the pixel grid and unprojected (f32)."""
    mask, depth = depth_scene(seed, h, w)
    depth = depth.astype(np.float32)
    valid = mask & (depth > 0)
    pix, faces, masked = triangulate.triangulate_grid(valid, depth, MeshFilteringOptions())
    verts = np.stack([(pix[:, 0] - w / 2) / 100.0 * masked,
                      (pix[:, 1] - h / 2) / 100.0 * masked, masked], -1).astype(np.float32)
    return verts, faces


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_points(seed):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(12), np.arange(9)), -1).reshape(-1, 2)
    points = [grid.astype(float), grid + rng.uniform(-0.3, 0.3, grid.shape),
              rng.uniform(0, 50, (200, 2))][seed]
    assert_same(triangulate.triangulate_points(points),
                jax_triangulate.triangulate_points(points))


@pytest.mark.parametrize("options", [{}, dict(max_pixel_distance=1.5, max_depth_distance=0.05),
                                     dict(max_pixel_distance=10, max_depth_distance=0.5)],
                         ids=["default", "tight", "loose"])
def test_filter_faces(options):
    mask, depth = depth_scene(3)
    valid = mask | (depth > 0)
    v, u = valid.nonzero()
    points = np.stack([u, v], -1)
    faces = jax_triangulate.triangulate_points(points)
    ours, theirs = both_options(**options)
    kept = triangulate.filter_faces(points, depth[valid], faces, ours)
    assert 0 < len(kept) <= len(faces)
    assert_same(kept, jax_triangulate.filter_faces(points, depth[valid], faces, theirs))


@pytest.mark.parametrize("options", [{}, dict(max_pixel_distance=1), dict(max_depth_distance=0.1),
                                     dict(max_depth_distance=0.6)],
                         ids=["default", "sub_diagonal", "step", "bridging"])
@pytest.mark.parametrize("seed", [4, 5])
def test_triangulate_grid(options, seed):
    mask, depth = depth_scene(seed)
    valid = (mask | (np.random.default_rng(seed).random(mask.shape) < 0.5)) & (depth > 0)
    ours, theirs = both_options(**options)
    assert_same(triangulate.triangulate_grid(valid, depth, ours),
                jax_triangulate.triangulate_grid(valid, depth, theirs))


def test_both_packages_decimate_natively():
    """Both QEM libraries build (same source, same g++ flags) and load."""
    assert get_native_lib() is not None
    assert jax_native_lib() is not None


@pytest.mark.parametrize("case", ["sphere_200", "sphere_100", "disc_512", "noisy_disc_1024",
                                  "disabled", "under_target"])
def test_decimate_native(case):
    if case.startswith("sphere"):
        verts, faces = make_icosphere(3)
        target, max_error = int(case.split("_")[1]), 1e9
    elif case.endswith("disc_512"):
        verts, faces = grid_mesh(6)
        target, max_error = 512, 0.001
    elif case == "noisy_disc_1024":
        verts, faces = grid_mesh(7, 96, 128)
        target, max_error = 1024, 1e9
    else:
        verts, faces = make_icosphere(1 if case == "disabled" else 0)
        target, max_error = (-1 if case == "disabled" else 100), 0.001
    got = decimate.decimate_mesh(verts, faces, target, max_error)
    want = jax_decimate.decimate_mesh(verts, faces, target, max_error)
    assert_same(got, want)
    if target > 0 and len(faces) > target:
        assert len(got[1]) < len(faces)


@pytest.mark.parametrize("target", [300, 2, 5000])
def test_decimate_clustering(target):
    verts, faces = make_icosphere(3)
    assert_same(decimate._decimate_clustering(verts, faces, target),
                jax_decimate._decimate_clustering(verts, faces, target))


def _component_scene(case):
    big_v, big_f = make_icosphere(2)
    small_v, small_f = make_icosphere(0)
    tiny_v = np.array([[10, 0, 0], [11, 0, 0], [10, 1, 0]], dtype=np.float64)
    parts = {"two_spheres": [(big_v, big_f), (small_v + 10.0, small_f)],
             "with_triangle": [(big_v, big_f), (tiny_v, np.array([[0, 1, 2]]))],
             "only_noise": [(tiny_v, np.array([[0, 1, 2]])), (tiny_v + 5, np.array([[0, 1, 2]]))]}
    verts, faces, offset = [], [], 0
    for v, f in parts[case]:
        verts.append(v)
        faces.append(f + offset)
        offset += len(v)
    return np.concatenate(verts), np.concatenate(faces)


@pytest.mark.parametrize("case", ["two_spheres", "with_triangle", "only_noise"])
def test_connected_components(case):
    verts, faces = _component_scene(case)
    assert_same(components.face_connected_components(faces),
                jax_components.face_connected_components(faces))
    for is_object in (True, False):
        assert_same(components.cleanup_with_connected_components(verts, faces, is_object, 5),
                    jax_components.cleanup_with_connected_components(verts, faces, is_object, 5))


def test_ply_roundtrip_across_packages(tmp_path):
    verts, faces = make_icosphere(1)
    colors = np.random.default_rng(2).integers(0, 255, size=(len(verts), 3), dtype=np.uint8)
    mesh = TriangleMesh(vertices=verts.astype(np.float32), faces=faces, vertex_colors=colors)
    mesh.compute_vertex_normals()
    ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "theirs.ply")
    ply.save_ply(ours, mesh)
    jax_ply.save_ply(theirs, mesh)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        got, want = ply.load_ply(path), jax_ply.load_ply(path)
        for name in ("vertices", "faces", "vertex_colors", "vertex_normals"):
            assert_same(getattr(got, name), getattr(want, name))


def test_ply_ascii_mixed_polygons(tmp_path):
    path = tmp_path / "mixed.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 5\nproperty float x\n"
                    "property float y\nproperty float z\nproperty uchar red\n"
                    "property uchar green\nproperty uchar blue\nelement face 2\n"
                    "property list uchar int vertex_indices\nend_header\n"
                    "0 0 0 1 2 3\n1 0 0 4 5 6\n1 1 0 7 8 9\n0 1 0 10 11 12\n0.5 2 0 13 14 15\n"
                    "4 0 1 2 3\n3 2 3 4\n")
    got, want = ply.load_ply(str(path)), jax_ply.load_ply(str(path))
    assert len(got.faces) == 3
    for name in ("vertices", "faces", "vertex_colors"):
        assert_same(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("seed", [0, 1])
def test_texture_crop_and_uv(seed):
    """Vertices of a blob seen by a rotated, shifted camera, some projecting
    outside the frame (the crop is clipped)."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    K = np.array([[100.0, 0, 63.5], [0, 100.0, 47.5], [0, 0, 1]])
    angle = rng.uniform(-0.2, 0.2)
    R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]])
    t = rng.uniform(-0.1, 0.1, (3, 1))
    verts = rng.uniform([-0.9, -0.6, 1.4], [0.9, 0.6, 1.6], (300, 3)).astype(np.float32)
    assert_same(texture.get_mesh_texture_and_uv(verts, image, K, R, t),
                jax_texture.get_mesh_texture_and_uv(verts, image, K, R, t))


@pytest.mark.parametrize("n_rows", [1, 2])
def test_pack_textures(n_rows):
    rng = np.random.default_rng(n_rows)
    textures = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for h, w in ((20, 30), (35, 12), (8, 40))]
    uvs = [rng.uniform(0, 1, (n, 2)) * [t.shape[1], t.shape[0]]
           for n, t in zip((10, 7, 13), textures)]
    assert_same(texture.pack_textures(textures, uvs, n_rows=n_rows),
                jax_texture.pack_textures(textures, uvs, n_rows=n_rows))
