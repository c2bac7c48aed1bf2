"""hive_tpu_torch's sparse and dense TSDF integrators against hive_tpu's on
the same numpy-seeded inputs: pyramid and packed-frame words, compacted ids,
pass-1 and refined classes (exact), and the fused state.

State tolerance (as tests/test_tsdf_sparse.py:53-59): at most 1e-3 of the
voxels' weights may differ by > 1e-5 and 2e-3 of their tsdf by > 1e-4 (fp32
evaluation-order artefacts on pixel-rounding boundaries), colours within 1
where the weights agree. The poses keep voxel centres off exact half-pixel
boundaries, as there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hive_tpu.ops import tsdf_sparse as J
from hive_tpu.ops.tsdf import TSDFVolume as JaxTSDFVolume
from hive_tpu_torch.ops import tsdf_sparse as P
from hive_tpu_torch.ops.tsdf import TSDFVolume
from tests.test_tsdf import H, K, W, look_at_pose, render_sphere_depth

BOUNDS = np.array([[-1.6, 1.6], [-1.6, 1.6], [0.0, 3.2]], dtype=np.float32)
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _frames(num_frames=3, seed=0):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(0.8, 2.5, size=(num_frames, H, W)).astype(np.float32)
    colors = rng.integers(0, 255, size=(num_frames, H, W, 3)).astype(np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.3, num_frames) + 0.01237
    poses[:, 1, 3] = 0.00731
    return depths, colors, poses


def _state(volume):
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.float().numpy() for x in volume.state]


def _assert_states_close(ours, ref):
    (t_p, w_p, c_p), (t_j, w_j, c_j) = _state(ours), _state(ref)
    weight_off = np.abs(w_p - w_j) > 1e-5
    assert weight_off.mean() < 1e-3
    assert (np.abs(t_p - t_j) > 1e-4).mean() < 2e-3
    agree = ~weight_off & (w_j > 0)
    bv = w_j.shape[1]
    agree3 = np.tile(agree, (1, c_j.shape[1] // bv))
    assert np.abs(c_p - c_j)[agree3].max(initial=0.0) <= 1.0
    assert w_j.sum() > 0


def _both(depths, colors, poses, k=K, bounds=BOUNDS, voxel=0.05, dtype=jnp.float32,
          obs_weights=None, **kw):
    ref = J.SparseTSDFVolume(bounds, voxel_size=voxel, dtype=dtype, **kw)
    ref.integrate_frames(colors, depths, k, poses, obs_weights=obs_weights)
    ours = P.SparseTSDFVolume(bounds, voxel_size=voxel, dtype=TORCH_DTYPE[dtype],
                              device="cpu", **kw)
    ours.integrate_frames(colors, depths, k, poses, obs_weights=obs_weights)
    return ours, ref


@pytest.mark.parametrize("packed_u16", [False, True])
@pytest.mark.parametrize("height,width", [(96, 128), (120, 1280)])
def test_flat_pyramid_words_equal(packed_u16, height, width):
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.3, 80.0, (height, width)).astype(np.float32)
    depth[rng.random((height, width)) < 0.1] = 0.0
    depth[rng.random((height, width)) < 0.01] = np.inf
    depth[rng.random((height, width)) < 0.01] = np.nan
    want = np.asarray(J.build_flat_pyramid(jnp.asarray(depth), height, width,
                                           packed_u16=packed_u16)).view(np.int32)
    got = P.build_flat_pyramid(torch.as_tensor(depth), height, width,
                               packed_u16=packed_u16).numpy()
    np.testing.assert_array_equal(got, want)
    for a, b in zip(P.pyramid_layout(height, width), J.pyramid_layout(height, width)):
        np.testing.assert_array_equal(a, b)


def _jax_closure(integ, name):
    """A closure variable of hive_tpu's integrator (its ``pack_frame``)."""
    impl = integ.scan_impl
    return dict(zip(impl.__code__.co_freevars,
                    (c.cell_contents for c in impl.__closure__)))[name]


@pytest.mark.parametrize("color_mode", ["rgb565d16", "rgb888"])
def test_pack_frame_words_equal(color_mode):
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.0, 70.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.05] = np.nan
    color = rng.uniform(-20.0, 280.0, (H, W, 3)).astype(np.float32)

    ref = J.SparseTSDFVolume(BOUNDS, voxel_size=0.1, color_mode=color_mode)
    want = _jax_closure(ref._build_integrator(H, W), "pack_frame")(
        jnp.asarray(depth), jnp.asarray(color))
    ours = P.SparseTSDFVolume(BOUNDS, voxel_size=0.1, color_mode=color_mode, device="cpu")
    got = ours._integrator(H, W).pack_frame(torch.as_tensor(depth), torch.as_tensor(color))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.view(np.int32))


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("size", [50, 200, 260])
def test_compact_ids_equal(density, size):
    mask = np.random.default_rng(3).random(200) < density
    np.testing.assert_array_equal(
        P.compact_ids(torch.as_tensor(mask), size, 200).numpy(),
        np.asarray(J.compact_ids(jnp.asarray(mask), size, 200)))


# 8 x 8 x 4 m at 0.05 m / (8, 8, 8) blocks: large enough to engage compaction.
BIG_BOUNDS = np.array([[-4.0, 4.0], [-4.0, 4.0], [0.0, 4.0]], dtype=np.float32)


@pytest.mark.parametrize("view", ["inside", "outside_in"])
@pytest.mark.parametrize("compact_cap", [None, 0.375])
def test_classes_equal(view, compact_cap):
    if view == "inside":
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.01237
        depth = np.full((H, W), 2.0, dtype=np.float32)
        depth[:, :20] = 0.0
    else:
        pose = look_at_pose((0.0, 0.0, -6.0), (0.0, 0.0, 2.0)).astype(np.float32)
        depth = render_sphere_depth((0.0, 0.0, 2.0), 1.0, pose)
    w2c = np.linalg.inv(pose).astype(np.float32)
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)

    ref = J.SparseTSDFVolume(BIG_BOUNDS, voxel_size=0.05)
    integ = ref._build_integrator(H, W, compact_cap=compact_cap)
    jargs = (ref.block_origins_device, jnp.asarray(depth), jnp.asarray(w2c[:3, :3]),
             jnp.asarray(w2c[:3, 3]), jnp.asarray(intr))
    want_pass1 = np.asarray(integ.classify(*jargs))
    want_refined = np.asarray(integ.classify_refined(*jargs))

    ours = P.SparseTSDFVolume(BIG_BOUNDS, voxel_size=0.05, device="cpu")
    pinteg = ours._integrator(H, W, compact_cap)
    pyramid = P.build_flat_pyramid(torch.as_tensor(depth), H, W, packed_u16=True)
    pargs = (ours.block_origins_device, pyramid, torch.as_tensor(w2c[:3, :3]),
             torch.as_tensor(w2c[:3, 3]), tuple(torch.as_tensor(intr)))
    got_pass1 = pinteg.classify(*pargs)
    np.testing.assert_array_equal(got_pass1.numpy(), want_pass1)
    got_refined = pinteg.classify_refined(*pargs)[0]
    np.testing.assert_array_equal(got_refined.numpy(), want_refined)
    assert len(np.unique(want_refined)) >= 3


@pytest.mark.parametrize("color_mode", ["rgb565d16", "rgb888"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_state_after_three_frames(color_mode, dtype):
    ours, ref = _both(*_frames(), color_mode=color_mode, dtype=dtype)
    assert ours.state.tsdf.dtype == TORCH_DTYPE[dtype]
    _assert_states_close(ours, ref)


def test_state_with_invalid_and_infinite_depth():
    depths, colors, poses = _frames(num_frames=2)
    depths[:, :, : W // 3] = 0.0
    depths[:, : H // 4, :] = np.inf
    _assert_states_close(*_both(depths, colors, poses, color_mode="rgb888"))


def test_state_sphere_views_rotated_poses():
    center = np.zeros(3)
    poses = np.stack([look_at_pose(eye, center) for eye in
                      [(0, 0, -2.0), (2.0, 0, 0), (0, 2.0, 0.01)]]).astype(np.float32)
    depths = np.stack([render_sphere_depth(center, 0.5, p) for p in poses])
    colors = np.random.default_rng(4).integers(0, 255, (3, H, W, 3)).astype(np.uint8)
    bounds = np.array([[-0.9, 0.9]] * 3, dtype=np.float32)
    _assert_states_close(*_both(depths, colors, poses, bounds=bounds, voxel=0.03))


def test_state_multi_trip_and_sub_slabs():
    """A tiny band capacity forces many trips; (8, 8, 16) blocks take the
    SUB = 2 z-slab path."""
    depths, colors, poses = _frames(num_frames=2)
    ours, ref = _both(depths, colors, poses, band_capacity_fraction=0.001,
                      block_size=(8, 8, 16))
    assert ours._integrator(H, W, None).SUB == 2
    _assert_states_close(ours, ref)


def test_state_free_edge_wall():
    wall_bounds = np.array([[-2.0, 2.0], [-2.0, 2.0], [0.0, 2.2]], dtype=np.float32)
    depths = np.full((2, H, W), 2.0, dtype=np.float32)
    colors = np.full((2, H, W, 3), 120, dtype=np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 0, 3] = [0.01237, 0.11237]
    poses[:, 1, 3] = 0.00731
    _assert_states_close(*_both(depths, colors, poses, bounds=wall_bounds))


def test_zero_weight_frame_is_noop():
    depths, colors, poses = _frames(num_frames=1)
    ours = P.SparseTSDFVolume(BOUNDS, voxel_size=0.05, color_mode="rgb888", device="cpu")
    ours.integrate_frames(colors, depths, K, poses, obs_weights=np.zeros((1,), np.float32))
    assert float(ours.state.weight.abs().max()) == 0.0
    assert float(ours.state.tsdf.min()) == 1.0


def test_load_state_undoes_block_permutation():
    depths, colors, poses = _frames(num_frames=1)
    ref = J.SparseTSDFVolume(BOUNDS, voxel_size=0.1)
    ref.integrate_frames(colors, depths, K, poses)
    canonical = [np.asarray(x) for x in ref.state]
    perm = np.random.default_rng(5).permutation(ref.num_blocks)
    ref.apply_block_permutation(perm)

    ours = P.SparseTSDFVolume(BOUNDS, voxel_size=0.1, device="cpu")
    ours.load_state(*(np.asarray(x) for x in ref.state), block_perm=ref._block_perm)
    for got, want in zip(ours.state, canonical):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        ours.load_state(canonical[0][:-1], *canonical[1:])


def test_dense_volume_matches_jax_package():
    depths, colors, poses = _frames(num_frames=2)
    ref = JaxTSDFVolume(BOUNDS, voxel_size=0.1)
    ref.integrate_frames(colors, depths, K, poses)
    ours = TSDFVolume(BOUNDS, voxel_size=0.1, device="cpu")
    ours.integrate_frames(colors, depths, K, poses)
    (t_p, w_p, c_p), (t_j, w_j, c_j) = ours.get_volume(), ref.get_volume()
    assert (np.abs(w_p - w_j) > 1e-5).mean() < 1e-3
    assert (np.abs(t_p - t_j) > 1e-4).mean() < 2e-3
    agree = (np.abs(w_p - w_j) <= 1e-5) & (w_j > 0)
    assert np.abs(c_p - c_j)[agree].max() <= 1.0


def test_sparse_matches_dense_self_check():
    """The port's own sparse-vs-dense equivalence (the JAX package's
    TestSparseEquivalence), which chip_smoke.py repeats on the card."""
    depths, colors, poses = _frames()
    dense = TSDFVolume(BOUNDS, voxel_size=0.05, device="cpu")
    dense.integrate_frames(colors, depths, K, poses)
    sparse = P.SparseTSDFVolume(BOUNDS, voxel_size=0.05, color_mode="rgb888", device="cpu")
    sparse.integrate_frames(colors, depths, K, poses)
    (t_d, w_d, _), (t_s, w_s, _) = dense.get_volume(), sparse.get_volume()
    assert (np.abs(w_s - w_d) > 1e-5).mean() < 1e-3
    assert (np.abs(t_s - t_d) > 1e-4).mean() < 2e-3


def test_half_pixel_candidate_fault_is_mirrored():
    """A fault of the reference, mirrored for parity (ROADMAP.md Queue 3):
    pass-1 compaction admits candidates with ``u1 >= 0`` while
    ``classes_from_bounds`` admits ``u1 >= -0.5``, so a block whose footprint
    ends in u in [-0.5, 0) is SKIP under compaction although its voxels
    round into column 0 and the full query classifies it BAND/FREE_EDGE."""
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 0.0123 + 0.06
    w2c = np.linalg.inv(pose).astype(np.float32)
    depth = np.full((H, W), 3.5, dtype=np.float32)
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)

    ours = P.SparseTSDFVolume(BIG_BOUNDS, voxel_size=0.05, device="cpu")
    pyramid = P.build_flat_pyramid(torch.as_tensor(depth), H, W, packed_u16=True)
    args = (ours.block_origins_device, pyramid, torch.as_tensor(w2c[:3, :3]),
            torch.as_tensor(w2c[:3, 3]), tuple(torch.as_tensor(intr)))
    full = ours._integrator(H, W, None).classify(*args).numpy()
    compacted = ours._integrator(H, W, 0.375).classify(*args).numpy()
    lost = (compacted == P.SparseTSDFVolume.SKIP) & (full != P.SparseTSDFVolume.SKIP)
    assert lost.sum() > 0

    ref = J.SparseTSDFVolume(BIG_BOUNDS, voxel_size=0.05)
    want = np.asarray(ref._build_integrator(H, W, compact_cap=0.375).classify(
        ref.block_origins_device, jnp.asarray(depth), jnp.asarray(w2c[:3, :3]),
        jnp.asarray(w2c[:3, 3]), jnp.asarray(intr)))
    np.testing.assert_array_equal(compacted, want)
