"""The multi-device layer (hive_tpu_torch.parallel, ``--num_devices``) on the
CPU: the port's k-way splits against its own unsplit path and against
hive_tpu's sharded functions on the virtual 8-device CPU mesh that
tests/conftest.py provides.

A port mesh here is ``device="cpu"`` shards (``get_device_mesh(n,
device="cpu")``): every shard runs on the CPU, so a split is checked for
what it computes, not for speed.

Tolerances. Integration and extraction: bit for bit, against the unsplit
path and hive_tpu alike (blocks are independent, and on these scenes the
port's unsplit state equals hive_tpu's to the bit). Pose: the shards'
partial loss sums meet in shard order, so a split run is not bit-equal to
the unsplit one; in float64 it is held within POSE_F64_TOL of it, and in
float32 within tests/test_parallel.py's 1e-5 of hive_tpu's mesh run. DPT
(bf16): within 1 mm of the unsplit port (the estimator tolerance of
tests/test_torch_dpt.py), and within DPT_JAX_TOL of hive_tpu's mesh run.
"""

import os
import shutil
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from hive_tpu.ops.tsdf_sparse import SparseTSDFVolume as JaxSparseTSDFVolume
from hive_tpu.parallel import fusion as jax_fusion
from hive_tpu.parallel import mesh as jax_mesh
from hive_tpu_torch.ops import classify_blocks
from hive_tpu_torch.ops.tsdf import world_to_camera
from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume, pick_compact_cap
from hive_tpu_torch.parallel import fusion, mesh, runtime
from hive_tpu_torch.parallel.mesh import get_device_mesh

H, W = 24, 32
K = np.array([[30.0, 0, 15.5], [0, 30.0, 11.5], [0, 0, 1.0]])
BOUNDS = np.array([[-1.0, 1.0], [-1.0, 1.0], [0.0, 2.0]])
VOXEL = 2.0 / 32
POSE_F64_TOL = 1e-9
# Metres, the port's bf16 depth against hive_tpu's mesh run with the check
# weights: measured 0.0115 at 64 x 96, where hive_tpu's own split run moves
# its depth by 0.0111 (XLA keeps some bf16 intermediates in float32, torch
# rounds each: tests/test_torch_dpt.py's FULL_TOL). Any two of the test's
# frames differ by more than three times this.
DPT_JAX_TOL = 0.02


def _scene(seed=0, num_frames=3):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(0.8, 1.6, (num_frames, H, W)).astype(np.float32)
    colors = rng.uniform(0, 255, (num_frames, H, W, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.1, num_frames)
    return colors, depths, poses


def _jax_state(volume):
    """hive_tpu's state as float32 numpy arrays in canonical block order."""
    state = [np.asarray(x, np.float32) for x in volume.state]
    if volume._block_perm is None:
        return state
    inverse = np.argsort(volume._block_perm)
    return [x[inverse] for x in state]


def _assert_states_equal(ours, want):
    for name, got, expected in zip(("tsdf", "weight", "color"), ours, want):
        np.testing.assert_array_equal(got.float().numpy(), expected, err_msg=name)


@pytest.fixture(autouse=True)
def no_runtime_mesh():
    yield
    runtime.set_runtime_mesh(None)


# ---------------------------------------------------------------------------
# Meshes.
# ---------------------------------------------------------------------------

def _jax_shards(array):
    return [np.asarray(s.data) for s in sorted(
        array.addressable_shards, key=lambda s: tuple(i.start or 0 for i in s.index))]


@pytest.mark.parametrize("shape, axis", [((8, 3, 5), 0), ((3, 16, 2), 1)])
def test_mesh_helpers_match_hive_tpu(shape, axis):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ours = get_device_mesh(8, device="cpu")
    theirs = jax_mesh.get_device_mesh(8)
    assert ours.size == 8 and ours.axis_names == theirs.axis_names == ("data",)
    got = mesh.shard_batch(ours, x, axis=axis)
    want = _jax_shards(jax_mesh.shard_batch(theirs, x, axis=axis))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(mesh.shard_volume(ours, x, axis=axis),
                    _jax_shards(jax_mesh.shard_volume(theirs, x, axis=axis))):
        np.testing.assert_array_equal(g.numpy(), w)
    for g in mesh.replicate(ours, x):
        np.testing.assert_array_equal(g.numpy(), x)
    for size, multiple in ((5, 8), (8, 8), (9, 4), (3, 1)):
        a = np.arange(size * 2, dtype=np.float32).reshape(size, 2)
        np.testing.assert_array_equal(mesh.pad_to_multiple(a, multiple),
                                      jax_mesh.pad_to_multiple(a, multiple))


def test_mesh_refusals(monkeypatch):
    """Non-positive counts and multi-axis names are refused as in
    hive_tpu; an indivisible split too. More CUDA devices than the machine
    has raises, naming both counts, where hive_tpu falls back to its
    virtual CPU devices (a difference by design: the fallback would hide
    the card)."""
    for n in (0, -2):
        with pytest.raises(ValueError, match="positive"):
            get_device_mesh(n, device="cpu")
        with pytest.raises(ValueError, match="positive"):
            jax_mesh.get_device_mesh(n)
    with pytest.raises(ValueError, match="1-D"):
        get_device_mesh(2, axis_names=("data", "space"), device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        jax_mesh.get_device_mesh(2, axis_names=("data", "space"))
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_batch(get_device_mesh(3, device="cpu"), np.zeros((8, 2)))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"Requested 2 CUDA devices but only 1 .*no fallback"):
        get_device_mesh(2)
    with pytest.raises(ValueError, match="not among the 1 CUDA devices"):
        get_device_mesh(devices=["cuda:0", "cuda:1"])
    one_card = get_device_mesh(devices=["cuda:0", "cuda:0"])
    assert one_card.devices == (torch.device("cuda", 0),) * 2
    assert len(jax.devices()) == 8 and jax_mesh.get_device_mesh(2).devices.size == 2


def test_configure_runtime_mesh():
    assert runtime.configure(1) is None and runtime.configure(0) is None
    assert runtime.runtime_mesh() is None
    # -1 on the CPU is one device: no mesh, the single-device path.
    assert runtime.configure(-1, device="cpu") is None
    two = runtime.configure(2, device="cpu")
    assert two.devices == (torch.device("cpu"),) * 2 and runtime.runtime_mesh() is two
    runtime.set_runtime_mesh(None)
    assert runtime.runtime_mesh() is None
    # No CUDA device here: a CUDA mesh is refused, not built on the CPU.
    with pytest.raises(ValueError, match="Requested 2 CUDA devices but only 0"):
        runtime.configure(2)
    with pytest.raises(ValueError, match="positive"):
        runtime.configure(-2, device="cpu")


# ---------------------------------------------------------------------------
# Integration and extraction.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded():
    """hive_tpu's integrate_frames_sharded on its 8-device mesh, by
    placement: the volume (its state un-permuted by ``_jax_state``)."""
    colors, depths, poses = _scene()
    out = {}
    for placement in ("contiguous", "cyclic"):
        volume = JaxSparseTSDFVolume(BOUNDS, voxel_size=VOXEL)
        jmesh = jax_mesh.get_device_mesh(8)
        jax_fusion.shard_sparse_state(volume, jmesh, placement=placement)
        jax_fusion.integrate_frames_sharded(volume, jmesh, colors, depths, K, poses)
        out[placement] = volume
    return out


@pytest.fixture(scope="module")
def unsplit():
    colors, depths, poses = _scene()
    volume = SparseTSDFVolume(BOUNDS, voxel_size=VOXEL, device="cpu")
    volume.integrate_frames(colors, depths, K, poses)
    return volume


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("placement", ["contiguous", "cyclic"])
def test_sharded_integration(jax_sharded, unsplit, placement, shards):
    """The split state, un-permuted, is bit-equal to the port's unsplit
    state and to hive_tpu's sharded state; dense reads un-permute too."""
    colors, depths, poses = _scene()
    volume = SparseTSDFVolume(BOUNDS, voxel_size=VOXEL, device="cpu")
    cpu_mesh = get_device_mesh(shards, device="cpu")
    fusion.shard_sparse_state(volume, cpu_mesh, placement=placement)
    assert len(volume.shards) == shards
    assert all(s.state.tsdf.shape[0] == volume.num_blocks // shards for s in volume.shards)
    fusion.integrate_frames_sharded(volume, cpu_mesh, colors, depths, K, poses)

    assert float(unsplit.state.weight.sum()) > 0
    _assert_states_equal(volume.state, [x.float().numpy() for x in unsplit.state])
    _assert_states_equal(volume.state, _jax_state(jax_sharded[placement]))
    for got, want in zip(volume.get_volume(), unsplit.get_volume()):
        np.testing.assert_array_equal(got, want)


def test_sharded_integration_of_an_unsplit_volume_is_refused():
    volume = SparseTSDFVolume(BOUNDS, voxel_size=VOXEL, device="cpu")
    with pytest.raises(ValueError, match="shard_sparse_state"):
        fusion.integrate_frames_sharded(volume, get_device_mesh(2, device="cpu"),
                                        *_scene(num_frames=1)[:2], K,
                                        np.eye(4, dtype=np.float32)[None])


def test_shard_cap_overflow_matches_hive_tpu():
    """A scene whose pass-1 candidates overflow one slab's cap (contiguous
    placement, a camera over the x < 0 half): each slab takes its caps from
    its own rows, as hive_tpu's integrator does inside shard_map, so the
    port's split state equals hive_tpu's sharded state."""
    k = np.array([[26.0, 0, 15.5], [0, 26.0, 11.5], [0, 0, 1.0]])
    bounds = np.array([[-2.0, 2.0], [-1.0, 1.0], [0.0, 2.0]])
    rng = np.random.default_rng(2)
    depths = rng.uniform(1.0, 1.8, (1, H, W)).astype(np.float32)
    colors = rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    poses = np.eye(4, dtype=np.float32)[None].copy()
    poses[0, :3, 3] = [-1.0, 0.0, -0.2]
    options = dict(voxel_size=2.0 / 64, block_size=(4, 4, 8))

    volume = SparseTSDFVolume(bounds, device="cpu", **options)
    cpu_mesh = get_device_mesh(2, device="cpu")
    fusion.shard_sparse_state(volume, cpu_mesh, placement="contiguous")
    cap = pick_compact_cap(volume.estimate_candidate_fraction(k, poses, H, W))
    slab = volume.shards[0]
    integ = volume._integrator(H, W, cap, slab.origins.shape[0], slab.device)
    w2c = torch.as_tensor(world_to_camera(poses))[0]
    scal = classify_blocks.classify_scalars(w2c[:3, :3], w2c[:3, 3], torch.tensor(
        [k[0, 0], k[1, 1], k[0, 2], k[1, 2]], dtype=torch.float32))
    R, t, intr = classify_blocks._camera(scal)
    in_front, _, _, u0, u1, v0, v1, outside = classify_blocks.project_corners(
        slab.origins, R, t, intr, integ.geometry)
    candidates = int(classify_blocks.pass1_candidates(in_front, u0, u1, v0, v1, outside,
                                                      integ.geometry).sum())
    unsplit_cap = volume._integrator(H, W, cap).pass1_cap
    assert integ.pass1_cap < candidates < unsplit_cap

    fusion.integrate_frames_sharded(volume, cpu_mesh, colors, depths, k, poses)
    theirs = JaxSparseTSDFVolume(bounds, **options)
    jmesh = jax_mesh.get_device_mesh(2)
    jax_fusion.shard_sparse_state(theirs, jmesh, placement="contiguous")
    jax_fusion.integrate_frames_sharded(theirs, jmesh, colors, depths, k, poses)
    assert float(volume.state.weight.sum()) > 0
    _assert_states_equal(volume.state, _jax_state(theirs))


@pytest.mark.parametrize("placement", ["contiguous", "cyclic"])
def test_sharded_extraction(jax_sharded, unsplit, placement):
    """get_mesh_sharded (a small chunk_size: many rounds over 8 shards) and
    get_mesh on the split volume are byte-identical to the unsplit
    volume's get_mesh, and to hive_tpu's get_mesh_sharded."""
    theirs = jax_sharded[placement]
    want = unsplit.get_mesh()
    assert len(want[0]) > 1000
    volume = SparseTSDFVolume(BOUNDS, voxel_size=VOXEL, device="cpu")
    cpu_mesh = get_device_mesh(8, device="cpu")
    fusion.shard_sparse_state(volume, cpu_mesh, placement=placement)
    fusion.integrate_frames_sharded(volume, cpu_mesh, *_scene()[:2], K, _scene()[2])
    jax_mesh_8 = jax_mesh.get_device_mesh(8)
    jax_want = jax_fusion.get_mesh_sharded(theirs, jax_mesh_8)
    for got in (fusion.get_mesh_sharded(volume, cpu_mesh, chunk_size=64), volume.get_mesh()):
        for name, g, w, j in zip(("vertices", "faces", "normals", "colors"), got, want,
                                 jax_want):
            np.testing.assert_array_equal(g, w, err_msg=name)
            np.testing.assert_array_equal(g, j, err_msg=name)


def test_cyclic_placement_interleaves_blocks():
    """Row r of the split holds block perm[r] of hive_tpu's block-cyclic
    permutation: slab d holds canonical blocks d, d+8, d+16, ..."""
    volume = SparseTSDFVolume(BOUNDS, voxel_size=VOXEL, device="cpu")
    theirs = JaxSparseTSDFVolume(BOUNDS, voxel_size=VOXEL)
    fusion.shard_sparse_state(volume, get_device_mesh(8, device="cpu"), placement="cyclic")
    jax_fusion.shard_sparse_state(theirs, jax_mesh.get_device_mesh(8), placement="cyclic")
    np.testing.assert_array_equal(volume.block_perm, theirs._block_perm)
    rows = np.concatenate([s.origins.numpy() for s in volume.shards])
    np.testing.assert_array_equal(rows, theirs.block_origins)
    np.testing.assert_array_equal(volume.shards[0].origins.numpy(), volume.block_origins[0::8])
    contiguous = SparseTSDFVolume(BOUNDS, voxel_size=VOXEL, device="cpu")
    fusion.shard_sparse_state(contiguous, get_device_mesh(2, device="cpu"),
                              placement="contiguous")
    assert contiguous.block_perm is None
    np.testing.assert_array_equal(contiguous.shards[1].origins.numpy(),
                                  contiguous.block_origins[contiguous.num_blocks // 2:])


def test_indivisible_blocks_and_unknown_placement_raise():
    bounds = np.array([[-1.0, 1.0]] * 3)
    volume = SparseTSDFVolume(bounds, voxel_size=2.0 / 24, block_size=(8, 8, 4), device="cpu")
    theirs = JaxSparseTSDFVolume(bounds, voxel_size=2.0 / 24, block_size=(8, 8, 4))
    assert volume.num_blocks == theirs.num_blocks and volume.num_blocks % 8 != 0
    with pytest.raises(ValueError, match="divide"):
        fusion.shard_sparse_state(volume, get_device_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="divide"):
        jax_fusion.shard_sparse_state(theirs, jax_mesh.get_device_mesh(8))
    with pytest.raises(ValueError, match="placement"):
        fusion.shard_sparse_state(volume, get_device_mesh(2, device="cpu"), placement="random")
    assert volume.shards is None


# ---------------------------------------------------------------------------
# Pose optimisation.
# ---------------------------------------------------------------------------

def _pose_inputs(m=64, num_frames=6, seed=3):
    """tests/test_parallel.py's problem: random correspondences, identity
    start."""
    rng = np.random.default_rng(seed)
    features = {
        "idx_i": rng.integers(0, num_frames, m).astype(np.int64),
        "points_i": rng.uniform(0, 32, (m, 2)).astype(np.float32),
        "depth_i": rng.uniform(0.5, 3.0, m).astype(np.float32),
        "idx_j": rng.integers(0, num_frames, m).astype(np.int64),
        "points_j": rng.uniform(0, 32, (m, 2)).astype(np.float32),
        "depth_j": rng.uniform(0.5, 3.0, m).astype(np.float32),
        "weight": np.ones(m, dtype=np.float32),
    }
    params = {"q": np.tile(np.float32([0.0, 0.0, 0.0, 1.0]), (num_frames, 1)),
              "t": np.zeros((num_frames, 3), np.float32),
              "scale": np.zeros((0,), np.float32), "shift": np.zeros((0,), np.float32)}
    return features, params, np.float32([50.0, 50.0, 15.5, 11.5])


def _optimise(module, features, params, intrinsics, num_epochs, mesh_=None, **convert):
    options = module.OptimisationOptions(num_epochs=num_epochs, epochs_per_chunk=5,
                                         lr_scheduler_patience=1000,
                                         early_stopping_patience=1000)
    out = module.optimise_packed_features(
        features, intrinsics, params, options, residual_type=module.ResidualType.World3D,
        frame_size=(32, 24), fps=30.0, mesh=mesh_)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_pose_float64_matches_unsplit(shards):
    """Float64, 40 epochs, no plateau or early stop (a decision there could
    flip on a last-bit difference): the split run within POSE_F64_TOL of
    the unsplit one."""
    from hive_tpu_torch import pose_optimisation as P

    features, params, intrinsics = _pose_inputs()
    feats = {k: torch.as_tensor(v.astype(np.float64) if v.dtype == np.float32 else v)
             for k, v in features.items()}
    params = {k: v.astype(np.float64) for k, v in params.items()}
    intr = torch.as_tensor(intrinsics, dtype=torch.float64)
    want = _optimise(P, feats, params, intr, 40)
    got = _optimise(P, feats, params, intr, 40, get_device_mesh(shards, device="cpu"))
    assert got["t"].dtype == np.float64 and np.abs(want["t"]).max() > 1e-2
    for key in ("q", "t"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=POSE_F64_TOL)


def test_sharded_pose_matches_hive_tpu_mesh_run():
    """Float32 on 8 shards against hive_tpu's run on its 8-device mesh,
    within tests/test_parallel.py's 1e-5."""
    import jax.numpy as jnp

    from hive_tpu import pose_optimisation as J
    from hive_tpu_torch import pose_optimisation as P

    features, params, intrinsics = _pose_inputs()
    want = _optimise(J, {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                         for k, v in features.items()},
                     {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(intrinsics),
                     10, jax_mesh.get_device_mesh(8))
    got = _optimise(P, {k: torch.as_tensor(v) for k, v in features.items()}, params,
                    torch.as_tensor(intrinsics), 10, get_device_mesh(8, device="cpu"))
    assert np.abs(want["t"]).max() > 1e-3
    for key in ("q", "t"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)


def test_indivisible_correspondences_raise():
    from hive_tpu_torch import pose_optimisation as P

    features, params, intrinsics = _pose_inputs(m=63)
    with pytest.raises(ValueError, match="divide"):
        _optimise(P, {k: torch.as_tensor(v) for k, v in features.items()}, params,
                  torch.as_tensor(intrinsics), 2, get_device_mesh(8, device="cpu"))


def test_pose_optimiser_pads_for_the_mesh():
    """Under a runtime mesh of 3 CPU shards PoseOptimiser pads 13
    correspondences to 15 rows of weight 0, and the padded, split run
    equals the unsplit one within 1e-5 (float32)."""
    from hive_tpu_torch import pose_optimisation as P
    from hive_tpu_torch.pose_optimisation import (FeatureData, FeatureSet, OptimisationOptions,
                                                  PoseOptimiser, ResidualType)

    rng = np.random.default_rng(5)
    m, num_frames = 13, 4

    def feature_data(idx):
        return FeatureData(index=idx.astype(np.int64), points=rng.uniform(0, 32, (m, 2)),
                           depth=rng.uniform(0.5, 3.0, m))

    idx_i = rng.integers(0, num_frames - 1, m)
    feature_set = FeatureSet(camera_matrix=np.array([[50.0, 0, 16.0], [0, 50.0, 12.0],
                                                     [0, 0, 1.0]]),
                             frame_i=feature_data(idx_i), frame_j=feature_data(idx_i + 1))

    packed = PoseOptimiser._pack_features(feature_set, device="cpu", pad_to=15)
    assert packed["weight"].tolist() == [1.0] * 13 + [0.0] * 2
    assert all(float(v[13:].abs().sum()) == 0 for v in packed.values())

    class _Dataset:
        frame_width, frame_height, fps, num_frames = 32, 24, 30.0, 4

    optimiser = PoseOptimiser.__new__(PoseOptimiser)
    optimiser.dataset = _Dataset()
    optimiser.device = torch.device("cpu")
    options = OptimisationOptions(num_epochs=6, epochs_per_chunk=3)
    params = {"q": torch.tensor([[0.0, 0.0, 0.0, 1.0]] * num_frames),
              "t": torch.zeros((num_frames, 3)), "scale": torch.zeros((0,)),
              "shift": torch.zeros((0,))}

    with mock.patch.object(P, "optimise_packed_features",
                           wraps=P.optimise_packed_features) as spy:
        want = optimiser._optimisation_loop(feature_set, params, options, ResidualType.World3D)
        runtime.set_runtime_mesh(get_device_mesh(3, device="cpu"))
        got = optimiser._optimisation_loop(feature_set, params, options, ResidualType.World3D)
        sizes = [len(call.args[0]["weight"]) for call in spy.call_args_list]
    assert sizes == [13, 15] and spy.call_args_list[1].kwargs["mesh"].size == 3
    assert np.abs(want["t"].numpy()).max() > 1e-3
    for key in ("q", "t"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# DPT.
# ---------------------------------------------------------------------------

def test_sharded_dpt_matches_unsplit_and_hive_tpu(tmp_path, monkeypatch):
    """predict_batch of 3 frames over 2 shards (the last frame repeated to
    pad) equals the unsplit port within 1 mm and hive_tpu's 2-device mesh
    within DPT_JAX_TOL, at tests/test_torch_dpt.py's narrow net size, with
    the check weights (head mapped to about 2 m, as chip_smoke.py writes
    them)."""
    from hive_tpu.models import dpt as jax_dpt
    from hive_tpu_torch.models import dpt

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    chip_smoke.write_dpt_weights(str(tmp_path))
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    frames = np.random.default_rng(7).integers(0, 256, (3, 50, 70, 3)).astype(np.uint8)
    unsplit_estimator = dpt.DPTDepthEstimator(net_size=(64, 96), device="cpu", mesh=None)
    want = unsplit_estimator.predict_batch(frames)
    runtime.set_runtime_mesh(get_device_mesh(2, device="cpu"))
    split = dpt.DPTDepthEstimator(net_size=(64, 96), device="cpu")
    assert split.mesh.size == 2
    got = split.predict_batch(frames)
    theirs = jax_dpt.DPTDepthEstimator(net_size=(64, 96), mesh=jax_mesh.get_device_mesh(2))
    jax_want = theirs.predict_batch(frames)
    assert got.shape == want.shape == jax_want.shape == (3, 50, 70)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        assert np.abs(want[i] - want[j]).max() > 3 * DPT_JAX_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, jax_want, rtol=0, atol=DPT_JAX_TOL)


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

def test_cli_num_devices_2_equals_hive_tpu(tmp_path):
    """``--num_devices 2`` with ``device="cpu"``: the volume splits over
    two CPU shards, and bg.glb's mesh equals hive_tpu's with
    ``--num_devices 2`` (its 2 virtual devices); the mesh is cleared after
    the run."""
    from hive_tpu.meshing.gltf import load_glb as jax_load_glb
    from hive_tpu.pipeline import Pipeline as JaxPipeline
    from hive_tpu_torch import fusion as torch_fusion
    from hive_tpu_torch.pipeline import Pipeline
    from tests.helpers import make_synthetic_hive_dataset

    source = make_synthetic_hive_dataset(tmp_path / "source", num_frames=6, width=128,
                                         height=96)
    meshes = {}
    for name in ("jax", "torch"):
        path = str(tmp_path / name)
        shutil.copytree(source, path)
        argv = ["--dataset_path", path, "--output_path", path, "--background_only",
                "--num_frames", "6", "--key_frame_threshold", "1.0", "--overwrite_ok",
                "--sdf_max_voxels", "500000", "--webxr_path", str(tmp_path / name / "webxr"),
                "--log_file", str(tmp_path / name / "log.txt"), "--num_devices", "2"]
        if name == "jax":
            with mock.patch.object(sys, "argv", ["hive", *argv]):
                JaxPipeline.from_command_line().run(compress=False)
        else:
            with mock.patch.object(torch_fusion, "shard_sparse_state",
                                   wraps=torch_fusion.shard_sparse_state) as shard:
                Pipeline.from_command_line(argv, device="cpu").run(compress=False)
            assert shard.call_args.args[1].devices == (torch.device("cpu"),) * 2
            assert runtime.runtime_mesh() is None
        meshes[name] = next(iter(jax_load_glb(os.path.join(path, "mesh", "bg.glb"))
                                 .geometry.values()))
    assert len(meshes["torch"].vertices) > 1000
    for attribute in ("faces", "vertices", "vertex_colors"):
        np.testing.assert_array_equal(getattr(meshes["torch"], attribute),
                                      getattr(meshes["jax"], attribute))
