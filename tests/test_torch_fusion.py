"""The background path end to end: ``tsdf_fusion`` and the ``Pipeline`` with
``--background_only`` in both packages on one synthetic HIVE dataset."""

import json
import os

import numpy as np
import pytest

from hive_tpu.fusion import tsdf_fusion as jax_tsdf_fusion
from hive_tpu.io import HiveDataset as JaxHiveDataset
from hive_tpu.meshing.gltf import load_glb as jax_load_glb
from hive_tpu.options import BackgroundMeshOptions as JaxBackgroundMeshOptions
from hive_tpu_torch.fusion import adjust_voxel_size, tsdf_fusion
from hive_tpu_torch.io import HiveDataset
from hive_tpu_torch.meshing.gltf import load_glb
from hive_tpu_torch.options import BackgroundMeshOptions
from hive_tpu_torch.pipeline import Pipeline
from tests.helpers import make_synthetic_hive_dataset

# At 128x96 with fx = 100 the default 5 mm voxel would need ~79M voxels.
BUDGET = 500_000


@pytest.fixture(scope="module")
def dataset_path(tmp_path_factory):
    return make_synthetic_hive_dataset(tmp_path_factory.mktemp("hive") / "ds",
                                       num_frames=6, width=128, height=96)


def test_voxel_sizing_matches(dataset_path):
    from hive_tpu.fusion import adjust_voxel_size as jax_adjust

    frames = list(range(6))
    size_p, bounds_p = adjust_voxel_size(HiveDataset(dataset_path),
                                         BackgroundMeshOptions(sdf_max_voxels=BUDGET), frames)
    size_j, bounds_j = jax_adjust(JaxHiveDataset(dataset_path),
                                  JaxBackgroundMeshOptions(sdf_max_voxels=BUDGET), frames)
    assert size_p == size_j
    np.testing.assert_array_equal(bounds_p, bounds_j)


@pytest.mark.parametrize("use_sparse", [True, False], ids=["sparse", "dense"])
def test_tsdf_fusion_same_mesh(dataset_path, use_sparse):
    want = jax_tsdf_fusion(JaxHiveDataset(dataset_path),
                           JaxBackgroundMeshOptions(sdf_max_voxels=BUDGET),
                           use_sparse=use_sparse)
    profiling = {}
    got = tsdf_fusion(HiveDataset(dataset_path), BackgroundMeshOptions(sdf_max_voxels=BUDGET),
                      use_sparse=use_sparse, profiling=profiling, device="cpu")
    assert len(want.faces) > 1000
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-6, rtol=0)
    stages = profiling["timing"]["background_reconstruction"]
    assert set(stages) == {"voxel_sizing", "volume_init", "integration", "mesh_extraction"}
    assert profiling["background_volume"]["dtype"] == "float32"


def rotated_poses(count, seed=1):
    from scipy.spatial.transform import Rotation

    poses = np.tile(np.eye(4), (count, 1, 1))
    poses[:, :3, :3] = Rotation.random(count, random_state=seed).as_matrix()
    poses[:, :3, 3] = np.random.default_rng(seed).normal(size=(count, 3))
    return poses


def test_world_to_camera_is_hive_tpus_inverse():
    """The integrators' world-to-camera poses are ``jnp.linalg.inv``'s
    float32 inverses bit for bit (``torch.linalg.inv`` rounds rotated poses
    otherwise)."""
    import jax.numpy as jnp

    from hive_tpu_torch.ops.tsdf import world_to_camera

    poses = rotated_poses(500).astype(np.float32)
    want = np.asarray(jnp.linalg.inv(jnp.asarray(poses)))
    np.testing.assert_array_equal(world_to_camera(poses), want)
    np.testing.assert_array_equal(world_to_camera(poses[0]), want[0])


@pytest.mark.parametrize("use_sparse", [True, False], ids=["sparse", "dense"])
def test_fusion_of_rotated_poses_same_mesh(dataset_path, tmp_path, use_sparse):
    """The integrators on the synthetic frames seen from turned cameras: the
    same mesh as hive_tpu's, bit for bit (its pose inverses, and for the
    dense volume its FMA contractions, mirrored)."""
    import shutil

    from scipy.spatial.transform import Rotation

    path = str(tmp_path / "rotated")
    shutil.copytree(dataset_path, path)
    turn = np.eye(4)
    turn[:3, :3] = Rotation.from_euler("xyz", [0.1, 0.2, -0.15]).as_matrix()
    HiveDataset(path).camera_trajectory.apply(turn).save(
        os.path.join(path, HiveDataset.camera_trajectory_filename))
    want = jax_tsdf_fusion(JaxHiveDataset(path), JaxBackgroundMeshOptions(sdf_max_voxels=BUDGET),
                           use_sparse=use_sparse)
    got = tsdf_fusion(HiveDataset(path), BackgroundMeshOptions(sdf_max_voxels=BUDGET),
                      use_sparse=use_sparse, device="cpu")
    assert len(want.faces) > 1000
    for attribute in ("faces", "vertices", "vertex_colors"):
        np.testing.assert_array_equal(getattr(got, attribute), getattr(want, attribute))


def _argv(path, tmp_path, *extra):
    return ["--dataset_path", str(path), "--output_path", str(path), "--background_only",
            "--num_frames", "6", "--key_frame_threshold", "1.0", "--overwrite_ok",
            "--sdf_max_voxels", str(BUDGET), "--webxr_path", str(tmp_path / "webxr"),
            "--log_file", str(tmp_path / "log.txt"), *extra]


def test_pipeline_writes_bg_glb_both_packages_read(dataset_path, tmp_path):
    Pipeline.from_command_line(_argv(dataset_path, tmp_path), device="cpu").run()
    glb = os.path.join(dataset_path, "mesh", "bg.glb")
    ours = next(iter(load_glb(glb).geometry.values()))
    ref = next(iter(jax_load_glb(glb).geometry.values()))
    np.testing.assert_array_equal(ours.vertices, ref.vertices)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_array_equal(ours.vertex_colors, ref.vertex_colors)
    assert len(ours.vertices) > 1000

    # The wall's colour gradients survive: G follows x, B follows y.
    v, c = ours.vertices, ours.vertex_colors.astype(np.float64)
    assert abs(np.corrcoef(v[:, 0], c[:, 1])[0, 1]) > 0.9
    assert abs(np.corrcoef(v[:, 1], c[:, 2])[0, 1]) > 0.9

    with open(os.path.join(dataset_path, "mesh", "metadata.json")) as f:
        assert json.load(f)["num_frames"] == 6
    with open(os.path.join(dataset_path, "profiling.json")) as f:
        profiling = json.load(f)
    assert profiling["frame_count"]["background"] == 1
    assert "integration" in profiling["timing"]["background_reconstruction"]
    assert os.path.isfile(tmp_path / "webxr" / "ds" / "bg.glb")


def test_estimate_depth_on_a_hive_dataset_runs_as_in_hive_tpu(dataset_path, tmp_path):
    """On a folder that is already a HIVE dataset ``--estimate_depth`` only
    concerns conversion, so both CLIs mesh the given depth maps: the same
    bg.glb, and no conversion stage."""
    import shutil
    import sys
    from unittest import mock

    from hive_tpu.pipeline import Pipeline as JaxPipeline

    meshes = {}
    for name in ("jax", "torch"):
        path = str(tmp_path / name)
        shutil.copytree(dataset_path, path)
        argv = _argv(path, tmp_path / name, "--estimate_depth")
        if name == "jax":
            with mock.patch.object(sys, "argv", ["hive", *argv]):
                JaxPipeline.from_command_line().run(compress=False)
        else:
            pipeline = Pipeline.from_command_line(argv, device="cpu")
            pipeline.run(compress=False)
            assert pipeline.options.estimate_depth
            assert "get_depth_maps" not in pipeline.profiling["timing"]["load_dataset"]
        meshes[name] = next(iter(load_glb(os.path.join(path, "mesh", "bg.glb"))
                                 .geometry.values()))
    assert len(meshes["torch"].vertices) > 1000
    for attribute in ("faces", "vertices", "vertex_colors"):
        np.testing.assert_array_equal(getattr(meshes["torch"], attribute),
                                      getattr(meshes["jax"], attribute))


@pytest.mark.parametrize("extra", [["--webxr_run_server"], ["--num_devices", "2"]],
                         ids=["webxr_run_server", "num_devices"])
def test_unported_options_name_their_roadmap_item(dataset_path, tmp_path, extra):
    """Once refused, both options now run. ``--num_devices 2`` on the CPU
    splits the volume over two CPU shards and writes the same ``bg.glb`` as
    ``--num_devices 1``. ``--webxr_run_server`` runs, then starts the
    port's viewer (its ``main`` patched here) on the export folder."""
    import shutil
    from unittest import mock

    from hive_tpu_torch import viewer

    if extra == ["--num_devices", "2"]:
        meshes = {}
        for count in ("1", "2"):
            path = str(tmp_path / count)
            shutil.copytree(dataset_path, path)
            Pipeline.from_command_line(_argv(path, tmp_path / count, "--num_devices", count),
                                       device="cpu").run(compress=False)
            meshes[count] = next(iter(load_glb(os.path.join(path, "mesh", "bg.glb"))
                                      .geometry.values()))
        assert len(meshes["2"].vertices) > 1000
        for attribute in ("faces", "vertices", "vertex_colors"):
            np.testing.assert_array_equal(getattr(meshes["2"], attribute),
                                          getattr(meshes["1"], attribute))
        return
    pipeline = Pipeline.from_command_line(_argv(dataset_path, tmp_path, *extra), device="cpu")
    with mock.patch.object(viewer, "main") as viewer_main:
        pipeline.run(compress=False)
    viewer_main.assert_called_once_with(["--webxr_path", pipeline.webxr_options.webxr_path,
                                         "--port", "8080"])


def test_cli_flag_roster_is_the_jax_packages():
    import argparse

    from hive_tpu import options as jopt
    from hive_tpu_torch import options as topt

    def flags(module):
        parser = argparse.ArgumentParser()
        for name in ("PipelineOptions", "StorageOptions", "MaskDilationOptions",
                     "MeshFilteringOptions", "MeshDecimationOptions", "COLMAPOptions",
                     "BackgroundMeshOptions", "WebXROptions"):
            getattr(module, name).add_args(parser)
        return {a.dest: str(a.default) for a in parser._actions}

    port, ref = flags(topt), flags(jopt)
    # The COLMAP vocabulary file defaults to one path under the user's home in
    # the port; the JAX package names one fixed home.
    assert os.path.basename(port.pop("vocab_path")) == os.path.basename(ref.pop("vocab_path"))
    assert port == ref
