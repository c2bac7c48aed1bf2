"""hive_tpu_torch.scripts.experiments against scripts/experiments.py on the
CPU, with DPT stubbed to the same constant plane in both packages (as
tests/test_experiments.py does) and no LPIPS weights.

Tolerances: ``Latex`` and ``MeanSummary`` outputs and every ``.tex`` file
equal; trajectory metrics within 1e-6; meshes as tests/test_torch_fusion.py
holds them (faces and colours equal, vertices within 1e-6); render-vs-photo
scores as tests/test_torch_render_metrics.py holds them (SSIM within 1e-9,
PSNR equal, LPIPS NaN in both, MIFD within MIFD_RTOL); Telea's inpainted
pixels equal (the port's ``inpaint_telea`` is cv2 5.0.0's bit for bit);
the compressed meshes within the quantizer's bound of the uncompressed
ones (extent / 65535, as tests/test_experiments.py holds hive_tpu's). Every
``Pipeline`` the harness builds gets the options hive_tpu's does.
"""

import enum
import json
import logging
import os
import shutil
import sys
from os.path import join as pjoin

import cv2
import numpy as np
import pytest
import torch

from hive_tpu import metrics as jax_metrics
from hive_tpu.geometric import Trajectory as JaxTrajectory
from hive_tpu.io import HiveDataset as JaxHiveDataset
from hive_tpu.options import BackgroundMeshOptions as JaxBackgroundMeshOptions
from hive_tpu_torch import metrics
from hive_tpu_torch.geometric import Trajectory
from hive_tpu_torch.io import HiveDataset
from hive_tpu_torch.options import BackgroundMeshOptions
from hive_tpu_torch.scripts import experiments
from scripts import experiments as jax_experiments
from tests.helpers import make_synthetic_hive_dataset
from tests.test_data_loaders import make_hypernerf_capture, make_llff_capture

MIFD_RTOL = 0.01


@pytest.fixture(autouse=True)
def no_lpips_weights(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(metrics, "_lpips_models", {})
    monkeypatch.setattr(jax_metrics, "_lpips_model", None)
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "weights"))


@pytest.fixture()
def constant_depth(monkeypatch):
    """DPT replaced in both packages by a constant 2 m plane (uint16 mm)."""
    import hive_tpu.dataset_adaptors as jax_adaptors
    import hive_tpu_torch.dataset_adaptors as adaptors

    def fake_estimate(image_dataset, output_path, **kwargs):
        os.makedirs(output_path, exist_ok=True)
        for i in range(len(image_dataset)):
            h, w = image_dataset[i].shape[:2]
            cv2.imwrite(pjoin(output_path, f"{i:06d}.png"), np.full((h, w), 2000, np.uint16))

    monkeypatch.setattr(jax_adaptors, "estimate_depth_dpt", fake_estimate)
    monkeypatch.setattr(adaptors, "estimate_depth_dpt", fake_estimate)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _assert_scores_close(got, want, metric_names=("ssim", "psnr", "lpips", "mifd")):
    for metric in metric_names:
        g, w = np.atleast_1d(np.asarray(got[metric], float)), np.atleast_1d(
            np.asarray(want[metric], float))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        g, w = g[~np.isnan(w)], w[~np.isnan(w)]
        tolerance = {"ssim": 1e-9, "psnr": 0.0, "lpips": 1e-4 * np.abs(w),
                     "mifd": MIFD_RTOL * np.abs(w)}.get(metric, 0.0)
        assert (np.abs(g - w) <= tolerance).all(), (metric, g, w)


def _assert_meshes_equal(got, want):
    assert len(want.faces) > 50
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Helpers without a device.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    ("format_number", (1234.5678,)), ("format_number", (float("nan"),)),
    ("format_number", (None,)), ("format_number", (3, 3)), ("format_number", (-0.00049, 3)),
    ("to_mean_stddev", ([1.0, 2.5, 4.0],)), ("to_mean_stddev", ([1234.5, 99.1], 1)),
    ("table", (["name", "value"], [["a", "1"], ["b", 2]])),
    ("table", (["Run", "x", "y"], [["r", 1.5, "--"]], "A caption")),
])
def test_latex_matches_hive_tpu(call):
    name, args = call
    assert getattr(experiments.Latex, name)(*args) == getattr(jax_experiments.Latex, name)(*args)


@pytest.mark.parametrize("values", [[], [1.0, 2.0, None, float("nan"), 3.0],
                                    [np.float32(0.1), 7, float("inf"), -2.5]])
def test_mean_summary_matches_hive_tpu(values):
    got, want = experiments.MeanSummary(), jax_experiments.MeanSummary()
    for value in values:
        got.update(value)
        want.update(value)
    assert got.count == want.count
    assert repr(got.mean) == repr(want.mean)


def _trajectories(seed=0, n=20):
    rng = np.random.default_rng(seed)
    gt = np.zeros((n, 7), dtype=np.float32)
    gt[:, 3] = 1.0
    gt[:, 4] = np.linspace(0, 1, n)
    est = gt.copy()
    est[:, 4:] += rng.normal(scale=0.01, size=(n, 3)).astype(np.float32)
    est[:, :3] += rng.normal(scale=0.01, size=(n, 3)).astype(np.float32)
    est[:, :4] /= np.linalg.norm(est[:, :4], axis=1, keepdims=True)
    return gt, est


def test_trajectory_comparisons_match_hive_tpu(tmp_path):
    gt, est = _trajectories()
    got = experiments.run_trajectory_comparisons(
        None, Trajectory(est), Trajectory(gt), str(tmp_path / "port"), device="cpu")
    want = jax_experiments.run_trajectory_comparisons(
        None, JaxTrajectory(est), JaxTrajectory(gt), str(tmp_path / "ref"))
    assert list(got) == list(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-6, key
    with open(tmp_path / "port" / "trajectory_metrics.json") as fh:
        assert json.load(fh) == got
    assert _read(tmp_path / "port" / "trajectories.png") == _read(
        tmp_path / "ref" / "trajectories.png")


def test_trajectory_comparisons_without_matplotlib_warn(tmp_path, monkeypatch, caplog):
    """A machine without matplotlib (the card's) still gets the metrics."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    gt, est = _trajectories(1)
    with caplog.at_level(logging.WARNING):
        got = experiments.run_trajectory_comparisons(
            None, Trajectory(est), Trajectory(gt), str(tmp_path), device="cpu")
    assert got["ate_rmse"] > 0
    assert os.listdir(tmp_path) == ["trajectory_metrics.json"]
    assert "Trajectory plot skipped" in caplog.text


# ---------------------------------------------------------------------------
# Fusion from COLMAP depth.
# ---------------------------------------------------------------------------

def test_tsdf_fusion_with_colmap_matches_hive_tpu(tmp_path):
    path = make_synthetic_hive_dataset(tmp_path / "ds", num_frames=3, with_object=False)
    colmap_dir = tmp_path / "ds" / "colmap_depth"
    os.makedirs(colmap_dir)
    rng = np.random.default_rng(3)
    # One frame short (a COLMAP drop-out), named by true frame index, with a
    # stray file that is no frame.
    for i in (0, 2):
        depth = (1800 + rng.integers(-20, 20, (96, 128))).astype(np.uint16)
        cv2.imwrite(pjoin(str(colmap_dir), f"{i:06d}.png"), depth)
    cv2.imwrite(pjoin(str(colmap_dir), "notes.png"), np.zeros((96, 128), np.uint16))
    options = dict(sdf_voxel_size=0.04, sdf_max_voxels=2_000_000)

    dataset = HiveDataset(path)
    got = experiments.tsdf_fusion_with_colmap(dataset, [0, 1, 2],
                                              BackgroundMeshOptions(**options), device="cpu")
    want = jax_experiments.tsdf_fusion_with_colmap(JaxHiveDataset(path), [0, 1, 2],
                                                   JaxBackgroundMeshOptions(**options))
    _assert_meshes_equal(got, want)
    assert abs(np.median(got.vertices[:, 2]) - 1.8) < 0.1
    # The depth source is restored.
    assert np.median(dataset.depth_dataset[0]) == pytest.approx(2.0)


@pytest.mark.parametrize("layout", ["no_folder", "no_frame_names"])
def test_tsdf_fusion_with_colmap_returns_none_as_hive_tpu(tmp_path, layout):
    path = make_synthetic_hive_dataset(tmp_path / "ds", num_frames=2)
    if layout == "no_frame_names":
        os.makedirs(tmp_path / "ds" / "colmap_depth")
        cv2.imwrite(str(tmp_path / "ds" / "colmap_depth" / "x.png"),
                    np.zeros((96, 128), np.uint16))
    assert experiments.tsdf_fusion_with_colmap(
        HiveDataset(path), [0, 1], BackgroundMeshOptions(), device="cpu") is None
    assert jax_experiments.tsdf_fusion_with_colmap(
        JaxHiveDataset(path), [0, 1], JaxBackgroundMeshOptions()) is None


# ---------------------------------------------------------------------------
# Render-vs-photo experiments.
# ---------------------------------------------------------------------------

def _harnesses(tmp_path, **kwargs):
    port = experiments.Experiments(data_path=str(tmp_path), output_path=str(tmp_path / "port"),
                                   dataset_names=[], device="cpu", **kwargs)
    ref = jax_experiments.Experiments(data_path=str(tmp_path),
                                      output_path=str(tmp_path / "ref"), dataset_names=[],
                                      **kwargs)
    return port, ref


@pytest.mark.parametrize("group", ["llff", "hypernerf"])
def test_render_experiment_matches_hive_tpu(tmp_path, constant_depth, group):
    port, ref = _harnesses(tmp_path)
    if group == "llff":
        capture = make_llff_capture(tmp_path / "capture")
        got = port.run_llff_experiments(capture, sdf_max_voxels=200_000)
        want = ref.run_llff_experiments(capture, sdf_max_voxels=200_000)
    else:
        capture = make_hypernerf_capture(tmp_path / "capture")
        got = port.run_hypernerf_experiments(capture, sdf_max_voxels=200_000)
        want = ref.run_hypernerf_experiments(capture, sdf_max_voxels=200_000)
    assert set(got) == set(want) and set(got["mean"]) == {"ssim", "psnr", "lpips", "mifd"}
    _assert_scores_close(got, want)
    _assert_scores_close(got["mean"], want["mean"])
    assert got["skipped"] == want["skipped"]
    for side in ("port", "ref"):
        out = tmp_path / side / group
        assert os.path.isfile(out / "reconstruction.ply")
        assert os.path.isfile(out / f"{group}_metrics.json")
    assert sorted(os.listdir(tmp_path / "port" / group / "renders")) == sorted(
        os.listdir(tmp_path / "ref" / group / "renders"))
    for sub in ("rgb", "depth", "mask"):
        names = sorted(os.listdir(tmp_path / "ref" / group / "dataset" / sub))
        assert sorted(os.listdir(tmp_path / "port" / group / "dataset" / sub)) == names
    for name in ("camera_matrix.txt", "camera_trajectory.txt"):
        assert _read(tmp_path / "port" / group / "dataset" / name) == _read(
            tmp_path / "ref" / group / "dataset" / name)
    metadata = {}
    for side in ("port", "ref"):
        with open(tmp_path / side / group / "dataset" / "metadata.json") as fh:
            metadata[side] = json.load(fh)
        # The COLMAP vocabulary's default folder differs by design (the
        # port's lies under the home folder).
        metadata[side]["colmap_options"].pop("vocab_path")
    assert metadata["port"] == metadata["ref"]


def _write_cached_metrics(root, group, names, filename):
    for i, name in enumerate(names):
        folder = pjoin(root, group, name)
        os.makedirs(folder, exist_ok=True)
        result = {"mean": {"ssim": 0.5 + 0.1 * i, "psnr": 20.0 + i,
                           "lpips": float("nan"), "mifd": 3.0 + 1.234 * i}}
        if i != 1:
            result["skipped"] = {"lpips": "skipped: weights absent"}
        with open(pjoin(folder, filename), "w") as fh:
            json.dump(result, fh)


@pytest.mark.parametrize("group", ["llff", "hypernerf"])
def test_multi_sequence_rollups_match_hive_tpu(tmp_path, group):
    names = ["fern", "trex", "horns"] if group == "llff" else ["broom", "3dprinter"]
    for side in ("port", "ref"):
        _write_cached_metrics(str(tmp_path / side), group, names, f"{group}_metrics.json")
    port, ref = _harnesses(tmp_path)
    if group == "llff":
        got = port.run_llff_experiments(str(tmp_path), sequence_names=names)
        want = ref.run_llff_experiments(str(tmp_path), sequence_names=names)
    else:
        got = port.run_hypernerf_experiments(str(tmp_path), scene_names=names)
        want = ref.run_hypernerf_experiments(str(tmp_path), scene_names=names)
    assert json.dumps(got) == json.dumps(want)
    for name in (f"{group}_results.tex", f"{group}_results.json"):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "ref" / name)
    assert "skipped: weights absent" in _read(tmp_path / "port" / f"{group}_results.tex").decode()


# ---------------------------------------------------------------------------
# Mesh compression matrix and inpainting.
# ---------------------------------------------------------------------------

def _converted(tmp_path, side, num_frames=2):
    converted = tmp_path / side / "ds" / "gt" / "dataset"
    os.makedirs(converted.parent, exist_ok=True)
    return make_synthetic_hive_dataset(converted, num_frames=num_frames)


def test_mesh_compression_matrix_matches_hive_tpu(tmp_path, monkeypatch, recorded_pipelines):
    from hive_tpu.meshing.gltf import load_glb as jax_load_glb
    from hive_tpu_torch.meshing.gltf import load_glb

    monkeypatch.setattr(shutil, "which", lambda name: None)
    for side in ("port", "ref"):
        _converted(tmp_path, side)
    options = dict(sdf_voxel_size=0.04, sdf_max_voxels=2_000_000)
    got = experiments.Experiments(
        data_path=str(tmp_path), output_path=str(tmp_path / "port"), dataset_names=["ds"],
        num_frames=2, device="cpu").run_mesh_compression_experiments(
        configs=["gt"], mesh_options=BackgroundMeshOptions(**options))
    want = jax_experiments.Experiments(
        data_path=str(tmp_path), output_path=str(tmp_path / "ref"), dataset_names=["ds"],
        num_frames=2).run_mesh_compression_experiments(
        configs=["gt"], mesh_options=JaxBackgroundMeshOptions(**options))

    assert set(got) == set(want) == {"ds/gt", "mean"}
    assert set(got["ds/gt"]) == set(want["ds/gt"]) == {"fg", "bg", "render_comparison"}
    base = tmp_path / "port" / "ds" / "compression" / "gt"
    ref_base = tmp_path / "ref" / "ds" / "compression" / "gt"
    for name in ("fg", "bg"):
        g, w = got["ds/gt"][name], want["ds/gt"][name]
        assert g["method"] == w["method"] == "quantization"
        # The files differ only by the glTF generator's name and the
        # texture's PNG encoder (the port's zlib stream, fg only): a few
        # bytes in 25 kB.
        for key in ("uncompressed_file_size", "compressed_file_size", "compression_ratio"):
            assert abs(g[key] - w[key]) <= 1e-3 * w[key], (name, key)
        for folder in ("mesh_uncompressed", "mesh_compressed"):
            mesh = next(iter(load_glb(str(base / folder / f"{name}.glb")).geometry.values()))
            ref = next(iter(jax_load_glb(str(ref_base / folder / f"{name}.glb")
                                         ).geometry.values()))
            for attribute in ("vertices", "faces", "vertex_colors", "uv", "texture"):
                got_value, want_value = getattr(mesh, attribute), getattr(ref, attribute)
                assert (got_value is None) == (want_value is None), attribute
                if want_value is not None:
                    np.testing.assert_array_equal(got_value, want_value, err_msg=attribute)
    _assert_scores_close(got["ds/gt"]["render_comparison"], want["ds/gt"]["render_comparison"],
                         ("ssim", "psnr"))
    raw = next(iter(load_glb(str(base / "mesh_uncompressed" / "bg.glb")).geometry.values()))
    packed = next(iter(load_glb(str(base / "mesh_compressed" / "bg.glb")).geometry.values()))
    extent = (raw.vertices.max(axis=0) - raw.vertices.min(axis=0)).max()
    np.testing.assert_allclose(packed.vertices[packed.faces], raw.vertices[raw.faces],
                               atol=extent / 65535 * 0.51)
    assert got["mean"].keys() == want["mean"].keys()
    assert [_options(p, str(tmp_path / "port")) for p in recorded_pipelines["port"]] == [
        _options(p, str(tmp_path / "ref")) for p in recorded_pipelines["ref"]]
    assert len(recorded_pipelines["port"]) == 1
    for side in ("port", "ref"):
        assert os.path.isfile(tmp_path / side / "mesh_compression_results.json")
        assert sorted(os.listdir(tmp_path / side / "ds" / "compression" / "gt")) == [
            "logs.log", "mesh_compressed", "mesh_compressed.png", "mesh_uncompressed",
            "mesh_uncompressed.png"]


def test_inpainting_experiment_matches_hive_tpu(tmp_path, monkeypatch):
    from hive_tpu_torch import image_processing

    inpainted = {"port": [], "ref": []}
    telea, cv2_inpaint = image_processing.inpaint_telea, cv2.inpaint

    def port_telea(image, hole, radius):
        inpainted["port"].append(telea(image, hole, radius))
        return inpainted["port"][-1]

    def ref_inpaint(image, hole, radius, flags):
        out = cv2_inpaint(image, hole, radius, flags)
        inpainted["ref"].append(out[..., ::-1] if out.ndim == 3 else out)
        return out

    monkeypatch.setattr(image_processing, "inpaint_telea", port_telea)
    monkeypatch.setattr(cv2, "inpaint", ref_inpaint)
    path = make_synthetic_hive_dataset(tmp_path / "ds", num_frames=3)
    got = experiments.InpaintingExperiment(HiveDataset(path), str(tmp_path / "port"),
                                           device="cpu").run(num_frames=2)
    want = jax_experiments.InpaintingExperiment(JaxHiveDataset(path),
                                                str(tmp_path / "ref")).run(num_frames=2)
    assert len(inpainted["port"]) == len(inpainted["ref"]) == 4
    for g, w in zip(inpainted["port"], inpainted["ref"]):
        np.testing.assert_array_equal(g, w)
    assert list(got) == list(want)
    _assert_scores_close(got, want, list(want))
    with open(tmp_path / "port" / "inpainting_metrics.json") as fh:
        port_json = json.load(fh)
    with open(tmp_path / "ref" / "inpainting_metrics.json") as fh:
        ref_json = json.load(fh)
    assert port_json["skipped"] == ref_json["skipped"] == {"lpips": "skipped: weights absent"}
    _assert_scores_close(port_json["per_frame"], ref_json["per_frame"], list(want))


# ---------------------------------------------------------------------------
# The pipelines the harness builds, the BundleFusion skip and main().
# ---------------------------------------------------------------------------

def _plain(value):
    if isinstance(value, enum.Enum):
        return type(value).__name__, value.name
    if hasattr(value, "__dict__"):
        return {k: _plain(v) for k, v in vars(value).items()}
    return value


OPTION_GROUPS = ("options", "storage_options", "colmap_options", "decimation_options",
                 "dilation_options", "filtering_options", "background_mesh_options",
                 "webxr_options")


@pytest.fixture()
def recorded_pipelines(monkeypatch):
    """Both packages' ``Pipeline`` recorded as built, with ``run`` mocked to
    write a profiling.json naming its run."""
    import hive_tpu.pipeline as jax_pipeline
    import hive_tpu_torch.pipeline as pipeline

    built = {"port": [], "ref": []}
    for side, module in (("port", pipeline), ("ref", jax_pipeline)):
        def record(self, *args, _init=module.Pipeline.__init__, _side=side, **kwargs):
            _init(self, *args, **kwargs)
            built[_side].append(self)

        def run(self):
            output = self.storage_options.output_path
            os.makedirs(output, exist_ok=True)
            with open(pjoin(output, "profiling.json"), "w") as fh:
                json.dump({"elapsed_time": {"total": 1.5, "per_frame": 0.05},
                           "run": os.path.basename(os.path.dirname(output))}, fh)

        monkeypatch.setattr(module.Pipeline, "__init__", record)
        monkeypatch.setattr(module.Pipeline, "run", run)
    return built


def _options(pipeline, root: str) -> dict:
    """A pipeline's option groups as plain values, paths relative to the
    harness's root folder."""
    groups = {}
    for group in OPTION_GROUPS:
        options = _plain(getattr(pipeline, group))
        for key, value in options.items():
            if isinstance(value, str) and value.startswith(root):
                options[key] = os.path.relpath(value, root)
        if "vocab_path" in options:
            # The COLMAP vocabulary's default folder differs by design.
            options["vocab_path"] = os.path.basename(options["vocab_path"])
        groups[group] = options
    return groups


def test_pipelines_get_hive_tpu_options(tmp_path, recorded_pipelines, monkeypatch):
    for side in ("port", "ref"):
        os.makedirs(tmp_path / side / "data" / "ds", exist_ok=True)
    got = experiments.Experiments(data_path=str(tmp_path / "port" / "data"),
                                  output_path=str(tmp_path / "port" / "out"),
                                  dataset_names=["ds"], num_frames=30, frame_step=15,
                                  device="cpu")
    want = jax_experiments.Experiments(data_path=str(tmp_path / "ref" / "data"),
                                       output_path=str(tmp_path / "ref" / "out"),
                                       dataset_names=["ds"], num_frames=30, frame_step=15)
    got_profiling = got.run_pipeline_experiments()
    assert got_profiling == want.run_pipeline_experiments()
    assert list(got_profiling["ds"]) == ["gt", "cm", "est"]
    assert _read(tmp_path / "port" / "out" / "pipeline_profiling.json") == _read(
        tmp_path / "ref" / "out" / "pipeline_profiling.json")
    # Cached runs are skipped: no new pipeline.
    assert got.run_pipeline_experiments() == got_profiling
    assert len(recorded_pipelines["port"]) == 3
    assert got.run_kid_running_experiments("clip.mp4") == \
        want.run_kid_running_experiments("clip.mp4")
    assert [_options(p, str(tmp_path / "port")) for p in recorded_pipelines["port"]] == [
        _options(p, str(tmp_path / "ref")) for p in recorded_pipelines["ref"]]
    assert all(p.device == torch.device("cpu") for p in recorded_pipelines["port"])
    assert [p.options.estimate_pose for p in recorded_pipelines["port"]] == [
        False, True, True, True]


def test_bundlefusion_without_binary_returns_empty_as_hive_tpu(tmp_path, monkeypatch, caplog):
    monkeypatch.delenv("BUNDLE_FUSION_BIN", raising=False)
    port, ref = _harnesses(tmp_path)
    with caplog.at_level(logging.WARNING):
        assert port.run_bundlefusion_experiments() == ref.run_bundlefusion_experiments() == {}
    assert caplog.text.count("BUNDLE_FUSION_BIN not set") == 2


PROFILING = {
    "tum": {
        "gt": {"elapsed_time": {"total": 12.3456, "per_frame": 0.41152},
               "peak_ram_usage": 3.2e9, "peak_vram_usage": {"allocated": 7029718528},
               "mesh_tri_count": {"total": 11434070.0},
               "mesh_compression": {
                   "background": {"uncompressed_file_size": 284e6,
                                  "compressed_file_size": 97.5e6, "compression_ratio": 2.9128,
                                  "data_saving": 0.65669},
                   "foreground": {"error": "no draco"}}},
        "cm": {"elapsed_time": {"total": None}, "mesh_compression": {
            "foreground": {"uncompressed_file_size": 1234567, "compressed_file_size": 456789,
                           "compression_ratio": 2.70275, "data_saving": 0.63}}},
    },
    "other": {"est": {}},
}


def test_main_export_and_compression_match_hive_tpu(tmp_path, monkeypatch, capsys):
    sides = {}
    for side in ("port", "ref"):
        out = tmp_path / side / "fresh"
        os.makedirs(out)
        with open(out / "pipeline_profiling.json", "w") as fh:
            json.dump(PROFILING, fh)
        sides[side] = ["--data_path", str(tmp_path), "--output_path", str(out),
                       "--dataset_names", "tum", "other", "--experiments", "export",
                       "compression"]
    experiments.main(sides["port"], device="cpu")
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["experiments.py", *sides["ref"]])
    jax_experiments.main()
    want = capsys.readouterr().out
    assert got == want and "tum/gt" in got and "tum/cm/foreground" in got
    for name in ("pipeline_results.tex", "compression_results.tex"):
        assert _read(tmp_path / "port" / "fresh" / name) == _read(
            tmp_path / "ref" / "fresh" / name)
    assert os.path.isfile(tmp_path / "port" / "fresh" / "experiments.log")


def test_main_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiments.main(["--data_path", str(tmp_path), "--output_path", str(tmp_path / "o"),
                          "--dataset_names", "x", "--experiments", "export"])
