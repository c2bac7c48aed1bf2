"""hive_tpu_torch stands alone: it (and chip_smoke.py) imports neither JAX nor
hive_tpu, its entry points run on the card unless the CPU is asked for, and
its kernel wrappers take their plain versions only for CPU tensors."""

import importlib
import itertools
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import hive_tpu_torch
from hive_tpu_torch.ops import (band_sampler, band_update, classify_blocks, fused_band,
                                ordered_hist, patch_gather, tile_gather)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hive_tpu_torch")


def _port_modules():
    return sorted(name for _, name, _ in pkgutil.walk_packages([PORT], "hive_tpu_torch."))


def _port_sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


# What the card's machine lacks besides JAX: the port must run without them.
MISSING_ON_CARD_MACHINE = ("PIL", "cv2", "imageio", "tqdm", "transformers", "timm",
                           "torchvision")


def test_imports_with_jax_and_hive_tpu_blocked(tmp_path):
    """With JAX, hive_tpu and the packages the card's machine lacks blocked,
    every module imports, and a tiny full pipeline (foreground included, on
    the CPU) writes and compresses an fg.glb that loads back."""
    from tests.helpers import make_synthetic_hive_dataset

    dataset = make_synthetic_hive_dataset(tmp_path / "ds", num_frames=3, width=64, height=48)
    argv = ["--dataset_path", dataset, "--output_path", dataset, "--num_frames", "3",
            "--key_frame_threshold", "1.0", "--overwrite_ok", "--sdf_max_voxels", "100000",
            "--webxr_path", str(tmp_path / "webxr"), "--log_file", str(tmp_path / "log.txt")]
    blocked = ("jax", "hive_tpu") + MISSING_ON_CARD_MACHINE
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for name in {_port_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(name)\n"
            "from hive_tpu_torch.meshing.gltf import load_glb\n"
            "from hive_tpu_torch.pipeline import Pipeline\n"
            f"pipeline = Pipeline.from_command_line({argv!r}, device='cpu')\n"
            "pipeline.run()\n"
            "stats = pipeline.profiling['mesh_compression']\n"
            "assert stats['foreground']['method'] == 'quantization', stats\n"
            "assert stats['background']['method'] == 'quantization', stats\n"
            f"scene = load_glb({dataset!r} + '/mesh/fg.glb')\n"
            "assert scene.node_names == ['000000', '000001', '000002'], scene.node_names\n"
            "assert all(m.texture is not None and m.num_faces > 0\n"
            "           for m in scene.geometry.values())\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib')) or m == 'hive_tpu'\n"
            "               or m.startswith('hive_tpu.') for m in sys.modules\n"
            "               if sys.modules[m] is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_blocked_import_check_covers_the_evaluation_path():
    """The JAX-blocked import above walks every module of the package; the
    evaluation path's and the player's are among them."""
    modules = set(_port_modules())
    for name in ("metrics", "meshing.render", "data.llff", "data.hypernerf", "viewer",
                 "viewer.__main__", "interface"):
        assert f"hive_tpu_torch.{name}" in modules, name


def test_blocked_import_check_covers_the_video_modules():
    """The JAX-blocked import above walks the video input's modules too:
    none may need cv2, Pillow or imageio, which the card's machine lacks."""
    modules = set(_port_modules())
    for name in ("video.mp4", "video.h264_bits", "video.h264", "video.mpeg4", "video.nvdec",
                 "video.color", "video.capture", "video.mjpeg"):
        assert f"hive_tpu_torch.{name}" in modules, name


def test_blocked_import_check_covers_the_research_entry_points():
    """The JAX-blocked import above walks the research entry points and the
    CMU Panoptic loader too: none may need cv2, Pillow or imageio."""
    modules = set(_port_modules())
    for name in ("dataset", "scripts", "scripts.compare_image_pair",
                 "scripts.compare_image_pairs", "scripts.experiments"):
        assert f"hive_tpu_torch.{name}" in modules, name


def test_research_entry_points_with_missing_packages_blocked(tmp_path):
    """With JAX, hive_tpu, matplotlib and the packages the card's machine
    lacks blocked: both comparison CLIs score PNG / JPEG files the port
    wrote, the experiments CLI exports its tables from cached profiling, a
    trajectory comparison writes its metrics (its plot skipped with a
    warning), and the CMU Panoptic loader reads a synced pair."""
    from chip_smoke import write_panoptic_capture
    from hive_tpu_torch.image_codecs import write_image

    rng = np.random.default_rng(6)
    for folder, shift in (("a", 0), ("b", 3)):
        os.makedirs(tmp_path / folder)
        base = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8) if shift == 0 else base
        write_image(str(tmp_path / folder / "0.png"), np.roll(base, shift, axis=1))
        write_image(str(tmp_path / folder / "1.jpg"), np.roll(base, shift, axis=0))
    out = tmp_path / "experiments"
    os.makedirs(out)
    with open(out / "pipeline_profiling.json", "w") as fh:
        fh.write('{"tum": {"gt": {"elapsed_time": {"total": 3.5, "per_frame": 0.1}, '
                 '"mesh_compression": {"background": {"uncompressed_file_size": 2e6, '
                 '"compressed_file_size": 1e6, "compression_ratio": 2.0, '
                 '"data_saving": 0.5}}}}}')
    capture = tmp_path / "kinoptic"
    os.makedirs(capture)
    write_panoptic_capture(str(capture), size=(60, 80), hd=range(1, 3), nodes=2, loaded=(1, 2))
    blocked = ("jax", "hive_tpu", "matplotlib") + MISSING_ON_CARD_MACHINE
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import numpy as np\n"
            "from hive_tpu_torch.dataset import CMUPanopticDataset\n"
            "from hive_tpu_torch.geometric import Trajectory\n"
            "from hive_tpu_torch.scripts import compare_image_pair, compare_image_pairs, "
            "experiments\n"
            f"a, b = {str(tmp_path / 'a')!r}, {str(tmp_path / 'b')!r}\n"
            "compare_image_pair.main([a + '/0.png', b + '/0.png', '--json'], device='cpu')\n"
            "compare_image_pairs.main([a, b, '--latex'], device='cpu')\n"
            f"experiments.main(['--data_path', {str(tmp_path)!r}, '--output_path', "
            f"{str(out)!r}, '--dataset_names', 'tum', '--experiments', 'export', "
            "'compression'], device='cpu')\n"
            "values = np.zeros((5, 7)); values[:, 3] = 1; values[:, 4] = np.arange(5)\n"
            "moved = values.copy(); moved[:, 5] = 0.01 * np.arange(5) ** 2\n"
            "metrics = experiments.run_trajectory_comparisons(None, Trajectory(moved), "
            f"Trajectory(values), {str(tmp_path / 'trajectory')!r}, device='cpu')\n"
            "assert metrics['ate_rmse'] > 0, metrics\n"
            f"image, depth = CMUPanopticDataset({str(capture)!r}).get_synced_frame_data(2, 1)\n"
            "assert image.shape == (60, 80, 3) and depth.shape == (424, 512), image.shape\n"
            "print('ok')\n")
    env = dict(os.environ, WEIGHTS_PATH=str(tmp_path / "no_weights"))
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-4000:]
    lines = done.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert '"lpips": null' in lines[0] and '"skipped": {"lpips": "skipped: weights absent"}' in \
        lines[0]
    assert r"\begin{tabular}{lrrrr}" in lines and r"\begin{tabular}{lrrrrr}" in lines
    assert sorted(os.listdir(out)) == ["compression_results.tex", "experiments.log",
                                       "pipeline_profiling.json", "pipeline_results.tex"]
    assert os.listdir(tmp_path / "trajectory") == ["trajectory_metrics.json"]
    assert "Trajectory plot skipped" in done.stderr + done.stdout


def test_sources_import_nothing_of_jax_or_hive_tpu():
    """Nor Pillow, OpenCV, imageio, transformers, timm or torchvision, which
    the card's machine lacks."""
    banned = re.compile(r"^\s*(import\s+(jax|jaxlib|optax|hive_tpu)\b(?!_torch)"
                        r"|from\s+(jax|jaxlib|optax|hive_tpu)\b(?!_torch)"
                        r"|(import|from)\s+(PIL|cv2|imageio|transformers|timm|torchvision)\b)",
                        re.MULTILINE)
    offenders = [path for path in _port_sources() if banned.search(open(path).read())]
    assert offenders == []


def test_every_module_imports_here():
    for name in _port_modules():
        importlib.import_module(name)


def test_device_helper_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hive_tpu_torch.get_device()
    with pytest.raises(RuntimeError):
        hive_tpu_torch.get_device("cuda:0")
    assert hive_tpu_torch.get_device("cpu") == torch.device("cpu")
    assert hive_tpu_torch.get_device(torch.device("cpu")).type == "cpu"


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from hive_tpu_torch.models.segmentation import PersonSegmenter
    from hive_tpu_torch.ops.tsdf import TSDFVolume
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    bounds = np.array([[0, 1], [0, 1], [0, 1]], np.float32)
    for cls in (SparseTSDFVolume, TSDFVolume):
        with pytest.raises(RuntimeError):
            cls(bounds, voxel_size=0.25)
        assert cls(bounds, voxel_size=0.25, device="cpu").state.tsdf.device.type == "cpu"
    with pytest.raises(RuntimeError):
        PersonSegmenter()
    assert PersonSegmenter(device="cpu")._classical.device.type == "cpu"

    from hive_tpu_torch.pose_optimisation import ForegroundPoseOptimiser, PoseOptimiser

    for cls in (PoseOptimiser, ForegroundPoseOptimiser):
        with pytest.raises(RuntimeError):
            cls(None)
        assert cls(None, device="cpu").device.type == "cpu"


def test_conversion_with_missing_packages_blocked(tmp_path):
    """The CLI converts a TUM folder (PNG frames in, JPEG frames and motion
    masks out) with JAX, hive_tpu, Pillow, OpenCV, imageio and tqdm blocked,
    then reads its own JPEG frames back."""
    from chip_smoke import write_tum_dataset

    tum = str(tmp_path / "tum")
    write_tum_dataset(tum, num_frames=4, width=64, height=48)
    out = str(tmp_path / "out")
    argv = ["--dataset_path", tum, "--output_path", out, "--num_frames", "4",
            "--key_frame_threshold", "1.0", "--sdf_max_voxels", "100000", "--background_only",
            "--webxr_path", str(tmp_path / "webxr"), "--log_file", str(tmp_path / "log.txt")]
    blocked = ("jax", "hive_tpu") + MISSING_ON_CARD_MACHINE
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "from hive_tpu_torch.io import HiveDataset\n"
            "from hive_tpu_torch.pipeline import Pipeline\n"
            f"pipeline = Pipeline.from_command_line({argv!r}, device='cpu')\n"
            "pipeline.run()\n"
            f"dataset = HiveDataset({out!r})\n"
            "assert dataset.rgb_dataset.image_filenames[0] == '000000.jpg'\n"
            "assert dataset.rgb_dataset[3].shape == (48, 64, 3)\n"
            "assert dataset.mask_dataset[3].shape == (48, 64)\n"
            "assert set(pipeline.profiling['timing']['load_dataset']) >= {'copy_frames',\n"
            "    'create_instance_segmentation_masks', 'get_depth_maps'}\n"
            "print('ok')\n")
    env = dict(os.environ, WEIGHTS_PATH=str(tmp_path / "no_weights"))
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-4000:]
    assert done.stdout.strip().splitlines()[-1] == "ok"


def test_pose_paths_with_missing_packages_blocked(tmp_path):
    """With JAX, optax, hive_tpu, OpenCV and Pillow blocked, the CLI converts
    a moving TUM folder with --estimate_pose through a stand-in ``colmap``
    and meshes it with --fts_num_epochs; PoseOptimiser runs from a cached
    feature set and checkpoints; and with no COLMAP binary a textured
    wall's TUM folder converts through the PnP odometry and its features
    are extracted from the frames (both refused here before)."""
    from chip_smoke import wall_trajectory, write_colmap_stand_in, write_wall_tum
    from hive_tpu_torch.dataset_adaptors import TUMAdaptor
    from tests.test_adaptors import make_tum_dataset

    wall = str(tmp_path / "wall")
    write_wall_tum(wall, 4, 160, 120, wall_trajectory(4))
    tum = make_tum_dataset(tmp_path / "tum", num_frames=4)
    poses = TUMAdaptor(tum, str(tmp_path / "unused")).camera_trajectory.values
    K = np.array([[58.0, 0, 31.5], [0, 58.0, 23.5], [0, 0, 1]])
    stand_in = write_colmap_stand_in(str(tmp_path / "bin"), poses, K, (64, 48), depth=1.0,
                                     frame_step=15)
    out = str(tmp_path / "out")
    argv = ["--dataset_path", tum, "--output_path", out, "--estimate_pose", "--binary_path",
            stand_in, "--fts_num_epochs", "3", "--key_frame_threshold", "1.0",
            "--sdf_max_voxels", "100000", "--webxr_path", str(tmp_path / "webxr"),
            "--log_file", str(tmp_path / "log.txt")]
    blocked = ("jax", "optax", "hive_tpu") + MISSING_ON_CARD_MACHINE
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import numpy as np\n"
            "from hive_tpu_torch import pose_optimisation as P\n"
            "from hive_tpu_torch.dataset_adaptors import TUMAdaptor\n"
            "from hive_tpu_torch.io import HiveDataset\n"
            "from hive_tpu_torch.options import COLMAPOptions\n"
            "from hive_tpu_torch.pipeline import Pipeline\n"
            f"pipeline = Pipeline.from_command_line({argv!r}, device='cpu')\n"
            "pipeline.run()\n"
            "assert pipeline.profiling['timing']['stages_overlapped'] is False\n"
            f"dataset = HiveDataset({out!r})\n"
            "assert dataset.metadata.estimate_pose and dataset.num_frames == 4\n"
            "steps = np.diff(dataset.camera_trajectory.positions, axis=0)\n"
            "assert np.allclose(np.abs(steps[:, 0]), 0.01, atol=1e-6), steps\n"
            "rng = np.random.default_rng(0)\n"
            "features = P.FeatureSet(dataset.camera_matrix, P.FeatureData(\n"
            "    np.zeros(30, np.int64), rng.uniform(5, 40, (30, 2)).astype(np.float32),\n"
            "    np.ones(30, np.float32)), P.FeatureData(np.ones(30, np.int64),\n"
            "    rng.uniform(5, 40, (30, 2)).astype(np.float32), np.ones(30, np.float32)))\n"
            "options = P.OptimisationOptions(num_epochs=50, checkpoint_dir="
            f"{str(tmp_path / 'ckpt')!r}, checkpoint_every_chunks=1)\n"
            "optimiser = P.PoseOptimiser(dataset, optimisation_options=options, device='cpu')\n"
            "params = optimiser._optimisation_loop(features, optimiser._init_params(\n"
            "    dataset.camera_trajectory.values), options, P.ResidualType.World3D)\n"
            "assert params['t'].shape == (4, 3)\n"
            "import torch\n"
            "torch.set_num_threads(1)  # the feature stages' small ops, beside other workers\n"
            "adaptor = TUMAdaptor(" f"{wall!r}, {str(tmp_path / 'pnp')!r}, colmap_options="
            f"COLMAPOptions(binary_path={str(tmp_path / 'none')!r}))\n"
            "from hive_tpu_torch.options import InpaintingMode\n"
            "posed = adaptor.convert(True, False, InpaintingMode.Off, device='cpu')\n"
            "assert posed.metadata.estimate_pose and len(posed.camera_trajectory) == 4\n"
            "assert np.abs(posed.camera_trajectory.positions[1:]).max() > 1e-3\n"
            "pairs = P.sample_frame_pairs(P.FrameSamplingMode.Consecutive, 4)\n"
            "found = P.FeatureExtractor(posed, pairs, device='cpu').extract_feature_points()\n"
            "assert len(found) > 0\n"
            "print('ok')\n")
    env = dict(os.environ, WEIGHTS_PATH=str(tmp_path / "no_weights"))
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-4000:]
    assert done.stdout.strip().splitlines()[-1] == "ok"
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_000000025.npz", "step_000000050.npz"]
    assert os.path.isfile(tmp_path / "pnp" / "camera_trajectory.txt")


@pytest.mark.parametrize("mode", [1, 2])
def test_inpainting_with_missing_packages_blocked(tmp_path, mode):
    """The CLI converts a TUM folder with ``--inpainting_mode`` 1 (TELEA for
    both) and 2 (LaMa for RGB, with a small generator's check weights as
    ``$WEIGHTS_PATH/big-lama.npz``) with JAX, hive_tpu and the packages
    the card's machine lacks blocked: the three inpainted folders hold a
    frame each, the masks there are blacked out."""
    from chip_smoke import write_tum_dataset
    from hive_tpu_torch.models import lama

    tum = str(tmp_path / "tum")
    write_tum_dataset(tum, num_frames=10, width=64, height=48)
    weights = tmp_path / "weights"
    weights.mkdir()
    small = dict(base_features=8, num_downsamples=2, num_blocks=2)
    if mode == 2:
        np.savez(weights / "big-lama.npz", **lama.check_params(0, **small))
    out = str(tmp_path / "out")
    argv = ["--dataset_path", tum, "--output_path", out, "--num_frames", "10",
            "--inpainting_mode", str(mode), "--key_frame_threshold", "1.0", "--sdf_max_voxels",
            "100000", "--background_only", "--webxr_path", str(tmp_path / "webxr"),
            "--log_file", str(tmp_path / "log.txt")]
    blocked = ("jax", "hive_tpu") + MISSING_ON_CARD_MACHINE
    code = ("import functools, os, sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "from hive_tpu_torch.io import HiveDataset, load_image\n"
            "from hive_tpu_torch.models import lama\n"
            "from hive_tpu_torch.pipeline import Pipeline\n"
            f"lama.LamaGenerator = functools.partial(lama.LamaGenerator, **{small!r})\n"
            f"pipeline = Pipeline.from_command_line({argv!r}, device='cpu')\n"
            "pipeline.run()\n"
            f"dataset = HiveDataset({out!r})\n"
            "assert dataset.has_inpainted_frame_data\n"
            "for folder in ('rgb_inpainted', 'depth_inpainted', 'mask_inpainted'):\n"
            f"    assert len(os.listdir(os.path.join({out!r}, folder))) == 10, folder\n"
            f"mask = load_image(os.path.join({out!r}, 'mask_inpainted', '000009.png'))\n"
            "assert mask.shape == (48, 64) and not mask.any()\n"
            "assert pipeline.profiling['timing']['load_dataset']['inpainting'] > 0\n"
            "print('ok')\n")
    env = dict(os.environ, WEIGHTS_PATH=str(weights))
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-4000:]
    assert done.stdout.strip().splitlines()[-1] == "ok"


def test_depth_estimation_with_missing_packages_blocked(tmp_path):
    """The CLI converts a TUM folder with ``--estimate_depth`` (DPT-Hybrid at
    its random initialisation, on the CPU at a 64 x 96 net size) with JAX,
    hive_tpu and the packages the card's machine lacks blocked."""
    from chip_smoke import write_tum_dataset

    tum = str(tmp_path / "tum")
    write_tum_dataset(tum, num_frames=4, width=64, height=48)
    out = str(tmp_path / "out")
    argv = ["--dataset_path", tum, "--output_path", out, "--num_frames", "4", "--estimate_depth",
            "--key_frame_threshold", "1.0", "--sdf_max_voxels", "100000", "--background_only",
            "--webxr_path", str(tmp_path / "webxr"), "--log_file", str(tmp_path / "log.txt")]
    blocked = ("jax", "hive_tpu") + MISSING_ON_CARD_MACHINE
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "from hive_tpu_torch import dataset_adaptors\n"
            "from hive_tpu_torch.io import HiveDataset\n"
            "from hive_tpu_torch.pipeline import Pipeline\n"
            "dataset_adaptors.keep_aspect_multiple_of = lambda *args, **kwargs: (64, 96)\n"
            f"pipeline = Pipeline.from_command_line({argv!r}, device='cpu')\n"
            "pipeline.run()\n"
            f"dataset = HiveDataset({out!r})\n"
            "assert dataset.metadata.estimate_depth is True\n"
            "from hive_tpu_torch.io import load_image\n"
            "depth = load_image(dataset.depth_dataset.image_paths[3])\n"
            "assert depth.dtype.name == 'uint16' and depth.shape == (48, 64), depth.dtype\n"
            "assert 'get_depth_maps' in pipeline.profiling['timing']['load_dataset']\n"
            "print('ok')\n")
    env = dict(os.environ, WEIGHTS_PATH=str(tmp_path / "no_weights"))
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-4000:]
    assert done.stdout.strip().splitlines()[-1] == "ok"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo, the
    script exits non-zero and prints no result."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_wrappers_take_plain_versions_on_cpu():
    """CPU tensors go through the plain versions and count no launch."""
    band_sampler.launches = classify_blocks.pass1_launches = classify_blocks.refine_launches = 0
    tile_gather.launches = patch_gather.launches = fused_band.launches = 0
    ordered_hist.launches = 0
    frame = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    v = torch.tensor([[0, 2, 5]], dtype=torch.int32)
    u = torch.tensor([[3, -1, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(band_sampler.band_sample(frame, v, u).numpy(),
                                  [[3, 8, 9]])

    # Three 0.1 m blocks seen by an 8 x 8 camera looking at a wall at 2 m:
    # one in free space, one on the surface, one behind the camera.
    geom, pyramid = _tiny_classify_frame()
    origins = torch.tensor([[-0.05, -0.05, 1.0], [-0.05, -0.05, 1.95], [0.0, 0.0, -1.0]])
    scal = classify_blocks.classify_scalars(torch.eye(3), torch.zeros(3),
                                            torch.tensor([8.0, 8.0, 3.5, 3.5]))
    classes = classify_blocks.classify_pass1(origins, scal, pyramid, geom, cap=3)
    np.testing.assert_array_equal(classes.numpy(), [classify_blocks.FREE, classify_blocks.BAND,
                                                    classify_blocks.SKIP])
    dmin, dmax, free_ok = classify_blocks.classify_refine(classes, origins, scal, pyramid, geom,
                                                          cap=8, windows=True)
    assert classes[1] == classify_blocks.BAND and float(dmin[1]) == pytest.approx(2.0)
    assert float(dmax[1]) == pytest.approx(2.0) and bool(free_ok[1])
    assert float(dmin[0]) == -float("inf") and float(dmax[2]) == float("inf")

    tile = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    idx = torch.tensor([[3, 0, 1, 1], [1, 0, 0, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(tile_gather.tile_gather(tile, idx, 1).numpy(),
                                  [[3, 0, 1, 1], [5, 4, 4, 5]])
    np.testing.assert_array_equal(tile_gather.tile_gather(tile, idx % 2, 0).numpy(),
                                  [[4, 1, 6, 7], [4, 1, 2, 7]])

    origin = torch.tensor([1, 0], dtype=torch.int32)
    np.testing.assert_array_equal(
        patch_gather.patch_gather(origin[:1], origin[1:], frame, v[:, :2] + 1, u[:, :2] + 1,
                                  ph=2, pw=3).numpy(), [[0, 0]])
    np.testing.assert_array_equal(
        patch_gather.patch_gather(origin[:1], origin[1:], frame,
                                  torch.tensor([[1, 2]], dtype=torch.int32),
                                  torch.tensor([[2, 0]], dtype=torch.int32), ph=2, pw=3).numpy(),
        [[6, 8]])

    k, bv = 2, 4
    rows = [torch.zeros(k, bv), torch.zeros(k, bv), torch.zeros(k, 3 * bv)]
    cz = torch.full((k, bv), 1.0)
    depth_word = torch.full((2, 4), 1000, dtype=torch.int32)  # 1 m, black
    out = fused_band.fused_band(
        torch.zeros(k, dtype=torch.int32), torch.zeros(k, dtype=torch.int32),
        torch.tensor([1, 0], dtype=torch.int32),
        torch.cat([torch.ones(1), torch.eye(3).reshape(-1), torch.zeros(3)]),
        torch.zeros(k, 3), depth_word,
        (torch.zeros(k, bv, dtype=torch.int32), torch.zeros(k, bv, dtype=torch.int32), cz),
        *rows, project_in_kernel=False, intr=(1.0, 1.0, 0.0, 0.0), trunc=0.1, window=(2, 4))
    np.testing.assert_array_equal(out[1].numpy(), [[1.0] * bv, [0.0] * bv])
    assert out[0] is rows[0] and float(out[0].abs().max()) == 0.0
    np.testing.assert_array_equal(
        ordered_hist.ordered_hist(torch.tensor([[1, 0, 1]], dtype=torch.int32),
                                  torch.tensor([[0.5, 2.0, 0.25]]), 3).numpy(),
        [[2.0, 0.75, 0.0]])
    assert (band_sampler.launches, classify_blocks.pass1_launches,
            classify_blocks.refine_launches, tile_gather.launches, patch_gather.launches,
            fused_band.launches, ordered_hist.launches) == (0, 0, 0, 0, 0, 0, 0)


def _tiny_classify_frame():
    """The geometry of 0.1 m blocks in an 8 x 8 frame and the pyramid of a
    wall at 2 m."""
    from hive_tpu_torch.ops.tsdf_sparse import build_flat_pyramid, pyramid_layout

    geom = classify_blocks.Geometry(8, 8, 0.05, (0.1, 0.1, 0.1), pyramid_layout(8, 8))
    return geom, build_flat_pyramid(torch.full((8, 8), 2.0), 8, 8, packed_u16=True)


KERNEL_MODULES = (band_sampler, band_update, classify_blocks, fused_band, ordered_hist,
                  patch_gather, tile_gather)


def test_wrappers_never_fall_back_on_the_card():
    """A wrapper given CUDA tensors launches its kernel or raises: no kernel
    module (nor the integrator that calls the band update) catches an
    exception, and each launcher raises on a non-zero CUDA error."""
    from hive_tpu_torch.ops import tsdf_sparse

    handler = re.compile(r"^\s*(try\s*:|except\b)", re.MULTILINE)
    for module in KERNEL_MODULES + (tsdf_sparse,):
        source = open(module.__file__).read()
        assert not handler.search(source), module.__name__
    for module in KERNEL_MODULES:
        launcher = open(module.__file__).read().split("def _launch(", 1)[1].split("\ndef ", 1)[0]
        assert re.search(r"if err != 0:\n\s+raise RuntimeError", launcher), module.__name__
        assert "launches += 1" in launcher, module.__name__
        assert "_plain(" not in launcher, module.__name__


def test_wrappers_check_their_inputs():
    frame = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        band_sampler.band_sample(frame.float(), frame[:, :1], frame[:, :1])
    with pytest.raises(ValueError):
        band_sampler.band_sample(frame, frame[:, :1].long(), frame[:, :1].long())
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        band_sampler.band_sample(meta.reshape(2, 2), meta, meta)
    geom, pyramid = _tiny_classify_frame()
    origins, scal = torch.zeros(2, 3), torch.zeros(16)
    with pytest.raises(ValueError, match="unsupported device"):
        classify_blocks.classify_pass1(meta[:3].float().reshape(1, 3), meta[:4].float().repeat(4),
                                       meta, geom, cap=1)
    with pytest.raises(ValueError, match="origins"):
        classify_blocks.classify_pass1(origins.double(), scal, pyramid, geom, cap=2)
    with pytest.raises(ValueError, match="scal"):
        classify_blocks.classify_pass1(origins, scal[:12], pyramid, geom, cap=2)
    with pytest.raises(ValueError, match="pyramid"):
        classify_blocks.classify_pass1(origins, scal, pyramid.float(), geom, cap=2)
    with pytest.raises(ValueError, match="classes"):
        classify_blocks.classify_refine(torch.zeros(2, dtype=torch.int64), origins, scal,
                                        pyramid, geom, cap=2, windows=False)
    with pytest.raises(ValueError, match="share a device"):
        classify_blocks.classify_refine(torch.zeros(2, dtype=torch.int32, device="meta"),
                                        origins, scal, pyramid, geom, cap=2, windows=False)

    tile = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tile_gather.tile_gather(tile, tile.long(), 1)
    with pytest.raises(ValueError):
        tile_gather.tile_gather(tile, tile, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tile_gather.tile_gather(meta.reshape(2, 2), meta.reshape(2, 2), 0)

    origin = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        patch_gather.patch_gather(origin, origin, frame, frame[:1].long(), frame[:1].long())
    with pytest.raises(ValueError, match="does not fit"):
        patch_gather.patch_gather(origin, origin, frame, frame[:1], frame[:1], ph=4, pw=4)
    with pytest.raises(ValueError, match="unsupported device"):
        patch_gather.patch_gather(meta[:1], meta[:1], meta.reshape(2, 2), meta[None, :1],
                                  meta[None, :1], ph=1, pw=1)

    k = 2
    args = [torch.zeros(k, dtype=torch.int32)] * 3 + [torch.zeros(13), torch.zeros(k, 3),
                                                      frame, torch.zeros(3, 4)]
    rows = [torch.zeros(k, 4), torch.zeros(k, 4), torch.zeros(k, 12)]
    options = dict(project_in_kernel=True, intr=(1.0, 1.0, 0.0, 0.0), trunc=0.1, window=(2, 2))
    with pytest.raises(ValueError, match="color"):
        fused_band.fused_band(*args, rows[0], rows[1], rows[0], **options)
    with pytest.raises(ValueError, match="offsets"):
        fused_band.fused_band(*args[:-1], torch.zeros(3, 5), *rows, **options)
    with pytest.raises(ValueError, match="does not fit"):
        fused_band.fused_band(*args, *rows, **dict(options, window=(4, 4)))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_band.fused_band(*[x.to("meta") for x in args + rows], **options)


# The card test's classification frame: a camera looking down +z at 640 x
# 480 pixels with its principal point near the left edge (so a block's u0
# can be small, and its AABB extent fall on any f32 value), and blocks of
# 8^3 and 2^3 voxels of 2 cm and of (8, 8, 16) voxels (SUB = 2).
CARD_INTR = (300.0, 300.0, 0.5, 239.5)
CARD_CORNERS = ((0.16, 0.16, 0.16), (0.04, 0.04, 0.04), (0.16, 0.16, 0.32))
POWERS = [2.0 ** k for k in range(1, 10)]


def _crafted_origins(corner, rng):
    """Block origins (camera = world) whose pixel AABB extents land on 2^k
    and a few f32 ulps around it, for k = 1..9: a bisection for the depth,
    then the depth stepped one ulp at a time. A tiny random x offset puts
    u0 just right of the principal point, off the coarse grid of u1."""
    s, _, sz = corner
    f = CARD_INTR[0]
    origins = []
    for target in POWERS:
        for x0 in rng.uniform(0.0, 1e-4, 8):
            def extent(z):  # decreasing in z
                return f * (x0 + s) / z - f * x0 / (z + sz) + 0.5
            lo, hi = 1e-3, 100.0
            for _ in range(100):
                mid = 0.5 * (lo + hi)
                lo, hi = (mid, hi) if extent(mid) > target else (lo, mid)
            zs = (np.float32(lo).view(np.int32) + np.arange(-40, 41, dtype=np.int32)).view(
                np.float32)
            origins += [(x0, -s / 2, z) for z in zs]
    return np.asarray(origins, np.float32)


def _card_geometry(corner):
    from hive_tpu_torch.ops.tsdf_sparse import pyramid_layout

    return classify_blocks.Geometry(480, 640, 0.08, corner, pyramid_layout(480, 640))


def test_crafted_extents_hit_powers_of_two():
    """The card test's crafted blocks reach the level pick's edges: pixel
    AABB extents of exactly 2^k and one ulp below and above it."""
    rng = np.random.default_rng(0)
    scal = classify_blocks.classify_scalars(torch.eye(3), torch.zeros(3),
                                            torch.tensor(CARD_INTR))
    R, t, intr = scal[:9].view(3, 3), scal[9:12], tuple(scal[12:])
    found = set()
    for corner in CARD_CORNERS:
        origins = torch.as_tensor(_crafted_origins(corner, rng))
        _, _, _, u0, u1, v0, v1, _ = classify_blocks.project_corners(
            origins, R, t, intr, _card_geometry(corner))
        extent = torch.maximum((u1 + 0.5) - u0, (v1 + 0.5) - v0).numpy()
        for target in np.asarray(POWERS, np.float32):
            for side, value in (("below", np.nextafter(target, np.float32(0))), ("at", target),
                                ("above", np.nextafter(target, np.float32(np.inf)))):
                if (extent == value).any():
                    found.add((side, float(target)))
    for side in ("below", "at", "above"):
        assert sum(s == side for s, _ in found) >= 5, sorted(found)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["classify_pass1", "classify_refine", "band_sampler",
                                    "band_update", "tile_gather", "patch_gather", "fused_band"])
def test_kernel_matches_plain_on_card(kernel):
    """On the card each kernel equals its plain version bit for bit (the
    same check chip_smoke.py makes at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")

    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    if kernel in ("tile_gather", "patch_gather", "fused_band"):
        _check_probe_kernel_on_card(kernel, rng, dev)
        return
    if kernel == "band_update":
        _check_band_update_on_card(rng, dev)
        return
    if kernel == "band_sampler":
        frame = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (480, 640)),
                                dtype=torch.int32, device=dev)
        v = torch.as_tensor(rng.integers(-5, 490, (128, 512)), dtype=torch.int32, device=dev)
        u = torch.as_tensor(rng.integers(-5, 650, (128, 512)), dtype=torch.int32, device=dev)
        assert torch.equal(band_sampler.band_sample(frame, v, u),
                           band_sampler.band_sample_plain(frame, v, u))
        return
    _check_classify_on_card(kernel, rng, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["classify_pass1", "classify_refine", "band_update"])
def test_main_path_kernel_on_the_last_card(kernel):
    """A ``--num_devices`` shard's launch: each main-path kernel on the last
    visible card while cuda:0 stays current. The wrapper makes its tensors'
    card current, so the kernel runs there and equals its plain version."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards: the launch must be on a card that is not current")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(0)
    if kernel == "band_update":
        _check_band_update_on_card(rng, dev)
    else:
        _check_classify_on_card(kernel, rng, dev)
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_ordered_hist_on_card_equals_plain():
    """The ordered histogram on the card equals its plain version (the
    CPU's in-order scatter_add_) bit for bit, run after run, at SIFT's two
    widths and on a long single row; scatter_add_ on the card is no such
    sum (its atomics add in no fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    rng = np.random.default_rng(4)
    for rows, entries, bins in ((300, 2000, 36), (70, 8 * 1681, 360), (1, 200000, 36),
                                (0, 5, 36)):
        index = torch.as_tensor(rng.integers(0, bins, (rows, entries)), dtype=torch.int32)
        value = torch.as_tensor(rng.standard_normal((rows, entries))
                                * np.ldexp(1.0, rng.integers(-12, 12, (rows, entries))),
                                dtype=torch.float32)
        want = ordered_hist.ordered_hist_plain(index, value, bins)
        before = ordered_hist.launches
        first = ordered_hist.ordered_hist(index.cuda(), value.cuda(), bins)
        second = ordered_hist.ordered_hist(index.cuda(), value.cuda(), bins)
        torch.cuda.synchronize()
        assert ordered_hist.launches == before + (2 if rows else 0)   # no launch for no rows
        assert torch.equal(first.cpu().view(torch.int32), want.view(torch.int32)), (rows, bins)
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_sift_on_card_equals_cpu():
    """SIFT's keypoints and descriptors on the card equal the CPU's bit for
    bit, and two card runs are equal: the histograms sum in OpenCV's order
    on both, and every FMA rounds once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    from hive_tpu_torch.ops import sift

    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (60, 80)).astype(np.float32)
    grey = torch.from_numpy(np.kron(noise, np.ones((4, 4), np.float32)).astype(np.uint8))
    cpu = sift.detect_and_compute(grey)
    runs = [sift.detect_and_compute(grey.cuda()) for _ in range(2)]
    assert len(cpu) > 50
    for card in runs:
        for field in ("xy", "size", "angle", "response", "octave", "descriptors"):
            assert torch.equal(getattr(card, field).cpu(), getattr(cpu, field)), field


@pytest.mark.cuda
def test_dpt_fp32_on_card_equals_cpu():
    """The full-width DPT-Hybrid in float32 (TF32 off) on the card against
    the CPU's on a (2, 64, 96) batch, with the check weights: the logits
    within 1e-3 relative, the tolerance of the CPU parity test
    against hive_tpu (tests/test_torch_dpt.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: compares the card's forward with the CPU's")
    from hive_tpu_torch.models import dpt

    flat = dpt.check_flax_params(seed=11)
    images = torch.from_numpy(np.random.default_rng(12).uniform(
        -1, 1, (2, 3, 64, 96)).astype(np.float32))
    with torch.no_grad():
        want = dpt.load_flax_params(dpt.DPTHybrid(), flat).eval()(images)
        with torch.device("cuda"):
            model = dpt.DPTHybrid()
        got = dpt.load_flax_params(model, flat).eval()(images.cuda()).cpu()
    assert float(want.abs().max()) > 0.1
    assert float((got - want).abs().max() / want.abs().max()) < 1e-3


@pytest.mark.cuda
def test_lama_on_card_equals_cpu():
    """The full-width big-lama with the check weights on the card against
    the CPU, on two 60 x 84 frames (padded to 64 x 88) with a 255-valued
    hole, as ``chip_smoke.py``'s phase 10 holds it: float32 outputs;
    float32 within 1e-5 (the CPU parity test's tolerance against
    hive_tpu); bf16 within 0.02 (0.003 on average) of the CPU's bf16, and
    no further from the CPU's float32 than twice the CPU's bf16 is. The
    card's bf16 convolutions round one output in 10^3-10^4 to the other
    side, and one such rounding in the Fourier unit's spectrum moves the
    whole map (chip_smoke.py ``LAMA_BF16_TOL``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: compares the card's forward with the CPU's")
    from hive_tpu_torch.models import lama

    rng = np.random.default_rng(14)
    frames = rng.integers(0, 256, (2, 60, 84, 3)).astype(np.uint8)
    masks = np.zeros((2, 60, 84), np.uint8)
    masks[:, 15:45, 20:60] = 255
    flat = lama.check_params(0)
    hole = np.broadcast_to(masks[:, None] > 127, (2, 3, 60, 84))
    outs = {(device, name): lama.LamaInpainter(device, dtype=dtype, params=flat)
            .forward(frames, masks)
            for device in ("cuda", "cpu")
            for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    assert {out.dtype for out in outs.values()} == {torch.float32}
    outs = {key: out.cpu().numpy()[hole] for key, out in outs.items()}
    assert np.abs(outs["cuda", "f32"] - outs["cpu", "f32"]).max() <= 1e-5
    card = np.abs(outs["cuda", "bf16"] - outs["cpu", "bf16"])
    assert card.max() <= 0.02 and card.mean() <= 0.003, (card.max(), card.mean())
    card_error = np.abs(outs["cuda", "bf16"] - outs["cpu", "f32"])
    cpu_error = np.abs(outs["cpu", "bf16"] - outs["cpu", "f32"])
    assert card_error.max() <= 2 * cpu_error.max()
    assert card_error.mean() <= 2 * cpu_error.mean()
    assert outs["cpu", "f32"].max() - outs["cpu", "f32"].min() > 0.3


@pytest.mark.cuda
def test_weighted_segmenters_on_card_equal_cpu(tmp_path):
    """Mask R-CNN and the U-Net with check weights on the card against the
    CPU, at the CPU tests' small canvas: Mask R-CNN's validity equal, its
    scores within 5e-5, boxes within 5e-3 px and masks within 1e-3
    (tests/test_torch_maskrcnn.py's tolerances against hive_tpu); the
    U-Net's probabilities within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: compares the card's forwards with the CPU's")
    from hive_tpu_torch.models import maskrcnn, segmentation

    frames = np.random.default_rng(13).integers(0, 256, (2, 120, 160, 3)).astype(np.uint8)
    flat = maskrcnn.check_params(0)
    outs = [maskrcnn.MaskRCNNDetector(maskrcnn.load_params(flat, device), (120, 160),
                                      canvas_min_side=160, canvas_max_side=224).forward(frames)
            for device in ("cuda", "cpu")]
    got, want = outs
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=5e-5, rtol=0)
    np.testing.assert_allclose(got["boxes"][want["valid"]], want["boxes"][want["valid"]],
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(got["masks"], want["masks"], atol=1e-3, rtol=0)

    np.savez(tmp_path / "person_unet.npz", **segmentation.unet_check_params(0))
    got, want = (segmentation._UNetBackend(str(tmp_path / "person_unet.npz"), device)
                 .person_probabilities(frames).cpu().numpy() for device in ("cuda", "cpu"))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_motion_segmenter_on_card_equals_cpu(tmp_path):
    """MOG2, the open and close and the instance ids on the card equal the
    CPU's, frame by frame, on chip_smoke.py's VGA TUM scene (a noisy wall, a
    blob that jumps about) with its last four frames dimmed (shadows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the segmenter's device path runs there")
    from chip_smoke import write_tum_dataset
    from hive_tpu_torch.io import load_image
    from hive_tpu_torch.models.segmentation import _MotionBackend

    write_tum_dataset(str(tmp_path), num_frames=16, width=640, height=480)
    names = sorted(os.listdir(tmp_path / "rgb"))
    frames = np.stack([load_image(str(tmp_path / "rgb" / name)) for name in names])
    frames[12:] = (frames[12:] * 0.6).astype(np.uint8)
    frames = torch.from_numpy(frames)
    card, cpu = _MotionBackend(device="cuda"), _MotionBackend(device="cpu")
    for name, batch in (("prime", frames[:8]), ("first", frames[:8]), ("second", frames[8:])):
        if name == "prime":
            card.prime(batch.cuda())
            cpu.prime(batch)
            continue
        got, want = card.foreground(batch.cuda()).cpu(), cpu.foreground(batch)
        assert torch.equal(got, want), name
        for g, w in zip(got.numpy(), want.numpy()):
            np.testing.assert_array_equal(card.instances(g), cpu.instances(w))
        for state in ("weight", "variance", "mean", "modes_used"):
            assert torch.equal(getattr(card, state).cpu(), getattr(cpu, state)), (name, state)


@pytest.mark.cuda
def test_render_and_batch_metrics_on_card_equal_cpu():
    """The card's render equals the CPU's (image and depth, 0 pixels
    differ: the same float32 operations, FMAs through float64); its
    ``batch_ssim_psnr`` is within 1e-5 / 1e-4 dB of the CPU's (the CPU
    tolerance against hive_tpu, tests/test_torch_render_metrics.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: compares the card's render with the CPU's")
    from hive_tpu_torch import metrics
    from hive_tpu_torch.meshing import render
    from hive_tpu_torch.meshing.mesh import TriangleMesh

    rng = np.random.default_rng(21)
    K = np.array([[580.0, 0.0, 319.5], [0.0, 580.0, 239.5], [0.0, 0.0, 1.0]])
    R = np.linalg.qr(np.eye(3) + 0.1 * rng.normal(size=(3, 3)))[0]
    R[:, 0] *= np.sign(np.linalg.det(R))
    t = rng.normal(0, 0.1, (3, 1))
    centres = np.stack([rng.uniform(-1.5, 1.5, 2000), rng.uniform(-1, 1, 2000),
                        rng.uniform(1.0, 4.0, 2000)], 1)
    vertices = (centres[:, None] + rng.normal(0, 0.15, (2000, 3, 3))).reshape(-1, 3)
    arrays = dict(vertices=vertices.astype(np.float32), faces=np.arange(6000).reshape(2000, 3))
    for colours in (dict(vertex_colors=rng.integers(0, 256, (6000, 3)).astype(np.uint8)),
                    dict(uv=rng.uniform(0, 1, (6000, 2)).astype(np.float32),
                         texture=rng.integers(0, 256, (16, 24, 3)).astype(np.uint8))):
        mesh = TriangleMesh(**arrays, **colours)
        card = render.render_mesh(mesh, K, R, t, 640, 480, device="cuda")
        cpu = render.render_mesh(mesh, K, R, t, 640, 480, device="cpu")
        assert (cpu[1] > 0).sum() > 100_000
        for got, want in zip(card, cpu):
            np.testing.assert_array_equal(got, want)
    # Edge-on slivers in the plane X = Y, drawn by their bands along the
    # diagonal (tests/test_torch_render_metrics.py holds them to the scan).
    x = rng.uniform(-0.8, 0.8, (256, 1)) + rng.uniform(-0.02, 0.02, (256, 3))
    z = rng.uniform(1, 4, (256, 1)) + rng.uniform(-0.02, 0.02, (256, 3))
    slivers = TriangleMesh(vertices=np.stack([x, x, z], -1).reshape(-1, 3).astype(np.float32),
                           faces=np.arange(768).reshape(256, 3),
                           vertex_colors=rng.integers(0, 256, (768, 3)).astype(np.uint8))
    K_diagonal = np.array([[525.0, 0.0, 320.0], [0.0, 525.0, 240.0], [0.0, 0.0, 1.0]])
    card, cpu = (render.render_mesh(slivers, K_diagonal, np.eye(3), np.zeros((3, 1)), 640, 480,
                                    device=device) for device in ("cuda", "cpu"))
    assert (cpu[1] > 0).sum() >= 400
    for got, want in zip(card, cpu):
        np.testing.assert_array_equal(got, want)
    a = rng.integers(0, 256, (4, 480, 640, 3)).astype(np.uint8)
    b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)
    card = metrics.batch_ssim_psnr(a, b, device="cuda")
    cpu = metrics.batch_ssim_psnr(a, b, device="cpu")
    np.testing.assert_allclose(card[0], cpu[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(card[1], cpu[1], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_compare_images_on_card_equals_cpu(monkeypatch, tmp_path):
    """``compare_images`` on the card against the CPU on a textured pair:
    SSIM and PSNR (float64 on both, the same operations) within 1e-9
    relative, MIFD within 1% (phase 15's SIFT differences), LPIPS NaN on
    both without weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: compares the card's metrics with the CPU's")
    from hive_tpu_torch import metrics
    from hive_tpu_torch.scripts.compare_image_pair import compare_images

    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    monkeypatch.setattr(metrics, "_lpips_models", {})
    rng = np.random.default_rng(31)
    coarse = rng.uniform(0, 255, (25, 33))
    a = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[:192, :256]
    b = np.roll(a, (2, -3), axis=(0, 1))
    a, b = (np.clip(np.stack([x, 255 - x, x / 2], -1) + rng.normal(0, 3, (192, 256, 3)), 0,
                    255).astype(np.uint8) for x in (a, b))
    card, cpu = (compare_images(a, b, device=device) for device in ("cuda", "cpu"))
    for metric in ("ssim", "psnr"):
        assert abs(card[metric] - cpu[metric]) <= 1e-9 * abs(cpu[metric]), metric
    assert np.isfinite(cpu["mifd"]) and abs(card["mifd"] - cpu["mifd"]) <= 0.01 * cpu["mifd"]
    assert np.isnan(card["lpips"]) and np.isnan(cpu["lpips"])


@pytest.mark.cuda
def test_lpips_scorer_on_card_equals_cpu():
    """LPIPS with check weights on the card against the CPU, within 1e-4
    relative (float32 convolutions in other orders; TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: compares the card's scorer with the CPU's")
    from hive_tpu_torch.models import lpips

    flat = lpips.check_params(0)
    rng = np.random.default_rng(23)
    a = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.uint8)
    card, cpu = (lpips.LPIPSScorer(flat, device)(a, b) for device in ("cuda", "cpu"))
    assert cpu > 0 and abs(card - cpu) <= 1e-4 * cpu


@pytest.mark.cuda
def test_lpips_metric_scores_on_the_device_asked_for(monkeypatch, tmp_path):
    """``metrics.lpips`` on the card, then on the CPU: each call scores
    with a scorer on the device it asked for, within 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: scores on the card and then the CPU")
    from hive_tpu_torch import metrics
    from hive_tpu_torch.models import lpips

    np.savez(tmp_path / lpips.WEIGHTS_FILENAME, **lpips.check_params(1))
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    monkeypatch.setattr(metrics, "_lpips_models", {})
    rng = np.random.default_rng(29)
    a = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.uint8)
    card = metrics.lpips(a, b, device="cuda")
    cpu = metrics.lpips(a, b, device="cpu")
    devices = {d: next(scorer.model.parameters()).device.type
               for d, scorer in metrics._lpips_models.items()}
    assert devices == {torch.device("cuda", torch.cuda.current_device()): "cuda",
                       torch.device("cpu"): "cpu"}
    assert cpu > 0 and abs(card - cpu) <= 1e-4 * cpu


def _check_classify_on_card(kernel, rng, dev):
    """Both classification passes on blocks whose AABB extents sit at and
    one ulp around powers of two (the level pick's edges), and on scattered
    blocks, some straddling the camera plane, for 8^3, 2^3 and (8, 8, 16)
    blocks; pass 1 with and without compaction and with an overflowing
    cap, the refine pass with an overflowing cap and with windows: classes
    and windows bit for bit."""
    from hive_tpu_torch.ops.tsdf_sparse import build_flat_pyramid

    cb = classify_blocks
    depth = torch.as_tensor(rng.uniform(0.3, 40.0, (480, 640)), dtype=torch.float32, device=dev)
    depth[torch.as_tensor(rng.random((480, 640)) < 0.1, device=dev)] = 0.0
    pyramid = build_flat_pyramid(depth, 480, 640, packed_u16=True)
    scal = cb.classify_scalars(torch.eye(3), torch.zeros(3), torch.tensor(CARD_INTR)).to(dev)
    craft = np.random.default_rng(0)  # test_crafted_extents_hit_powers_of_two's blocks
    cb.pass1_launches = cb.refine_launches = 0
    calls = 0
    for corner in CARD_CORNERS:
        geom = _card_geometry(corner)
        scattered = rng.uniform([-0.5, -2.0, -0.5], [6.0, 2.0, 6.0], (20000, 3))
        origins = torch.as_tensor(np.concatenate([_crafted_origins(corner, craft), scattered]),
                                  dtype=torch.float32, device=dev)
        nb = origins.shape[0]
        if kernel == "classify_pass1":
            for cap in (nb, nb // 3, 16):
                got = cb.classify_pass1(origins, scal, pyramid, geom, cap)
                assert torch.equal(got, cb.classify_pass1_plain(origins, scal, pyramid, geom, cap))
                calls += 1
            continue
        classes = torch.as_tensor(rng.choice(4, nb, p=[0.2, 0.1, 0.6, 0.1]), dtype=torch.int32,
                                  device=dev)
        for cap in (nb, int((classes == cb.BAND).sum()) // 2):
            for windows in (False, True):
                got_classes, want_classes = classes.clone(), classes.clone()
                got = cb.classify_refine(got_classes, origins, scal, pyramid, geom, cap, windows)
                want = cb.classify_refine_plain(want_classes, origins, scal, pyramid, geom, cap,
                                                windows)
                torch.cuda.synchronize()
                assert torch.equal(got_classes, want_classes)
                assert not torch.equal(got_classes, classes)
                for g, w in zip(got, want):
                    assert (g is None) == (not windows) and (g is None or torch.equal(
                        g.view(torch.int32) if g.is_floating_point() else g,
                        w.view(torch.int32) if w.is_floating_point() else w))
                calls += 1
    assert (cb.pass1_launches, cb.refine_launches) == (
        (calls, 0) if kernel == "classify_pass1" else (0, calls))


def _check_band_update_on_card(rng, dev):
    """The band update on random states in both dtypes and colour modes, at
    SUB = 1 and 2, in slabs of 8 x 8 x 8 and of 2 x 2 x 2 voxels (fewer
    threads than scalars), against its plain version: every value bit for
    bit."""
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFState

    height, width = 120, 160
    for (block, bvs), dtype, words, sub in itertools.product(
            (((8, 8), 512), ((2, 2), 8)), (torch.float32, torch.bfloat16), (1, 2), (1, 2)):
        rows = 64 * sub
        state = SparseTSDFState(
            torch.as_tensor(rng.uniform(-1, 1, (rows, bvs)), dtype=dtype, device=dev),
            torch.as_tensor(rng.integers(0, 4, (rows, bvs)), dtype=dtype, device=dev),
            torch.as_tensor(rng.uniform(0, 255, (rows * 3, bvs)), dtype=dtype, device=dev))
        ids = torch.as_tensor(rng.choice(rows, rows // 2, replace=False), device=dev)
        base = torch.as_tensor(rng.uniform(-0.6, 0.6, (rows // 2, 3)) + [0, 0, 1.5],
                               dtype=torch.float32, device=dev)
        angle = rng.uniform(-0.3, 0.3)
        rot = torch.tensor([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                            [-np.sin(angle), 0, np.cos(angle)]], dtype=torch.float32)
        scal = band_update.band_scalars(
            torch.tensor([100.0, 100.0, 79.5, 59.5]), torch.tensor(0.05),
            torch.tensor(1.0) / torch.tensor(0.05), torch.tensor(1.0),
            rot * 0.02).to(dev)
        depth = torch.as_tensor(rng.uniform(1.0, 2.2, (height, width)),
                                dtype=torch.float32, device=dev)
        frames = ((depth.view(torch.int32), torch.as_tensor(
            rng.integers(0, 2 ** 24, (height, width)), dtype=torch.int32, device=dev))
            if words == 2 else (torch.as_tensor(
                rng.integers(-2 ** 31, 2 ** 31, (height, width)), dtype=torch.int32,
                device=dev),))
        want = SparseTSDFState(*(x.clone() for x in state))
        before = state.weight.clone()
        band_update.band_update_plain(want, ids, base, scal, frames, block=block, sub=sub)
        band_update.band_update(state, ids, base, scal, frames, block=block, sub=sub)
        torch.cuda.synchronize()
        assert not torch.equal(want.weight, before)
        for got, exp in zip(state, want):
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            assert torch.equal(got.view(bits), exp.view(bits))


def _check_probe_kernel_on_card(kernel, rng, dev):
    """The measurement entry points' kernels on random inputs at their shapes."""
    from hive_tpu_torch.micro import fused_band as mf

    def words(shape):
        return torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape), dtype=torch.int32,
                               device=dev)

    def ints(low, high, shape):
        return torch.as_tensor(rng.integers(low, high, shape), dtype=torch.int32, device=dev)

    if kernel == "tile_gather":
        src = words((8, 128))
        for axis, high in ((1, 128), (0, 8)):
            idx = ints(0, high, (8, 128))
            assert torch.equal(tile_gather.tile_gather(src, idx, axis),
                               tile_gather.tile_gather_plain(src, idx, axis))
        return
    frame = words((480, 640))
    if kernel == "patch_gather":
        v0, u0 = ints(-4, 470, (1024,)), ints(-4, 390, (1024,))
        vv = v0[:, None, None] + ints(-4, 20, (1024, 4, 128))
        uu = u0[:, None, None] + ints(-8, 264, (1024, 4, 128))
        assert torch.equal(patch_gather.patch_gather(v0, u0, frame, vv, uu),
                           patch_gather.patch_gather_plain(v0, u0, frame, vv, uu))
        # The kernel reads four samples of a block at a time: 15 are refused.
        with pytest.raises(ValueError, match="multiple of 4"):
            patch_gather.patch_gather(v0, u0, frame, vv[:, :3, :5], uu[:, :3, :5])
        return
    s = mf.setup(dev)
    ids = s["ids"]
    rid = torch.clamp(ids, max=mf.NBS - 1)
    scal = torch.cat([s["obs_weight"].reshape(1), s["R"].reshape(-1), s["t"].reshape(-1)])
    cz, uu, vv = mf.project(s["origins"], s["R"], s["t"], s["iota"])
    # Windows moved up or down by 8 rows: some lanes leave them and read the edge.
    v0 = torch.clamp(s["win_v0"] + ints(-1, 2, (mf.K,)) * 8, 0, 480 - mf.PH)
    for pik, coords in ((True, s["iota"]), (False, (vv, uu, cz))):
        outs = [fn(v0, s["win_u0"], (ids < mf.NBS).int(), scal,
                   s["origins"], frame, coords, s["state"][0][rid], s["state"][1][rid],
                   s["state"][2][rid], project_in_kernel=pik, intr=mf.INTR, trunc=mf.TRUNC,
                   window=(mf.PH, mf.PW))
                for fn in (fused_band.fused_band, fused_band.fused_band_plain)]
        for got, want in zip(*outs):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# The video path on the card (tests/test_torch_video.py holds the same
# functions to cv2 on the CPU; this file imports no cv2, which the card's
# machine lacks).

@pytest.mark.cuda
def test_video_conversion_resize_and_rotation_on_card_equal_cpu():
    """On the card the YUV -> BGR conversion, the uint8 resize and the
    rotation give the CPU's bytes at the phone clip's and the Stray Scanner
    capture's sizes."""
    from hive_tpu_torch.image_processing import (ROTATE_90_CLOCKWISE,
                                                 ROTATE_90_COUNTERCLOCKWISE, ROTATE_180,
                                                 resize_linear_u8, rotate)
    from hive_tpu_torch.video import color

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(5)
    for (height, width), target in (((1080, 1920), (360, 640)), ((1440, 1920), (640, 480))):
        planes = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
                  for shape in ((height, width), (height // 2, width // 2),
                                (height // 2, width // 2))]
        for full_range, matrix in ((False, 2), (True, 1)):
            cpu = color.yuv420_to_bgr(*planes, full_range, matrix)
            card = color.yuv420_to_bgr(*(p.cuda() for p in planes), full_range, matrix)
            assert torch.equal(card.cpu(), cpu)
        for code in (ROTATE_90_CLOCKWISE, ROTATE_180, ROTATE_90_COUNTERCLOCKWISE):
            assert torch.equal(rotate(cpu.cuda(), code).cpu(), rotate(cpu, code))
        upright = rotate(cpu, ROTATE_90_CLOCKWISE) if target[0] > target[1] else cpu
        assert torch.equal(resize_linear_u8(upright.cuda(), target[1], target[0]).cpu(),
                           resize_linear_u8(upright, target[1], target[0]))


@pytest.mark.cuda
def test_nvdec_decodes_the_seeded_planes_or_refuses_by_name(tmp_path):
    """The card's capture gives the seeded samples of I_PCM streams (in
    order, out of order, cropped), decoded on the host (H264Decoder) as
    for the CPU; NVDEC, which is no longer on that path, either decodes the
    same planes or refuses, naming the call and its CUresult (ROADMAP item
    9b)."""
    from hive_tpu_torch.video import h264, mp4, nvdec
    from hive_tpu_torch.video.capture import VideoCapture

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(0)
    for name, (width, height), options in (("in_order", (64, 48), {}),
                                           ("out_of_order", (64, 48), dict(reorder=True)),
                                           ("cropped", (160, 120), {})):
        planes = [(rng.integers(0, 256, (height, width), dtype=np.uint8),
                   rng.integers(0, 256, (height // 2, width // 2), dtype=np.uint8),
                   rng.integers(0, 256, (height // 2, width // 2), dtype=np.uint8))
                  for _ in range(7)]
        path = str(tmp_path / f"{name}.mp4")
        h264.write_h264_mp4(path, planes, h264.PcmPlanner(width, height), **options)
        capture = VideoCapture(path, device="cuda:0")
        got = list(capture.planes())
        assert len(got) == len(planes)
        for decoded, want in zip(got, planes):
            for plane, expected in zip(decoded, want):
                assert plane.device.type == "cuda"
                np.testing.assert_array_equal(plane.cpu().numpy(), expected)
        units = [capture.sps_units + capture.pps_units + capture._nal_units(k)
                 for k in range(len(planes))]
        try:
            with nvdec.NvdecDecoder("cuda:0") as decoder:
                through = list(decoder.decode_all((mp4.annex_b(u), k) for k, u in
                                                  enumerate(units)))
        except nvdec.NvdecError as e:
            assert "CUresult" in str(e), str(e)
            continue
        assert len(through) == len(planes)
        for (_, *decoded), want in zip(through, planes):
            for plane, expected in zip(decoded, want):
                np.testing.assert_array_equal(plane.cpu().numpy(), expected)
