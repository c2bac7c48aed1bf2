"""Experiments harness: quantitative evaluation of the pipeline, on the card.

Counterpart of ``scripts/experiments.py``, with the same API, flags, JSON
keys, LaTeX text and output folders::

    python -m hive_tpu_torch.scripts.experiments --data_path DATA \\
        --output_path OUT --dataset_names NAME [NAME ...] [--experiments ...]

Provides:

* the gt/cm/est config matrix per dataset (ground-truth data, estimated
  pose + gt depth, fully estimated);
* pipeline experiments that run the full pipeline per config and collect each
  run's ``profiling.json``;
* trajectory experiments: ATE/RPE of estimated trajectories vs ground truth,
  plus TSDF reconstructions per trajectory for qualitative comparison;
* compression experiments (ratios from profiling data) and the mesh
  compression matrix;
* inpainting experiments: mask a region, inpaint, score SSIM/PSNR/LPIPS and
  depth MAE/RMSE against the original;
* LLFF / HyperNeRF render-vs-photo experiments;
* LaTeX table export for all of the above.

``Experiments(..., device=None)`` runs every pipeline, fusion, pose
optimisation, render and metric on ``cuda:0`` unless ``device="cpu"`` is
passed. Without matplotlib the trajectory plot is skipped with a warning.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
from os.path import join as pjoin
from typing import Dict, List, Optional

import numpy as np

from hive_tpu_torch import get_device
from hive_tpu_torch.fusion import tsdf_fusion
from hive_tpu_torch.geometric import Trajectory
from hive_tpu_torch.image_codecs import write_image
from hive_tpu_torch.io import HiveDataset, temporary_trajectory
from hive_tpu_torch.meshing.ply import save_ply
from hive_tpu_torch.metrics import depth_mae, depth_rmse, lpips, metric_skip_notes, ssim_psnr
from hive_tpu_torch.options import (BackgroundMeshOptions, COLMAPOptions, PipelineOptions,
                                    StorageOptions, WebXROptions)
from hive_tpu_torch.utils import setup_logger


class MeanSummary:
    """Streaming mean accumulator."""

    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def update(self, value) -> None:
        if value is None or not np.isfinite(value):
            return
        self._sum += float(value)
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else float("nan")


class Latex:
    """Small LaTeX formatting helpers."""

    @staticmethod
    def format_number(value, precision: int = 2) -> str:
        if value is None or (isinstance(value, float) and not np.isfinite(value)):
            return "--"

        return f"{value:,.{precision}f}"

    @staticmethod
    def to_mean_stddev(values, precision: int = 2) -> str:
        values = np.asarray(values, dtype=float)
        return (f"{Latex.format_number(values.mean(), precision)} $\\pm$ "
                f"{Latex.format_number(values.std(), precision)}")

    @staticmethod
    def table(header: List[str], rows: List[List[str]], caption: str = "") -> str:
        cols = "l" + "r" * (len(header) - 1)
        lines = [f"\\begin{{tabular}}{{{cols}}}",
                 " & ".join(header) + r" \\", r"\hline"]

        for row in rows:
            lines.append(" & ".join(str(cell) for cell in row) + r" \\")

        lines.append(r"\end{tabular}")

        if caption:
            lines.append(f"% {caption}")

        return "\n".join(lines)


def _mean_rows(results: Dict[str, dict], label: str) -> tuple:
    """The LaTeX rows and cross-run mean of cached or fresh per-run
    results (each with a ``mean`` and maybe ``skipped``): one row a run
    plus the mean row."""
    summaries: Dict[str, MeanSummary] = {}
    skip_notes: Dict[str, str] = {}
    rows = []
    for name, result in results.items():
        mean = result.get("mean", {})
        row = [name]
        for metric in ("ssim", "psnr", "lpips", "mifd"):
            value = mean.get(metric)
            summaries.setdefault(metric, MeanSummary()).update(value)
            note = result.get("skipped", {}).get(metric)
            if note:
                skip_notes[metric] = note
            row.append(note or Latex.format_number(value, 3))
        rows.append(row)

    rollup = {metric: summary.mean for metric, summary in summaries.items() if summary.count}
    rows.append([label] + [
        (Latex.format_number(rollup[m], 3) if m in rollup else skip_notes.get(m, "--"))
        for m in ("ssim", "psnr", "lpips", "mifd")])
    return rows, rollup


def run_trajectory_comparisons(dataset: HiveDataset, estimated: Trajectory,
                               ground_truth: Trajectory, output_folder: str,
                               mesh_options: Optional[BackgroundMeshOptions] = None,
                               device=None) -> dict:
    """ATE/RPE of an estimated trajectory vs ground truth + TSDF meshes from
    both trajectories for visual comparison.

    :param device: where the meshes are fused; default ``cuda:0``.
    """
    os.makedirs(output_folder, exist_ok=True)

    ate = ground_truth.calculate_ate(estimated)
    rpe_rotation, rpe_translation = ground_truth.calculate_rpe(estimated)

    results = {
        "ate_rmse": float(np.sqrt(np.mean(np.sum(ate ** 2, axis=-1)))),
        "rpe_rotation_deg": float(np.rad2deg(rpe_rotation).mean()),
        "rpe_translation_m": float(rpe_translation.mean()),
    }

    with open(pjoin(output_folder, "trajectory_metrics.json"), "w") as fh:
        json.dump(results, fh)

    try:
        ground_truth.plot_comparison(estimated, pjoin(output_folder, "trajectories.png"))
    except ImportError as exc:
        logging.warning(f"Trajectory plot skipped: {exc}")

    if mesh_options is not None:
        logging.info("Reconstructing mesh from ground-truth trajectory...")
        mesh_gt = tsdf_fusion(dataset, mesh_options, device=device)
        save_ply(pjoin(output_folder, "mesh_gt.ply"), mesh_gt)

        logging.info("Reconstructing mesh from estimated trajectory...")
        with temporary_trajectory(dataset, estimated):
            mesh_est = tsdf_fusion(dataset, mesh_options, device=device)
        save_ply(pjoin(output_folder, "mesh_est.ply"), mesh_est)

    return results


def tsdf_fusion_with_colmap(dataset: HiveDataset, frame_set: List[int],
                            mesh_options: BackgroundMeshOptions, device=None):
    """Reconstruct the background from COLMAP's (metric-scaled) dense depth
    maps instead of the dataset's own depth.

    The adaptors save the dense COLMAP depth as u16-mm PNGs under
    ``<dataset>/colmap_depth`` during pose estimation, the same codec as
    ``depth/``, so reconstruction is a temporary depth-source swap.

    :param device: where the mesh is fused; default ``cuda:0``.
    :return: The reconstructed mesh, or ``None`` when no COLMAP depth exists.
    """
    from hive_tpu_torch.io import ImageFolderDataset, disable_inpainted_data

    colmap_depth_path = pjoin(str(dataset.base_path), "colmap_depth")

    if not os.path.isdir(colmap_depth_path):
        return None

    colmap_depth = ImageFolderDataset(
        colmap_depth_path, transform=dataset._get_depth_map_transform())

    # The adaptor names these files by TRUE frame index over the
    # frames[::frame_step] subset (000000.png, 000015.png, ...), so
    # positional indexing would pair each pose/RGB with another frame's
    # depth whenever frame_step > 1: translate through the filenames, and
    # keep only frames COLMAP registered a depth map for.
    positions = {}
    for pos, name in enumerate(colmap_depth.image_filenames):
        try:
            positions[int(os.path.splitext(name)[0])] = pos
        except ValueError:
            continue
    frame_set = [i for i in frame_set if i in positions]
    if not frame_set:
        return None

    class _ByFrameIndex:
        def __getitem__(self, index):
            return colmap_depth[positions[index]]

        def __len__(self):
            return dataset.num_frames

    depth_backup = dataset.depth_dataset
    try:
        dataset.depth_dataset = _ByFrameIndex()
        with disable_inpainted_data(dataset):
            return tsdf_fusion(dataset, mesh_options, frame_set=frame_set, device=device)
    finally:
        dataset.depth_dataset = depth_backup


class InpaintingExperiment:
    """Mask a crop region, inpaint RGB + depth (Telea, radius 30), score
    against the original."""

    def __init__(self, dataset: HiveDataset, output_path: str, crop_fraction: float = 0.25,
                 device=None):
        """:param device: where the metrics run; default ``cuda:0``."""
        self.dataset = dataset
        self.output_path = output_path
        self.crop_fraction = crop_fraction
        self.device = get_device(device)

    def run(self, num_frames: int = 10) -> dict:
        from hive_tpu_torch.image_processing import inpaint_telea

        os.makedirs(self.output_path, exist_ok=True)

        results = {"ssim": [], "psnr": [], "lpips": [], "depth_mae": [], "depth_rmse": []}
        num_frames = min(num_frames, self.dataset.num_frames)

        for index in range(num_frames):
            rgb = self.dataset.rgb_dataset[index]
            depth = self.dataset.depth_dataset[index]

            h, w = rgb.shape[:2]
            ch = int(h * self.crop_fraction)
            cw = int(w * self.crop_fraction)
            y0 = (h - ch) // 2
            x0 = (w - cw) // 2

            mask = np.zeros((h, w), dtype=np.uint8)
            mask[y0:y0 + ch, x0:x0 + cw] = 255

            # Telea fills each channel on its own, so RGB needs no swap to
            # OpenCV's BGR.
            inpainted_rgb = inpaint_telea(rgb, mask, radius=30)

            depth_u8 = np.clip(depth / max(depth.max(), 1e-6) * 255, 0, 255).astype(np.uint8)
            inpainted_depth_u8 = inpaint_telea(depth_u8, mask, radius=30)
            inpainted_depth = inpainted_depth_u8.astype(np.float32) / 255.0 \
                * max(depth.max(), 1e-6)

            region = (slice(y0, y0 + ch), slice(x0, x0 + cw))
            ssim_value, psnr_value = ssim_psnr(rgb[region], inpainted_rgb[region],
                                               device=self.device)
            results["ssim"].append(ssim_value)
            results["psnr"].append(psnr_value)
            results["lpips"].append(lpips(rgb[region], inpainted_rgb[region],
                                          device=self.device))
            results["depth_mae"].append(depth_mae(inpainted_depth[region], depth[region]))
            results["depth_rmse"].append(depth_rmse(inpainted_depth[region], depth[region]))

        summary = {metric: float(np.nanmean(values)) for metric, values in results.items()}
        skipped = metric_skip_notes(results, self.device)

        with open(pjoin(self.output_path, "inpainting_metrics.json"), "w") as fh:
            json.dump({"per_frame": results, "mean": summary,
                       "skipped": skipped}, fh)

        return summary


class MeshCompressionExperimentConfig:
    """Folder/name layout of the compression matrix."""

    uncompressed_mesh_folder = "mesh_uncompressed"
    compressed_mesh_folder = "mesh_compressed"
    fg_mesh_name = "fg"
    bg_mesh_name = "bg"


class Experiments:
    """The gt/cm/est experiment matrix."""

    # Config labels: ground-truth everything; estimated pose (COLMAP, or
    # PnP odometry without its binary) + ground-truth depth; everything
    # estimated.
    CONFIGS = {
        "gt": dict(estimate_pose=False, estimate_depth=False),
        "cm": dict(estimate_pose=True, estimate_depth=False),
        "est": dict(estimate_pose=True, estimate_depth=True),
    }

    def __init__(self, data_path: str, output_path: str, dataset_names: List[str],
                 num_frames: int = -1, frame_step: int = 15,
                 colmap_options: COLMAPOptions = COLMAPOptions(),
                 overwrite_ok: bool = False, device=None):
        """:param device: where every pipeline, fusion, pose optimisation,
        render and metric runs; default ``cuda:0``."""
        self.data_path = data_path
        self.output_path = output_path
        self.dataset_names = dataset_names
        self.num_frames = num_frames
        self.frame_step = frame_step
        self.colmap_options = colmap_options
        self.overwrite_ok = overwrite_ok
        self.device = get_device(device)

        os.makedirs(output_path, exist_ok=True)

    def _run_output_path(self, dataset_name: str, config: str) -> str:
        return pjoin(self.output_path, dataset_name, config)

    # -- pipeline experiments -------------------------------------------------
    def run_pipeline_experiments(self, configs: Optional[List[str]] = None) -> dict:
        """Run the full pipeline per dataset x config; collect profiling.json.

        Skips runs whose profiling.json already exists.
        """
        from hive_tpu_torch.pipeline import Pipeline

        configs = configs or list(self.CONFIGS)
        all_profiling: Dict[str, Dict[str, dict]] = {}

        for dataset_name in self.dataset_names:
            all_profiling[dataset_name] = {}

            for config in configs:
                run_output = self._run_output_path(dataset_name, config)
                converted_path = pjoin(run_output, "dataset")
                profiling_path = pjoin(converted_path, "profiling.json")

                if os.path.isfile(profiling_path) and not self.overwrite_ok:
                    logging.info(f"Using cached results for {dataset_name}/{config}.")
                    with open(profiling_path) as fh:
                        all_profiling[dataset_name][config] = json.load(fh)
                    continue

                logging.info(f"Running pipeline for {dataset_name}/{config}...")

                # Before Pipeline(): its __init__ opens run_output/logs.log,
                # and setup_logger creates no folders.
                os.makedirs(run_output, exist_ok=True)

                pipeline = Pipeline(
                    options=PipelineOptions(
                        num_frames=self.num_frames, frame_step=self.frame_step,
                        log_file=pjoin(run_output, "logs.log"),
                        **self.CONFIGS[config]),
                    storage_options=StorageOptions(
                        dataset_path=pjoin(self.data_path, dataset_name),
                        output_path=converted_path, overwrite_ok=True),
                    colmap_options=self.colmap_options,
                    webxr_options=WebXROptions(webxr_path=pjoin(run_output, "webxr")),
                    device=self.device,
                )

                try:
                    pipeline.run()
                    with open(profiling_path) as fh:
                        all_profiling[dataset_name][config] = json.load(fh)
                except Exception:
                    logging.exception(f"Pipeline failed for {dataset_name}/{config}")

        with open(pjoin(self.output_path, "pipeline_profiling.json"), "w") as fh:
            json.dump(all_profiling, fh)

        return all_profiling

    def export_pipeline_results(self, profiling: Optional[dict] = None) -> str:
        """Runtime/memory LaTeX table from collected profiling data."""
        if profiling is None:
            with open(pjoin(self.output_path, "pipeline_profiling.json")) as fh:
                profiling = json.load(fh)

        rows = []

        for dataset_name, configs in profiling.items():
            for config, data in configs.items():
                elapsed = data.get("elapsed_time", {})
                ram = data.get("peak_ram_usage", 0)
                vram = data.get("peak_vram_usage", {}).get("allocated", 0)
                tris = data.get("mesh_tri_count", {}).get("total", 0)

                rows.append([
                    f"{dataset_name}/{config}",
                    Latex.format_number(elapsed.get("total")),
                    Latex.format_number(elapsed.get("per_frame"), 3),
                    Latex.format_number(ram / 1e9, 2),
                    Latex.format_number(vram / 1e9, 2),
                    f"{tris:,.0f}",
                ])

        table = Latex.table(
            ["Run", "Total (s)", "Per frame (s)", "RAM (GB)", "Device mem (GB)",
             "Triangles"],
            rows, caption="Pipeline runtime and memory")

        output_file = pjoin(self.output_path, "pipeline_results.tex")
        with open(output_file, "w") as fh:
            fh.write(table)

        return table

    # -- trajectory experiments -----------------------------------------------
    def run_trajectory_experiments(self) -> dict:
        """Per dataset: optimise the trajectory and compare against ground
        truth with ATE/RPE."""
        from hive_tpu_torch.pose_optimisation import PoseOptimiser

        results = {}

        for dataset_name in self.dataset_names:
            gt_dataset_path = pjoin(self.output_path, dataset_name, "gt", "dataset")

            if not HiveDataset.is_valid_folder_structure(gt_dataset_path):
                logging.warning(f"No converted gt dataset for {dataset_name}; "
                                f"run pipeline experiments first.")
                continue

            dataset = HiveDataset(gt_dataset_path)
            ground_truth = dataset.camera_trajectory.copy()

            optimiser = PoseOptimiser(dataset, debug=False, device=self.device)
            estimated, _, _ = optimiser.run()

            output_folder = pjoin(self.output_path, dataset_name, "trajectory")
            results[dataset_name] = run_trajectory_comparisons(
                dataset, estimated, ground_truth, output_folder, device=self.device)

        with open(pjoin(self.output_path, "trajectory_results.json"), "w") as fh:
            json.dump(results, fh)

        return results

    # -- compression experiments ----------------------------------------------
    def run_compression_experiments(self, profiling: Optional[dict] = None) -> str:
        """Compression ratio table from profiling data."""
        if profiling is None:
            with open(pjoin(self.output_path, "pipeline_profiling.json")) as fh:
                profiling = json.load(fh)

        rows = []

        for dataset_name, configs in profiling.items():
            for config, data in configs.items():
                compression = data.get("mesh_compression", {})

                for part in ("foreground", "background"):
                    stats = compression.get(part)
                    if not isinstance(stats, dict) or "compression_ratio" not in stats:
                        continue

                    rows.append([
                        f"{dataset_name}/{config}/{part}",
                        Latex.format_number(stats["uncompressed_file_size"] / 1e6),
                        Latex.format_number(stats["compressed_file_size"] / 1e6),
                        Latex.format_number(stats["compression_ratio"]),
                        Latex.format_number(100 * stats["data_saving"], 1) + r"\%",
                    ])

        table = Latex.table(["Mesh", "Before (MB)", "After (MB)", "Ratio", "Saving"],
                            rows, caption="Draco compression")

        with open(pjoin(self.output_path, "compression_results.tex"), "w") as fh:
            fh.write(table)

        return table

    # -- mesh-compression matrix ------------------------------------------------
    def run_mesh_compression_experiments(self, configs: Optional[List[str]] = None,
                                         frame_index: int = 0,
                                         mesh_options: Optional[BackgroundMeshOptions] = None
                                         ) -> dict:
        """The compression-option matrix: per dataset x config, export the
        first foreground frame's mesh and the background mesh both
        uncompressed and compressed, record sizes/ratios, and render both
        background variants from the first camera on the card, scoring the
        compressed render against the uncompressed one with SSIM/PSNR.

        Requires converted gt/cm/est datasets (run pipeline experiments
        first). Without ``draco_transcoder`` on PATH the meshes are
        compressed with the KHR_mesh_quantization encoder instead.
        """
        from hive_tpu_torch.geometric import get_pose_components
        from hive_tpu_torch.meshing.gltf import export_scene, load_glb
        from hive_tpu_torch.meshing.mesh import Scene
        from hive_tpu_torch.meshing.render import render_mesh
        from hive_tpu_torch.pipeline import Pipeline

        config_cls = MeshCompressionExperimentConfig
        configs = configs or list(self.CONFIGS)
        have_draco = shutil.which("draco_transcoder") is not None
        if not have_draco:
            logging.info("draco_transcoder not on PATH; compressing with the "
                         "native KHR_mesh_quantization encoder instead.")

        results: Dict[str, dict] = {}
        summaries = {"compression_ratio": MeanSummary(),
                     "render_ssim": MeanSummary(), "render_psnr": MeanSummary()}

        for dataset_name in self.dataset_names:
            for config in configs:
                converted = pjoin(self._run_output_path(dataset_name, config),
                                  "dataset")
                if not HiveDataset.is_valid_folder_structure(converted):
                    continue

                label = f"{dataset_name}/{config}"
                logging.info(f"Compression experiment for {label}...")
                dataset = HiveDataset(converted)

                run_output = pjoin(self.output_path, dataset_name,
                                   "compression", config)
                uncompressed_dir = pjoin(run_output,
                                         config_cls.uncompressed_mesh_folder)
                compressed_dir = pjoin(run_output,
                                       config_cls.compressed_mesh_folder)
                os.makedirs(uncompressed_dir, exist_ok=True)
                os.makedirs(compressed_dir, exist_ok=True)

                pipeline = Pipeline(
                    options=PipelineOptions(num_frames=self.num_frames,
                                            log_file=pjoin(run_output, "logs.log")),
                    storage_options=StorageOptions(dataset_path=converted,
                                                   output_path=run_output,
                                                   overwrite_ok=True),
                    webxr_options=WebXROptions(
                        webxr_path=pjoin(run_output, "webxr")),
                    device=self.device,
                )

                fg_mesh = pipeline.process_frame(dataset, index=frame_index)
                bg_mesh = Pipeline.create_static_mesh(
                    dataset, num_frames=self.num_frames,
                    options=mesh_options or BackgroundMeshOptions(), device=self.device)

                entry = {}
                for name, mesh in ((config_cls.fg_mesh_name, fg_mesh),
                                   (config_cls.bg_mesh_name, bg_mesh)):
                    if mesh.is_empty:
                        continue

                    scene = Scene()
                    scene.add_geometry(mesh, node_name="000000")

                    raw_path = pjoin(uncompressed_dir, f"{name}.glb")
                    export_scene(scene, raw_path)
                    stats = {"uncompressed_file_size": os.path.getsize(raw_path)}

                    drc_path = pjoin(compressed_dir, f"{name}.glb")
                    if have_draco:
                        import subprocess

                        rc = subprocess.run(
                            ["draco_transcoder", "-i", raw_path, "-o", drc_path],
                            capture_output=True).returncode
                        compressed_ok = rc == 0 and os.path.isfile(drc_path)
                        method = "draco"
                    else:
                        from hive_tpu_torch.meshing.gltf import quantize_glb

                        quantize_glb(raw_path, drc_path)
                        compressed_ok = os.path.isfile(drc_path)
                        method = "quantization"

                    if compressed_ok:
                        stats["method"] = method
                        stats["compressed_file_size"] = os.path.getsize(drc_path)
                        stats["compression_ratio"] = (
                            stats["uncompressed_file_size"]
                            / max(stats["compressed_file_size"], 1))
                        stats["data_saving"] = 1 - (
                            stats["compressed_file_size"]
                            / stats["uncompressed_file_size"])
                        summaries["compression_ratio"].update(
                            stats["compression_ratio"])

                    entry[name] = stats

                # Render the two background variants from the first camera and
                # score the compression loss.
                if "bg" in entry and "compressed_file_size" in entry["bg"]:
                    pose = dataset.camera_trajectory.to_homogenous_transforms()[0]
                    R, t = get_pose_components(pose)

                    renders = []
                    for folder in (uncompressed_dir, compressed_dir):
                        loaded = load_glb(pjoin(folder, "bg.glb"))
                        bg = next(iter(loaded.geometry.values()))
                        image, _ = render_mesh(bg, dataset.camera_matrix, R, t,
                                               dataset.frame_width,
                                               dataset.frame_height, device=self.device)
                        write_image(pjoin(run_output, f"{os.path.basename(folder)}.png"),
                                    image)
                        renders.append(image)

                    ssim_value, psnr_value = ssim_psnr(renders[0], renders[1],
                                                       device=self.device)
                    entry["render_comparison"] = {"ssim": ssim_value, "psnr": psnr_value}
                    summaries["render_ssim"].update(ssim_value)
                    summaries["render_psnr"].update(psnr_value)

                results[label] = entry

        results["mean"] = {key: summary.mean
                           for key, summary in summaries.items()
                           if summary.count}

        with open(pjoin(self.output_path, "mesh_compression_results.json"),
                  "w") as fh:
            json.dump(results, fh)

        return results

    # -- inpainting experiments -----------------------------------------------
    def run_inpainting_experiments(self) -> dict:
        results = {}

        for dataset_name in self.dataset_names:
            gt_dataset_path = pjoin(self.output_path, dataset_name, "gt", "dataset")

            if not HiveDataset.is_valid_folder_structure(gt_dataset_path):
                continue

            dataset = HiveDataset(gt_dataset_path)
            experiment = InpaintingExperiment(
                dataset, pjoin(self.output_path, dataset_name, "inpainting"),
                device=self.device)
            results[dataset_name] = experiment.run()

        with open(pjoin(self.output_path, "inpainting_results.json"), "w") as fh:
            json.dump(results, fh)

        return results

    # -- BundleFusion experiments ----------------------------------------------
    def run_bundlefusion_experiments(self) -> dict:
        """Per dataset: reconstruct the background with BundleFusion instead of
        TSDF fusion and record its timing.

        Requires the external BundleFusion binary (BUNDLE_FUSION_BIN);
        without it the group is skipped with a warning.
        """
        import time

        from hive_tpu_torch.fusion import bundle_fusion
        from hive_tpu_torch.options import MeshReconstructionMethod

        if "BUNDLE_FUSION_BIN" not in os.environ:
            logging.warning("BUNDLE_FUSION_BIN not set; skipping BundleFusion "
                            "experiments.")
            return {}

        results = {}

        for dataset_name in self.dataset_names:
            gt_dataset_path = pjoin(self.output_path, dataset_name, "gt", "dataset")

            if not HiveDataset.is_valid_folder_structure(gt_dataset_path):
                continue

            dataset = HiveDataset(gt_dataset_path)

            start = time.time()
            mesh = bundle_fusion(
                "bundle_fusion", dataset,
                options=BackgroundMeshOptions(
                    reconstruction_method=MeshReconstructionMethod.BundleFusion))
            elapsed = time.time() - start

            output_folder = pjoin(self.output_path, dataset_name, "bundlefusion")
            os.makedirs(output_folder, exist_ok=True)
            save_ply(pjoin(output_folder, "mesh.ply"), mesh)

            results[dataset_name] = {"elapsed_seconds": elapsed,
                                     "num_faces": mesh.num_faces}

        with open(pjoin(self.output_path, "bundlefusion_results.json"), "w") as fh:
            json.dump(results, fh)

        return results

    # -- LLFF render-vs-photo experiments ---------------------------------------
    def run_llff_experiments(self, llff_path: str,
                             sequence_names: Optional[List[str]] = None,
                             dataset_name: str = "llff",
                             sdf_max_voxels: int = 80_000_000) -> dict:
        """LLFF render-vs-photo evaluation.

        With ``sequence_names``, ``llff_path`` is a root folder of captures:
        each sequence is reconstructed and scored separately under
        ``llff/<sequence>/``, with a cross-sequence MeanSummary rollup and a
        LaTeX table. Without, ``llff_path`` is a single capture (results
        under ``dataset_name``).
        """
        if sequence_names is None:
            return self._run_llff_sequence(llff_path, dataset_name,
                                           sdf_max_voxels)

        per_sequence: Dict[str, dict] = {}

        for sequence in sequence_names:
            results_root = pjoin(self.output_path, "llff", sequence)
            cached = pjoin(results_root, "llff_metrics.json")

            if os.path.isfile(cached) and not self.overwrite_ok:
                logging.info(f"Cached LLFF results for {sequence}; skipping.")
                with open(cached) as fh:
                    results = json.load(fh)
            else:
                results = self._run_llff_sequence(
                    pjoin(llff_path, sequence), pjoin("llff", sequence),
                    sdf_max_voxels)

            per_sequence[sequence] = results

        rows, rollup = _mean_rows(per_sequence, "mean")
        table = Latex.table(["Sequence", "SSIM", "PSNR", "LPIPS", "MIFD"],
                            rows, caption="LLFF render-vs-photo")
        with open(pjoin(self.output_path, "llff_results.tex"), "w") as fh:
            fh.write(table)

        combined = {"per_sequence": per_sequence, "mean": rollup}
        with open(pjoin(self.output_path, "llff_results.json"), "w") as fh:
            json.dump(combined, fh)

        return combined

    def _write_converted_dataset(self, converted: str, images, camera_matrix: np.ndarray,
                                 trajectory: Trajectory, width: int, height: int) -> None:
        """A HIVE dataset of ``images`` (JPEG), empty masks, DPT depth,
        the camera matrix and trajectory given."""
        from hive_tpu_torch import dataset_adaptors
        from hive_tpu_torch.io import DatasetMetadata, ImageFolderDataset

        for sub in ("rgb", "depth", "mask"):
            os.makedirs(pjoin(converted, sub), exist_ok=True)

        for out_index, image in enumerate(images):
            write_image(pjoin(converted, "rgb", f"{out_index:06d}.jpg"), image)
            write_image(pjoin(converted, "mask", f"{out_index:06d}.png"),
                        np.zeros(image.shape[:2], dtype=np.uint8))

        dataset_adaptors.estimate_depth_dpt(ImageFolderDataset(pjoin(converted, "rgb")),
                                            pjoin(converted, "depth"), device=self.device)

        np.savetxt(pjoin(converted, "camera_matrix.txt"), camera_matrix)
        trajectory.save(pjoin(converted, "camera_trajectory.txt"))

        DatasetMetadata(num_frames=len(trajectory), fps=30.0, width=width, height=height,
                        estimate_pose=False, estimate_depth=True,
                        depth_mask_dilation_iterations=10,
                        depth_scale=1.0 / 1000.0).save(pjoin(converted, "metadata.json"))

    def _run_llff_sequence(self, llff_path: str, dataset_name: str,
                           sdf_max_voxels: int = 80_000_000) -> dict:
        """Reconstruct an LLFF capture from its training views and score
        renders of the held-out views."""
        from hive_tpu_torch.data.llff import LLFFDataset, evaluate_renders

        llff = LLFFDataset(llff_path)
        train, test = llff.train_test_split()

        output_folder = pjoin(self.output_path, dataset_name)
        os.makedirs(output_folder, exist_ok=True)

        # A HiveDataset from the training views with estimated depth.
        converted = pjoin(output_folder, "dataset")
        height, width = int(llff.hwf[0]), int(llff.hwf[1])
        self._write_converted_dataset(
            converted, (llff.get_image(view)[:height, :width] for view in train),
            llff.camera_matrix, Trajectory(llff.get_trajectory().values[train]), width, height)

        dataset = HiveDataset(converted)
        mesh = tsdf_fusion(dataset, BackgroundMeshOptions(sdf_max_voxels=sdf_max_voxels),
                           device=self.device)
        save_ply(pjoin(output_folder, "reconstruction.ply"), mesh)

        results = evaluate_renders(mesh, llff, view_indices=test,
                                   output_folder=pjoin(output_folder, "renders"),
                                   device=self.device)

        with open(pjoin(output_folder, "llff_metrics.json"), "w") as fh:
            json.dump(results, fh)

        return results

    def run_hypernerf_experiments(self, hypernerf_path: str,
                                  scene_names: Optional[List[str]] = None,
                                  dataset_name: str = "hypernerf",
                                  sdf_max_voxels: int = 80_000_000) -> dict:
        """HyperNeRF render-vs-photo evaluation.

        With ``scene_names``, ``hypernerf_path`` is a root of captures (each
        scene's scale/near/far comes from its own ``scene.json``): each scene
        is evaluated separately with a cross-scene MeanSummary rollup and
        LaTeX table. Without, a single capture is evaluated.
        """
        if scene_names is None:
            return self._run_hypernerf_scene(hypernerf_path, dataset_name,
                                             sdf_max_voxels)

        per_scene: Dict[str, dict] = {}

        for scene in scene_names:
            results_root = pjoin(self.output_path, "hypernerf", scene)
            cached = pjoin(results_root, "hypernerf_metrics.json")

            if os.path.isfile(cached) and not self.overwrite_ok:
                logging.info(f"Cached HyperNeRF results for {scene}; skipping.")
                with open(cached) as fh:
                    results = json.load(fh)
            else:
                results = self._run_hypernerf_scene(
                    pjoin(hypernerf_path, scene), pjoin("hypernerf", scene),
                    sdf_max_voxels)

            per_scene[scene] = results

        rows, rollup = _mean_rows(per_scene, "mean")
        table = Latex.table(["Scene", "SSIM", "PSNR", "LPIPS", "MIFD"],
                            rows, caption="HyperNeRF render-vs-photo")
        with open(pjoin(self.output_path, "hypernerf_results.tex"), "w") as fh:
            fh.write(table)

        combined = {"per_scene": per_scene, "mean": rollup}
        with open(pjoin(self.output_path, "hypernerf_results.json"), "w") as fh:
            json.dump(combined, fh)

        return combined

    def _run_hypernerf_scene(self, hypernerf_path: str,
                             dataset_name: str = "hypernerf",
                             sdf_max_voxels: int = 80_000_000) -> dict:
        """Reconstruct a HyperNeRF capture from its train split and score
        renders of the held-out validation views.

        HyperNeRF captures carry per-item cameras, so views are rendered
        with each item's own intrinsics/pose rather than one shared K.
        """
        from hive_tpu_torch.data.hypernerf import HyperNeRFDataset
        from hive_tpu_torch.geometric import get_pose_components
        from hive_tpu_torch.meshing.render import render_mesh
        from hive_tpu_torch.metrics import mifd

        hypernerf = HyperNeRFDataset(hypernerf_path)
        train, val = hypernerf.train_val_split()

        output_folder = pjoin(self.output_path, dataset_name)
        converted = pjoin(output_folder, "dataset")

        first = hypernerf.get_image(train[0])
        height, width = first.shape[:2]

        self._write_converted_dataset(
            converted, (hypernerf.get_image(item_id)[:height, :width] for item_id in train),
            hypernerf.cameras[train[0]].camera_matrix, hypernerf.get_trajectory(train),
            width, height)

        dataset = HiveDataset(converted)
        mesh = tsdf_fusion(dataset, BackgroundMeshOptions(sdf_max_voxels=sdf_max_voxels),
                           device=self.device)
        save_ply(pjoin(output_folder, "reconstruction.ply"), mesh)

        renders_folder = pjoin(output_folder, "renders")
        os.makedirs(renders_folder, exist_ok=True)

        results = {"ssim": [], "psnr": [], "lpips": [], "mifd": []}
        for item_id in val:
            camera = hypernerf.cameras[item_id]
            R, t = get_pose_components(camera.world_to_camera)
            photo = hypernerf.get_image(item_id)[:height, :width, :3]
            rendered, _ = render_mesh(mesh, camera.camera_matrix, R, t,
                                      width, height, device=self.device)

            ssim_value, psnr_value = ssim_psnr(photo, rendered, device=self.device)
            results["ssim"].append(ssim_value)
            results["psnr"].append(psnr_value)
            results["lpips"].append(lpips(photo, rendered, device=self.device))
            results["mifd"].append(mifd(photo, rendered, device=self.device))
            write_image(pjoin(renders_folder, f"render_{item_id}.png"), rendered)

        def safe_mean(values):
            finite = [v for v in values if np.isfinite(v)]
            return float(np.mean(finite)) if finite else float("nan")

        skipped = metric_skip_notes(results, self.device)
        results["mean"] = {metric: safe_mean(values)
                           for metric, values in results.items()}
        if skipped:
            results["skipped"] = skipped

        with open(pjoin(output_folder, "hypernerf_metrics.json"), "w") as fh:
            json.dump(results, fh)

        return results

    # -- canonical single-video experiment -------------------------------------
    def run_kid_running_experiments(self, video_path: str) -> dict:
        """The canonical monocular-video experiment: the full estimated
        pipeline on a single RGB video."""
        from hive_tpu_torch.pipeline import Pipeline

        run_output = pjoin(self.output_path, "kid_running")
        # Before Pipeline(): __init__ opens run_output/logs.log.
        os.makedirs(run_output, exist_ok=True)

        pipeline = Pipeline(
            options=PipelineOptions(num_frames=self.num_frames, frame_step=self.frame_step,
                                    estimate_pose=True, estimate_depth=True,
                                    log_file=pjoin(run_output, "logs.log")),
            storage_options=StorageOptions(dataset_path=video_path,
                                           output_path=pjoin(run_output, "dataset"),
                                           overwrite_ok=True),
            colmap_options=self.colmap_options,
            webxr_options=WebXROptions(webxr_path=pjoin(run_output, "webxr")),
            device=self.device,
        )

        pipeline.run()

        with open(pjoin(run_output, "dataset", "profiling.json")) as fh:
            return json.load(fh)


def main(argv=None, device=None):
    """:param device: where the experiments run; default ``cuda:0``."""
    parser = argparse.ArgumentParser(description="Run the evaluation experiment suite.")
    parser.add_argument("--data_path", type=str, required=True,
                        help="Folder containing the input datasets.")
    parser.add_argument("--output_path", type=str, required=True,
                        help="Folder to write experiment outputs to.")
    parser.add_argument("--dataset_names", type=str, nargs="+", required=True,
                        help="Names of datasets (folders under data_path) to evaluate.")
    parser.add_argument("--num_frames", type=int, default=-1)
    parser.add_argument("--frame_step", type=int, default=15)
    parser.add_argument("--experiments", type=str, nargs="+",
                        default=["pipeline", "export"],
                        choices=["pipeline", "export", "trajectory", "compression",
                                 "mesh_compression", "inpainting", "llff",
                                 "hypernerf"],
                        help="Which experiment groups to run.")
    parser.add_argument("--llff_path", type=str, default=None,
                        help="Root folder of LLFF captures (for the llff group).")
    parser.add_argument("--llff_sequences", type=str, nargs="+", default=None,
                        help="LLFF sequence names under --llff_path.")
    parser.add_argument("--hypernerf_path", type=str, default=None,
                        help="Root folder of HyperNeRF captures.")
    parser.add_argument("--hypernerf_scenes", type=str, nargs="+", default=None,
                        help="HyperNeRF scene names under --hypernerf_path.")
    parser.add_argument("--overwrite_ok", action="store_true")
    args = parser.parse_args(argv)

    # The output folder first, so the initial sweep also gets a log file.
    os.makedirs(args.output_path, exist_ok=True)
    setup_logger(pjoin(args.output_path, "experiments.log"))

    experiments = Experiments(data_path=args.data_path, output_path=args.output_path,
                              dataset_names=args.dataset_names,
                              num_frames=args.num_frames, frame_step=args.frame_step,
                              overwrite_ok=args.overwrite_ok, device=device)

    if "pipeline" in args.experiments:
        experiments.run_pipeline_experiments()

    if "export" in args.experiments:
        print(experiments.export_pipeline_results())

    if "trajectory" in args.experiments:
        experiments.run_trajectory_experiments()

    if "compression" in args.experiments:
        print(experiments.run_compression_experiments())

    if "mesh_compression" in args.experiments:
        experiments.run_mesh_compression_experiments()

    if "inpainting" in args.experiments:
        experiments.run_inpainting_experiments()

    if "llff" in args.experiments and args.llff_path:
        experiments.run_llff_experiments(args.llff_path,
                                         sequence_names=args.llff_sequences)

    if "hypernerf" in args.experiments and args.hypernerf_path:
        experiments.run_hypernerf_experiments(
            args.hypernerf_path, scene_names=args.hypernerf_scenes)


if __name__ == "__main__":
    main()
