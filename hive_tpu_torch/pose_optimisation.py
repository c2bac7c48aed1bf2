"""Gradient-based camera-trajectory refinement from image correspondences.

Counterpart of ``hive_tpu/pose_optimisation.py``: frame-pair sampling, the
``FeatureData`` / ``FeatureSet`` containers (the same ``.npz`` keys), the
extractor's feature-set cache, the optimisation options, the loss and its
chunked Adam loop (:func:`optimise_packed_features`), ``PoseOptimiser``,
``ForegroundPoseOptimiser`` and the standalone CLI
(``python -m hive_tpu_torch.pose_optimisation``).

The device code is plain PyTorch: the loss is a function of tensors and its
gradients come from autograd. Each epoch projects the parameters (unit
quaternions, the inter-frame distance clip), takes the loss and its
gradients, pins frame 0 and applies Adam in optax 0.2.6's order, which is
not ``torch.optim.Adam``'s (the bias corrections divide the moments, then
``eps`` is added to the root of the second one). A chunk of epochs keeps its
losses on the device and the host reads them once per chunk, as
``hive_tpu`` reads its ``lax.scan``'s output; the learning rate is a device
scalar. ReduceLROnPlateau, early stopping and checkpoints run on the host
between chunks, as in the JAX package.

:class:`FeatureExtractor` detects SIFT features, matches them and filters
them with a robust homography on the device (``hive_tpu`` runs those steps
with OpenCV on the host); a cached ``feature_set.npz`` from either package is
reused.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import logging
import os
from os.path import join as pjoin
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.core import transforms as T
from hive_tpu_torch.geometric import (Trajectory, add_pose, get_identity_pose,
                                      point_cloud_from_depth, subtract_pose)
from hive_tpu_torch.image_codecs import CV2_JPEG_QUALITY, write_image
from hive_tpu_torch.io import HiveDataset
from hive_tpu_torch.ops import homography, matching, sift
from hive_tpu_torch.parallel.mesh import replicate, shard_batch
from hive_tpu_torch.parallel.runtime import runtime_mesh
from hive_tpu_torch.sfm import RANSAC_SEED
from hive_tpu_torch.utils import Domain, check_domain, temp_seed, tqdm_imap


# ---------------------------------------------------------------------------
# Frame pair sampling.
# ---------------------------------------------------------------------------

class FrameSamplingMode(enum.Enum):
    """Strategy for choosing which frame pairs constrain the pose graph."""

    Exhaustive = enum.auto()               # all unique pairs — O(N^2)
    Consecutive = enum.auto()              # (0,1), (1,2), ...
    ConsecutiveNoOverlap = enum.auto()     # (0,1), (2,3), ...
    ConsecutiveNoOverlapOffset = enum.auto()  # (1,2), (3,4), ...
    Hierarchical = enum.auto()             # power-of-two strides — O(N log N)


FramePair = Tuple[int, int]
FramePairs = List[FramePair]


def sample_frame_pairs(mode: FrameSamplingMode, num_frames: int) -> FramePairs:
    """Enumerate frame pairs for a sampling mode."""
    if mode == FrameSamplingMode.Exhaustive:
        return [(i, j) for i in range(num_frames) for j in range(i + 1, num_frames)]

    if mode in (FrameSamplingMode.Consecutive, FrameSamplingMode.ConsecutiveNoOverlap,
                FrameSamplingMode.ConsecutiveNoOverlapOffset):
        start = 1 if mode == FrameSamplingMode.ConsecutiveNoOverlapOffset else 0
        step = 1 if mode == FrameSamplingMode.Consecutive else 2
        return [(i, i + 1) for i in range(start, num_frames - 1, step)]

    if mode == FrameSamplingMode.Hierarchical:
        # Consecutive pairs plus increasingly distant (power-of-two) pairs.
        pairs = []
        max_level = int(np.floor(np.log2(max(num_frames - 1, 1))))

        for level in range(max_level + 1):
            step = 1 << level
            for start in range(0, num_frames, step):
                if start + step < num_frames:
                    pairs.append((start, start + step))

        return pairs

    raise RuntimeError(f"No such frame sampling mode: {mode}.")


# ---------------------------------------------------------------------------
# Feature data containers (host NumPy; shipped to the device as one batch).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FeatureData:
    """Per-correspondence data for one side of the frame pairs."""

    index: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    points: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.float32))
    depth: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.float32))

    def __len__(self):
        return len(self.index)

    def sample_at(self, mask_or_indices) -> "FeatureData":
        return FeatureData(self.index[mask_or_indices].copy(),
                           self.points[mask_or_indices].copy(),
                           self.depth[mask_or_indices].copy())

    @staticmethod
    def concatenate(items: List["FeatureData"]) -> "FeatureData":
        if not items:
            return FeatureData()

        return FeatureData(np.concatenate([d.index for d in items]),
                           np.concatenate([d.points for d in items]),
                           np.concatenate([d.depth for d in items]))


@dataclasses.dataclass
class FeatureSet:
    """Matched correspondences between frame pairs + shared intrinsics.

    Persisted as `.npz` with ``hive_tpu``'s keys, so a file written by
    either package loads in the other.
    """

    camera_matrix: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    frame_i: FeatureData = dataclasses.field(default_factory=FeatureData)
    frame_j: FeatureData = dataclasses.field(default_factory=FeatureData)

    def __len__(self):
        return len(self.frame_i)

    def save(self, f):
        np.savez(f, camera_matrix=self.camera_matrix,
                 index_i=self.frame_i.index, points_i=self.frame_i.points,
                 depth_i=self.frame_i.depth,
                 index_j=self.frame_j.index, points_j=self.frame_j.points,
                 depth_j=self.frame_j.depth)

    @classmethod
    def load(cls, f) -> "FeatureSet":
        data = np.load(f)
        return cls(camera_matrix=data["camera_matrix"],
                   frame_i=FeatureData(data["index_i"], data["points_i"], data["depth_i"]),
                   frame_j=FeatureData(data["index_j"], data["points_j"], data["depth_j"]))

    def sample_at(self, frame_indices: Iterable[int]) -> "FeatureSet":
        """Keep only correspondences where both frames are in ``frame_indices``."""
        frame_set = np.asarray(sorted(set(frame_indices)))
        mask = (np.isin(self.frame_i.index, frame_set)
                & np.isin(self.frame_j.index, frame_set))

        return FeatureSet(self.camera_matrix.copy(),
                          self.frame_i.sample_at(mask), self.frame_j.sample_at(mask))

    def subset_from(self, frame_pairs: FramePairs) -> "FeatureSet":
        """Keep only correspondences belonging to the given frame pairs."""
        if len(self) == 0:
            return FeatureSet(self.camera_matrix.copy())

        pairs = np.asarray(list(frame_pairs), dtype=np.int64)
        # The key base must cover the REQUESTED pairs too: a base taken
        # from the feature set alone lets a requested j past our max wrap
        # into a colliding key and falsely match.
        base = int(max(self.frame_j.index.max(), pairs[:, 1].max())) + 1
        ours = self.frame_i.index.astype(np.int64) * base + self.frame_j.index
        theirs = pairs[:, 0] * base + pairs[:, 1]
        mask = np.isin(ours, theirs)

        return FeatureSet(self.camera_matrix.copy(),
                          self.frame_i.sample_at(mask), self.frame_j.sample_at(mask))


# ---------------------------------------------------------------------------
# Feature extraction.
# ---------------------------------------------------------------------------

class FeatureExtractionOptions:
    """Options for the FeatureExtractor."""

    def __init__(self, ignore_dynamic_objects: bool = True, min_features: int = 20,
                 max_features: Optional[int] = 2048,
                 save_match_visualisations: bool = False):
        if not isinstance(min_features, int) or min_features < 5:
            raise ValueError(f"min_features needs an int >= 5 (RANSAC needs at least 5 "
                             f"correspondences); got {min_features}.")

        if max_features is not None and (not isinstance(max_features, int)
                                         or max_features <= min_features):
            raise ValueError(f"max_features must be an int above min_features "
                             f"(= {min_features}); got {max_features}.")

        if min_features < 20:
            logging.warning(f"min_features={min_features} is low; values under 20 tend to "
                            f"leave too few matches for a stable solve.")

        self.ignore_dynamic_objects = ignore_dynamic_objects
        self.min_features = min_features
        self.max_features = max_features
        # Write accepted/rejected match JPEGs per frame pair into
        # <debug_path>/matches.
        self.save_match_visualisations = save_match_visualisations


class FeatureExtractor:
    """SIFT + exact k-NN matching with ratio / depth / homography filtering,
    on the device.

    ``hive_tpu``'s extractor runs SIFT, FLANN and a MAGSAC homography with
    OpenCV on the host; here they are :mod:`hive_tpu_torch.ops.sift`,
    :mod:`~hive_tpu_torch.ops.matching` and
    :mod:`~hive_tpu_torch.ops.homography` on ``device``. The cache is
    ``hive_tpu``'s (``frame_pairs.txt``, ``feature_options.json`` and
    ``feature_set.npz`` under ``debug_path``), so either package reuses the
    other's feature set.
    """

    def __init__(self, dataset: HiveDataset, frame_pairs: FramePairs,
                 feature_extraction_options=FeatureExtractionOptions(),
                 debug_path: Optional[str] = None, device=None):
        """:param device: where features are detected and matched; default
        ``cuda:0``. Each pair's homography samples come from a generator
        seeded with ``sfm.RANSAC_SEED``."""
        self.dataset = dataset
        self.frame_pairs = frame_pairs
        self.options = feature_extraction_options
        self.debug_path = debug_path
        self.feature_set_path: Optional[str] = None
        self.frame_pairs_path: Optional[str] = None
        self.device = get_device(device)

        self.frames: Optional[List[torch.Tensor]] = None
        self.depth_maps: Optional[List[torch.Tensor]] = None
        self.masks: Optional[List[torch.Tensor]] = None
        self._detect_cache: Dict[int, "sift.SiftFeatures"] = {}

    def extract_feature_points(self) -> FeatureSet:
        logging.info("Detecting and matching image features...")
        self._setup_cache()

        if self.feature_set_path and os.path.isfile(self.feature_set_path):
            logging.info(f"Reusing the cached feature set {self.feature_set_path}")
            return FeatureSet.load(self.feature_set_path)

        self._load_frame_data()

        good = [r for r in map(self._match_pair, self.frame_pairs) if r is not None]
        if good:
            frame_i = FeatureData.concatenate([g.frame_i for g in good])
            frame_j = FeatureData.concatenate([g.frame_j for g in good])
        else:
            frame_i = frame_j = FeatureData(np.zeros(0, np.int64), np.zeros((0, 2), np.float32),
                                            np.zeros(0, np.float32))
        feature_set = FeatureSet(camera_matrix=self.dataset.camera_matrix.copy(),
                                 frame_i=frame_i, frame_j=frame_j)

        self._log_stats(feature_set, num_good_pairs=len(good))

        if self.feature_set_path:
            feature_set.save(self.feature_set_path)

        return feature_set

    def _setup_cache(self):
        """``hive_tpu``'s cache check: keep ``feature_set.npz`` only for the
        same frame pairs and options fingerprint; otherwise delete it and
        write this run's pairs and fingerprint."""
        if self.debug_path is None:
            return

        os.makedirs(self.debug_path, exist_ok=True)
        self.frame_pairs_path = pjoin(self.debug_path, "frame_pairs.txt")
        self.feature_set_path = pjoin(self.debug_path, "feature_set.npz")
        options_path = pjoin(self.debug_path, "feature_options.json")
        options_fingerprint = json.dumps(vars(self.options), sort_keys=True, default=str)

        keep_cache = False
        if os.path.isfile(self.frame_pairs_path):
            cached = np.loadtxt(self.frame_pairs_path)
            cached = cached.reshape(-1, 2)
            keep_cache = (len(cached) == len(self.frame_pairs)
                          and np.array_equal(cached, np.asarray(self.frame_pairs)))
        if keep_cache:
            try:
                with open(options_path) as f:
                    keep_cache = f.read() == options_fingerprint
            except OSError:
                keep_cache = False

        if not keep_cache:
            if os.path.isfile(self.feature_set_path):
                os.remove(self.feature_set_path)
            np.savetxt(self.frame_pairs_path, np.asarray(self.frame_pairs))
            with open(options_path, "w") as f:
                f.write(options_fingerprint)

    def _load_frame_data(self):
        """Grey frames, depth maps and (with ``ignore_dynamic_objects``) the
        SIFT masks of the static regions, on the device."""
        logging.info("Loading frames...")
        num_frames = self.dataset.num_frames

        def to_device(image):
            return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

        self.frames = [sift.rgb_to_grey(to_device(frame)) for frame in
                       tqdm_imap(self.dataset.rgb_dataset.__getitem__, range(num_frames))]

        logging.info("Reading the depth maps into memory...")
        self.depth_maps = [to_device(depth) for depth in
                           tqdm_imap(self.dataset.depth_dataset.__getitem__, range(num_frames))]

        if self.options.ignore_dynamic_objects:
            logging.info("Loading masks...")
            # SIFT mask: nonzero = detect here; exclude dynamic objects.
            self.masks = [torch.where(to_device(mask) > 0, 0, 255).to(torch.uint8) for mask in
                          tqdm_imap(self.dataset.mask_dataset.__getitem__, range(num_frames))]
        else:
            self.masks = None

    def _detect(self, index: int) -> "sift.SiftFeatures":
        """SIFT of frame ``index``, once per frame (each frame appears in
        several pairs)."""
        cache = getattr(self, "_detect_cache", None)
        if cache is None:
            cache = self._detect_cache = {}
        cached = cache.get(index)
        if cached is None:
            mask = self.masks[index] if self.masks is not None else None
            cached = sift.detect_and_compute(self.frames[index], mask,
                                             nfeatures=self.options.max_features or 0)
            cache[index] = cached
        return cached

    def _match_pair(self, frame_pair: FramePair) -> Optional[FeatureSet]:
        i, j = frame_pair

        kp_i, kp_j = self._detect(i), self._detect(j)
        if min(len(kp_i), len(kp_j)) < self.options.min_features:
            return None

        # Lowe's ratio test: reject m > 0.7 n.
        matches = matching.match_descriptors(kp_i.descriptors, kp_j.descriptors, 0.7,
                                             strict=False)
        pt_i, pt_j = kp_i.xy[matches[:, 0]], kp_j.xy[matches[:, 1]]
        depth_i = self.depth_maps[i][torch.round(pt_i[:, 1]).long(), torch.round(pt_i[:, 0]).long()]
        depth_j = self.depth_maps[j][torch.round(pt_j[:, 1]).long(), torch.round(pt_j[:, 0]).long()]
        keep = (depth_i != 0) & (depth_j != 0)
        if int(keep.sum()) < self.options.min_features:
            return None

        pt_i, pt_j = pt_i[keep], pt_j[keep]
        generator = torch.Generator(device=self.device)
        generator.manual_seed(RANSAC_SEED)
        # Robust geometric filter (the MAGSAC homography of hive_tpu).
        _, inlier_mask = homography.find_homography(pt_i, pt_j, generator=generator)
        if inlier_mask is None:
            return None

        points_i = pt_i.cpu().numpy().astype(np.float32)
        points_j = pt_j.cpu().numpy().astype(np.float32)
        depths_i = depth_i[keep].cpu().numpy().astype(np.float32)
        depths_j = depth_j[keep].cpu().numpy().astype(np.float32)
        inliers = inlier_mask.cpu().numpy()

        if self.options.save_match_visualisations and self.debug_path:
            self._save_matches_visualisation(frame_pair, points_i, points_j, inliers)

        if inliers.sum() < self.options.min_features:
            return None

        n_matches = int(inliers.sum())
        return FeatureSet(
            camera_matrix=self.dataset.camera_matrix.copy(),
            frame_i=FeatureData(np.full(n_matches, i, dtype=np.int64),
                                points_i[inliers], depths_i[inliers]),
            frame_j=FeatureData(np.full(n_matches, j, dtype=np.int64),
                                points_j[inliers], depths_j[inliers]),
        )

    def _save_matches_visualisation(self, frame_pair: FramePair, points_i: np.ndarray,
                                    points_j: np.ndarray, inliers: np.ndarray):
        """Side-by-side accepted (green) and rejected (red) match JPEGs of a
        frame pair under ``<debug_path>/matches/``, named, sized and drawn
        between the same endpoints as ``hive_tpu``'s; drawn by
        :func:`draw_matches` and written at OpenCV's JPEG quality."""
        i, j = frame_pair
        viz_dir = pjoin(self.debug_path, "matches")
        os.makedirs(viz_dir, exist_ok=True)

        frame_i, frame_j = self.frames[i].cpu().numpy(), self.frames[j].cpu().numpy()
        for mask, colour, suffix in ((inliers, (0, 192, 0), "accepted"),
                                     (~inliers, (224, 0, 0), "rejected")):
            canvas = draw_matches(frame_i, frame_j, points_i[mask], points_j[mask], colour)
            write_image(pjoin(viz_dir, f"{i:06d}-{j:06d}-{suffix}.jpg"), canvas,
                        jpeg_quality=CV2_JPEG_QUALITY)

    def _log_stats(self, feature_set: FeatureSet, num_good_pairs: int):
        covered = set(feature_set.frame_i.index.tolist()) \
            | set(feature_set.frame_j.index.tolist())
        coverage = len(covered) / max(self.dataset.num_frames, 1)

        logging.info(f"Usable frame pairs: {num_good_pairs} of {len(self.frame_pairs)}")
        logging.info(f"Pair coverage: {100 * coverage:.2f}% of all frames.")


def _raster_line(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels (rows, cols) of the 1-pixel segments from each a to each b
    ((N, 2) integer (x, y) points): one sample a pixel along the longer axis."""
    steps = np.maximum(np.abs(b - a).max(axis=1), 1)
    t = np.arange(steps.max() + 1)[None, :] / steps[:, None]
    t = np.where(t <= 1, t, 1.0)
    xy = np.rint(a[:, None, :] + (b - a)[:, None, :] * t[..., None]).astype(np.int64)
    return xy[..., 1].ravel(), xy[..., 0].ravel()


def _raster_circle(centres: np.ndarray, radius: int) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels of 1-pixel circles of ``radius`` around (N, 2) centres."""
    angles = np.linspace(0, 2 * np.pi, 8 * radius + 1)[:-1]
    ring = np.rint(np.stack([np.cos(angles), np.sin(angles)], 1) * radius).astype(np.int64)
    xy = centres[:, None, :] + ring[None]
    return xy[..., 1].ravel(), xy[..., 0].ravel()


def draw_matches(frame_i: np.ndarray, frame_j: np.ndarray, points_i: np.ndarray,
                 points_j: np.ndarray, colour: Tuple[int, int, int]) -> np.ndarray:
    """Two grey frames side by side as RGB, each match a circle of radius 3
    at both ends and a line between them in ``colour``: the endpoints of
    ``hive_tpu``'s ``cv2.circle`` / ``cv2.line`` drawing (rounded points, the
    second frame offset by the first's width), drawn without anti-aliasing."""
    h = max(frame_i.shape[0], frame_j.shape[0])
    offset_u = frame_i.shape[1]
    canvas = np.zeros((h, offset_u + frame_j.shape[1], 3), np.uint8)
    canvas[:frame_i.shape[0], :offset_u] = frame_i[..., None]
    canvas[:frame_j.shape[0], offset_u:] = frame_j[..., None]
    if len(points_i):
        a = np.rint(points_i).astype(np.int64)
        b = np.rint(points_j).astype(np.int64) + np.array([offset_u, 0])
        rows, cols = [], []
        for r, c in (_raster_circle(a, 3), _raster_circle(b, 3), _raster_line(a, b)):
            rows.append(r)
            cols.append(c)
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        inside = (rows >= 0) & (rows < canvas.shape[0]) & (cols >= 0) & (cols < canvas.shape[1])
        canvas[rows[inside], cols[inside]] = colour
    return canvas


# ---------------------------------------------------------------------------
# Optimisation configuration.
# ---------------------------------------------------------------------------

class AlignmentType(enum.Enum):
    """How depth maps are scaled/shifted during alignment."""

    Rigid = enum.auto()       # pose only
    Affine = enum.auto()      # + per-frame inverse-depth scale & shift
    Deformable = enum.auto()  # + per-frame 3x3 grid of scale & shift


class ResidualType(enum.Enum):
    World3D = enum.auto()  # 3D distance between correspondences in world space
    Image2D = enum.auto()  # pixel distance after cross-projection


class OptimisationStep(enum.Enum):
    PairWise3D = enum.auto()
    Global3D = enum.auto()
    PairWise2D = enum.auto()
    Global2D = enum.auto()


class EarlyStopping:
    """Stagnation tracker (host side)."""

    def __init__(self, patience: int = 10, min_difference: float = 0.0):
        self.patience = patience
        self.min_difference = min_difference
        self.best_loss = float("inf")
        self.calls_since_last_best = 0
        self.should_stop = False

    def step(self, loss: float) -> bool:
        if loss < self.best_loss and abs(loss - self.best_loss) > self.min_difference:
            self.best_loss = loss
            self.calls_since_last_best = 0
        else:
            self.calls_since_last_best += 1

        if self.calls_since_last_best > self.patience:
            self.should_stop = True

        return self.should_stop


class OptimisationOptions:
    """Configuration for PoseOptimiser."""

    default_pipeline = (OptimisationStep.PairWise3D, OptimisationStep.Global3D)

    def __init__(self, num_epochs: int = 4000, learning_rate: float = 1e-2,
                 l2_regularisation: float = 0.5, min_loss_delta: float = 1e-4,
                 lr_scheduler_patience: int = 50, early_stopping_patience: int = 75,
                 alignment_type: AlignmentType = AlignmentType.Rigid,
                 steps=default_pipeline, position_only: bool = False, fine_tune: bool = True,
                 pose_t_reg: float = 0.5, pose_r_reg: float = 1.0,
                 trajectory_smoothing: Optional[float] = None,
                 clip_distance: Optional[float] = 1.0,
                 epochs_per_chunk: int = 25,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_chunks: int = 20):
        check_domain(num_epochs, "num_epochs", int, Domain.Positive)
        check_domain(learning_rate, "learning_rate", float, Domain.Positive)
        check_domain(l2_regularisation, "l2_regularisation", float, Domain.NonNegative)
        check_domain(min_loss_delta, "min_loss_delta", float, Domain.Positive)
        check_domain(lr_scheduler_patience, "lr_scheduler_patience", int, Domain.Positive)
        check_domain(early_stopping_patience, "early_stopping_patience", int, Domain.Positive)
        check_domain(pose_t_reg, "pose_t_reg", float, Domain.NonNegative)
        check_domain(pose_r_reg, "pose_r_reg", float, Domain.NonNegative)
        check_domain(trajectory_smoothing, "trajectory_smoothing", float, Domain.NonNegative,
                     nullable=True)
        check_domain(clip_distance, "clip_distance", float, Domain.NonNegative, nullable=True)
        check_domain(epochs_per_chunk, "epochs_per_chunk", int, Domain.Positive)
        check_domain(checkpoint_every_chunks, "checkpoint_every_chunks", int,
                     Domain.Positive)

        if not isinstance(steps, (tuple, list)) or len(steps) == 0:
            raise ValueError("steps must be a tuple or list with at least one element.")

        for step in steps:
            if not isinstance(step, OptimisationStep):
                raise ValueError(f"steps must only contain OptimisationStep values, "
                                 f"found {type(step)}")

        self.num_epochs = num_epochs
        self.learning_rate = learning_rate
        self.l2_regularisation = l2_regularisation
        self.min_loss_delta = min_loss_delta
        self.lr_scheduler_patience = lr_scheduler_patience
        self.early_stopping_patience = early_stopping_patience
        self.alignment_type = alignment_type
        self.steps = tuple(steps)
        self.position_only = position_only
        self.fine_tune = fine_tune
        self.pose_t_reg = pose_t_reg
        self.pose_r_reg = pose_r_reg
        self.trajectory_smoothing = trajectory_smoothing
        self.clip_distance = clip_distance
        self.epochs_per_chunk = epochs_per_chunk
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_chunks = checkpoint_every_chunks

    def copy(self) -> "OptimisationOptions":
        return OptimisationOptions(
            num_epochs=self.num_epochs, learning_rate=self.learning_rate,
            l2_regularisation=self.l2_regularisation, min_loss_delta=self.min_loss_delta,
            lr_scheduler_patience=self.lr_scheduler_patience,
            early_stopping_patience=self.early_stopping_patience,
            alignment_type=self.alignment_type, steps=self.steps,
            position_only=self.position_only, fine_tune=self.fine_tune,
            pose_t_reg=self.pose_t_reg, pose_r_reg=self.pose_r_reg,
            trajectory_smoothing=self.trajectory_smoothing,
            clip_distance=self.clip_distance, epochs_per_chunk=self.epochs_per_chunk,
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_every_chunks=self.checkpoint_every_chunks)


# ---------------------------------------------------------------------------
# Device-side optimisation core.
# ---------------------------------------------------------------------------

# The optimised parameters, in sorted key order (jax.tree.flatten's order of
# hive_tpu's params dict, which its checkpoints follow).
PARAM_KEYS = ("q", "scale", "shift", "t")

# optax.adam's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# ForegroundPoseOptimiser's AdamW weight decay (optax.adamw's argument).
FOREGROUND_WEIGHT_DECAY = 1e-4


def _apply_depth_alignment(depth, points, indices, scale, shift, alignment: AlignmentType,
                           frame_size):
    """Optionally warp inverse depth by learned per-frame scale/shift."""
    if alignment == AlignmentType.Rigid:
        return depth

    if alignment == AlignmentType.Affine:
        s = scale[indices]
        b = shift[indices]
        return 1.0 / (s * (1.0 / depth) + b)

    # Deformable: bilinear sample a per-frame 3x3 scale/shift grid at the
    # correspondence location.
    w, h = frame_size
    gx = torch.clamp(points[:, 0] / max(w - 1, 1) * 2.0, 0.0, 2.0)
    gy = torch.clamp(points[:, 1] / max(h - 1, 1) * 2.0, 0.0, 2.0)

    x0 = torch.clamp(torch.floor(gx).long(), 0, 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, 1)
    fx = gx - x0
    fy = gy - y0

    def sample(field):
        # Grid rows index y, columns x.
        f00 = field[indices, y0, x0]
        f01 = field[indices, y0, x0 + 1]
        f10 = field[indices, y0 + 1, x0]
        f11 = field[indices, y0 + 1, x0 + 1]
        return ((1 - fy) * ((1 - fx) * f00 + fx * f01)
                + fy * ((1 - fx) * f10 + fx * f11))

    s = sample(scale)
    b = sample(shift)
    return 1.0 / (s * (1.0 / depth) + b)


def _unproject_to_world(points, depth, indices, quats, trans, intrinsics):
    """Correspondences → world space via the (inverse) camera poses."""
    fx, fy, cx, cy = intrinsics
    x = (points[:, 0] - cx) * depth / fx
    y = (points[:, 1] - cy) * depth / fy
    cam = torch.stack([x, y, depth], dim=-1)

    q = T.quat_normalize(quats[indices])
    # World = R^T (cam - t): rotate by the conjugate.
    return T.quat_rotate(T.quat_conjugate(q), cam - trans[indices])


def _project_to_image(world, indices, quats, trans, intrinsics):
    fx, fy, cx, cy = intrinsics
    q = T.quat_normalize(quats[indices])
    cam = T.quat_rotate(q, world) + trans[indices]

    x, y, z = cam[:, 0], cam[:, 1], cam[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    return torch.stack([(fx * x + cx * z) / safe_z, (fy * y + cy * z) / safe_z], dim=-1)


def _clip_frame_distances(positions, max_frame_distance):
    """Limit inter-frame displacement, propagating shifts downstream, as a
    cumulative sum of clipped deltas."""
    deltas = positions[1:] - positions[:-1]
    norms = torch.linalg.vector_norm(deltas, dim=-1, keepdim=True)
    factor = torch.clamp(max_frame_distance / torch.clamp(norms, min=1e-12), max=1.0)
    clipped = deltas * factor

    return torch.cat([positions[:1], positions[:1] + torch.cumsum(clipped, dim=0)])


def _make_loss_fn(residual_type: ResidualType, alignment: AlignmentType, smooth: bool,
                  position_only: bool, pose_t_reg: float, pose_r_reg: float,
                  l2_reg: float, frame_size) -> Callable:
    """Build the loss function of one optimisation configuration:
    ``loss_fn(params, features, intrinsics)`` on tensors."""

    def data_sums(params, features, intrinsics):
        """(sum of weight x distance, sum of weight) over ``features``."""
        quats, trans, scale, shift = (params["q"], params["t"],
                                      params["scale"], params["shift"])

        depth_i = _apply_depth_alignment(features["depth_i"], features["points_i"],
                                         features["idx_i"], scale, shift, alignment,
                                         frame_size)
        p = _unproject_to_world(features["points_i"], depth_i, features["idx_i"],
                                quats, trans, intrinsics)

        if residual_type == ResidualType.World3D:
            depth_j = _apply_depth_alignment(features["depth_j"], features["points_j"],
                                             features["idx_j"], scale, shift, alignment,
                                             frame_size)
            q_pts = _unproject_to_world(features["points_j"], depth_j, features["idx_j"],
                                        quats, trans, intrinsics)
            residuals = p - q_pts
        else:
            projected = _project_to_image(p, features["idx_j"], quats, trans, intrinsics)
            residuals = features["points_j"] - projected

        weights = features["weight"]
        # Safe L2: the norm's gradient is NaN at exactly zero, which
        # residuals reach once pairwise alignment converges.
        distances = torch.sqrt(torch.sum(torch.square(residuals), dim=-1) + 1e-12)
        return torch.sum(weights * distances), torch.sum(weights)

    def loss_fn(params, features, intrinsics):
        """``features`` and ``intrinsics``: one dict and tensor, or lists of
        them, one per shard of a device mesh. Each shard's partial sums are
        taken on its device (the parameters copied there) and summed on the
        parameters' device in shard order; autograd carries the gradient
        back across devices."""
        quats, trans, scale, shift = (params["q"], params["t"],
                                      params["scale"], params["shift"])
        if isinstance(features, dict):
            features, intrinsics = [features], [intrinsics]

        weighted = weight_sum = None
        for shard, intr in zip(features, intrinsics):
            device = shard["weight"].device
            sums = data_sums({k: v.to(device) for k, v in params.items()}, shard, intr)
            sums = [x.to(quats.device) for x in sums]
            weighted = sums[0] if weighted is None else weighted + sums[0]
            weight_sum = sums[1] if weight_sum is None else weight_sum + sums[1]
        loss = weighted / torch.clamp(weight_sum, min=1.0)

        if smooth:
            # Each difference order only where the trajectory is long enough:
            # the mean of an empty difference is NaN.
            n = trans.shape[0]
            if n >= 2:
                d1 = trans[:-1] - trans[1:]
                loss = loss + pose_t_reg * torch.mean(torch.sum(torch.square(d1), dim=1))
                q_dot = torch.sum(quats[:-1] * quats[1:], dim=-1)
                loss = loss + pose_r_reg * torch.mean(1.0 - torch.square(q_dot))
            if n >= 3:
                d2 = trans[:-2] - 2 * trans[1:-1] + trans[2:]
                loss = loss + pose_t_reg * torch.mean(torch.sum(torch.square(d2), dim=1))
                if n >= 4:
                    d3 = d2[:-1] - d2[1:]
                    loss = loss + pose_t_reg * torch.mean(torch.sum(torch.square(d3), dim=1))

        if alignment != AlignmentType.Rigid:
            loss = loss + l2_reg * torch.mean(torch.square(1.0 / scale - 1.0))
            loss = loss + 2 * l2_reg * torch.mean(torch.square(shift))

        return loss

    return loss_fn


def adam_init(params: Dict[str, torch.Tensor]) -> dict:
    """optax ``scale_by_adam``'s state: an int32 step count and zero moments."""
    first = next(iter(params.values()))
    return {"count": torch.zeros((), dtype=torch.int32, device=first.device),
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


@torch.no_grad()
def adam_directions(grads: Dict[str, torch.Tensor], state: dict) -> Dict[str, torch.Tensor]:
    """optax 0.2.6 ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)
    in its order: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
    ``count += 1``, each moment divided by ``1 - b**count``, then
    ``m_hat / (sqrt(v_hat + eps_root) + eps)`` (``eps_root`` 0 and the
    moment non-negative, so it is left out). Updates ``state`` in place and
    returns the directions (the update before the learning rate's -lr)."""
    state["count"] = state["count"] + 1
    # In the moments' dtype: optax computes b**count in the default float
    # type, float32 unless JAX runs in float64.
    count = state["count"].to(next(iter(state["mu"].values())).dtype)
    correction1 = 1 - torch.pow(ADAM_B1, count)
    correction2 = 1 - torch.pow(ADAM_B2, count)

    directions = {}
    for key, g in grads.items():
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][key]
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][key]
        state["mu"][key], state["nu"][key] = mu, nu
        directions[key] = (mu / correction1) / (torch.sqrt(nu / correction2) + ADAM_EPS)

    return directions


@torch.no_grad()
def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
               learning_rate: float, weight_decay: float) -> Dict[str, torch.Tensor]:
    """One ``optax.adamw(learning_rate, weight_decay)`` step in its order:
    ``scale_by_adam``, then ``weight_decay * p`` added to the direction,
    then x -lr and added to ``p``. Updates ``state`` in place."""
    directions = adam_directions(grads, state)
    return {k: v + (directions[k] + weight_decay * v) * (-learning_rate)
            for k, v in params.items()}


def _loss_and_grads(loss_fn, params: Dict[str, torch.Tensor], *args):
    """The loss and its gradient for every parameter (zeros for a parameter
    the loss does not use, as ``jax.grad`` gives)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, *args)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)

    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


@torch.no_grad()
def _project_params(params: Dict[str, torch.Tensor], max_frame_distance,
                    use_clip: bool) -> Dict[str, torch.Tensor]:
    """The constraint projection before each epoch's gradient: unit
    quaternions and, with ``use_clip``, bounded inter-frame distance."""
    params = dict(params)
    params["q"] = T.quat_normalize(params["q"])

    if use_clip:
        params["t"] = _clip_frame_distances(params["t"], max_frame_distance)

    return params


def _pin_first_frame(grads: Dict[str, torch.Tensor], position_only: bool) -> None:
    """Zero frame 0's gradients (it anchors the trajectory) and, with
    ``position_only``, every rotation's."""
    grads["t"][0] = 0.0
    if position_only:
        grads["q"] = torch.zeros_like(grads["q"])
    else:
        grads["q"][0] = 0.0


def _run_epoch_chunk(params, opt_state, features, intrinsics, learning_rate,
                     max_frame_distance, *, loss_fn, num_epochs: int,
                     position_only: bool, use_clip: bool):
    """Run ``num_epochs`` Adam epochs. Returns the parameters, the Adam state
    (updated in place) and the per-epoch losses as one device tensor, for
    the host's plateau / early-stop logic."""
    losses = []

    for _ in range(num_epochs):
        params = _project_params(params, max_frame_distance, use_clip)
        loss, grads = _loss_and_grads(loss_fn, params, features, intrinsics)
        _pin_first_frame(grads, position_only)

        # Adam is invariant to gradient scale, so the dynamic learning rate
        # scales the updates: optax.adam(1.0)'s -1, then x lr.
        directions = adam_directions(grads, opt_state)
        with torch.no_grad():
            params = {k: v + (-directions[k]) * learning_rate for k, v in params.items()}

        losses.append(loss)

    return params, opt_state, torch.stack(losses)


def optimise_packed_features(features: dict, intrinsics, params,
                             options: OptimisationOptions,
                             residual_type: ResidualType,
                             frame_size: Tuple[int, int], fps: float,
                             smooth_trajectory: bool = True, mesh=None):
    """The optimisation loop over packed correspondence tensors: Adam epoch
    chunks (:func:`_run_epoch_chunk`) with host-side LR-plateau reduction,
    early stopping and optional mid-run checkpointing. Runs on the device
    of ``features`` and in the dtype of their points (float32 from
    ``PoseOptimiser``; float64 holds two runs to each other closely where
    float32's rounding moves Adam near an optimum by about the learning
    rate).

    :param features: packed correspondences from ``PoseOptimiser._pack_features``
        (``hive_tpu``'s packing, whose rows of weight 0 count for nothing).
        With ``mesh``, their count must divide by the mesh size.
    :param params: ``{"q", "t", "scale", "shift"}`` tensors or arrays.
    :param mesh: optional device mesh. The correspondences split over its
        devices; the parameters, the Adam state, the learning rate and the
        clip stay on its first device, where the shards' partial loss sums
        meet (in shard order, so the loss is not bit-equal to one device's).
    """
    loss_fn = _make_loss_fn(
        residual_type=residual_type, alignment=options.alignment_type,
        smooth=smooth_trajectory, position_only=options.position_only,
        pose_t_reg=options.pose_t_reg, pose_r_reg=options.pose_r_reg,
        l2_reg=options.l2_regularisation, frame_size=frame_size)

    device = features["weight"].device
    dtype = features["points_i"].dtype
    if mesh is not None:
        m = len(features["weight"])
        if m % mesh.size != 0:
            raise ValueError(f"{m} correspondences do not divide over {mesh.size} "
                             f"devices; pad first.")
        device = mesh.devices[0]
        chunks = {k: shard_batch(mesh, v) for k, v in features.items()}
        features = [{k: chunks[k][i] for k in chunks} for i in range(mesh.size)]
        intrinsics = replicate(mesh, intrinsics)
    params = {k: torch.as_tensor(params[k], dtype=dtype, device=device) for k in PARAM_KEYS}
    opt_state = adam_init(params)

    lr = options.learning_rate
    use_clip = options.clip_distance is not None
    max_frame_distance = torch.tensor((options.clip_distance or 0.0) / max(fps, 1e-6),
                                      dtype=torch.float32, device=device)

    early_stopping = EarlyStopping(patience=options.early_stopping_patience,
                                   min_difference=options.min_loss_delta)
    plateau_best = float("inf")
    plateau_count = 0

    epochs_done = 0

    # Optional mid-run checkpointing (pre-emption safety for long runs).
    manager = None
    if options.checkpoint_dir:
        from hive_tpu_torch.checkpoint import (CheckpointManager, adam_state_from_leaves,
                                               adam_state_to_leaves)

        manager = CheckpointManager(options.checkpoint_dir)
        restored, meta = manager.restore()

        if restored is not None:
            params, opt_state = adam_state_from_leaves(restored, PARAM_KEYS, device)
            epochs_done = int(meta.get("epochs_done", 0))
            lr = float(meta.get("lr", lr))
            logging.info(f"Resumed pose optimisation from epoch {epochs_done}.")

    chunks_since_checkpoint = 0

    while epochs_done < options.num_epochs:
        chunk = min(options.epochs_per_chunk, options.num_epochs - epochs_done)

        params, opt_state, losses = _run_epoch_chunk(
            params, opt_state, features, intrinsics,
            torch.tensor(lr, dtype=torch.float32, device=device), max_frame_distance,
            loss_fn=loss_fn, num_epochs=chunk,
            position_only=options.position_only, use_clip=use_clip)

        losses = losses.cpu().numpy()
        epochs_done += chunk

        stop = False
        for loss in losses:
            loss = float(loss)

            # ReduceLROnPlateau (threshold-abs mode).
            if loss < plateau_best - options.min_loss_delta:
                plateau_best = loss
                plateau_count = 0
            else:
                plateau_count += 1
                if plateau_count > options.lr_scheduler_patience:
                    lr *= 0.1
                    plateau_count = 0
                    logging.debug(f"Reducing learning rate to {lr:.2e}")

            if early_stopping.step(loss):
                stop = True
                break

        logging.debug(f"Epoch {epochs_done}: loss={float(losses[-1]):.6f} lr={lr:.2e}")

        chunks_since_checkpoint += 1
        if manager is not None \
                and chunks_since_checkpoint >= options.checkpoint_every_chunks:
            manager.save(epochs_done, adam_state_to_leaves(params, opt_state),
                         metadata={"epochs_done": epochs_done, "lr": lr})
            chunks_since_checkpoint = 0

        if stop or not np.isfinite(losses[-1]):
            break

    params["q"] = T.quat_normalize(params["q"])
    return params


# ---------------------------------------------------------------------------
# PoseOptimiser.
# ---------------------------------------------------------------------------

class PoseOptimiser:
    """Optimises the camera trajectory of an RGB-D sequence.

    Pipeline: sample frame pairs → extract features (or reuse their cache)
    → pairwise alignment → global alignment → optional fine-tune →
    interpolate uncovered frames → optional EMA smoothing.
    """

    DEBUG_FOLDER = "pose_optim"

    def __init__(self, dataset: HiveDataset,
                 frame_sampling: FrameSamplingMode = FrameSamplingMode.Hierarchical,
                 feature_extraction_options=FeatureExtractionOptions(),
                 optimisation_options=OptimisationOptions(), debug: bool = True,
                 device=None):
        """:param device: where the optimisation runs; default ``cuda:0``."""
        self.dataset = dataset
        self.frame_sampling = frame_sampling
        self.feature_extraction_options = feature_extraction_options
        self.optimisation_options = optimisation_options
        self.debug = debug
        self.debug_path: Optional[str] = None
        self.device = get_device(device)

    # -- public API ----------------------------------------------------------
    def run(self, num_frames: int = -1) -> Tuple[Trajectory, np.ndarray, np.ndarray]:
        if num_frames == -1:
            num_frames = self.dataset.num_frames

        self._setup_debug_folder()

        frame_pairs = sample_frame_pairs(self.frame_sampling, self.dataset.num_frames)
        feature_set = self._extract_feature_points(frame_pairs)

        initial = self.dataset.camera_trajectory[:num_frames]
        params = self._init_params(initial)

        if num_frames != self.dataset.num_frames:
            feature_set = feature_set.sample_at(range(num_frames))

        params = self._optimise_pose(feature_set, params, num_frames)

        trajectory = self._params_to_trajectory(params)
        trajectory = self._interpolate_poses_without_matches(feature_set, trajectory)

        if self.optimisation_options.trajectory_smoothing:
            trajectory = self._smooth_trajectory(
                trajectory, weight=self.optimisation_options.trajectory_smoothing)

        scale = params["scale"].cpu().numpy()
        shift = params["shift"].cpu().numpy()

        if self.debug and self.debug_path:
            trajectory.save(pjoin(self.debug_path, "optimised_camera_trajectory.txt"))
            np.savetxt(pjoin(self.debug_path, "scale.txt"), scale.reshape(num_frames, -1)
                       if scale.size else scale)
            np.savetxt(pjoin(self.debug_path, "shift.txt"), shift.reshape(num_frames, -1)
                       if shift.size else shift)

        return trajectory, scale, shift

    # -- setup ----------------------------------------------------------------
    def _setup_debug_folder(self):
        if self.debug:
            self.debug_path = pjoin(str(self.dataset.base_path), self.DEBUG_FOLDER)
            os.makedirs(self.debug_path, exist_ok=True)

    def _extract_feature_points(self, frame_pairs: FramePairs) -> FeatureSet:
        extractor = FeatureExtractor(self.dataset, frame_pairs,
                                     self.feature_extraction_options,
                                     debug_path=self.debug_path, device=self.device)
        feature_set = extractor.extract_feature_points()
        return feature_set.subset_from(frame_pairs)

    def _empty(self) -> torch.Tensor:
        return torch.zeros((0,), dtype=torch.float32, device=self.device)

    def _init_params(self, initial_trajectory: np.ndarray) -> Dict[str, torch.Tensor]:
        n = len(initial_trajectory)
        alignment = self.optimisation_options.alignment_type
        shape = {AlignmentType.Affine: (n,), AlignmentType.Deformable: (n, 3, 3)}.get(alignment)

        if shape is None:
            scale, shift = self._empty(), self._empty()
        else:
            scale = torch.ones(shape, dtype=torch.float32, device=self.device)
            shift = torch.zeros(shape, dtype=torch.float32, device=self.device)

        initial = np.asarray(initial_trajectory)
        return {
            "q": torch.as_tensor(initial[:, :4], dtype=torch.float32, device=self.device),
            "t": torch.as_tensor(initial[:, 4:], dtype=torch.float32, device=self.device),
            "scale": scale,
            "shift": shift,
        }

    @staticmethod
    def _params_to_trajectory(params) -> Trajectory:
        q = params["q"].detach().cpu().numpy().astype(np.float64)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        t = params["t"].detach().cpu().numpy().astype(np.float64)
        return Trajectory(np.hstack([q, t]))

    # -- feature packing -------------------------------------------------------
    @staticmethod
    def _pack_features(feature_set: FeatureSet, device=None,
                       pad_to: Optional[int] = None) -> dict:
        """Correspondence arrays → device tensors with a validity weight: 1
        for each correspondence, 0 for the zero rows that pad them to
        ``pad_to`` (a multiple of a device mesh's size)."""
        m = len(feature_set)
        size = pad_to if pad_to is not None else m

        def tensor(a):
            out = np.zeros((size, *a.shape[1:]), dtype=a.dtype)
            out[:m] = a
            return torch.as_tensor(out, device=device)

        weight = np.zeros(size, dtype=np.float32)
        weight[:m] = 1.0
        return {
            "idx_i": tensor(feature_set.frame_i.index.astype(np.int64)),
            "points_i": tensor(feature_set.frame_i.points.astype(np.float32)),
            "depth_i": tensor(np.maximum(feature_set.frame_i.depth.astype(np.float32), 1e-6)),
            "idx_j": tensor(feature_set.frame_j.index.astype(np.int64)),
            "points_j": tensor(feature_set.frame_j.points.astype(np.float32)),
            "depth_j": tensor(np.maximum(feature_set.frame_j.depth.astype(np.float32), 1e-6)),
            "weight": torch.as_tensor(weight, device=device),
        }

    # -- optimisation steps ----------------------------------------------------
    def _visualise_solution(self, params, label: str) -> None:
        """Save an XY/XZ plot of the current solution's camera positions as
        ``<label>.png`` under ``debug_path``: before the first step and after
        every optimisation step. A plot that fails (no matplotlib) warns."""
        if not (self.debug and self.debug_path):
            return
        try:
            self._params_to_trajectory(params).plot(
                pjoin(self.debug_path, f"{label}.png"))
        except Exception as exc:  # noqa: BLE001 — plots must never kill a run
            logging.warning(f"Trajectory plot {label!r} failed: {exc}")

    def _optimise_pose(self, feature_set: FeatureSet, params, num_frames: int):
        options = self.optimisation_options
        num_steps = len(options.steps) + (1 if options.fine_tune else 0)

        self._visualise_solution(params, "initial_trajectory")

        for i, step in enumerate(options.steps):
            logging.info(f"Optimisation step {i + 1}/{num_steps}: {step.name} alignment")

            residual_type = (ResidualType.Image2D
                             if step in (OptimisationStep.PairWise2D, OptimisationStep.Global2D)
                             else ResidualType.World3D)

            if step in (OptimisationStep.PairWise2D, OptimisationStep.PairWise3D):
                params = self._optimise_pairwise(feature_set, params, residual_type,
                                                 num_frames)
            else:
                params = self._optimisation_loop(feature_set, params, options,
                                                 residual_type)

            self._visualise_solution(params, f"{i + 1}_{step.name}")

        if options.fine_tune:
            logging.info(f"Optimisation step {num_steps}/{num_steps}: fine-tune (no smoothing)")
            params = self._optimisation_loop(feature_set, params, options,
                                             ResidualType.World3D, smooth_trajectory=False)
            self._visualise_solution(params, f"{num_steps}_FineTune")

        return params

    def _optimise_pairwise(self, feature_set: FeatureSet, params,
                           residual_type: ResidualType, num_frames: int):
        """Align consecutive pairs independently, then chain relative poses.

        Two interleaved no-overlap passes (so pairs don't interact through
        gradients) and a chaining pass. A pass with no matches fills its
        pairs from the unoptimised trajectory, so the chaining maps each
        pair to its frame.
        """
        options = self.optimisation_options.copy()
        options.alignment_type = AlignmentType.Rigid

        pose_data = {}

        for mode in (FrameSamplingMode.ConsecutiveNoOverlap,
                     FrameSamplingMode.ConsecutiveNoOverlapOffset):
            frame_pairs = sample_frame_pairs(mode, num_frames)
            subset = feature_set.subset_from(frame_pairs)

            if len(subset) == 0:
                trajectory = self._params_to_trajectory(params)
            else:
                rigid_params = {**params, "scale": self._empty(), "shift": self._empty()}
                optimised = self._optimisation_loop(subset, rigid_params,
                                                    options, residual_type)
                trajectory = self._params_to_trajectory(optimised)

            for pair in frame_pairs:
                pose_data[tuple(pair)] = trajectory[list(pair)]

        if not pose_data:
            return params

        merged = [get_identity_pose()]
        previous = merged[0]

        for i, j in sorted(pose_data.keys()):
            pose_i, pose_j = pose_data[(i, j)]
            relative = subtract_pose(pose_i, pose_j)
            previous = add_pose(previous, relative)
            merged.append(previous)

        merged = np.asarray(merged)

        # Keep any trailing frames beyond the chained range unchanged.
        chained = {**params}
        n = min(len(merged), len(params["q"]))
        for key, columns in (("q", slice(0, 4)), ("t", slice(4, 7))):
            chained[key] = params[key].clone()
            chained[key][:n] = torch.as_tensor(merged[:n, columns], dtype=torch.float32,
                                               device=self.device)

        return chained

    def _optimisation_loop(self, feature_set: FeatureSet, params,
                           options: OptimisationOptions,
                           residual_type: ResidualType,
                           smooth_trajectory: bool = True):
        """The Adam loop with host-side LR plateau + early stopping, on the
        optimiser's device. Under a multi-device runtime (``--num_devices``)
        the correspondences pad to a multiple of the mesh size and split
        over its devices."""
        if len(feature_set) == 0:
            logging.warning("No correspondences available; skipping optimisation loop.")
            return params

        mesh = runtime_mesh()
        pad_to = None
        if mesh is not None:
            pad_to = -(-len(feature_set) // mesh.size) * mesh.size

        features = self._pack_features(feature_set, device=self.device, pad_to=pad_to)
        K = feature_set.camera_matrix
        intrinsics = torch.as_tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                                     dtype=torch.float32, device=self.device)

        return optimise_packed_features(
            features, intrinsics, params, options,
            residual_type=residual_type,
            frame_size=(self.dataset.frame_width, self.dataset.frame_height),
            fps=self.dataset.fps, smooth_trajectory=smooth_trajectory, mesh=mesh)

    # -- post-processing -------------------------------------------------------
    @staticmethod
    def _interpolate_poses_without_matches(feature_set: FeatureSet,
                                           trajectory: Trajectory) -> Trajectory:
        """Slerp/lerp over gaps in feature coverage."""
        num_frames = len(trajectory)
        covered = set(int(i) for i in np.concatenate([feature_set.frame_i.index,
                                                      feature_set.frame_j.index])
                      if i < num_frames)

        uncovered = [i for i in range(num_frames) if i not in covered]

        if not uncovered or not covered:
            return trajectory

        values = trajectory.values.copy()

        # Build gap chunks of consecutive uncovered frames.
        chunks: List[List[int]] = []
        chunk: List[int] = []

        for i in range(num_frames):
            if i in covered:
                if chunk:
                    chunks.append(chunk)
                    chunk = []
            else:
                chunk.append(i)

        if chunk:
            chunks.append(chunk)

        for chunk in chunks:
            start = max(0, chunk[0] - 1)
            end = min(chunk[-1] + 1, num_frames - 1)

            if start == end:
                continue

            alphas = np.linspace(0.0, 1.0, num=end - start + 1)
            q = T.quat_slerp(
                torch.as_tensor(np.tile(values[start, :4], (len(alphas), 1)),
                                dtype=torch.float32),
                torch.as_tensor(np.tile(values[end, :4], (len(alphas), 1)),
                                dtype=torch.float32),
                torch.as_tensor(alphas[:, None], dtype=torch.float32)).numpy()
            t = (values[start, 4:] * (1 - alphas[:, None])
                 + values[end, 4:] * alphas[:, None])

            values[start:end + 1, :4] = q
            values[start:end + 1, 4:] = t

        return Trajectory(values)

    @staticmethod
    def _smooth_trajectory(trajectory: Trajectory, weight: float) -> Trajectory:
        """EMA smoothing of the positions."""
        smoothed = trajectory.copy()

        for i in range(1, len(smoothed)):
            smoothed.positions[i] = (weight * trajectory.positions[i]
                                     + (1 - weight) * smoothed.positions[i - 1])

        return smoothed


# ---------------------------------------------------------------------------
# ForegroundPoseOptimiser.
# ---------------------------------------------------------------------------

class ForegroundPoseOptimiser:
    """Smooths foreground-object centroid motion by refining the trajectory.

    The centroids come from the masked depth on host threads; the loss over
    the chunks of frames with foreground and every AdamW epoch run on the
    device, and the final loss is read once at the end.
    """

    def __init__(self, dataset: HiveDataset, learning_rate: float = 1e-5,
                 num_epochs: int = 100, device=None):
        """:param device: where the optimisation runs; default ``cuda:0``."""
        self.dataset = dataset
        self.learning_rate = learning_rate
        self.num_epochs = num_epochs
        self.device = get_device(device)

    def run(self) -> Trajectory:
        num_frames = self.dataset.num_frames

        def centroid(index):
            depth = self.dataset.depth_dataset[index]
            mask = self.dataset.mask_dataset[index] > 0
            valid = mask & (depth > 0)

            if valid.sum() == 0:
                return None

            cloud = point_cloud_from_depth(depth, mask, self.dataset.camera_matrix)
            return np.mean(cloud, axis=0)

        centroids_list = tqdm_imap(centroid, list(range(num_frames)))

        centroids = np.zeros((num_frames, 3))
        has_fg = np.zeros(num_frames, dtype=bool)

        for i, c in enumerate(centroids_list):
            if c is not None:
                centroids[i] = c
                has_fg[i] = True

        # Split into chunks of >= 3 consecutive frames with foreground.
        chunks: List[List[int]] = []
        chunk: List[int] = []

        for i in range(num_frames):
            if has_fg[i]:
                chunk.append(i)
            else:
                if len(chunk) >= 3:
                    chunks.append(chunk)
                chunk = []

        if len(chunk) >= 3:
            chunks.append(chunk)

        if not chunks:
            return self.dataset.camera_trajectory.copy()

        trajectory = self.dataset.camera_trajectory.values
        params = {"q": torch.as_tensor(trajectory[:, :4], dtype=torch.float32,
                                       device=self.device),
                  "t": torch.as_tensor(trajectory[:, 4:], dtype=torch.float32,
                                       device=self.device)}
        cents = torch.as_tensor(centroids, dtype=torch.float32, device=self.device)

        # Ground-truth world centroids under the initial trajectory.
        q_norm = T.quat_normalize(params["q"])
        gt_world = T.quat_rotate(T.quat_conjugate(q_norm), cents - params["t"])

        chunk_indices = [torch.as_tensor(c, dtype=torch.long, device=self.device)
                         for c in chunks]

        def safe_norm(x):
            return torch.sqrt(torch.sum(torch.square(x), dim=1) + 1e-12)

        def loss_fn(params):
            q, t = params["q"], params["t"]
            loss = 0.0

            for idx in chunk_indices:
                qc = T.quat_normalize(q[idx])
                tc = t[idx]

                world = T.quat_rotate(T.quat_conjugate(qc), cents[idx] - tc)

                error_geom = torch.mean(safe_norm(gt_world[idx] - world))
                error_temp = torch.mean(safe_norm(tc[:-2] - 2 * tc[1:-1] + tc[2:]))
                error_vel = torch.mean(safe_norm(tc[:-1] - tc[1:]))

                loss = loss + 0.01 * error_geom + 0.1 * error_temp + 0.1 * error_vel

            return loss

        opt_state = adam_init(params)
        losses = []
        for _ in range(self.num_epochs):
            loss, grads = _loss_and_grads(loss_fn, params)
            params = adamw_step(params, grads, opt_state, self.learning_rate,
                                FOREGROUND_WEIGHT_DECAY)
            losses.append(loss)

        logging.info(f"Foreground pose optimisation: final loss "
                     f"{float(torch.stack(losses)[-1]):.6f}")

        q = T.quat_normalize(params["q"]).cpu().numpy().astype(np.float64)
        return Trajectory(np.hstack([q, params["t"].cpu().numpy().astype(np.float64)]))


def main(argv=None, device=None):
    """``python -m hive_tpu_torch.pose_optimisation <dataset>``: optimise a
    HIVE dataset's trajectory from its frames' features (extracted, or its
    cached feature set), then fuse debug meshes from the poses before and
    after.

    :param device: where the extraction, optimisation and fusion run;
        default ``cuda:0``.
    """
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_path", type=str, help="Path to the HIVE formatted dataset.")
    parser.add_argument("--num_frames", type=int, default=-1,
                        help="Number of frames to optimise. -1 (default) uses all frames.")
    parser.add_argument("--fine_tune", action="store_true",
                        help="Run an extra fine-tuning pass after the main optimisation.")
    parser.add_argument("--params_init", type=str, choices=["gt", "random"], default="gt",
                        help="Source of the initial camera trajectory.")
    parser.add_argument("--random_seed", type=int, default=None,
                        help="Random seed when initialising the trajectory randomly.")
    args = parser.parse_args(argv)

    if not HiveDataset.is_valid_folder_structure(args.dataset_path):
        raise RuntimeError(f"No valid HIVE dataset found at {args.dataset_path}.")

    dataset = HiveDataset(args.dataset_path)

    num_frames = args.num_frames
    if num_frames == -1:
        num_frames = dataset.num_frames
    elif num_frames < 2:
        raise RuntimeError(f"--num_frames must be at least 2, but got {num_frames}.")

    if args.params_init == "random":
        from scipy.spatial.transform import Rotation

        with temp_seed(args.random_seed or 0):
            dataset.camera_trajectory[:, :4] = Rotation.random(
                len(dataset), random_state=args.random_seed).as_quat()
            dataset.camera_trajectory[:, 4:] = np.random.normal(
                loc=0.0, scale=0.1, size=(len(dataset), 3))

    optimiser = PoseOptimiser(
        dataset,
        feature_extraction_options=FeatureExtractionOptions(min_features=40,
                                                            max_features=2048),
        optimisation_options=OptimisationOptions(num_epochs=20000, learning_rate=1e-2,
                                                 lr_scheduler_patience=50,
                                                 fine_tune=args.fine_tune),
        device=device)
    trajectory, _, _ = optimiser.run(num_frames)

    if optimiser.debug_path:
        from hive_tpu_torch.fusion import tsdf_fusion
        from hive_tpu_torch.meshing.ply import save_ply
        from hive_tpu_torch.options import BackgroundMeshOptions

        reconstruction_options = BackgroundMeshOptions(sdf_max_voxels=80_000_000)

        logging.info("Fusing a debug mesh from the pre-optimisation poses...")
        mesh_before = tsdf_fusion(dataset, options=reconstruction_options,
                                  num_frames=num_frames, device=optimiser.device)
        save_ply(pjoin(optimiser.debug_path, "before.ply"), mesh_before)

        dataset.camera_trajectory = trajectory
        logging.info("Running TSDFFusion on final pose data...")
        mesh_after = tsdf_fusion(dataset, options=reconstruction_options,
                                 num_frames=num_frames, device=optimiser.device)
        save_ply(pjoin(optimiser.debug_path, "after.ply"), mesh_after)


if __name__ == "__main__":
    main()
