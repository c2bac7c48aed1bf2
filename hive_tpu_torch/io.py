"""The HIVE dataset format: the read path and the instance masks.

Counterpart of ``hive_tpu/io.py``: the raw float32 codec (:56, :81),
``ImageFolderDataset`` (:111), ``create_masks`` (:177), ``DatasetMetadata``
(:626), ``make_depth_map_transform`` (:733), the ``HiveDataset`` read path
(:746) with ``create_masked_depth`` (:936) and ``select_key_frames`` (:986),
``temporary_trajectory``, ``temporary_camera_matrix`` and
``disable_inpainted_data`` (:1053-1091), and ``COLMAPProcessor``
(:238-525), which runs a ``colmap`` binary and reads its model with
:mod:`hive_tpu_torch.data.colmap_model`.

The port depends on neither Pillow nor OpenCV. PNGs (depth maps, masks,
the frames of other formats) are decoded here with ``zlib`` and ``struct``:
1- to 16-bit grey, grey+alpha, RGB, RGBA and palettes, non-interlaced, all
five scanline filters; JPEGs (the converted RGB frames) with
:func:`hive_tpu_torch.image_codecs.decode_jpeg`; masks and masked depth
maps are written with :func:`hive_tpu_torch.image_codecs.encode_png`.
"""

from __future__ import annotations

import abc
import contextlib
import datetime
import json
import logging
import os
import struct
import subprocess
import zlib
from os.path import join as pjoin
from pathlib import Path
from typing import Callable, IO, Iterator, List, Optional, Tuple, Union

import numpy as np

from hive_tpu_torch.custom_types import File
from hive_tpu_torch.data import colmap_model
from hive_tpu_torch.geometric import (Trajectory, get_pose_components, point_cloud_from_depth,
                                      pose_mat2vec, pose_vec2mat, world2image)
from hive_tpu_torch.image_codecs import decode_jpeg, encode_png
from hive_tpu_torch.image_processing import dilate_mask
from hive_tpu_torch.native import png_unfilter
from hive_tpu_torch.options import COLMAPOptions, MaskDilationOptions
from hive_tpu_torch.utils import Domain, check_domain, tqdm_imap


# ---------------------------------------------------------------------------
# Raw float32 image codec (bit-compatible with the reference's C++ freadimg
# format, hive/io.py:52-132).
# ---------------------------------------------------------------------------

_CV_CN_SHIFT = 3
_CV_32F = 5
_CV_CN_MAX = 512


def load_raw_float32_image(file_name: File) -> np.ndarray:
    """Load a `.raw` float32 image written by :func:`save_raw_float32_image`."""
    with open(file_name, "rb") as f:
        h, w, cv_type = struct.unpack("iii", f.read(12))
        (pixel_size,) = struct.unpack("Q", f.read(8))

        channels = ((cv_type - _CV_32F) >> _CV_CN_SHIFT) + 1
        if channels < 1 or channels != pixel_size // 4:
            raise ValueError(f"Incompatible pixel_size({pixel_size}) and cv_type({cv_type})")
        if channels > _CV_CN_MAX:
            raise ValueError("Cannot load image with more than 512 channels")

        data = np.frombuffer(f.read(), dtype=np.float32)

    # The body is plain C-order (h, w[, c]) float32.
    if channels == 1:
        return data.reshape((h, w)).copy()

    return data.reshape((h, w, channels)).copy()


def save_raw_float32_image(file_name: File, image: np.ndarray):
    """Save an image as raw float32 binary (C++ `freadimg`-compatible)."""
    image = np.asarray(image)

    if image.ndim == 2:
        h, w = image.shape
        channels = 1
    else:
        h, w, channels = image.shape

    if channels > _CV_CN_MAX:
        raise ValueError("The raw-float codec supports at most 512 channels per image.")

    cv_type = _CV_32F + ((channels - 1) << _CV_CN_SHIFT)

    with open(file_name, "wb") as f:
        f.write(struct.pack("iii", h, w, cv_type))
        f.write(struct.pack("Q", channels * 4))
        f.write(np.ascontiguousarray(image.astype(np.float32)).tobytes())


# ---------------------------------------------------------------------------
# PNG decoding (zlib + struct).
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples per pixel: grey, RGB, palette, grey+alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Colour type -> the bit depths PNG allows for it.
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _png_unfilter(raw: bytes, height: int, stride: int, bpp: int,
                  native: Optional[bool] = None) -> np.ndarray:
    """Undo the per-scanline PNG filters; returns (height, stride) uint8.

    Natively (one C++ pass without the interpreter lock) when the native
    library builds or ``native`` is True. Otherwise, and as the plain
    version: a byte depends on its left, upper and upper-left neighbours, so
    the reconstruction walks anti-diagonals of pixel columns: every pixel on
    one wavefront only reads pixels of earlier wavefronts, which makes each
    step a vectorised numpy pass over up to ``height`` pixels instead of a
    Python loop per byte.
    """
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes; expected "
                         f"{height * (stride + 1)}")
    data = data.reshape(height, stride + 1)
    ftype = data[:, 0]
    if ftype.max() > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    filtered = data[:, 1:]
    if not ftype.any():
        return filtered.copy()
    if native is not False:
        out = png_unfilter(data, height, stride, bpp)
        if out is not None:
            return out
        if native:
            raise RuntimeError("the native library did not build; decode with native=False")

    # out[r + 1, bpp + i] holds byte i of row r; the zero row/columns are the
    # "outside the image" neighbours the filters define as 0.
    out = np.zeros((height + 1, stride + bpp), np.int32)
    f = filtered.astype(np.int32)
    ncols = stride // bpp
    lanes = np.arange(bpp)
    for d in range(height + ncols - 1):
        rows = np.arange(max(0, d - ncols + 1), min(height - 1, d) + 1)
        bi = (d - rows)[:, None] * bpp + lanes            # (n, bpp) byte index
        r = rows[:, None]
        a = out[r + 1, bi]                                 # left
        b = out[r, bi + bpp]                               # up
        c = out[r, bi]                                     # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[rows][:, None]
        pred = np.select([t == 0, t == 1, t == 2, t == 3],
                         [np.zeros_like(a), a, b, (a + b) >> 1], paeth)
        out[r + 1, bi + bpp] = (f[r, bi] + pred) & 0xFF
    return out[1:, bpp:].astype(np.uint8)


def _unpack_samples(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, stride) bytes of 1-, 2- or 4-bit samples -> (H, width) values."""
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :width]


# Adam7's passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_rows(raw: bytes, height: int, width: int, channels: int, depth: int,
              native: Optional[bool]) -> np.ndarray:
    """Unfilter one (sub)image: (H, W) samples for depths under 8 bits,
    (H, W * bytes per pixel) bytes otherwise."""
    bpp = max(1, channels * depth // 8)
    rows = _png_unfilter(raw, height, -(-width * channels * depth // 8), bpp, native)
    return _unpack_samples(rows, width, depth) if depth < 8 else rows


def decode_png(blob: bytes, native: Optional[bool] = None) -> np.ndarray:
    """Decode a PNG, interlaced (Adam7, each pass unfiltered on its own) or
    not, into the arrays Pillow gives the HIVE loader: 8-bit grey (H, W)
    uint8, 2- and 4-bit grey scaled to it, 16-bit grey (H, W) uint16, and
    everything else as (H, W, 3) uint8 RGB (alpha dropped, grey+alpha
    replicated, 1-bit grey as 0 / 255, palettes looked up, 16-bit colour
    reduced to its high byte).

    :param native: unfilter natively (True) or in numpy (False); by default
        natively when the native library builds.
    """
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")

    pos = 8
    header = None
    palette = np.zeros((256, 3), np.uint8)
    idat = []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            entries = np.frombuffer(body, np.uint8)[:768].reshape(-1, 3)
            palette[:len(entries)] = entries
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break

    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[colour]:
        raise NotImplementedError(f"PNG colour type {colour} at bit depth "
                                  f"{depth} is not supported")
    channels = _PNG_CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        pixels = _png_rows(raw, height, width, channels, depth, native)
    else:
        unit = 1 if depth < 8 else channels * depth // 8
        full = np.zeros((height, width, unit), np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pass_w, pass_h = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pass_w <= 0 or pass_h <= 0:
                continue
            size = pass_h * (-(-pass_w * channels * depth // 8) + 1)
            rows = _png_rows(raw[at:at + size], pass_h, pass_w, channels, depth, native)
            full[y0::dy, x0::dx] = rows.reshape(pass_h, pass_w, unit)
            at += size
        pixels = full.reshape(height, width * unit)

    if depth < 8:
        samples = pixels
        if colour == 3:
            return palette[samples]
        if depth == 1:
            return np.repeat(samples[..., None] * np.uint8(255), 3, axis=-1)
        return samples * np.uint8(255 // ((1 << depth) - 1))
    if colour == 3:
        return palette[pixels]

    if depth == 16:
        pixels = pixels.reshape(height, width * channels, 2)
        if colour == 0:
            return (pixels[..., 0].astype(np.uint16) << 8) | pixels[..., 1]
        pixels = pixels[..., 0]                        # high byte
    image = pixels.reshape(height, width, channels)

    if colour == 0:
        return image[..., 0].copy()
    if colour == 4:
        return np.repeat(image[..., :1], 3, axis=-1)
    return np.ascontiguousarray(image[..., :3])


def load_image(path: str) -> np.ndarray:
    """Load a PNG, JPEG or raw float32 frame, PNG and JPEG told apart by
    their signatures, as Pillow loads them for ``hive_tpu``: 8-bit grey as
    (H, W) uint8, 16-bit grey as (H, W) uint16, everything else as (H, W, 3)
    uint8 RGB."""
    if path.endswith(".raw"):
        return load_raw_float32_image(path)
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:3] == b"\xff\xd8\xff":
        return decode_jpeg(blob)
    return decode_png(blob)


# ---------------------------------------------------------------------------
# Frame loading.
# ---------------------------------------------------------------------------

class ImageFolderDataset:
    """A lazily-loaded, indexable folder of images (PNG, JPEG or raw
    float32), read as ``hive_tpu``'s Pillow reads them.

    16-bit PNGs load as uint16 (depth maps); colour images load as RGB.
    """

    def __init__(self, base_dir: File, transform: Optional[Callable] = None):
        if not os.path.isdir(base_dir):
            raise NotADirectoryError(f"Missing folder: {base_dir}")

        self.base_dir = str(base_dir)
        self.transform = transform

        filenames = sorted(os.listdir(base_dir))
        if len(filenames) == 0:
            raise FileNotFoundError(f"Folder {base_dir} is empty - no files to load")

        self.image_filenames = filenames
        self.image_paths = [pjoin(self.base_dir, name) for name in filenames]

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        image = load_image(self.image_paths[idx])

        if self.transform:
            image = self.transform(image)

        return image

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]

    def load_all(self, num_workers: Optional[int] = None, show_progress: bool = False) -> np.ndarray:
        """Load every frame with a thread pool and stack into one (N, H, W, ...) array."""
        frames = tqdm_imap(self.__getitem__, range(len(self)),
                           num_workers=num_workers, show_progress=show_progress)
        return np.stack(frames)

    def batches(self, batch_size: int, num_workers: Optional[int] = None) -> Iterator[np.ndarray]:
        """Yield stacked (B, H, W, ...) batches in order (threaded loads)."""
        for start in range(0, len(self), batch_size):
            indices = range(start, min(start + batch_size, len(self)))
            frames = tqdm_imap(self.__getitem__, indices,
                               num_workers=num_workers, show_progress=False)
            yield np.stack(frames)


# ---------------------------------------------------------------------------
# Instance segmentation mask creation.
# ---------------------------------------------------------------------------

def create_masks(rgb_source, mask_folder: File, for_colmap: bool = False,
                 filename_fmt: Optional[Callable[[int], str]] = None,
                 batch_size: int = 8, device=None):
    """Create person instance-segmentation masks for an RGB sequence.

    Mask-ID contract (that of ``hive_tpu.io.create_masks``):

    * default: background = 0, object instances = 1..N (uint8, one PNG/frame);
    * ``for_colmap=True``: white (255) = keep, black (0) = dynamic object, and
      files are named ``<source filename>.png``.

    :param rgb_source: An :class:`ImageFolderDataset` (or any indexable frame
        source with ``image_filenames``).
    :param mask_folder: Where to write the PNG masks (8-bit grey).
    :param device: where the segmenter runs; default ``cuda:0``.
    """
    from hive_tpu_torch.models.segmentation import PersonSegmenter

    logging.info("Running instance segmentation over the frames...")

    os.makedirs(mask_folder, exist_ok=True)
    segmenter = PersonSegmenter(device=device)

    index = 0

    for batch in rgb_source.batches(batch_size) if hasattr(rgb_source, "batches") \
            else _iter_batches(rgb_source, batch_size):
        instance_masks = segmenter.predict_batch(batch)

        for masks in instance_masks:
            if for_colmap:
                combined = np.full(masks.shape[-2:], 255, dtype=np.uint8)
                combined[masks > 0] = 0
            else:
                combined = masks.astype(np.uint8)

            if filename_fmt:
                output_filename = filename_fmt(index)
            elif for_colmap:
                output_filename = f"{rgb_source.image_filenames[index]}.png"
            else:
                output_filename = f"{index:06d}.png"

            with open(pjoin(str(mask_folder), output_filename), "wb") as f:
                f.write(encode_png(combined))
            index += 1


def _iter_batches(source, batch_size):
    batch = []
    for item in source:
        batch.append(item)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


# ---------------------------------------------------------------------------
# COLMAP: running the binary and reading its models.
# ---------------------------------------------------------------------------

def resize_nearest_exact(image: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_NEAREST_EXACT)``
    in numpy, index for index as OpenCV 5.0.0 picks them: along each axis the
    source coordinate of output ``x`` is ``s / 2`` plus ``x`` additions of
    ``s = size / out``, accumulated in float64 (rounding included), then
    floored and clamped to the last row or column."""

    def offsets(size: int, out: int) -> np.ndarray:
        step = size / out
        coords = np.cumsum(np.concatenate([[step / 2], np.full(out - 1, step)]))
        return np.minimum(np.floor(coords).astype(np.int64), size - 1)

    height, width = target_hw
    return image[offsets(image.shape[0], height)[:, None], offsets(image.shape[1], width)]


# The camera whose frames are read from a model: COLMAP numbers cameras from 1,
# and by default every frame shares one (``COLMAPOptions.is_single_camera``).
COLMAP_CAMERA_ID = 1


class COLMAPProcessor:
    """Runs COLMAP (an external binary, optional) and reads its sparse and
    dense models.

    The reading path (:meth:`load_camera_params`, :meth:`get_sparse_depth_maps`,
    :meth:`get_dense_depth_maps`) has no external dependency.
    """

    def __init__(self, image_path: File, workspace_path: File,
                 colmap_options: COLMAPOptions = COLMAPOptions()):
        self.image_path = str(image_path)
        self.workspace_path = str(workspace_path)
        self.colmap_options = colmap_options
        self._model_cache = None

    @property
    def mask_path(self) -> str:
        return pjoin(self.workspace_path, "masks")

    @property
    def sparse_path(self) -> str:
        return pjoin(self.workspace_path, "sparse")

    @property
    def dense_path(self) -> str:
        return pjoin(self.workspace_path, "dense")

    @property
    def probably_has_results(self) -> bool:
        recon_result_path = pjoin(self.sparse_path, "0")
        min_files_for_recon = 3

        return (os.path.isdir(self.sparse_path) and len(os.listdir(self.sparse_path)) > 0
                and os.path.isdir(recon_result_path)
                and len(os.listdir(recon_result_path)) >= min_files_for_recon)

    def run(self, device=None):
        """Run ``colmap automatic_reconstructor`` on the image folder, with
        exclusion masks of the moving objects.

        :param device: where the exclusion masks are segmented, when the
            mask folder is empty; default ``cuda:0``.
        """
        os.makedirs(self.workspace_path, exist_ok=True)
        os.makedirs(self.mask_path, exist_ok=True)

        if len(os.listdir(self.mask_path)) == 0:
            logging.info(f"No masks present under {self.mask_path}.")
            logging.info("Generating COLMAP exclusion masks...")
            create_masks(ImageFolderDataset(self.image_path), self.mask_path, for_colmap=True,
                         device=device)
        else:
            logging.info(f"Using {len(os.listdir(self.mask_path))} existing masks from "
                         f"{self.mask_path}.")

        logging.info("Running COLMAP, this may take a while...")
        command = self.get_command()

        with subprocess.Popen(command, stdout=subprocess.PIPE, bufsize=1,
                              universal_newlines=True) as p:
            for line in p.stdout:
                logging.debug(line.rstrip("\n"))

        if (return_code := p.wait()) != 0:
            raise RuntimeError(f"COLMAP failed (exit status {return_code}).")

    def get_command(self) -> List[str]:
        """Build the ``colmap automatic_reconstructor`` command."""
        options = self.colmap_options

        assert os.path.isfile(options.binary_path), \
            f"No COLMAP executable at {options.binary_path}."
        assert os.path.isdir(self.workspace_path), \
            f"Could not open workspace path: {self.workspace_path}."
        assert os.path.isdir(self.image_path), \
            f"Could not open image folder: {self.image_path}."

        command = [options.binary_path, "automatic_reconstructor",
                   "--workspace_path", self.workspace_path,
                   "--image_path", self.image_path,
                   "--vocab_tree_path", options.vocab_path,
                   "--single_camera", 1 if options.is_single_camera else 0,
                   "--single_camera_per_folder", 1 if options.single_camera_per_folder else 0,
                   "--dense", 1 if options.dense else 0,
                   "--quality", options.quality]

        assert os.path.isdir(self.mask_path), f"Mask folder {self.mask_path} is not a directory."
        command += ["--mask_path", self.mask_path]

        return list(map(str, command))

    def _load_model(self):
        models = sorted(item for item in os.listdir(self.sparse_path)
                        if os.path.isdir(pjoin(self.sparse_path, item)))

        if len(models) != 1:
            raise RuntimeError(
                f"COLMAP produced {len(models)} sub-models instead of one, meaning the "
                f"camera trajectory could not be estimated for the entire video. This may be due "
                f"to COLMAP using a bad random initial guess of the camera parameters and can "
                f"sometimes be fixed by running the program again, or by increasing the quality "
                f"setting (e.g. `--quality medium`). Otherwise, the video likely lacks the camera "
                f"movement COLMAP needs.")

        sparse_recon_path = pjoin(self.sparse_path, models[0])

        # Parsed once per processor: load_camera_params and
        # get_sparse_depth_maps both run during one conversion.
        if self._model_cache is None or self._model_cache[0] != sparse_recon_path:
            logging.debug(f"Loading the sparse COLMAP model at {sparse_recon_path}...")
            self._model_cache = (sparse_recon_path,
                                 colmap_model.read_model(sparse_recon_path))

        return self._model_cache[1]

    def load_camera_params(self) -> Tuple[np.ndarray, Trajectory]:
        """Load intrinsics + camera trajectory (COLMAP's world-to-camera
        poses as they are) from the sparse model.

        :return: ((3, 3) intrinsics, (N, 7) trajectory — scalar-last
            quaternion + translation, missing frames slerp-interpolated).
        """
        cameras, images, _ = self._load_model()

        camera = cameras[COLMAP_CAMERA_ID]
        params = camera.params
        # SIMPLE_* models are (f, cx, cy, ...); PINHOLE and the OPENCV family
        # (fx, fy, cx, cy, ...).
        model = getattr(camera, "model", "SIMPLE_RADIAL")
        if model.startswith("SIMPLE_") or model in ("RADIAL", "RADIAL_FISHEYE"):
            fx = fy = params[0]
            cx, cy = params[1], params[2]
        elif model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV",
                       "FOV", "THIN_PRISM_FISHEYE"):
            fx, fy, cx, cy = params[0], params[1], params[2], params[3]
        else:
            raise NotImplementedError(
                f"COLMAP camera model {model!r} is not supported")

        intrinsic = np.eye(3)
        intrinsic[0, 0] = fx
        intrinsic[1, 1] = fy
        intrinsic[0, 2] = cx
        intrinsic[1, 2] = cy

        extrinsic = {}

        for image in images.values():
            if image.camera_id != COLMAP_CAMERA_ID:
                continue

            M = np.eye(4)
            M[:3, :3] = image.rotation_matrix()
            M[:3, 3] = np.asarray(image.tvec).reshape(3)
            extrinsic[self._get_index_from_image(image)] = pose_mat2vec(M)

        frame_count = self._get_frame_count()

        if len(extrinsic) < frame_count:
            logging.info(f"COLMAP registered {len(extrinsic)} of {frame_count} frames; "
                         f"filling the gaps by interpolation.")
            trajectory = Trajectory.create_by_interpolating(extrinsic, frame_count=frame_count)
        else:
            trajectory = Trajectory(
                np.asarray([extrinsic[i] for i in sorted(extrinsic)]))

        return intrinsic, trajectory

    def _get_frame_count(self) -> int:
        files = sorted(os.listdir(self.image_path))

        if os.path.isdir(pjoin(self.image_path, files[0])):
            files = sorted(os.listdir(pjoin(self.image_path, files[0])))

        return max(self._get_index_from_filename(name) for name in files) + 1

    @staticmethod
    def _get_index_from_filename(filename: str) -> int:
        return int(Path(filename).stem)

    def _get_index_from_image(self, image) -> int:
        return self._get_index_from_filename(image.name)

    def get_sparse_depth_maps(self, camera_matrix: np.ndarray,
                              camera_poses: Trajectory) -> np.ndarray:
        """Splat the sparse 3D points into per-frame depth maps."""
        _, images, points3d = self._load_model()
        K = camera_matrix.copy()
        poses_homogeneous = camera_poses.to_homogenous_transforms()

        first_image = next(iter(images.values()))
        source_shape = load_image(pjoin(self.image_path, first_image.name)).shape[:2]

        depth_maps = np.zeros((len(camera_poses), *source_shape), dtype=np.float32)

        for image_data in images.values():
            if image_data.camera_id != COLMAP_CAMERA_ID:
                continue

            pids = [pid for pid in image_data.point3d_ids if pid != -1]
            if not pids:
                continue

            points = np.asarray([points3d[pid].xyz for pid in pids])

            index = self._get_index_from_image(image_data)
            R, t = get_pose_components(poses_homogeneous[index])
            projected, depth = world2image(points, K, R, t)

            h, w = source_shape
            valid = ((projected[:, 0] > 0) & (projected[:, 0] < w)
                     & (projected[:, 1] > 0) & (projected[:, 1] < h))

            if valid.sum() < 1:
                logging.debug(f"Frame {image_data.name}: every reprojected COLMAP point fell "
                              f"outside the image/depth gates - skipped.")
                continue

            u, v = projected[valid].T
            depth_maps[index, v, u] = depth[valid]

        return depth_maps

    def get_dense_depth_maps(self, resize_to: Tuple[int, int]) -> np.ndarray:
        """Load COLMAP dense-stereo depth maps (the geometric ones where
        present), resized nearest-exact to ``resize_to`` (height, width),
        with the 95th-percentile outlier clamp."""
        path_to_depth_maps = pjoin(self.dense_path, "0", "stereo", "depth_maps")

        if not os.path.isdir(path_to_depth_maps):
            raise NotADirectoryError(f"No folder at {path_to_depth_maps} — dense stereo output is missing "
                                     f"(was COLMAP run with dense reconstruction enabled?).")

        filenames = sorted(f for f in os.listdir(path_to_depth_maps)
                           if f.endswith(".geometric.bin"))
        if not filenames:  # older/configured runs may emit photometric only
            filenames = sorted(os.listdir(path_to_depth_maps))

        if len(filenames) == 0:
            raise FileNotFoundError(f"The folder {path_to_depth_maps} holds no depth maps — was COLMAP "
                                    f"run with dense reconstruction enabled?")

        def load_depth_map(filename: str) -> np.ndarray:
            depth_map = colmap_model.read_colmap_depth_map(pjoin(path_to_depth_maps, filename))
            return resize_nearest_exact(depth_map, resize_to)

        depth_maps = np.asarray(tqdm_imap(load_depth_map, filenames))

        max_depth = np.quantile(depth_maps, 0.95)
        depth_maps[depth_maps < 0] = 0
        depth_maps[depth_maps > max_depth] = 0

        return depth_maps


class InvalidDatasetFormatError(Exception):
    """The folder structure/files of a dataset do not match the expected format."""


class Dataset(abc.ABC):
    """Base class enforcing a dataset's on-disk folder contract."""

    required_files: List[str] = []
    required_folders: List[str] = []

    def __init__(self, base_path: File):
        self.base_path = base_path
        type(self)._validate_dataset(base_path)

    @classmethod
    def is_valid_folder_structure(cls, path: File) -> bool:
        try:
            cls._validate_dataset(path)
            return True
        except InvalidDatasetFormatError:
            return False

    @classmethod
    def _validate_dataset(cls, base_path: File):
        files_to_find = set(cls.required_files)
        folders_to_find = set(cls.required_folders)

        if not os.path.isdir(base_path):
            raise InvalidDatasetFormatError(f"Dataset folder {base_path} is missing.")

        for filename in os.listdir(base_path):
            file_path = pjoin(str(base_path), filename)

            if os.path.isfile(file_path):
                files_to_find.discard(filename)
            elif os.path.isdir(file_path):
                if len(os.listdir(file_path)) == 0 and filename in folders_to_find:
                    raise InvalidDatasetFormatError(f"Folder {filename} under {base_path} is empty.")

                folders_to_find.discard(filename)

        if files_to_find:
            raise InvalidDatasetFormatError(
                f"The dataset at {base_path} is missing required files: {files_to_find}.")

        if folders_to_find:
            raise InvalidDatasetFormatError(
                f"The dataset at {base_path} is missing required folders: {folders_to_find}.")

    def __str__(self):
        return f"<{type(self).__name__} {Path(self.base_path).stem}>"


class DatasetMetadata:
    """JSON metadata describing a converted HIVE dataset (same schema as
    ``hive_tpu.io.DatasetMetadata``, so datasets are interchangeable)."""

    def __init__(self, num_frames: int, fps: float, width: int, height: int,
                 estimate_pose: bool, estimate_depth: bool,
                 depth_mask_dilation_iterations: int, depth_scale: float,
                 max_depth: float = 10.0, frame_step: int = 1,
                 colmap_options: COLMAPOptions = COLMAPOptions()):
        if not isinstance(estimate_pose, bool):
            raise ValueError(f"estimate_pose expects a bool; got {type(estimate_pose).__name__}.")

        if not isinstance(estimate_depth, bool):
            raise ValueError(f"estimate_depth expects a bool; got {type(estimate_depth).__name__}.")

        check_domain(num_frames, "num_frames", int, Domain.Positive)
        check_domain(frame_step, "frame_step", int, Domain.Positive)
        check_domain(width, "width", int, Domain.Positive)
        check_domain(height, "height", int, Domain.Positive)
        check_domain(depth_scale, "depth_scale", float)
        check_domain(max_depth, "max_depth", float, Domain.Positive)
        check_domain(depth_mask_dilation_iterations, "depth_mask_dilation_iterations",
                     int, Domain.Positive)

        self.num_frames = num_frames
        self.fps = fps
        self.frame_step = frame_step
        self.width = width
        self.height = height
        self.depth_scale = depth_scale
        self.max_depth = max_depth
        self.depth_mask_dilation_iterations = depth_mask_dilation_iterations
        self.estimate_pose = estimate_pose
        self.estimate_depth = estimate_depth
        self.colmap_options = colmap_options

    def __eq__(self, other: "DatasetMetadata") -> bool:
        return (self.num_frames == other.num_frames
                and np.isclose(self.fps, other.fps)
                and self.frame_step == other.frame_step
                and self.width == other.width
                and self.height == other.height
                and np.isclose(self.depth_scale, other.depth_scale)
                and np.isclose(self.max_depth, other.max_depth)
                and self.depth_mask_dilation_iterations == other.depth_mask_dilation_iterations
                and self.estimate_pose == other.estimate_pose
                and self.estimate_depth == other.estimate_depth
                and self.colmap_options == other.colmap_options)

    @property
    def duration(self) -> datetime.timedelta:
        return datetime.timedelta(seconds=self.num_frames / self.fps)

    def to_json(self) -> dict:
        return dict(num_frames=self.num_frames, fps=self.fps, frame_step=self.frame_step,
                    width=self.width, height=self.height, depth_scale=self.depth_scale,
                    max_depth=self.max_depth,
                    depth_mask_dilation_iterations=self.depth_mask_dilation_iterations,
                    estimate_pose=self.estimate_pose, estimate_depth=self.estimate_depth,
                    colmap_options=self.colmap_options.to_json())

    @staticmethod
    def from_json(json_dict: dict) -> "DatasetMetadata":
        return DatasetMetadata(
            num_frames=int(json_dict["num_frames"]),
            frame_step=int(json_dict["frame_step"]),
            fps=float(json_dict["fps"]),
            width=int(json_dict["width"]),
            height=int(json_dict["height"]),
            estimate_pose=bool(json_dict["estimate_pose"]),
            estimate_depth=bool(json_dict["estimate_depth"]),
            depth_scale=float(json_dict["depth_scale"]),
            max_depth=float(json_dict["max_depth"]),
            depth_mask_dilation_iterations=int(json_dict["depth_mask_dilation_iterations"]),
            colmap_options=COLMAPOptions.from_json(json_dict["colmap_options"]),
        )

    def save(self, f: Union[File, IO]):
        if isinstance(f, (str, Path)):
            with open(f, "w") as fh:
                json.dump(self.to_json(), fh)
        else:
            json.dump(self.to_json(), f)

    @staticmethod
    def load(f: Union[File, IO]) -> "DatasetMetadata":
        if isinstance(f, (str, Path)):
            with open(f) as fh:
                json_dict = json.load(fh)
        else:
            json_dict = json.load(f)

        return DatasetMetadata.from_json(json_dict)


# ---------------------------------------------------------------------------
# HiveDataset — the converted dataset consumed by the pipeline.
# ---------------------------------------------------------------------------

def make_depth_map_transform(depth_scaling_factor: float, max_depth: float):
    """THE depth decode: stored u16 units -> float32 metres, with values
    past ``max_depth`` zeroed (invalid)."""
    def transform(depth_map: np.ndarray) -> np.ndarray:
        depth_map = depth_scaling_factor * depth_map.astype(np.float32)
        depth_map[depth_map > max_depth] = 0.0
        return depth_map

    return transform


class HiveDataset(Dataset):
    """The on-disk HIVE dataset: RGB + depth + instance masks + camera params.

    Folder layout, filenames and units are those of ``hive_tpu.io.HiveDataset``:
    depth maps are 16-bit PNG millimetres (scale 1/1000), masks encode
    instance IDs, camera files are plain-text matrices.
    """

    metadata_filename = "metadata.json"
    camera_matrix_filename = "camera_matrix.txt"
    camera_trajectory_filename = "camera_trajectory.txt"

    required_files = [metadata_filename, camera_trajectory_filename, camera_matrix_filename]

    rgb_folder = "rgb"
    depth_folder = "depth"
    mask_folder = "mask"
    masked_depth_folder = "masked_depth"

    inpainted_rgb_folder = f"{rgb_folder}_inpainted"
    inpainted_depth_folder = f"{depth_folder}_inpainted"
    inpainted_mask_folder = f"{mask_folder}_inpainted"

    required_folders = [rgb_folder, depth_folder, mask_folder]

    # Converts stored millimetre depth to meters.
    depth_scaling_factor = 1.0 / 1000.0

    def __init__(self, base_path: File):
        super().__init__(base_path=base_path)

        self.metadata = DatasetMetadata.load(self.path_to_metadata)
        self.camera_matrix, self.camera_trajectory = self._load_camera_parameters()

        self.rgb_dataset = ImageFolderDataset(self.path_to_rgb_frames)
        self.depth_dataset = ImageFolderDataset(self.path_to_depth_maps,
                                                transform=self._get_depth_map_transform())
        self.mask_dataset = ImageFolderDataset(self.path_to_masks)

        self.inpainted_rgb_dataset, self.inpainted_depth_dataset = self._get_inpainted_frame_data()

        self._masked_depth_path: Optional[str] = None

    # -- paths ---------------------------------------------------------------
    @property
    def path_to_metadata(self):
        return pjoin(str(self.base_path), self.metadata_filename)

    @property
    def path_to_camera_matrix(self):
        return pjoin(str(self.base_path), self.camera_matrix_filename)

    @property
    def path_to_camera_trajectory(self):
        return pjoin(str(self.base_path), self.camera_trajectory_filename)

    @property
    def path_to_rgb_frames(self):
        return pjoin(str(self.base_path), self.rgb_folder)

    @property
    def path_to_depth_maps(self):
        return pjoin(str(self.base_path), self.depth_folder)

    @property
    def path_to_masks(self):
        return pjoin(str(self.base_path), self.mask_folder)

    @property
    def path_to_inpainted_rgb_frames(self):
        return pjoin(str(self.base_path), self.inpainted_rgb_folder)

    @property
    def path_to_inpainted_depth_maps(self):
        return pjoin(str(self.base_path), self.inpainted_depth_folder)

    @property
    def path_to_inpainted_masks(self):
        return pjoin(str(self.base_path), self.inpainted_mask_folder)

    # -- inpainted variants --------------------------------------------------
    def _get_inpainted_frame_data(self):
        if not (os.path.isdir(self.path_to_inpainted_rgb_frames)
                and os.path.isdir(self.path_to_inpainted_depth_maps)
                and os.path.isdir(self.path_to_inpainted_masks)):
            return None, None

        inpainted_rgb = ImageFolderDataset(self.path_to_inpainted_rgb_frames)
        inpainted_depth = ImageFolderDataset(self.path_to_inpainted_depth_maps,
                                             transform=self._get_depth_map_transform())

        if len(inpainted_rgb) != self.num_frames or len(inpainted_depth) != self.num_frames:
            raise RuntimeError(f"Inpainted frame counts ({len(inpainted_rgb)} rgb, "
                               f"{len(inpainted_depth)} depth) do not match the dataset's "
                               f"{self.num_frames} frames.")

        return inpainted_rgb, inpainted_depth

    @property
    def bg_rgb_dataset(self) -> ImageFolderDataset:
        """RGB frames for the background (inpainted if available)."""
        return self.inpainted_rgb_dataset or self.rgb_dataset

    @property
    def bg_depth_dataset(self) -> ImageFolderDataset:
        """Depth maps for the background (inpainted if available)."""
        return self.inpainted_depth_dataset or self.depth_dataset

    @property
    def has_inpainted_frame_data(self) -> bool:
        return self.inpainted_rgb_dataset is not None and self.inpainted_depth_dataset is not None

    # -- camera accessors ----------------------------------------------------
    @property
    def num_frames(self) -> int:
        return self.metadata.num_frames

    @property
    def frame_width(self) -> int:
        return self.metadata.width

    @property
    def frame_height(self) -> int:
        return self.metadata.height

    @property
    def fps(self) -> float:
        return self.metadata.fps

    @property
    def fx(self) -> float:
        return self.camera_matrix[0, 0]

    @property
    def fy(self) -> float:
        return self.camera_matrix[1, 1]

    @property
    def cx(self) -> float:
        return self.camera_matrix[0, 2]

    @property
    def cy(self) -> float:
        return self.camera_matrix[1, 2]

    @property
    def fov_x(self) -> float:
        """Horizontal field of view in degrees."""
        return float(np.rad2deg(2.0 * np.arctan2(self.frame_width, 2.0 * self.fx)))

    @property
    def fov_y(self) -> float:
        """Vertical field of view in degrees."""
        return float(np.rad2deg(2.0 * np.arctan2(self.frame_height, 2.0 * self.fy)))

    @property
    def masked_depth_path(self) -> str:
        if self._masked_depth_path:
            return self._masked_depth_path

        raise RuntimeError("This dataset has no masked depth maps; call "
                           "`.create_masked_depth()` first.")

    def __len__(self):
        return self.num_frames

    # -- loading -------------------------------------------------------------
    def _get_depth_map_transform(self):
        return make_depth_map_transform(self.depth_scaling_factor,
                                        self.metadata.max_depth)

    def _load_camera_parameters(self) -> Tuple[np.ndarray, Trajectory]:
        camera_matrix = np.loadtxt(self.path_to_camera_matrix, dtype=np.float32)
        camera_trajectory = Trajectory.load(self.path_to_camera_trajectory)

        if camera_matrix.shape != (3, 3):
            raise RuntimeError(f"The camera matrix should be 3x3; its shape is "
                               f"{camera_matrix.shape}.")

        if camera_trajectory.values.ndim != 2 or camera_trajectory.shape[1] != 7:
            raise RuntimeError(f"The camera trajectory should be Nx7; its shape is "
                               f"{camera_trajectory.shape}.")

        return camera_matrix, camera_trajectory

    @staticmethod
    def index_to_filename(index: int, file_extension: str = "png") -> str:
        return f"{index:06d}.{file_extension}"

    # -- derived data --------------------------------------------------------
    def create_masked_depth(self,
                            dilation_options=MaskDilationOptions(num_iterations=64)) -> "HiveDataset":
        """Write depth maps with (dilated) dynamic-object regions zeroed out,
        as 16-bit millimetre PNGs.

        Cached on disk, keyed on the dilation iteration count recorded in the
        metadata (the contract of ``hive_tpu.io.HiveDataset.create_masked_depth``).
        """
        start = datetime.datetime.now()

        masked_depth_path = pjoin(str(self.base_path), self.masked_depth_folder)

        if os.path.isdir(masked_depth_path) and len(os.listdir(masked_depth_path)) == len(self):
            if self.metadata.depth_mask_dilation_iterations == dilation_options.num_iterations:
                logging.info(f"Reusing cached masked depth maps from {masked_depth_path}")
                self._masked_depth_path = masked_depth_path
                return self

            logging.warning(
                f"Cached masked depth maps used "
                f"{self.metadata.depth_mask_dilation_iterations} dilation iterations but "
                f"{dilation_options.num_iterations} were requested — regenerating them.")

        logging.info(f"Writing masked depth maps into {masked_depth_path}")
        os.makedirs(masked_depth_path, exist_ok=True)

        def save_masked_depth(i):
            depth_map = self.depth_dataset[i]
            mask = self.mask_dataset[i]
            binary_mask = dilate_mask(mask > 0, dilation_options)

            depth_map = depth_map.copy()
            depth_map[binary_mask] = 0.0
            as_mm = (depth_map / self.depth_scaling_factor).astype(np.uint16)
            with open(pjoin(masked_depth_path, f"{i:06d}.png"), "wb") as f:
                f.write(encode_png(as_mm))

        tqdm_imap(save_masked_depth, range(len(self)))

        self.metadata.depth_mask_dilation_iterations = dilation_options.num_iterations
        self.metadata.save(self.path_to_metadata)
        self._masked_depth_path = masked_depth_path

        elapsed = datetime.datetime.now() - start
        logging.info(f"Masked depth maps written: {len(os.listdir(masked_depth_path))} "
                     f"(took {elapsed})")

        return self

    def select_key_frames(self, threshold: float = 0.3, frame_step: int = 30) -> List[int]:
        """Greedy key-frame selection by view-overlap ratio.

        A sampled frame joins the key-frame set iff its point cloud, projected
        into every existing key frame, covers less than ``threshold`` of that
        view (hive/io.py:1117-1189 behaviour).
        """
        logging.info(f"Choosing key frames at overlap threshold {threshold}...")

        if not (0.0 <= threshold <= 1.0):
            raise ValueError(
                f"The key-frame overlap threshold {threshold} is outside "
                f"[0, 1].")

        if threshold == 0.0:
            return [0]
        if threshold == 1.0:
            return list(range(self.num_frames))

        if threshold > 0.8:
            logging.warning("Key-frame thresholds above 0.8 admit nearly "
                            "every sampled frame; expect long runtimes.")

        if frame_step < 1:
            raise ValueError(
                f"frame_step must be >= 1 (got {frame_step}).")

        width, height = self.metadata.width, self.metadata.height
        K = self.camera_matrix

        key_frames = [0]
        key_poses = [get_pose_components(pose_vec2mat(self.camera_trajectory[0]))]

        for frame in range(1, self.num_frames, frame_step):
            depth = self.bg_depth_dataset[frame]
            mask = self.mask_dataset[frame] == 0
            R, t = get_pose_components(pose_vec2mat(self.camera_trajectory[frame]))

            frame_points = point_cloud_from_depth(depth, mask, K=K, R=R, t=t)

            is_key_frame = True

            for key_R, key_t in key_poses:
                projected, _ = world2image(frame_points, K=K, R=key_R, t=key_t)

                visible = projected[(projected[:, 0] >= 0) & (projected[:, 0] < width)
                                    & (projected[:, 1] >= 0) & (projected[:, 1] < height)]

                if len(visible) == 0:
                    continue

                extent = visible.max(axis=0) - visible.min(axis=0)
                overlap_ratio = np.prod(extent) / (width * height)

                if overlap_ratio >= threshold:
                    is_key_frame = False
                    break

            if is_key_frame:
                key_frames.append(frame)
                key_poses.append((R, t))

        logging.debug(f"Key-frame set: {key_frames}.")
        return key_frames


@contextlib.contextmanager
def temporary_trajectory(dataset: HiveDataset, trajectory: Trajectory):
    """Temporarily swap a dataset's camera trajectory."""
    backup = dataset.camera_trajectory.copy()

    try:
        dataset.camera_trajectory = trajectory
        yield
    finally:
        dataset.camera_trajectory = backup


@contextlib.contextmanager
def temporary_camera_matrix(dataset: HiveDataset, camera_matrix: np.ndarray):
    """Temporarily swap a dataset's camera matrix."""
    backup = dataset.camera_matrix.copy()

    try:
        dataset.camera_matrix = camera_matrix
        yield
    finally:
        dataset.camera_matrix = backup


@contextlib.contextmanager
def disable_inpainted_data(dataset: HiveDataset):
    """Temporarily hide a dataset's inpainted RGB/depth so consumers fall back
    to the raw frames."""
    rgb_backup = dataset.inpainted_rgb_dataset
    depth_backup = dataset.inpainted_depth_dataset

    try:
        dataset.inpainted_rgb_dataset = None
        dataset.inpainted_depth_dataset = None
        yield
    finally:
        dataset.inpainted_rgb_dataset = rgb_backup
        dataset.inpainted_depth_dataset = depth_backup
