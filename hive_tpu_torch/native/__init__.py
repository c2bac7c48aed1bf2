"""Native (C++) host code, loaded via ctypes: the extraction weld, the
QEM decimation, the JPEG scan decodes (baseline and progressive), the PNG
unfilter, Telea's inpainting, the MPEG-4 Part 2 VOP decode and encode and
the H.264 slice decode (I, P and B slices, CAVLC and CABAC), deblocking and encode, with
its constant tables in ``src/h264_tables.h``, and the HEVC picture decode (I, P and B
slices, deblocking and SAO included) and encode, with its tables in ``src/hevc_tables.h``; both codecs share
the CABAC engine of ``src/cabac.h``.

Counterpart of ``hive_tpu/native`` (``src/weld.cpp`` and
``src/qem_decimate.cpp`` are copies of the JAX package's, built with the same
flags, so both packages decimate a mesh to the same bits);
``src/jpeg_decode.cpp`` and ``src/png_unfilter.cpp`` are the port's own, in
place of the libjpeg and zlib-based decoders of Pillow, which the JAX
package reads its frames with (both share FFmpeg's simple IDCT,
``src/simple_idct.h``, with ``src/mpeg4_decode.cpp``, the macroblock layer
of MPEG-4 Part 2 video as FFmpeg's ``mpeg4`` decoder reads it, which has no
Python fallback: :mod:`hive_tpu_torch.video.mpeg4` raises without the
library); ``src/telea_inpaint.cpp`` computes what
OpenCV's ``cv2.inpaint(..., INPAINT_TELEA)`` computes, and is built with
``-ffp-contract=off`` so that no fused multiply-add rounds its sums
differently from OpenCV's build. The shared library
builds on demand with g++ the first time it is needed, into
``hive_tpu_torch/_build/``. Other callers fall back to numpy when no
toolchain is available (:func:`build_error` says why it is not). This is
host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_NATIVE_DIR, "src")
_BUILD_DIR = os.path.join(os.path.dirname(_NATIVE_DIR), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libhive_native.so")

_SOURCES = ["h264_decode.cpp", "hevc_decode.cpp", "jpeg_decode.cpp", "mpeg4_decode.cpp",
            "png_unfilter.cpp", "qem_decimate.cpp", "telea_inpaint.cpp", "weld.cpp"]
# Headers the sources include: a change to one rebuilds the library too.
_HEADERS = ["cabac.h", "h264_tables.h", "hevc_tables.h", "simple_idct.h"]
# Flags beyond the common ones, per source.
_EXTRA_FLAGS = {"telea_inpaint.cpp": ["-ffp-contract=off"]}
_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_build_error = ""


def _needs_rebuild() -> bool:
    if not os.path.isfile(_LIB_PATH):
        return True

    lib_mtime = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(os.path.join(_SRC_DIR, src)) > lib_mtime
               for src in _SOURCES + _HEADERS)


def _run(command) -> bool:
    global _build_error
    logging.info(f"Building native library: {' '.join(command)}")
    try:
        result = subprocess.run(command, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        _build_error = f"{' '.join(command)} did not run: {exc}"
        logging.warning(f"Native build failed to run: {exc}")
        return False
    if result.returncode != 0:
        _build_error = f"{' '.join(command)} failed:\n{result.stderr}"
        logging.warning(f"Native build failed:\n{result.stderr}")
        return False
    return True


def build_error() -> str:
    """Why :func:`get_native_lib` gave None: the failed build or load."""
    return _build_error or "the native library was not built"


def _build() -> bool:
    # Each source compiles to its own object (its flags may differ), then
    # one link to a per-process temp file, renamed into place: os.rename
    # is atomic on one filesystem, so a concurrent process never dlopens a
    # half-written library.
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp_path = f"{_LIB_PATH}.build-{os.getpid()}"
    objects = [f"{tmp_path}.{os.path.splitext(src)[0]}.o" for src in _SOURCES]
    try:
        for src, obj in zip(_SOURCES, objects):
            if not _run(["g++", *_FLAGS, *_EXTRA_FLAGS.get(src, []), "-c", "-o", obj,
                         os.path.join(_SRC_DIR, src)]):
                return False
        if not _run(["g++", "-shared", "-o", tmp_path, *objects]):
            return False
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)

    try:
        os.rename(tmp_path, _LIB_PATH)
    except OSError as exc:
        global _build_error
        _build_error = f"moving the built library into place failed: {exc}"
        logging.warning(f"Could not move the built library into place: {exc}")
        return False

    return True


def get_native_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it first if necessary.

    Returns ``None`` when unavailable (callers must fall back to Python).
    """
    global _lib, _build_failed, _build_error

    with _lock:
        if _lib is not None:
            return _lib

        if _build_failed:
            return None

        if _needs_rebuild() and not _build():
            _build_failed = True
            return None

        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as exc:
            _build_error = f"loading {_LIB_PATH} failed: {exc}"
            logging.warning(f"Could not load native library: {exc}")
            _build_failed = True
            return None

        import ctypes as ct

        lib.hive_qem_decimate.restype = ct.c_int
        lib.hive_qem_decimate.argtypes = [
            ct.POINTER(ct.c_double), ct.c_int,
            ct.POINTER(ct.c_int), ct.c_int,
            ct.c_int, ct.c_double,
            ct.POINTER(ct.c_double), ct.POINTER(ct.c_int),
            ct.POINTER(ct.c_int), ct.POINTER(ct.c_int),
        ]

        lib.hive_weld_unique.restype = ct.c_int64
        lib.hive_weld_unique.argtypes = [
            ct.POINTER(ct.c_uint64), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ]

        lib.hive_oct_average.restype = None
        lib.hive_oct_average.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.c_int64, ct.c_int64, ct.POINTER(ct.c_float),
        ]

        lib.hive_weld_unique_lanes.restype = ct.c_int64
        lib.hive_weld_unique_lanes.argtypes = [
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint32), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ]

        lib.hive_extract_assemble.restype = ct.c_int64
        lib.hive_extract_assemble.argtypes = [
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint32),
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64), ct.c_int64, ct.c_int64,
            ct.c_int64, ct.c_int64, ct.c_double, ct.POINTER(ct.c_double),
            ct.POINTER(ct.c_float), ct.POINTER(ct.c_uint8),
            ct.POINTER(ct.c_float),
        ]

        lib.hive_jpeg_decode_scan.restype = ct.c_int
        lib.hive_jpeg_decode_scan.argtypes = [
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.c_int32, ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_uint8),
            ct.POINTER(ct.c_int32), ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int32,
            ct.POINTER(ct.c_void_p),
        ]

        lib.hive_jpeg_decode_progressive_scan.restype = ct.c_int
        lib.hive_jpeg_decode_progressive_scan.argtypes = [
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.c_int32, ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_uint8),
            ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int32, ct.c_int32, ct.c_int32,
            ct.c_int32, ct.POINTER(ct.c_void_p),
        ]

        lib.hive_mpeg4_decode_vop.restype = ct.c_int
        lib.hive_mpeg4_decode_vop.argtypes = [
            ct.c_char_p, ct.c_int64, ct.c_int64, ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_int64),
        ]

        lib.hive_mpeg4_encode_vop.restype = ct.c_int64
        lib.hive_mpeg4_encode_vop.argtypes = [
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_void_p),
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_int32,
            ct.c_char_p, ct.c_int64, ct.c_void_p, ct.c_int64, ct.POINTER(ct.c_int64),
        ]

        lib.hive_h264_mb_state_bytes.restype = ct.c_int
        lib.hive_h264_mb_state_bytes.argtypes = []
        lib.hive_h264_stat_counts.restype = ct.c_int
        lib.hive_h264_stat_counts.argtypes = [ct.POINTER(ct.c_int32)]
        lib.hive_h264_decode_slice.restype = ct.c_int
        lib.hive_h264_param_ints.restype = ct.c_int
        lib.hive_h264_param_ints.argtypes = []
        lib.hive_h264_decode_slice.argtypes = [
            ct.c_char_p, ct.c_int64, ct.c_int64, ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_int32), ct.c_void_p,
            ct.POINTER(ct.c_void_p), ct.c_void_p, ct.POINTER(ct.c_int64),
        ]
        lib.hive_h264_deblock.restype = ct.c_int
        lib.hive_h264_deblock.argtypes = [
            ct.POINTER(ct.c_int32), ct.c_void_p, ct.POINTER(ct.c_void_p),
        ]
        lib.hive_h264_encode_slice.restype = ct.c_int64
        lib.hive_h264_encode_slice.argtypes = [
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_void_p),
            ct.POINTER(ct.c_int32), ct.c_void_p, ct.POINTER(ct.c_void_p), ct.c_void_p,
            ct.c_void_p, ct.c_void_p, ct.c_char_p, ct.c_int64, ct.c_void_p, ct.c_int64,
            ct.POINTER(ct.c_int64),
        ]

        for name in ("hive_hevc_param_ints", "hive_hevc_slice_ints", "hive_hevc_col_ints"):
            getattr(lib, name).restype = ct.c_int
            getattr(lib, name).argtypes = []
        lib.hive_hevc_stat_counts.restype = ct.c_int
        lib.hive_hevc_stat_counts.argtypes = [ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32)]
        lib.hive_hevc_decode_picture.restype = ct.c_int
        lib.hive_hevc_decode_picture.argtypes = [
            ct.c_void_p, ct.c_int, ct.c_void_p, ct.POINTER(ct.c_void_p), ct.c_void_p,
            ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_void_p), ct.c_int, ct.c_void_p, ct.c_void_p,
            ct.c_void_p,
        ]
        lib.hive_hevc_encode_picture.restype = ct.c_int64
        lib.hive_hevc_encode_picture.argtypes = [
            ct.c_void_p, ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_uint64,
            ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_void_p),
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_void_p,
            ct.POINTER(ct.c_void_p), ct.c_int, ct.c_void_p,
        ]

        lib.hive_png_unfilter.restype = ct.c_int
        lib.hive_png_unfilter.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64, ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_uint8),
        ]

        lib.hive_telea_inpaint.restype = ct.c_int
        lib.hive_telea_inpaint.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int, ct.c_int, ct.c_int, ct.c_int,
            ct.c_void_p, ct.c_double,
        ]

        _lib = lib
        return _lib


def weld_unique(keys):
    """np.unique(keys, return_index=True, return_inverse=True) — native
    radix-sort weld when the library is available, numpy otherwise.

    :param keys: (N,) uint64 array.
    :return: (first_index (U,) int64, inverse (N,) int64) with unique values
        ascending and first_index holding the smallest original index per
        unique value (np.unique semantics).
    """
    import numpy as np

    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    lib = get_native_lib()

    if lib is None or len(keys) == 0:
        _, first_index, inverse = np.unique(keys, return_index=True,
                                            return_inverse=True)
        return first_index.astype(np.int64), inverse.astype(np.int64)

    first_index = np.empty(len(keys), dtype=np.int64)
    inverse = np.empty(len(keys), dtype=np.int64)

    count = lib.hive_weld_unique(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(keys),
        first_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))

    if count < 0:  # native allocation failure — numpy fallback
        _, first_index, inverse = np.unique(keys, return_index=True,
                                            return_inverse=True)
        return first_index.astype(np.int64), inverse.astype(np.int64)

    return first_index[:count].copy(), inverse


def extract_assemble(klo, colcode, fracnrm, dims, voxel_size: float, origin):
    """Weld + assemble an extracted mesh from the raw isosurface lanes
    (hive_tpu_torch/ops/marching.py 3-lane layout) in one native pass: key
    build, radix-sort weld, position/colour decode for unique vertices,
    oct-normal averaging, degenerate-face compaction.

    :param klo: (N,) int32 lane 0 — global lo-corner ids.
    :param colcode: (N,) uint32 lane 1 — colour | edge code << 24.
    :param fracnrm: (N,) uint32 lane 2 — frac16 | oct8x8 << 16.
    :param dims: (X, Y, Z) volume extents in voxels.
    :param voxel_size: voxel edge length (meters).
    :param origin: (3,) world position of voxel (0, 0, 0).
    :return: (vertices (U, 3) f32 world, faces (F, 3) int64,
        colors (U, 3) uint8, normals (U, 3) f32 unit), or ``None`` when the
        native library is unavailable (callers fall back to numpy).
    """
    import numpy as np

    lib = get_native_lib()
    if lib is None:
        return None

    n = len(klo)
    if n == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                np.zeros((0, 3), np.uint8), np.zeros((0, 3), np.float32))

    klo = np.ascontiguousarray(klo, dtype=np.int32)
    colcode = np.ascontiguousarray(colcode, dtype=np.uint32)
    fracnrm = np.ascontiguousarray(fracnrm, dtype=np.uint32)

    first_index = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    num_unique = lib.hive_weld_unique_lanes(
        ptr(klo, ctypes.c_int32), ptr(colcode, ctypes.c_uint32), n,
        ptr(first_index, ctypes.c_int64), ptr(inverse, ctypes.c_int64))
    if num_unique < 0:  # allocation failure — numpy fallback
        return None

    vertices = np.empty((num_unique, 3), dtype=np.float32)
    colors = np.empty((num_unique, 3), dtype=np.uint8)
    normals = np.empty((num_unique, 3), dtype=np.float32)
    origin64 = np.ascontiguousarray(origin, dtype=np.float64)

    kept = lib.hive_extract_assemble(
        ptr(klo, ctypes.c_int32), ptr(colcode, ctypes.c_uint32),
        ptr(fracnrm, ctypes.c_uint32), ptr(first_index, ctypes.c_int64),
        ptr(inverse, ctypes.c_int64), n, num_unique,
        int(dims[1]), int(dims[2]), float(voxel_size),
        ptr(origin64, ctypes.c_double),
        ptr(vertices, ctypes.c_float), ptr(colors, ctypes.c_uint8),
        ptr(normals, ctypes.c_float))

    faces = inverse[:3 * kept].reshape(-1, 3).copy()
    return vertices, faces, colors, normals


def oct_average(packed, inverse, num_unique: int):
    """Average oct-encoded normals per welded vertex (one native pass).

    :param packed: (N,) uint32 oct-encoded normals (snorm16 x, y halves).
    :param inverse: (N,) int64 welded ranks from :func:`weld_unique`.
    :param num_unique: number of welded vertices.
    :return: (num_unique, 3) float32 unit normals, or ``None`` when the
        native library is unavailable (callers fall back to numpy).
    """
    import numpy as np

    lib = get_native_lib()
    if lib is None:
        return None

    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    inverse = np.ascontiguousarray(inverse, dtype=np.int64)
    out = np.empty((num_unique, 3), dtype=np.float32)

    lib.hive_oct_average(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(packed), num_unique,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    return out


def png_unfilter(data, height: int, stride: int, bpp: int):
    """Undo PNG scanline filters in one native pass.

    :param data: (height, stride + 1) uint8: each row's filter type, then
        its filtered bytes.
    :return: (height, stride) uint8, or ``None`` when the native library is
        unavailable (callers fall back to numpy).
    :raises ValueError: for an unknown filter type.
    """
    import numpy as np

    lib = get_native_lib()
    if lib is None:
        return None

    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.shape != (height, stride + 1) or bpp < 1:
        raise ValueError(f"PNG rows of shape {data.shape} do not hold {height} rows of "
                         f"{stride} bytes")
    out = np.empty((height, stride), dtype=np.uint8)
    status = lib.hive_png_unfilter(data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                   height, stride, bpp,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if status:
        raise ValueError("unknown PNG filter type")
    return out


def telea_inpaint(image, hole, radius: float):
    """Telea's inpainting of ``image`` where ``hole`` is non-zero, as
    ``cv2.inpaint(image, hole, radius, cv2.INPAINT_TELEA)``.

    :param image: (H, W) or (H, W, 3) uint8, or (H, W) uint16.
    :param hole: (H, W) uint8.
    :return: the inpainted copy, or ``None`` when the native library is
        unavailable.
    :raises ValueError: for another layout.
    """
    import numpy as np

    lib = get_native_lib()
    if lib is None:
        return None

    out = np.array(image, order="C", copy=True)
    hole = np.ascontiguousarray(hole, dtype=np.uint8)
    channels = 1 if out.ndim == 2 else out.shape[2]
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}.get(out.dtype, 0)
    if hole.shape != out.shape[:2] or out.ndim not in (2, 3):
        raise ValueError(f"a hole of shape {hole.shape} does not fit an image of shape "
                         f"{out.shape}")
    status = lib.hive_telea_inpaint(hole.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                    out.shape[0], out.shape[1], channels, depth,
                                    out.ctypes.data_as(ctypes.c_void_p), float(radius))
    if status:
        raise ValueError(f"Telea inpainting takes uint8 images of 1 or 3 channels or uint16 "
                         f"images of 1 channel, not {out.dtype} x {channels}")
    return out
