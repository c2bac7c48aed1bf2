#!/usr/bin/env python3
"""Drive hive_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build all six CUDA kernels from ``hive_tpu_torch/csrc`` (one ``nvcc``
   each, started together);
3. refine-query kernel vs its plain version on a VGA depth map (10% invalid
   pixels) with the refine pass's 4096 block AABBs: bit-exact, timed;
4. band-update kernel vs its plain version on a whole frame's band at the
   bench shape (f32 state, after two frames), timed; the same bit-exact
   check on a small volume in each of the four {f32, bf16} x {rgb565d16,
   rgb888} states at SUB = 1 and at SUB = 2; and the band-sampler kernel vs
   its plain version on one 128-block trip and on a whole frame's band:
   bit-exact, timed beside ``torch.take``;
5. integration at the TSDF bench shape (VGA x 64 frames into a 256^3
   volume, the wavy-wall scene made on the card): the kernel path and the
   plain path give bit-identical states; voxel-updates/s, median of 5 reps;
   plus the sparse-vs-dense self-check on a small volume;
6. the main path through the CLI entry point (``python -m hive_tpu_torch
   ... --background_only``, run in this process) on a 30-frame 640x480
   synthetic HIVE dataset this script writes, at the default 5 mm / 320M
   voxel budget: ``bg.glb`` must load and carry the scene's colour
   gradients. Kernel launch counts are reset just before and read just
   after this run; both kernels (refine query, band update) must have
   launched. Every kernel call of the run is also made through its plain
   version on the same inputs and must agree bit for bit (the band update's
   plain version runs on a snapshot of the frame's band rows, which raises
   the run's peak device memory); the kernels are then timed on the run's
   largest call (the band update on the volume's own state);
7. the tile-gather kernel, both axes, on the gather probe's (8, 128) tile:
   bit-exact vs its plain version, timed beside ``torch.gather``;
8. the patch-gather kernel on the probe's 1024 blocks x 512 samples, with
   one sample in eight moved out of its window: bit-exact vs its plain
   version, timed beside ``torch.take`` and the band sampler;
9. both fused band-trip variants on the fused-trip probe's 128-row trip:
   bit-exact vs the plain version, timed;
10. the two measurement entry points, each run in this process with the
   launch counts reset just before and read just after:
   ``hive_tpu_torch.micro.gather`` (Q1 tile gathers, Q2 patch gather timed
   beside ``torch.take`` and the band sampler) and
   ``hive_tpu_torch.micro.fused_band`` (Q2: both fused trips equal the
   production trip; Q3: fused, production and take trips timed, their final
   states bit-identical on the rows that fit); each of its kernels must have
   launched;
11. one ``{"kernels": [...]}`` line (times, errors and bounds at the main
   paths' shapes, and under ``bench`` at the bench shape), then the card's
   ``nvidia-smi`` line, then ``{"ok": true, "device": {...}}`` as the last
   line.

Kernel and plain times are device time from torch.profiler's CUPTI trace;
``loop_ms`` is a Python loop of launches timed with CUDA events, host cost
included. The band update changes the state it runs on, so each of its
timed launches runs on its rows as they were before the update, written
back (and the L2 flushed) before it; it runs once per frame, so it has no
``loop_ms``. ``bound_ms`` is the larger of the bytes the call must move
over the HBM rate and its operations over the card's non-tensor-core peak;
the band update's counts the state of the voxels the frame updates, not of
every band voxel.

It needs one CUDA card and exits non-zero without one, printing no result.
"""

from __future__ import annotations

import json
import os
import runpy
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from unittest import mock

import numpy as np
import torch

from hive_tpu_torch.micro import timing
from hive_tpu_torch.micro.timing import device_profile, device_us, events_ms, self_device_us

SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), for the bounds: HBM rate,
# and the float32 rate outside the tensor cores, the nearest listed peak for
# the kernels' integer work.
HBM_BYTES_PER_S = 3.35e12
SIMT_OPS_PER_S = 67e12

BENCH_FRAMES, BENCH_H, BENCH_W, BENCH_GRID = 64, 480, 640, 256
E2E_FRAMES, E2E_H, E2E_W = 30, 480, 640


def log(msg: str) -> None:
    print(msg, flush=True)


def device_time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Device ms per call of ``fn()``: the kernels' own device time from
    torch.profiler's CUPTI trace, which leaves out the host's launch cost."""
    return device_profile(fn, reps, warmup)[0]


def bound(num_bytes: float, int_ops: float):
    """(bound ms, what bounds it): the larger of the bytes over the HBM rate
    and the integer operations over the card's non-tensor-core peak."""
    bytes_ms = 1e3 * num_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * int_ops / SIMT_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def refine_bound(cells):
    """The refine query's least time on these cell bounds. Bytes: each
    distinct pyramid word any block reads (blocks that share cells share
    words), the six int32 bounds in and dmin/dmax/valid out per block.
    Operations per cell: index (2 min, mul, 2 add), three fields (5 shifts
    and masks), three reductions; ten more per block to decode."""
    from hive_tpu_torch.ops.refine_query import GRID

    off, w_l, cu0, cu1, cv0, cv1 = (c.long() for c in cells)
    step = torch.arange(GRID, device=off.device)
    cv = torch.minimum(cv0[:, None] + step, cv1[:, None])
    cu = torch.minimum(cu0[:, None] + step, cu1[:, None])
    idx = off[:, None, None] + cv[:, :, None] * w_l[:, None, None] + cu[:, None, :]
    n = off.numel()
    return bound(torch.unique(idx).numel() * 4 + n * (6 * 4 + 9),
                 n * (GRID * GRID * 13 + 10))


def sampler_bound(frame, vc, uc):
    """The sampler's least time on these coordinates. Bytes: v, u in and the
    word out per voxel, plus each distinct frame word once. Operations per
    voxel: two clamps (4), the flat index (2)."""
    flat = vc.long() * frame.shape[1] + uc.long()
    n = vc.numel()
    return bound(n * 12 + torch.unique(flat).numel() * 4, n * 6)


def max_abs_err(got, want) -> torch.Tensor:
    """Largest |got - want| on the card; equal values (equal infinities
    included) count 0, so it stays finite when the two agree."""
    g, w = got.double(), want.double()
    return torch.where(g == w, 0.0, (g - w).abs()).max()


def bit_differences(got, want) -> torch.Tensor:
    """How many elements differ in their bit patterns, on the card."""
    def bits(x):
        if x.dtype in (torch.float32, torch.bfloat16):
            return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)
        return x.to(torch.int32)
    return (bits(got) != bits(want)).sum()


def time_refine(pyramid, cells):
    """Kernel, plain and launch-loop times of one refine query, and its bound."""
    from hive_tpu_torch.ops import refine_query as rq

    bound_ms, bound_by = refine_bound(cells)
    return dict(
        ms=device_time_ms(lambda: rq.refine_query_cells(pyramid, *cells)),
        plain_ms=device_time_ms(lambda: rq.refine_query_plain(pyramid, *cells), reps=20),
        loop_ms=events_ms(lambda: rq.refine_query_cells(pyramid, *cells)),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        shape=f"pyramid {tuple(pyramid.shape)} int32, {cells[0].numel()} blocks x 25 cells")


def time_sampler(frame, vc, uc):
    """Kernel, plain, ``torch.take`` and launch-loop times of one sampler
    call, and its bound."""
    from hive_tpu_torch.ops import band_sampler as bs

    flat = (vc.long() * frame.shape[1] + uc.long()).contiguous()
    frame_flat = frame.reshape(-1)
    bound_ms, bound_by = sampler_bound(frame, vc, uc)
    return dict(
        ms=device_time_ms(lambda: bs.band_sample(frame, vc, uc), reps=200),
        plain_ms=device_time_ms(lambda: bs.band_sample_plain(frame, vc, uc), reps=200),
        loop_ms=events_ms(lambda: bs.band_sample(frame, vc, uc), reps=200),
        library_ms=device_time_ms(lambda: torch.take(frame_flat, flat), reps=200),
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"frame {tuple(frame.shape)} int32, coordinates {tuple(vc.shape)} int32")


# Operations per voxel of the band update (csrc/band_update.cu), each f32 or
# integer instruction-level operation counted once (a division as one): for
# every voxel, in-slab offsets 7, camera coordinates 18 (3 x (3 mul, 3 add)),
# z guard 2, u and v 10 (2 x (mul, div, add, round, convert)), view test 5;
# for a voxel in view, clamps and address 6 and the unpack, 15 (rgb565d16)
# or 8 (rgb888), keyed by the frame words per pixel; for a valid voxel, the
# update 31 (sdf, 3 tests, scale and clamp, 5 for the weights, 4 x
# (convert, mul, FMA, div, convert) for tsdf and the colours).
BAND_UPDATE_OPS = dict(voxel=42, in_view={1: 21, 2: 14}, valid=31)
# What the band update's bound counts, reported beside its times.
BAND_UPDATE_COUNTS = ("voxels", "in_view", "valid", "values_changed")
# Rows per trip where the band update's plain version runs on the card.
PLAIN_TRIP_ROWS = 4096
# An L2 flush: reading twice the H100's 50 MB L2 evicts what a setup left
# there (and leaves clean lines, so no write-back lands in the timed call).
L2_FLUSH_INTS = 25 << 20


def band_update_in_trips(state, ids, base, scal, frames, *, block, sub):
    """The band update's plain version in trips of PLAIN_TRIP_ROWS rows,
    which bounds its temporaries on the card."""
    from hive_tpu_torch.ops.band_update import band_update_plain

    for start in range(0, ids.numel(), PLAIN_TRIP_ROWS):
        end = start + PLAIN_TRIP_ROWS
        band_update_plain(state, ids[start:end], base[start:end], scal, frames, block=block,
                          sub=sub)


def band_call(volume, frames, f: int, device) -> dict:
    """The band update's inputs for frame ``f`` on ``volume``, built by its
    integrator's stages as ``integrate`` builds them (weight 1)."""
    from hive_tpu_torch.ops.tsdf_sparse import build_flat_pyramid

    depths, colors, K, poses = frames
    height, width = depths.shape[1:]
    integ = volume._integrator(height, width, None)
    origins = volume.block_origins_device
    w2c = torch.linalg.inv(torch.as_tensor(poses[f], device=device))
    R, t = w2c[:3, :3], w2c[:3, 3]
    intr = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=device)
    one = torch.tensor(1.0, device=device)
    sample = integ.pack_frame(depths[f], colors[f])
    pyramid = build_flat_pyramid(depths[f], height, width,
                                 packed_u16=volume.color_mode == "rgb565d16")
    classes, dmin, dmax, free_ok = integ.classify_refined(origins, pyramid, R, t, tuple(intr))
    band_flat, _, _ = integ.slab_masks(origins, classes, dmin, dmax, free_ok, R, t, one)
    ids = torch.nonzero(band_flat).reshape(-1)
    return dict(state=integ.to_slabs(volume.state), ids=ids,
                base=integ.slab_base(origins, ids, R, t), scal=integ.band_scalars(intr, R, one),
                frames=sample, block=integ.block, sub=integ.SUB)


def compact_call(call: dict) -> dict:
    """The same band update on a copy of just its rows: ids 0..K-1 and the
    SUB = 1 colour layout (each row's R|G|B segments), which give every
    voxel the same inputs and so the same result."""
    from hive_tpu_torch.ops.band_update import gather_rows

    tsdf, weight, color = gather_rows(call["state"], call["ids"], call["sub"])
    n = tsdf.shape[0]
    return dict(call, state=(tsdf, weight, color.reshape(n * 3, -1)),
                ids=torch.arange(n, device=tsdf.device), sub=1)


def band_update_args(call: dict):
    return ((call["ids"], call["base"], call["scal"], call["frames"]),
            dict(block=call["block"], sub=call["sub"]))


def band_update_exact(call: dict) -> float:
    """The kernel on ``call``'s state in place vs the plain version on a
    copy: every value bit for bit. Returns the largest |difference| (0)."""
    from hive_tpu_torch.ops import band_update as bu

    args, options = band_update_args(call)
    want = tuple(x.clone() for x in call["state"])
    bu.band_update_plain(want, *args, **options)
    bu.band_update(call["state"], *args, **options)
    return exact_or_raise("band_update", zip(call["state"], want))


def band_update_bound(compact: dict, after):
    """The band update's least time on this call (``compact``: its rows
    before the update, as :func:`compact_call` gives them; ``after``: the
    plain version's result). Whether a voxel is updated depends only on its
    geometry and the frame, so the function reads the state of the valid
    voxels only. Bytes: those voxels' 5 values read once, each value that
    changes written once, the id and base of each row, the 64 B of scalars,
    and each distinct frame word that a voxel in view samples once."""
    from hive_tpu_torch.ops import band_update as bu

    before, frames = compact["state"], compact["frames"]
    n, bvs = before[0].shape
    elem = before[0].element_size()
    changed = sum(int(bit_differences(a, b)) for a, b in zip(after, before))
    pixel, in_view, valid, _, _ = bu.observe(compact["base"], compact["scal"], frames,
                                             block=compact["block"], bvs=bvs)
    seen, updated = int(in_view.sum()), int(valid.sum())
    pixels = torch.unique(pixel[in_view]).numel()
    ops = (n * bvs * BAND_UPDATE_OPS["voxel"] + seen * BAND_UPDATE_OPS["in_view"][len(frames)]
           + updated * BAND_UPDATE_OPS["valid"])
    bound_ms, bound_by = bound(updated * 5 * elem + changed * elem + n * 20 + 64
                               + pixels * 4 * len(frames), ops)
    return bound_ms, bound_by, dict(zip(BAND_UPDATE_COUNTS, (n * bvs, seen, updated, changed)))


def time_band_update(call: dict, compact: dict, tag: str) -> dict:
    """Kernel and plain times of one band update, and its bound.

    ``call`` is the update on its own state (scattered slab ids, the
    integrator's layout), ``compact`` its rows before the update. Each timed
    launch runs on ``call``'s state after its rows were written back from
    ``compact`` and the L2 flushed, so every launch makes the whole update
    from a cold cache; the state after the last launch must equal one update
    by the plain version, bit for bit. The plain version's work does not
    depend on the state's values, so it runs again and again on one copy."""
    from hive_tpu_torch.ops import band_update as bu

    args, options = band_update_args(call)
    compact_args, compact_options = band_update_args(compact)
    after = tuple(x.clone() for x in compact["state"])
    bu.band_update_plain(after, *compact_args, **compact_options)
    bound_ms, bound_by, counts = band_update_bound(compact, after)
    n, bvs = compact["state"][0].shape
    before = (*compact["state"][:2], compact["state"][2].view(n, 3, bvs))
    flush = torch.zeros(L2_FLUSH_INTS, dtype=torch.int32, device=call["ids"].device)

    def setup():
        bu.scatter_rows(call["state"], call["ids"], call["sub"], before)
        flush.sum()

    def launch():
        bu.band_update(call["state"], *args, **options)

    ms, _ = device_profile(launch, reps=10, warmup=2, setup=setup, kernel="band_update_kernel")
    tsdf, weight, color = bu.gather_rows(call["state"], call["ids"], call["sub"])
    exact_or_raise("band_update (the state after its timed launches)",
                   zip((tsdf, weight, color.reshape(n * 3, bvs)), after))
    plain_state = tuple(x.clone() for x in compact["state"])
    times = dict(
        ms=ms, loop_ms=None, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        plain_ms=device_time_ms(lambda: bu.band_update_plain(plain_state, *compact_args,
                                                             **compact_options),
                                reps=3, warmup=1),
        **counts,
        shape=f"{n} slab rows x {bvs} voxels, {compact['state'][0].dtype} state, "
              f"{len(call['frames'])} frame word(s) per pixel; each launch on the rows as "
              "before the update, L2 flushed")
    log_times(tag, times)
    log(f"[{tag}] {counts['voxels']} voxels, {counts['in_view']} in view, {counts['valid']} "
        f"valid; {counts['values_changed']} values changed (every timed launch: the state "
        f"after them equals one update)")
    return times


def log_times(tag: str, times: dict) -> None:
    library = ("" if times["library_ms"] is None
               else f" {times.get('library', 'take')}={times['library_ms']:.6f} ms")
    loop = ("" if times["loop_ms"] is None
            else f"; launch loop {times['loop_ms']:.6f} ms/call (events)")
    log(f"[{tag}] {times['shape']}: kernel={times['ms']:.6f} ms "
        f"plain={times['plain_ms']:.6f} ms{library} (profiler){loop}; "
        f"bound={times['bound_ms']:.7f} ms ({times['bound_by']})")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Scenes.
# ---------------------------------------------------------------------------

def bench_frames(device):
    """The TSDF bench's wavy wall 1.5-3.5 m away, textured, made on the card."""
    f = torch.arange(BENCH_FRAMES, device=device, dtype=torch.float32)[:, None, None]
    v = torch.arange(BENCH_H, device=device, dtype=torch.float32)[None, :, None]
    u = torch.arange(BENCH_W, device=device, dtype=torch.float32)[None, None, :]
    depths = 2.5 + 0.3 * torch.sin(u * 0.02 + f * 0.3) * torch.cos(v * 0.03)
    shape = (BENCH_FRAMES, BENCH_H, BENCH_W)
    colors = torch.stack([((u * 0.4) % 255.0).expand(shape),
                          ((v * 0.5) % 255.0).expand(shape),
                          ((u + v + 30.0 * f) % 255.0).expand(shape)], dim=-1)
    K = np.array([[580.0, 0, 319.5], [0, 580.0, 239.5], [0, 0, 1.0]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (BENCH_FRAMES, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.5, BENCH_FRAMES) + 0.0123
    return depths.contiguous(), colors.contiguous(), K, poses


def write_png(path: str, image: np.ndarray) -> None:
    """Write an 8-bit grey/RGB or 16-bit grey PNG (filter 0) with zlib."""
    height, width = image.shape[:2]
    if image.dtype == np.uint16:
        depth, colour, raw = 16, 0, image.astype(">u2").tobytes()
    else:
        depth, colour = 8, (2 if image.ndim == 3 else 0)
        raw = np.ascontiguousarray(image, np.uint8).tobytes()
    stride = len(raw) // height
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride)
    body = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, colour,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(body, 1)))
        f.write(chunk(b"IEND", b""))


def write_hive_dataset(base: str, num_frames: int, width: int, height: int) -> None:
    """A synthetic HIVE-format dataset: a camera sliding sideways in front of a
    wall at z = 2 m (R = 60, G = x gradient, B = y gradient) with a moving
    masked blob at 1.5 m, and +-1 mm seeded sensor noise on the depth."""
    from hive_tpu_torch.options import COLMAPOptions

    rng = np.random.default_rng(SEED)
    for sub in ("rgb", "depth", "mask"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    fx = fy = 100.0
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    np.savetxt(os.path.join(base, "camera_matrix.txt"),
               np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]))

    poses = np.zeros((num_frames, 7))
    poses[:, 3] = 1.0
    poses[:, 4] = -0.02 * np.arange(num_frames)
    np.savetxt(os.path.join(base, "camera_trajectory.txt"), poses)

    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    for i in range(num_frames):
        rgb = np.zeros((height, width, 3), dtype=np.uint8)
        rgb[..., 0] = 60
        rgb[..., 1] = (us * 255 // width).astype(np.uint8)
        rgb[..., 2] = (vs * 255 // height).astype(np.uint8)
        depth_mm = 2000 + rng.integers(-1, 2, size=(height, width))
        mask = np.zeros((height, width), dtype=np.uint8)

        blob = (us - (width // 4 + i * 6)) ** 2 + (vs - height // 2) ** 2 \
            < (height // 5) ** 2
        depth_mm[blob] = 1500
        mask[blob] = 1
        rgb[blob] = [200, 64, 64]

        name = f"{i:06d}.png"
        write_png(os.path.join(base, "rgb", name), rgb)
        write_png(os.path.join(base, "depth", name), depth_mm.astype(np.uint16))
        write_png(os.path.join(base, "mask", name), mask)

    metadata = dict(num_frames=num_frames, fps=30.0, frame_step=1, width=width,
                    height=height, depth_scale=1.0 / 1000.0, max_depth=10.0,
                    depth_mask_dilation_iterations=10, estimate_pose=False,
                    estimate_depth=False, colmap_options=COLMAPOptions().to_json())
    with open(os.path.join(base, "metadata.json"), "w") as f:
        json.dump(metadata, f)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def plain_paths():
    """Patch the integrator onto the kernels' plain versions (on the card)."""
    from hive_tpu_torch.ops import tsdf_sparse
    from hive_tpu_torch.ops.refine_query import LEVEL_BIAS, refine_query_plain

    def refine(pyramid, layout, u0, u1, v0, v1, height, width):
        return refine_query_plain(pyramid, *tsdf_sparse.pyramid_cell_bounds(
            layout, u0, u1, v0, v1, height, width, LEVEL_BIAS))

    return (mock.patch.object(tsdf_sparse, "band_update", band_update_in_trips),
            mock.patch.object(tsdf_sparse, "refine_query", refine))


def check_refine(device, frames):
    from hive_tpu_torch.ops import refine_query as rq
    from hive_tpu_torch.ops.tsdf_sparse import (SparseTSDFVolume, build_flat_pyramid,
                                                pyramid_cell_bounds)

    depths, _, K, poses = frames
    rng = np.random.default_rng(SEED)
    depth = depths[0].clone()
    invalid = torch.as_tensor(rng.random((BENCH_H, BENCH_W)) < 0.1, device=device)
    depth[invalid] = 0.0

    volume = SparseTSDFVolume([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]],
                              voxel_size=4.0 / BENCH_GRID, device=device)
    integ = volume._integrator(BENCH_H, BENCH_W, None)
    w2c = torch.linalg.inv(torch.as_tensor(poses[0], device=device))
    R, t = w2c[:3, :3], w2c[:3, 3]
    intr = tuple(torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=device))
    pyramid = build_flat_pyramid(depth, BENCH_H, BENCH_W, packed_u16=True)
    classes = integ.classify(volume.block_origins_device, pyramid, R, t, intr)
    band_ids = torch.nonzero(classes == SparseTSDFVolume.BAND).reshape(-1)
    band_ids = band_ids[:integ.refine_cap]
    _, _, _, u0, u1, v0, v1, _ = integ.project_corners(
        volume.block_origins_device[band_ids], R, t, intr)
    cells = pyramid_cell_bounds(integ.layout, u0, u1, v0, v1, BENCH_H, BENCH_W,
                                rq.LEVEL_BIAS)

    got = rq.refine_query_cells(pyramid, *cells)
    want = rq.refine_query_plain(pyramid, *cells)
    for name, g, w in zip(("dmin", "dmax", "valid"), got, want):
        if int(bit_differences(g, w)):
            raise AssertionError(f"refine_query kernel differs from plain in {name}")

    times = time_refine(pyramid, cells)
    log_times("refine, bench shape, exact", times)
    return times


def check_sampler(device, frames):
    from hive_tpu_torch.ops import band_sampler as bs
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume, build_flat_pyramid

    depths, colors, K, poses = frames
    volume = SparseTSDFVolume([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]],
                              voxel_size=4.0 / BENCH_GRID, device=device)
    integ = volume._integrator(BENCH_H, BENCH_W, None)
    w2c = torch.linalg.inv(torch.as_tensor(poses[0], device=device))
    R, t = w2c[:3, :3], w2c[:3, 3]
    intr = tuple(torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device=device))
    origins = volume.block_origins_device

    (packed,) = integ.pack_frame(depths[0], colors[0])
    pyramid = build_flat_pyramid(depths[0], BENCH_H, BENCH_W, packed_u16=True)
    classes, dmin, dmax, free_ok = integ.classify_refined(origins, pyramid, R, t, intr)
    band_flat, _, _ = integ.slab_masks(origins, classes, dmin, dmax, free_ok, R, t,
                                       torch.tensor(1.0, device=device))
    band_ids = torch.nonzero(band_flat).reshape(-1)

    def coords(ids):
        cam_x, cam_y, cam_z = integ.slab_camera_coords(origins, ids, R, t)
        u, v, _ = integ.project_voxels(cam_x, cam_y, cam_z, intr)
        return (torch.clamp(v, 0, BENCH_H - 1).contiguous(),
                torch.clamp(u, 0, BENCH_W - 1).contiguous())

    vc_all, uc_all = coords(band_ids)
    vc, uc = coords(band_ids[:integ.chunk])
    err = exact_or_raise("band_sampler", [
        (bs.band_sample(packed, vc_all, uc_all), bs.band_sample_plain(packed, vc_all, uc_all)),
        (bs.band_sample(packed, vc, uc), bs.band_sample_plain(packed, vc, uc))])

    times = time_sampler(packed, vc, uc)
    log_times(f"sampler, bench shape, one trip (frame band {band_ids.numel()} rows), exact "
              "on the trip and the frame's band", times)
    return dict(times, max_abs_err=err)


def check_band_update(device, frames):
    """The band update of frame 2 on the bench volume (f32) after two
    integrated frames: bit-exact on the frame's whole band, timed."""
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    depths, colors, K, poses = frames
    volume = SparseTSDFVolume([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]],
                              voxel_size=4.0 / BENCH_GRID, device=device)
    volume.integrate_frames(colors[:2], depths[:2], K, poses[:2])
    call = band_call(volume, frames, 2, device)
    compact = compact_call(call)
    err = band_update_exact(call)
    times = time_band_update(call, compact, f"band_update, bench shape (frame band "
                                            f"{call['ids'].numel()} rows), exact")
    return dict(times, max_abs_err=err)


def check_band_update_states(device):
    """The band update bit-exact in each state dtype and colour mode, at
    SUB = 1 and 2, on a small volume (random depth, 96 x 128): frame 2's
    band after two integrated frames."""
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    rng = np.random.default_rng(SEED)
    h, w = 96, 128
    K = np.array([[100.0, 0.0, 63.5], [0.0, 100.0, 47.5], [0.0, 0.0, 1.0]], np.float32)
    depths = torch.as_tensor(rng.uniform(0.8, 2.5, size=(3, h, w)), dtype=torch.float32,
                             device=device)
    colors = torch.as_tensor(rng.integers(0, 255, size=(3, h, w, 3)), dtype=torch.uint8,
                             device=device)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.3, 3) + 0.01237
    bounds = np.array([[-1.6, 1.6], [-1.6, 1.6], [0.0, 3.2]], np.float32)
    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("rgb565d16", "rgb888"):
            for block in ((8, 8, 8), (8, 8, 16)):
                volume = SparseTSDFVolume(bounds, voxel_size=0.05, color_mode=mode, dtype=dtype,
                                          block_size=block, device=device)
                volume.integrate_frames(colors[:2], depths[:2], K, poses[:2])
                call = band_call(volume, (depths, colors, K, poses), 2, device)
                band_update_exact(call)
                checked.append(f"{str(dtype)[6:]}/{mode}/SUB={call['sub']} "
                               f"({call['ids'].numel()} rows)")
    log(f"[band_update] bit-exact on a small volume in {len(checked)} states: "
        + ", ".join(checked))


def check_integration(device, frames, launches):
    from hive_tpu_torch.ops import band_update, refine_query
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    depths, colors, K, poses = frames
    bounds = np.array([[-2.0, 2.0], [-2.0, 2.0], [0.0, 4.0]], np.float32)

    def volume():
        return SparseTSDFVolume(bounds, voxel_size=4.0 / BENCH_GRID, device=device)

    band_update.launches = refine_query.launches = 0
    kernel_vol = volume()
    kernel_vol.integrate_frames(colors, depths, K, poses)
    torch.cuda.synchronize()
    launches["bench"] = {"band_update": band_update.launches,
                         "refine_query": refine_query.launches}

    plain_vol = volume()
    patch_sample, patch_refine = plain_paths()
    with patch_sample, patch_refine:
        start = time.perf_counter()
        plain_vol.integrate_frames(colors, depths, K, poses)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - start

    for name in ("tsdf", "weight", "color"):
        if not torch.equal(getattr(kernel_vol.state, name), getattr(plain_vol.state, name)):
            raise AssertionError(f"kernel and plain integration differ in {name}")
    if min(launches["bench"].values()) == 0:
        raise AssertionError(f"bench integration skipped a kernel: {launches['bench']}")

    samples = []
    for _ in range(5):
        start = time.perf_counter()
        kernel_vol.integrate_frames(colors, depths, K, poses)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - start)
    median = sorted(samples)[len(samples) // 2]
    rate = kernel_vol.num_voxels * BENCH_FRAMES / median

    from torch.profiler import ProfilerActivity, profile

    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernel_vol.integrate_frames(colors, depths, K, poses)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - start
    busy_s = device_us(prof) / 1e6
    top = sorted(prof.key_averages(), key=lambda e: -self_device_us(e))[:6]
    # torch.nonzero sizes every trip stream and compaction on the host: each
    # call waits for the device (the .item()-class sync of the trip counts).
    syncs = [e for e in prof.key_averages() if e.key == "aten::nonzero"]
    sync_ms = sum(e.cpu_time_total for e in syncs) / 1e3
    log(f"[integrate] aten::nonzero x{sum(e.count for e in syncs)} in the traced rep, "
        f"{sync_ms:.1f} ms of host time including its device waits")
    log(f"[integrate] traced rep {traced_s * 1e3:.1f} ms, device busy "
        f"{busy_s * 1e3:.1f} ms ({100 * busy_s / traced_s:.1f}%; "
        f"{'not measured' if busy_s == 0 else 'profiler'}); top device time: "
        + "; ".join(f"{e.key[:40]} x{e.count} {self_device_us(e) / 1e3:.2f} ms"
                    for e in top))
    log(f"[integrate] VGA x {BENCH_FRAMES} frames into {kernel_vol.dims} "
        f"({kernel_vol.num_voxels} voxels): kernel == plain bit-identical; "
        f"launches {launches['bench']}; {rate / 1e6:.1f}M voxel-updates/s "
        f"(median of 5: {median * 1e3:.1f} ms; reps "
        f"{[round(s * 1e3, 1) for s in samples]} ms); plain path "
        f"{plain_s * 1e3:.1f} ms")
    return rate


def check_sparse_vs_dense(device):
    """The JAX package's sparse-vs-dense self-check (random depth, 3 frames,
    rgb888) on the card: at most 1e-3 of voxels may differ."""
    from hive_tpu_torch.ops.tsdf import TSDFVolume
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    rng = np.random.default_rng(SEED)
    h, w = 96, 128
    K = np.array([[100.0, 0.0, 63.5], [0.0, 100.0, 47.5], [0.0, 0.0, 1.0]], np.float32)
    depths = rng.uniform(0.8, 2.5, size=(3, h, w)).astype(np.float32)
    colors = rng.integers(0, 255, size=(3, h, w, 3)).astype(np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.3, 3) + 0.01237
    poses[:, 1, 3] = 0.00731
    bounds = np.array([[-1.6, 1.6], [-1.6, 1.6], [0.0, 3.2]], np.float32)

    dense = TSDFVolume(bounds, voxel_size=0.05, device=device)
    dense.integrate_frames(colors, depths, K, poses)
    sparse = SparseTSDFVolume(bounds, voxel_size=0.05, color_mode="rgb888", device=device)
    sparse.integrate_frames(colors, depths, K, poses)
    tsdf_d, w_d, _ = dense.get_volume()
    tsdf_s, w_s, _ = sparse.get_volume()
    w_frac = float((np.abs(w_s - w_d) > 1e-5).mean())
    t_frac = float((np.abs(tsdf_s - tsdf_d) > 1e-4).mean())
    if w_frac >= 1e-3 or t_frac >= 2e-3:
        raise AssertionError(f"sparse vs dense: weight {w_frac}, tsdf {t_frac} differ")
    log(f"[self-check] sparse vs dense on {sparse.dims}: weight differs at "
        f"{w_frac:.2e}, tsdf at {t_frac:.2e} of voxels")


class MainPathCheck:
    """Stands in for the integrator's two kernel calls during the CLI run.

    Each call goes through the kernel's own wrapper (which counts the
    launch) and, on the same inputs, through its plain version (no launch):
    the refine query on the same tensors, the band update on a snapshot of
    the frame's band rows taken before the kernel updates them in place.
    The bit differences and the largest |difference| add up on the card, so
    the run gains no host syncs; the largest call's inputs are kept so the
    kernels are timed at the main path's own shapes afterwards."""

    NAMES = ("refine_query", "band_update")

    def __init__(self, device):
        self.differences = {n: torch.zeros((), dtype=torch.int64, device=device)
                            for n in self.NAMES}
        self.max_abs_err = {n: torch.zeros((), dtype=torch.float64, device=device)
                            for n in self.NAMES}
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.largest = {}

    def _compare(self, name, got, want, size, keep):
        """``keep()`` gives the call's inputs, kept if it is the largest."""
        for g, w in zip(got, want):
            self.differences[name] += bit_differences(g, w)
            self.max_abs_err[name] = torch.maximum(self.max_abs_err[name],
                                                   max_abs_err(g, w))
        self.calls[name] += 1
        if size > self.largest.get(name, (0, None))[0]:
            self.largest[name] = (size, keep())

    def refine(self, pyramid, layout, u0, u1, v0, v1, height, width):
        from hive_tpu_torch.ops import refine_query as rq
        from hive_tpu_torch.ops.tsdf_sparse import pyramid_cell_bounds

        cells = pyramid_cell_bounds(layout, u0, u1, v0, v1, height, width, rq.LEVEL_BIAS)
        got = rq.refine_query_cells(pyramid, *cells)
        self._compare("refine_query", got, rq.refine_query_plain(pyramid, *cells),
                      int(u0.numel()), lambda: tuple(x.clone() for x in (pyramid, *cells)))
        return got

    def update(self, state, ids, base, scal, frames, *, block, sub):
        from hive_tpu_torch.ops import band_update as bu

        call = dict(state=state, ids=ids, base=base, scal=scal, frames=frames, block=block,
                    sub=sub)
        before = compact_call(call)
        want = tuple(x.clone() for x in before["state"])
        bu.band_update(state, ids, base, scal, frames, block=block, sub=sub)
        band_update_in_trips(want, before["ids"], base, scal, frames, block=block, sub=1)
        tsdf, weight, color = bu.gather_rows(state, ids, sub)
        got = (tsdf, weight, color.reshape(tsdf.shape[0] * 3, -1))
        # The snapshot, ids, bases, scalars and packed frames are this call's
        # own; the state is the volume's, which stays alive with them.
        self._compare("band_update", got, want, int(ids.numel()), lambda: (call, before))

    def results(self):
        """Per kernel: calls checked, bit differences, largest |difference|,
        and the times at the largest call's inputs."""
        out = {}
        for name in self.NAMES:
            differences = int(self.differences[name])
            if self.calls[name] == 0 or differences:
                raise AssertionError(f"{name} on the main path: {self.calls[name]} calls "
                                     f"checked, {differences} values differ from plain")
            inputs = self.largest[name][1]
            tag = f"{name}, main path's largest call, exact in {self.calls[name]} calls"
            if name == "refine_query":
                times = time_refine(inputs[0], inputs[1:])
                log_times(tag, times)
            else:
                times = time_band_update(*inputs, tag)
            out[name] = dict(times, calls_checked=self.calls[name],
                             max_abs_err=float(self.max_abs_err[name]))
        return out


def run_main_path(device, launches):
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.ops import band_update, refine_query, tsdf_sparse

    check = MainPathCheck(device)
    with tempfile.TemporaryDirectory(prefix="hive_smoke_") as tmp:
        dataset = os.path.join(tmp, "synthetic")
        start = time.perf_counter()
        write_hive_dataset(dataset, E2E_FRAMES, E2E_W, E2E_H)
        log(f"[e2e] wrote {E2E_FRAMES} frames of {E2E_W}x{E2E_H} in "
            f"{time.perf_counter() - start:.1f} s")

        argv = ["hive_tpu_torch", "--dataset_path", dataset, "--output_path", dataset,
                "--background_only", "--num_frames", str(E2E_FRAMES),
                "--key_frame_threshold", "1.0", "--overwrite_ok",
                "--webxr_path", os.path.join(tmp, "webxr"),
                "--log_file", os.path.join(tmp, "pipeline.log")]
        band_update.launches = refine_query.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        with mock.patch.object(sys, "argv", argv), \
                mock.patch.object(tsdf_sparse, "refine_query", check.refine), \
                mock.patch.object(tsdf_sparse, "band_update", check.update):
            runpy.run_module("hive_tpu_torch", run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches["main"] = {"band_update": band_update.launches,
                            "refine_query": refine_query.launches}

        with open(os.path.join(dataset, "profiling.json")) as f:
            profiling = json.load(f)
        scene = load_glb(os.path.join(dataset, "mesh", "bg.glb"))
        mesh = next(iter(scene.geometry.values()))
        verts, cols = mesh.vertices, mesh.vertex_colors

    if len(verts) == 0 or not np.isfinite(verts).all():
        raise AssertionError("bg.glb holds no (finite) vertices")
    corr_x = float(np.corrcoef(verts[:, 0], cols[:, 1].astype(np.float64))[0, 1])
    corr_y = float(np.corrcoef(verts[:, 1], cols[:, 2].astype(np.float64))[0, 1])
    if abs(corr_x) < 0.9 or abs(corr_y) < 0.9:
        raise AssertionError(f"bg.glb colour gradients lost: corr(x, G) {corr_x:.3f}, "
                             f"corr(y, B) {corr_y:.3f}")
    if min(launches["main"].values()) == 0:
        raise AssertionError(f"main path skipped a kernel: {launches['main']}")

    def rounded(tree):
        return {k: rounded(v) if isinstance(v, dict) else round(v, 4)
                for k, v in tree.items() if not isinstance(v, bool)}

    volume = profiling["background_volume"]
    log(f"[e2e] bg.glb {len(verts)} vertices, corr(x, G) {corr_x:.4f}, "
        f"corr(y, B) {corr_y:.4f}")
    log(f"[e2e] volume {volume['num_voxels']} voxels at {volume['voxel_size']:.5f} m, "
        f"{volume['dtype']}; {profiling['elapsed_time']['per_frame']:.4f} s/frame "
        f"(run {wall:.1f} s); {profiling['mesh_tri_count']['total']} triangles; "
        f"peak device memory {profiling['peak_vram_usage']['allocated']} B; "
        f"launches {launches['main']}; each call also ran its plain version (the band "
        f"update's on a snapshot of the frame's band rows, which raises the peak)")
    log("[e2e] profiling.json timing (s): " + json.dumps(rounded(profiling["timing"])))
    return check.results()

# ---------------------------------------------------------------------------
# The measurement entry points' kernels.
# ---------------------------------------------------------------------------

# Operations per voxel of the fused trip (csrc/fused_band.cu), each f32 or
# integer instruction-level operation counted once (a division as one):
# projection 27 (3 adds, 3 x (mul, 2 FMAs, add), the z guard, 2 x (mul, div,
# add, round, convert)); view test, clamps and window address 19; unpack 15;
# update 26 (sdf, 4 tests, dist, clamp, weights, 4 x (mul, FMA, div, select)).
FUSED_OPS_PER_VOXEL = {True: 87, False: 60}


def exact_or_raise(name, pairs):
    """Largest |difference| over (got, want) pairs, raising if any bit differs."""
    worst = 0.0
    for got, want in pairs:
        if int(bit_differences(got, want)):
            raise AssertionError(f"{name} kernel differs from its plain version")
        worst = max(worst, float(max_abs_err(got, want)))
    return worst


def check_tile_gather(device):
    from hive_tpu_torch.micro.gather import q1_inputs
    from hive_tpu_torch.ops import tile_gather as tg

    src, idx, ridx = (torch.as_tensor(x, device=device) for x in q1_inputs())
    err = exact_or_raise("tile_gather", [(tg.tile_gather(src, i, axis),
                                          tg.tile_gather_plain(src, i, axis))
                                         for axis, i in ((1, idx), (0, ridx))])
    index = idx.long()
    n = src.numel()
    # Bytes: tile, indices and output once. Operations per element: clamp
    # (2), row/column split (2), address (2).
    bound_ms, bound_by = bound(n * 12, n * 6)
    times = dict(
        ms=device_time_ms(lambda: tg.tile_gather(src, idx, 1), reps=200),
        ms_axis0=device_time_ms(lambda: tg.tile_gather(src, ridx, 0), reps=200),
        plain_ms=device_time_ms(lambda: tg.tile_gather_plain(src, idx, 1), reps=200),
        loop_ms=events_ms(lambda: tg.tile_gather(src, idx, 1), reps=200),
        library_ms=device_time_ms(lambda: torch.gather(src, 1, index), reps=200),
        library="torch.gather", bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
        shape="tile (8, 128) int32, indices (8, 128) int32, axis 1 (axis 0: ms_axis0)")
    log_times("tile_gather, gather probe's tile, exact on both axes", times)
    return times


def check_patch_gather(device):
    from hive_tpu_torch.micro import gather as mg
    from hive_tpu_torch.ops import band_sampler as bs
    from hive_tpu_torch.ops import patch_gather as pg

    img, v0, u0, vv, uu = mg.q2_inputs()
    rng = np.random.default_rng(SEED)
    # One sample in eight leaves its window by a whole window height or width.
    away = rng.random(vv.shape) < 1 / 8
    down = rng.random(vv.shape) < 0.5
    vv_out = np.where(away & down, vv + rng.choice([-mg.PH, mg.PH], vv.shape), vv)
    uu_out = np.where(away & ~down, uu + rng.choice([-mg.PW, mg.PW], uu.shape), uu)
    frame, v0, u0, vv, uu, vv_out, uu_out = (
        torch.as_tensor(x.astype(np.int32), device=device)
        for x in (img, v0, u0, vv, uu, vv_out, uu_out))
    args = (v0, u0, frame, vv_out, uu_out, mg.PH, mg.PW)
    got = pg.patch_gather(*args)
    away = torch.as_tensor(away, device=device)
    if not (torch.equal(got[away], torch.zeros_like(got[away]))
            and torch.equal(got[~away], frame[vv.long(), uu.long()][~away])):
        raise AssertionError("patch_gather's words differ from the frame's")
    err = exact_or_raise("patch_gather", [(got, pg.patch_gather_plain(*args)),
                                          (pg.patch_gather(v0, u0, frame, vv, uu, mg.PH, mg.PW),
                                           pg.patch_gather_plain(v0, u0, frame, vv, uu,
                                                                 mg.PH, mg.PW))])

    flat = (vv.long() * frame.shape[1] + uu.long()).contiguous()
    n = vv.numel()
    # Bytes: each distinct sampled word once, v0/u0 per block, vv/uu in and
    # the word out per sample. Operations per sample: two offsets, four
    # window tests, the shared-memory address and select (8).
    bound_ms, bound_by = bound(torch.unique(flat).numel() * 4 + v0.numel() * 8 + n * 12,
                               n * 8)
    times = dict(
        ms=device_time_ms(lambda: pg.patch_gather(v0, u0, frame, vv, uu, mg.PH, mg.PW)),
        plain_ms=device_time_ms(lambda: pg.patch_gather_plain(v0, u0, frame, vv, uu,
                                                              mg.PH, mg.PW), reps=20),
        loop_ms=events_ms(lambda: pg.patch_gather(v0, u0, frame, vv, uu, mg.PH, mg.PW)),
        library_ms=device_time_ms(lambda: torch.take(frame, flat)), library="torch.take",
        band_sampler_ms=device_time_ms(lambda: bs.band_sample(frame, vv, uu)),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
        shape=f"frame {tuple(frame.shape)} int32, {v0.numel()} blocks x "
              f"{n // v0.numel()} samples, {mg.PH}x{mg.PW} windows")
    log_times("patch_gather, gather probe's Q2, exact (1/8 of samples outside their "
              f"windows give 0); band_sample {times['band_sampler_ms']:.6f} ms", times)
    return times


def check_fused_band(device):
    from hive_tpu_torch.micro import fused_band as mf
    from hive_tpu_torch.ops import fused_band as fb

    s = mf.setup(device)
    st, sw, sc = s["state"]
    ids, frame = s["ids"], s["frame"]
    valid = (ids < mf.NBS).to(torch.int32)
    rid = torch.clamp(ids, max=mf.NBS - 1)
    scal = torch.cat([s["obs_weight"].reshape(1), s["R"].reshape(-1), s["t"].reshape(-1)])
    iota = s["iota"]
    cz, uu, vv = mf.project(s["origins"], s["R"], s["t"], iota)
    options = dict(intr=mf.INTR, trunc=mf.TRUNC, window=(mf.PH, mf.PW))

    def rows():
        return st[rid], sw[rid], sc[rid]

    def call(fn, pik, state):
        coords = iota if pik else (vv, uu, cz)
        return fn(s["win_v0"], s["win_u0"], valid, scal, s["origins"], frame, coords, *state,
                  project_in_kernel=pik, **options)

    pairs = []
    for pik in (True, False):
        pairs += zip(call(fb.fused_band, pik, rows()), call(fb.fused_band_plain, pik, rows()))
    err = exact_or_raise("fused_band", pairs)

    # Bytes: each distinct frame word the trip reads (at its window-clamped
    # pixel) once, 40 B of row state per voxel in and out, the row's window
    # origin, valid flag and block origin, the 13 scalars, and the offsets
    # (full) or v, u, cam_z per voxel (half-fused).
    height, width = frame.shape
    pixel = torch.arange(height * width, device=device, dtype=torch.int32).view(height, width)
    words = torch.unique(fb.window_sample(pixel, s["win_v0"], s["win_u0"], vv, uu,
                                          mf.PH, mf.PW)).numel()
    k, n = ids.numel(), vv.numel()
    common = words * 4 + n * 40 + k * (12 + 12) + 13 * 4

    def timed(pik):
        state_k, state_p = rows(), rows()
        return (device_time_ms(lambda: call(fb.fused_band, pik, state_k)),
                device_time_ms(lambda: call(fb.fused_band_plain, pik, state_p), reps=20),
                events_ms(lambda: call(fb.fused_band, pik, state_k)),
                bound(common + (iota.numel() * 4 if pik else n * 12),
                      n * FUSED_OPS_PER_VOXEL[pik]))

    ms, plain_ms, loop_ms, (bound_ms, bound_by) = timed(True)
    half_ms, half_plain_ms, half_loop_ms, (half_bound_ms, _) = timed(False)
    times = dict(ms=ms, plain_ms=plain_ms, loop_ms=loop_ms, library_ms=None,
                 bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                 half_fused=dict(ms=half_ms, plain_ms=half_plain_ms, loop_ms=half_loop_ms,
                                 bound_ms=half_bound_ms),
                 shape=f"{k} rows x {mf.BV} voxels, frame {tuple(frame.shape)} int32, "
                       f"{mf.PH}x{mf.PW} windows, projection in the kernel")
    log_times("fused_band, fused-trip probe's trip, both variants exact", times)
    log(f"[fused_band] half-fused: kernel={half_ms:.6f} ms plain={half_plain_ms:.6f} ms "
        f"(profiler); launch loop {half_loop_ms:.6f} ms/call; bound={half_bound_ms:.7f} ms")
    return times


def run_entry_points(device, launches):
    """Both measurement entry points, each with its kernels' launch counts
    reset just before and read just after its run."""
    from hive_tpu_torch.micro import fused_band as mf
    from hive_tpu_torch.micro import gather as mg
    from hive_tpu_torch.ops import band_sampler, fused_band, patch_gather, tile_gather

    tile_gather.launches = patch_gather.launches = band_sampler.launches = 0
    torch.cuda.synchronize()
    gather = mg.run(device)
    torch.cuda.synchronize()
    launches["micro.gather"] = {"tile_gather": tile_gather.launches,
                                "patch_gather": patch_gather.launches,
                                "band_sampler": band_sampler.launches}

    fused_band.launches = band_sampler.launches = 0
    torch.cuda.synchronize()
    fused = mf.run(device)
    torch.cuda.synchronize()
    launches["micro.fused_band"] = {"fused_band": fused_band.launches,
                                    "band_sampler": band_sampler.launches}

    for entry, result in (("micro.gather", gather), ("micro.fused_band", fused)):
        if not result["ok"]:
            raise AssertionError(f"{entry} found a wrong result: {result}")
    if fused["fits"] != mf.K:
        raise AssertionError(f"only {fused['fits']}/{mf.K} rows fit their windows")
    for entry, counts in (("micro.gather", launches["micro.gather"]),
                          ("micro.fused_band", launches["micro.fused_band"])):
        if min(counts.values()) == 0:
            raise AssertionError(f"{entry} skipped a kernel: {counts}")
    log(f"[entry points] launches {launches['micro.gather']} (micro.gather), "
        f"{launches['micro.fused_band']} (micro.fused_band); {timing.retakes} profiler "
        f"traces retaken so far in this process")
    return {"micro.gather": gather, "micro.fused_band": fused}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hive_tpu_torch import get_device
    from hive_tpu_torch.ops import cuda_build

    device = get_device()
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")

    start = time.perf_counter()
    cuda_build.build(["refine_query", "band_update", "band_sampler", "tile_gather",
                      "patch_gather", "fused_band"])
    log(f"[build] all six kernels in {time.perf_counter() - start:.1f} s")

    frames = bench_frames(device)
    bench = {"refine_query": check_refine(device, frames),
             "band_update": check_band_update(device, frames)}
    check_band_update_states(device)
    sampler = check_sampler(device, frames)
    launches = {}
    check_integration(device, frames, launches)
    check_sparse_vs_dense(device)
    del frames
    torch.cuda.empty_cache()
    main_path = run_main_path(device, launches)
    probes = {"band_sampler": sampler,
              "tile_gather": check_tile_gather(device),
              "patch_gather": check_patch_gather(device),
              "fused_band": check_fused_band(device)}
    entry_points = run_entry_points(device, launches)

    # Times, errors and bounds are the main path's own (its largest call);
    # "bench" holds the same at the TSDF bench shape.
    kernels = []
    for name, replaces in (("refine_query", "hive_tpu/ops/pallas_refine.py:72"),
                           ("band_update", "hive_tpu/ops/pallas_sampler.py:66")):
        result = main_path[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"hive_tpu_torch/csrc/{name}.cu", replaces=replaces,
            launches=launches["main"][name], launches_bench=launches["bench"][name],
            exact=True, calls_checked=result["calls_checked"],
            max_abs_err=result["max_abs_err"], ms=result["ms"], kernel_ms=result["ms"],
            plain_ms=result["plain_ms"], loop_ms=result["loop_ms"],
            bound_ms=result["bound_ms"], bound_by=result["bound_by"],
            library_ms=result["library_ms"], shape=result["shape"],
            **{k: result[k] for k in BAND_UPDATE_COUNTS if k in result},
            bench={k: bench[name][k] for k in ("ms", "plain_ms", "library_ms", "loop_ms",
                                               "bound_ms", "shape", *BAND_UPDATE_COUNTS)
                   if k in bench[name]}))
    # The measurement entry points' kernels: launches are the entry points'
    # runs, times and errors those of the probe phases at their shapes (the
    # band sampler's at the bench shape's 128-row trip, the production
    # trip's width).
    entry_results = {"band_sampler": entry_points["micro.fused_band"]["q3"],
                     "tile_gather": entry_points["micro.gather"]["q1"],
                     "patch_gather": entry_points["micro.gather"]["q2"],
                     "fused_band": entry_points["micro.fused_band"]["q3"]}
    for name, entries, replaces in (
            ("band_sampler", ("micro.gather", "micro.fused_band"),
             "hive_tpu/ops/pallas_sampler.py:66"),
            ("tile_gather", ("micro.gather",), "scripts/micro_pallas_gather.py:72"),
            ("patch_gather", ("micro.gather",), "scripts/micro_pallas_gather.py:113"),
            ("fused_band", ("micro.fused_band",), "scripts/micro_pallas_fused_band.py:134")):
        kernels.append(dict(
            name=name, route="cuda", source=f"hive_tpu_torch/csrc/{name}.cu",
            replaces=replaces, entry_point=", ".join(f"hive_tpu_torch.{e}" for e in entries),
            launches=sum(launches[e][name] for e in entries), exact=True,
            **{k: v for k, v in probes[name].items() if k != "library"},
            entry_point_result=entry_results[name]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
