"""A fused band trip on the card: the port of
``scripts/micro_pallas_fused_band.py``.

    python -m hive_tpu_torch.micro.fused_band [--device cpu]

The JAX package's sparse integrator (and the port's on the CPU) runs the
band pass in trips of K rows: row gather, projection, frame sampling,
unpack, TSDF / weight / colour update, row scatter, each a torch operation
or a small kernel. The fused trip (``ops/fused_band.py``) does everything
between gather and scatter in one launch. (On the card the port's
integrator updates a frame's whole band in one launch of its own,
``ops/band_update.py``.)

Q1  Both fused variants run: the full one projects in the kernel, the
    half-fused one takes torch's coordinates.
Q2  Each gives the production trip's state (torch projection, the port's
    band sampler, torch update) bit for bit on every row whose footprint
    fits its 64 x 256 window; the take trip (``torch.take`` in place of the
    sampler) gives it on every row.
Q3  Fused vs production vs take, LOOPS loops of TRIPS trips x REPS frames
    each into a state of NBS rows: the three final states must agree on the
    rows that fit. On the card, each loop is also timed on a state of its
    own: device time per trip (profiler), launch-loop time per trip (CUDA
    events, host included) and device operations per trip.

It runs on ``cuda:0`` unless ``--device cpu`` is passed; on the CPU the
wrappers take their plain versions and it prints correctness only. It exits
non-zero when a result is wrong.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.micro.gather import describe
from hive_tpu_torch.micro.timing import device_profile, events_ms
from hive_tpu_torch.ops import fused_band as fb
from hive_tpu_torch.ops.band_sampler import band_sample

H, W = 480, 640
PH, PW = 64, 256      # window (the production sampler's)
BV = 512              # voxels per (8, 8, 8) block
G = BV // 128
K = 128               # rows per trip (the production chunk)
DUMMIES = 16          # dummy rows (id == NBS) per trip
TRIPS = 8             # trips per timed loop
NBS = 16384           # state rows (+1 spare row, which dummy ids name)
TRUNC = 0.08
VOXEL = 0.0156
REPS = 4              # frames per timed loop
LOOPS = 5             # timed loops per trip kind (after one warm-up loop)

FX, FY, CX, CY = 580.0, 580.0, 319.5, 239.5
INTR = (FX, FY, CX, CY)

# Flat in-block voxel index i -> (ix, iy, iz) offsets, z-major like the
# integrator (i = iz*Bx*By + ix*By + iy with Bx=By=Bz=8).
_flat = np.arange(BV)
IOTA = np.stack([((_flat // 8) % 8).astype(np.float32),
                 (_flat % 8).astype(np.float32),
                 (_flat // 64).astype(np.float32)]) * VOXEL  # (3, BV)


# ---------------------------------------------------------- shared stages
def project(origins, R, t, iota):
    """(cam_z, u, v) of every voxel of each row, (K, BV); ``iota`` is
    ``IOTA`` on the rows' device."""
    return fb.project(origins, R, t, iota, INTR)


unpack_words = fb.unpack_words


def update_math(t_old, w_old, c_old, depth, rgb, cz, in_view, valid_row, obs_weight):
    return fb.update_math(t_old, w_old, c_old, depth, rgb, cz, in_view, valid_row,
                          obs_weight, TRUNC)


# ------------------------------------------------------------------ trips
def scatter_rows(state, ids, valid, rows):
    """Write the trip's rows back to ``state`` at their ids, skipping dummy
    rows: a dummy's id names the spare last row, which gets its own value
    back, so no sync is needed to drop it."""
    spare = state[0].shape[0] - 1
    sid = torch.where(valid, ids, spare).long()
    for s, r in zip(state, rows):
        s.index_copy_(0, sid, torch.where(valid[:, None], r, s[spare]))


def production_trip(state, ids, origins, R, t, iota, frame, obs_weight, take=False):
    """The production trip (the script's ``xla_trip``): row gather, torch
    projection, the band sampler (``take``: ``torch.take``), torch unpack and
    update, row scatter. Updates ``state`` (tsdf, weight, colour) in place."""
    st, sw, sc = state
    nrows = st.shape[0] - 1
    k = ids.shape[0]
    valid = ids < nrows
    rid = torch.clamp(ids, max=nrows - 1)

    t_old, w_old = st[rid], sw[rid]
    c_old = sc[rid].view(k, 3, BV).unbind(1)

    cz, uu, vv = project(origins, R, t, iota)
    in_view = (cz > fb.MIN_Z) & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
    vc = torch.clamp(vv, 0, H - 1)
    uc = torch.clamp(uu, 0, W - 1)
    if take:
        w = torch.take(frame, vc.long() * W + uc)
    else:
        w = band_sample(frame, vc, uc)
    depth, r, g, b = unpack_words(w)
    t_new, w_new, c_new = update_math(t_old, w_old, c_old, depth, (r, g, b), cz, in_view,
                                      valid[:, None], obs_weight)
    scatter_rows(state, ids, valid, (t_new, w_new, torch.stack(c_new, 1).view(k, 3 * BV)))
    return state


def fused_trip(project_in_kernel, state, ids, origins, R, t, iota, frame, obs_weight,
               win_v0, win_u0):
    """Row gather (torch) -> the fused kernel -> row scatter (torch)."""
    st, sw, sc = state
    nrows = st.shape[0] - 1
    valid = ids < nrows
    rid = torch.clamp(ids, max=nrows - 1)

    scal = torch.cat([obs_weight.reshape(1), R.reshape(-1), t.reshape(-1)])
    if project_in_kernel:
        coords = iota
    else:  # half-fused: ship the coordinates
        cz, uu, vv = project(origins, R, t, iota)
        coords = (vv, uu, cz)
    rows = fb.fused_band(win_v0, win_u0, valid.to(torch.int32), scal, origins, frame, coords,
                         st[rid], sw[rid], sc[rid], project_in_kernel=project_in_kernel,
                         intr=INTR, trunc=TRUNC, window=(PH, PW))
    scatter_rows(state, ids, valid, rows)
    return state


# ------------------------------------------------------------------ setup
def setup(device: torch.device) -> dict:
    """The script's draws (seed 0): frame, state, camera, one trip's ids and
    block origins, the window fit, and TRIPS more trips of ids for Q3."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64).astype(np.uint32)
    nrows = NBS + 1
    st = rng.normal(size=(nrows, BV)).astype(np.float32)
    sw = rng.uniform(0, 20, (nrows, BV)).astype(np.float32)
    sc = rng.uniform(0, 255, (nrows, 3 * BV)).astype(np.float32)

    # Camera: identity-ish rotation with a small tilt; block origins mostly
    # 1.5-3.5 m in front of it, a few behind it.
    theta = 0.05
    R = np.array([[np.cos(theta), 0, np.sin(theta)],
                  [0, 1, 0],
                  [-np.sin(theta), 0, np.cos(theta)]], np.float32)
    t = np.array([0.01, -0.02, 0.05], np.float32)

    def trip_ids():
        return np.concatenate([rng.choice(NBS, K - DUMMIES, replace=False).astype(np.int32),
                               np.full(DUMMIES, NBS, np.int32)])

    ids = trip_ids()
    origins = np.stack([rng.uniform(-0.8, 0.8, K),
                        rng.uniform(-0.6, 0.6, K),
                        rng.uniform(1.5, 3.5, K)], axis=-1).astype(np.float32)
    origins[rng.random(K) < 0.03, 2] = -0.5
    ids_t = np.stack([trip_ids() for _ in range(TRIPS)])

    def dev(x):
        return torch.as_tensor(x, device=device)

    # Window origins from each row's projected footprint (the integrator's
    # refine fit, on the host for the experiment).
    iota = dev(IOTA)
    _, uu, vv = (x.cpu().numpy() for x in project(dev(origins), dev(R), dev(t), iota))
    v0 = np.clip((vv.min(axis=1) - 1) // 8 * 8, 0, H - PH).astype(np.int32)
    u0 = np.clip((uu.min(axis=1) - 1) // 128 * 128, 0, W - PW).astype(np.int32)
    fits = ((np.clip(vv, 0, H - 1).max(axis=1) <= v0 + PH - 1)
            & (np.clip(uu, 0, W - 1).max(axis=1) <= u0 + PW - 1))
    return dict(frame=dev(img.view(np.int32)), state=(dev(st), dev(sw), dev(sc)),
                R=dev(R), t=dev(t), iota=iota, ids=dev(ids), origins=dev(origins),
                win_v0=dev(v0), win_u0=dev(u0), fits=fits, ids_t=dev(ids_t),
                obs_weight=torch.tensor(1.0, device=device))


def clone(state):
    return tuple(s.clone() for s in state)


def unfit_rows(ids, fits):
    """State rows written by a trip position whose footprint does not fit its
    window (dummy ids excluded)."""
    ids = ids.reshape(-1, K)[:, torch.as_tensor(~fits, device=ids.device)].reshape(-1)
    return torch.unique(ids[ids < NBS])


def differing_rows(a, b, skip):
    """How many state rows differ in their bits between states ``a`` and ``b``
    outside the rows ``skip``."""
    keep = torch.ones(NBS, dtype=torch.bool, device=a[0].device)
    keep[skip] = False
    bad = torch.zeros(NBS, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        bad |= (x[:NBS].view(torch.int32) != y[:NBS].view(torch.int32)).any(dim=1)
    return int((bad & keep).sum())


# ------------------------------------------------------------------ phases
def check(s: dict) -> dict:
    """Q1 and Q2 on one trip."""
    common = (s["ids"], s["origins"], s["R"], s["t"], s["iota"], s["frame"], s["obs_weight"])
    ref = production_trip(clone(s["state"]), *common)
    take = production_trip(clone(s["state"]), *common, take=True)
    skip = unfit_rows(s["ids"], s["fits"])
    result = {"take_rows_differing": differing_rows(take, ref, skip[:0])}
    print(f"Q2 take trip vs production trip: {result['take_rows_differing']} rows differ "
          f"(of {NBS})")
    for name, pik in (("full-fused", True), ("half-fused", False)):
        out = fused_trip(pik, clone(s["state"]), *common, s["win_v0"], s["win_u0"])
        print(f"Q1 {name}: ran ({'kernel' if out[0].is_cuda else 'plain version, CPU'})")
        result[name] = differing_rows(out, ref, skip)
        print(f"Q2 {name}: {result[name]} rows differ from the production trip outside "
              f"the {skip.numel()} rows of unfitting footprints")
    return result


def q3(s: dict, timed: bool) -> dict:
    """Fused vs production vs take: per trip (``timed``, on the card), device
    ms, launch-loop ms and device operations; and the three states after
    LOOPS loops each from the same start, compared."""
    frames = [s["frame"] ^ r for r in range(REPS)]
    common = (s["origins"], s["R"], s["t"], s["iota"])
    trips = {
        "fused": lambda st, ids, f: fused_trip(True, st, ids, *common, f, s["obs_weight"],
                                               s["win_v0"], s["win_u0"]),
        "production": lambda st, ids, f: production_trip(st, ids, *common, f, s["obs_weight"]),
        "take": lambda st, ids, f: production_trip(st, ids, *common, f, s["obs_weight"],
                                                   take=True),
    }

    def loop(trip, state):
        for f in frames:
            for ids in s["ids_t"]:
                trip(state, ids, f)

    n_trips = TRIPS * REPS
    result, finals = {}, {}
    for name, trip in trips.items():
        if timed:
            # On a state of its own: the profiler may take its trace again,
            # so the number of loops timed is not fixed.
            state = clone(s["state"])
            loop_ms = events_ms(lambda: loop(trip, state), reps=LOOPS, warmup=1)
            device_ms, ops = device_profile(lambda: loop(trip, state), reps=1, warmup=0)
            result[name] = {"device_ms_per_trip": device_ms / n_trips,
                            "loop_ms_per_trip": loop_ms / n_trips,
                            "device_ops_per_trip": ops / n_trips}
            print(f"Q3 {name:10s}: {device_ms / n_trips:8.5f} ms device/trip, "
                  f"{loop_ms / n_trips:8.5f} ms launch loop/trip, {ops / n_trips:5.1f} device "
                  f"ops/trip ({K * BV * n_trips / (loop_ms * 1e-3) / 1e9:.3f} G "
                  f"voxel-updates/s in the loop)")
        finals[name] = clone(s["state"])
        for _ in range(LOOPS):
            loop(trip, finals[name])
    skip = unfit_rows(s["ids_t"], s["fits"])
    result["rows_differing"] = {name: differing_rows(finals[name], finals["production"], skip)
                                for name in ("fused", "take")}
    result["rows_compared"] = NBS - skip.numel()
    print(f"Q3 final states vs production after {LOOPS} loops of {n_trips} trips: "
          f"{result['rows_differing']} rows differ of {result['rows_compared']} compared")
    return result


def run(device: torch.device) -> dict:
    s = setup(device)
    print(f"rows fitting the {PH}x{PW} window: {int(s['fits'].sum())}/{K}")
    result = {"fits": int(s["fits"].sum()), "check": check(s)}
    timed = device.type == "cuda"
    if not timed:
        print("(correctness only: timing needs the card)")
    result["q3"] = q3(s, timed)
    result["ok"] = (all(v == 0 for v in result["check"].values())
                    and not any(result["q3"]["rows_differing"].values()))
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (correctness only)")
    args = parser.parse_args(argv)
    device = get_device(args.device)
    print(f"device: {describe(device)}")
    return 0 if run(device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
