"""hive_tpu_torch.micro.fused_band and the fused band-trip kernel's contract,
held on the CPU against scripts/micro_pallas_fused_band.py: the plain
version (what the CUDA kernel is compared with on the card) must equal the
Pallas kernel, run in the Pallas interpreter at K = 8 rows, bit for bit in
both variants, and the port's trips must equal the script's XLA trip.

Exact float parity rests on rounding like XLA:CPU: the projection's two
mul-adds per row and the two running means are FMAs (``torch.addcmul``),
and ``sdf / TRUNC`` is a multiply by the f32 reciprocal."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hive_tpu_torch.micro import fused_band as micro
from hive_tpu_torch.ops.fused_band import fused_band

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 8


@pytest.fixture(scope="module")
def script():
    """The script, imported by path, with K = 8 rows per trip."""
    spec = importlib.util.spec_from_file_location(
        "micro_pallas_fused_band",
        os.path.join(REPO, "scripts", "micro_pallas_fused_band.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.K = K
    return mod


@pytest.fixture(scope="module")
def trip(script):
    """One K-row trip: the script's camera with a drawn tilt, row 0 behind
    the camera, row 2's window moved 8 rows down (its top lanes fall outside
    it and read the window's edge), the last row a dummy (valid 0), and
    frame depths near each voxel's camera depth so that most voxels update
    inside the truncation band."""
    rng = np.random.default_rng(11)
    H, W, PH, PW, BV = script.H, script.W, script.PH, script.PW, script.BV
    theta = rng.uniform(-0.1, 0.1)
    R = np.array([[np.cos(theta), 0, np.sin(theta)], [0, 1, 0],
                  [-np.sin(theta), 0, np.cos(theta)]], np.float32)
    t = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    origins = np.stack([rng.uniform(-0.8, 0.8, K), rng.uniform(-0.6, 0.6, K),
                        rng.uniform(1.5, 3.5, K)], axis=-1).astype(np.float32)
    origins[0, 2] = -0.5

    cz, uu, vv = (np.asarray(x) for x in jax.jit(script.project)(
        jnp.asarray(origins), jnp.asarray(R), jnp.asarray(t)))
    v0 = np.clip((vv.min(axis=1) - 1) // 8 * 8, 0, H - PH).astype(np.int32)
    u0 = np.clip((uu.min(axis=1) - 1) // 128 * 128, 0, W - PW).astype(np.int32)
    v0[2] += 8

    img = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64).astype(np.uint32)
    vc, uc = np.clip(vv, 0, H - 1), np.clip(uu, 0, W - 1)
    depth_mm = np.clip(np.round((cz + rng.uniform(-0.1, 0.1, cz.shape)) * 1000), 0, 65535)
    img[vc, uc] = (img[vc, uc] & np.uint32(0xFFFF0000)) | depth_mm.astype(np.uint32)

    valid = np.ones(K, np.int32)
    valid[-1] = 0
    return dict(img=img, R=R, t=t, origins=origins, cz=cz, uu=uu, vv=vv, v0=v0, u0=u0,
                valid=valid, scal=np.concatenate([[1.0], R.reshape(-1), t]).astype(np.float32),
                st=rng.normal(size=(K, BV)).astype(np.float32),
                sw=rng.uniform(0, 20, (K, BV)).astype(np.float32),
                sc=rng.uniform(0, 255, (K, 3 * BV)).astype(np.float32))


def bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("project_in_kernel", [True, False])
def test_fused_plain_equals_pallas_kernel(script, trip, project_in_kernel):
    coords = ([script.IOTA.reshape(3, script.G, 128)] if project_in_kernel
              else [trip["vv"], trip["uu"], trip["cz"]])
    args = [trip["v0"], trip["u0"], trip["valid"], trip["scal"], trip["origins"],
            trip["img"], *coords, trip["st"], trip["sw"], trip["sc"]]
    want = jax.jit(script.make_fused(project_in_kernel=project_in_kernel, interpret=True))(
        *(jnp.asarray(a) for a in args))

    def T(x):
        return torch.as_tensor(np.array(x))

    got = fused_band(T(trip["v0"]), T(trip["u0"]), T(trip["valid"]), T(trip["scal"]),
                     T(trip["origins"]), T(trip["img"].view(np.int32)),
                     T(script.IOTA) if project_in_kernel
                     else (T(trip["vv"]), T(trip["uu"]), T(trip["cz"])),
                     T(trip["st"]), T(trip["sw"]), T(trip["sc"]),
                     project_in_kernel=project_in_kernel,
                     intr=(script.FX, script.FY, script.CX, script.CY), trunc=script.TRUNC,
                     window=(script.PH, script.PW))
    for name, g, w in zip(("tsdf", "weight", "color"), got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w), err_msg=name)

    # The trip exercised what it should: most voxels of the rows in front of
    # the camera updated inside the band; the row behind the camera and the
    # dummy row kept their tsdf; row 2 read its window's edge.
    tsdf = got[0].numpy()
    changed = tsdf != trip["st"]
    assert not changed[0].any() and not changed[-1].any()
    assert changed[1:-1].mean() > 0.5
    assert (np.abs(tsdf[changed]) < 1.0).mean() > 0.5
    assert (np.clip(trip["vv"][2], 0, script.H - 1) < trip["v0"][2]).any()


def test_trips_equal_the_scripts_xla_trip(script, trip):
    """The slice as a whole: the port's production trip (band sampler and
    take), its fused trips (both variants, plain versions here) and the
    script's all-XLA take trip give the same state rows, bit for bit, where
    every row's footprint fits its window."""
    nbs = 64
    rng = np.random.default_rng(12)
    state = (rng.normal(size=(nbs + 1, script.BV)).astype(np.float32),
             rng.uniform(0, 20, (nbs + 1, script.BV)).astype(np.float32),
             rng.uniform(0, 255, (nbs + 1, 3 * script.BV)).astype(np.float32))
    ids = np.concatenate([rng.choice(nbs, K - 2, replace=False),
                          [nbs, nbs]]).astype(np.int32)
    v0 = trip["v0"].copy()
    v0[2] -= 8  # every row fits its window again

    want = jax.jit(lambda st, sw, sc, *a: script.xla_trip((st, sw, sc), *a))(
        *state, ids, trip["origins"], trip["R"], trip["t"], trip["img"], np.float32(1.0))
    want = [np.asarray(w)[:nbs] for w in want]

    def T(x):
        return torch.as_tensor(np.array(x))

    common = (T(ids), T(trip["origins"]), T(trip["R"]), T(trip["t"]), T(micro.IOTA),
              T(trip["img"].view(np.int32)), torch.tensor(1.0))
    results = {"production": micro.production_trip(tuple(map(T, state)), *common),
               "take": micro.production_trip(tuple(map(T, state)), *common, take=True)}
    for name, pik in (("full-fused", True), ("half-fused", False)):
        results[name] = micro.fused_trip(pik, tuple(map(T, state)), *common, T(v0),
                                         T(trip["u0"]))
    for trip_name, got in results.items():
        for name, g, w in zip(("tsdf", "weight", "color"), got, want):
            np.testing.assert_array_equal(bits(g.numpy()[:nbs]), bits(w),
                                          err_msg=f"{trip_name} {name}")
        for g, s in zip(got, state):  # dummies leave the spare row alone
            np.testing.assert_array_equal(bits(g.numpy()[nbs]), bits(s[nbs]))
    assert (results["production"][0].numpy()[:nbs] != state[0][:nbs]).any(axis=1).sum() >= 3


def test_entry_point_on_cpu_checks_correctness_only(monkeypatch, capsys):
    monkeypatch.setattr(micro, "NBS", 512)
    monkeypatch.setattr(micro, "K", 32)
    assert micro.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rows fitting the 64x256 window" in out and "correctness only" in out
    assert out.count("0 rows differ") == 3 and "ms device/trip" not in out
    assert "Q3 final states vs production after 5 loops of 32 trips: " \
           "{'fused': 0, 'take': 0} rows differ" in out


def test_q3_states_do_not_depend_on_the_timing(monkeypatch):
    """Q3 compares states that went through LOOPS loops each, however often
    the timing ran a loop (a profiler trace that lost kernels is retaken)."""
    monkeypatch.setattr(micro, "NBS", 256)
    monkeypatch.setattr(micro, "K", 32)
    monkeypatch.setattr(micro, "TRIPS", 2)
    monkeypatch.setattr(micro, "LOOPS", 2)
    runs = iter([1, 3, 2])  # loops each trip kind's timing makes

    def device_profile(fn, reps, warmup):
        for _ in range(next(runs)):
            fn()
        return 1.0, 1.0

    monkeypatch.setattr(micro, "events_ms", lambda fn, reps, warmup: 1.0)
    monkeypatch.setattr(micro, "device_profile", device_profile)
    result = micro.q3(micro.setup(torch.device("cpu")), timed=True)
    assert result["rows_differing"] == {"fused": 0, "take": 0}
    assert result["rows_compared"] > 0 and result["fused"]["device_ms_per_trip"] == 1.0 / 8


def test_entry_point_needs_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        micro.main([])


def test_iota_is_the_scripts(script):
    np.testing.assert_array_equal(micro.IOTA, script.IOTA)
    assert micro.IOTA.dtype == np.float32
    assert (micro.H, micro.W, micro.PH, micro.PW, micro.BV, micro.TRUNC, micro.INTR) == (
        script.H, script.W, script.PH, script.PW, script.BV, script.TRUNC,
        (script.FX, script.FY, script.CX, script.CY))
