"""hive_tpu_torch.micro.gather and its two kernels' contracts, held on the CPU
against the Pallas kernels of scripts/micro_pallas_gather.py run in the
Pallas interpreter: the plain versions (what the CUDA kernels are compared
with on the card) must equal them bit for bit."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hive_tpu_torch.micro import gather as micro
from hive_tpu_torch.ops.patch_gather import patch_gather
from hive_tpu_torch.ops.tile_gather import tile_gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    """The script, imported by path, with 8 blocks per patch-gather call."""
    spec = importlib.util.spec_from_file_location(
        "micro_pallas_gather", os.path.join(REPO, "scripts", "micro_pallas_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.NB = 8
    return mod


@pytest.mark.parametrize("axis,kernel", [(1, "q1_lane_kernel"), (0, "q1_sublane_kernel")])
@pytest.mark.parametrize("seed", [0, 7])
def test_tile_gather_plain_equals_pallas_probe(script, axis, kernel, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 128 if axis == 1 else 8, (8, 128)).astype(np.int32)
    idx[0, :2] = [0, idx.max()]
    want = pl.pallas_call(getattr(script, kernel),
                          out_shape=jax.ShapeDtypeStruct((8, 128), jnp.uint32),
                          interpret=True)(jnp.asarray(src), jnp.asarray(idx))
    got = tile_gather(torch.as_tensor(src.view(np.int32)), torch.as_tensor(idx), axis)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("use_sublane", [True, False])
def test_patch_gather_plain_equals_pallas(script, use_sublane):
    """Coordinates up to 4 rows and 16 columns outside their block's window
    give 0 on both sides; the last block's window touches the frame's edge."""
    H, W, PH, PW, NB, BV = (script.H, script.W, script.PH, script.PW, script.NB,
                            script.BV)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64).astype(np.uint32)
    v0 = rng.integers(0, H - PH + 1, NB).astype(np.int32)
    u0 = (rng.integers(0, (W - PW) // 128 + 1, NB) * 128).astype(np.int32)
    v0[-1], u0[-1] = H - PH, W - PW
    vv = (v0[:, None] + rng.integers(-4, PH + 4, (NB, BV))).astype(np.int32)
    uu = (u0[:, None] + rng.integers(-16, PW + 16, (NB, BV))).astype(np.int32)
    outside = ((vv < v0[:, None]) | (vv >= v0[:, None] + PH)
               | (uu < u0[:, None]) | (uu >= u0[:, None] + PW))
    assert 0.2 < outside.mean() < 0.5
    shape = (NB, BV // 128, 128)

    want = np.asarray(script.make_pallas_fn(use_sublane=use_sublane, interpret=True)(
        jnp.asarray(v0), jnp.asarray(u0), jnp.asarray(img),
        jnp.asarray(vv.reshape(shape)), jnp.asarray(uu.reshape(shape))))
    got = patch_gather(torch.as_tensor(v0), torch.as_tensor(u0),
                       torch.as_tensor(img.view(np.int32)),
                       torch.as_tensor(vv.reshape(shape)), torch.as_tensor(uu.reshape(shape)),
                       PH, PW).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    flat = got.reshape(NB, BV)
    np.testing.assert_array_equal(flat[outside], 0)
    np.testing.assert_array_equal(flat[~outside], img[vv[~outside], uu[~outside]])


def test_patch_gather_window_clamps_like_a_dynamic_slice(script):
    """A window origin past the frame's edge: the window is read where
    lax.dynamic_slice puts it, offsets come from the origin as given."""
    H, W, PH, PW, BV = script.H, script.W, script.PH, script.PW, script.BV
    rng = np.random.default_rng(6)
    img = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64).astype(np.uint32)
    v0 = np.array([H - PH + 5] * script.NB, np.int32)
    u0 = np.array([W - PW] * script.NB, np.int32)
    vv = (v0[:, None] + rng.integers(0, PH, (script.NB, BV))).astype(np.int32)
    uu = (u0[:, None] + rng.integers(0, PW, (script.NB, BV))).astype(np.int32)
    shape = (script.NB, BV // 128, 128)
    want = np.asarray(script.make_pallas_fn(interpret=True)(
        jnp.asarray(v0), jnp.asarray(u0), jnp.asarray(img),
        jnp.asarray(vv.reshape(shape)), jnp.asarray(uu.reshape(shape))))
    got = patch_gather(*(torch.as_tensor(x) for x in (v0, u0, img.view(np.int32),
                                                      vv.reshape(shape), uu.reshape(shape))),
                       PH, PW)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_probe_inputs_are_the_scripts():
    """The entry point draws the script's inputs (seed 0, same order)."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 2 ** 31, (8, 128)).astype(np.uint32)
    idx = rng.integers(0, 128, (8, 128))
    ridx = rng.integers(0, 8, (8, 128))
    for got, want in zip(micro.q1_inputs(), (src.view(np.int32), idx, ridx)):
        np.testing.assert_array_equal(got, want)
    img, v0, u0, vv, uu = micro.q2_inputs()
    assert img.shape == (micro.H, micro.W) and vv.shape == (micro.NB, micro.BV // 128, 128)
    assert ((vv >= v0[:, None, None]) & (vv < v0[:, None, None] + micro.PH)).all()
    assert ((uu >= u0[:, None, None]) & (uu < u0[:, None, None] + micro.PW)).all()
    assert (u0 % 128 == 0).all()


def test_entry_point_on_cpu_checks_correctness_only(capsys):
    assert micro.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK exact") == 2 and "values exact" in out
    assert "correctness only" in out and "ns/sample" not in out


def test_entry_point_needs_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        micro.main([])
