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
from hive_tpu_torch.ops import (band_sampler, band_update, fused_band, patch_gather, refine_query,
                                tile_gather)

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


def test_imports_with_jax_and_hive_tpu_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['hive_tpu'] = None\n"
            "import importlib\n"
            f"for name in {_port_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib')) or m == 'hive_tpu'\n"
            "               or m.startswith('hive_tpu.') for m in sys.modules\n"
            "               if sys.modules[m] is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_import_nothing_of_jax_or_hive_tpu():
    banned = re.compile(r"^\s*(import\s+(jax|jaxlib|hive_tpu)\b(?!_torch)"
                        r"|from\s+(jax|jaxlib|hive_tpu)\b(?!_torch))", re.MULTILINE)
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


def test_entry_points_default_to_the_card(monkeypatch):
    from hive_tpu_torch.ops.tsdf import TSDFVolume
    from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bounds = np.array([[0, 1], [0, 1], [0, 1]], np.float32)
    for cls in (SparseTSDFVolume, TSDFVolume):
        with pytest.raises(RuntimeError):
            cls(bounds, voxel_size=0.25)
        assert cls(bounds, voxel_size=0.25, device="cpu").state.tsdf.device.type == "cpu"


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
    band_sampler.launches = refine_query.launches = 0
    tile_gather.launches = patch_gather.launches = fused_band.launches = 0
    frame = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    v = torch.tensor([[0, 2, 5]], dtype=torch.int32)
    u = torch.tensor([[3, -1, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(band_sampler.band_sample(frame, v, u).numpy(),
                                  [[3, 8, 9]])

    from hive_tpu_torch.ops.tsdf_sparse import build_flat_pyramid, pyramid_layout

    depth = torch.full((8, 8), 2.0)
    pyramid = build_flat_pyramid(depth, 8, 8, packed_u16=True)
    box = torch.tensor([1.0])
    dmin, dmax, valid = refine_query.refine_query(pyramid, pyramid_layout(8, 8),
                                                  box, box + 2, box, box + 2, 8, 8)
    assert float(dmin) == pytest.approx(2.0) and float(dmax) == pytest.approx(2.0)
    assert bool(valid)

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
    assert (band_sampler.launches, refine_query.launches, tile_gather.launches,
            patch_gather.launches, fused_band.launches) == (0, 0, 0, 0, 0)


KERNEL_MODULES = (band_sampler, band_update, fused_band, patch_gather, refine_query, tile_gather)


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
    with pytest.raises(ValueError, match="unsupported device"):
        refine_query.refine_query_cells(meta, *[meta[:1]] * 6)

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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["refine_query", "band_sampler", "band_update",
                                    "tile_gather", "patch_gather", "fused_band"])
def test_kernel_matches_plain_on_card(kernel):
    """On the card each kernel equals its plain version bit for bit (the
    same check chip_smoke.py makes at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    from hive_tpu_torch.ops.tsdf_sparse import build_flat_pyramid, pyramid_cell_bounds, pyramid_layout

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
    depth = torch.as_tensor(rng.uniform(0.5, 4.0, (480, 640)), dtype=torch.float32, device=dev)
    depth[torch.as_tensor(rng.random((480, 640)) < 0.1, device=dev)] = 0.0
    pyramid = build_flat_pyramid(depth, 480, 640, packed_u16=True)
    u0 = torch.as_tensor(rng.uniform(-20, 640, 4096), dtype=torch.float32, device=dev)
    v0 = torch.as_tensor(rng.uniform(-20, 480, 4096), dtype=torch.float32, device=dev)
    ext = torch.as_tensor(rng.uniform(1, 60, 4096), dtype=torch.float32, device=dev)
    cells = pyramid_cell_bounds(pyramid_layout(480, 640), u0, u0 + ext, v0, v0 + ext,
                                480, 640, refine_query.LEVEL_BIAS)
    for got, want in zip(refine_query.refine_query_cells(pyramid, *cells),
                         refine_query.refine_query_plain(pyramid, *cells)):
        assert torch.equal(got, want)


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
