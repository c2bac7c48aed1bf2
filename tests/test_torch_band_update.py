"""The frame-wide band update (``hive_tpu_torch/ops/band_update.py``).

On the card the integrator updates a frame's whole band in one kernel
launch; on the CPU the plain version runs in trips of ``chunk`` rows. The
plain version over a frame's whole band must equal that trip loop bit for
bit (each trip computes its own rows' bases), in every state dtype, colour
mode and slab layout. The trip loop itself is held to ``hive_tpu`` by
``tests/test_torch_tsdf_sparse.py`` and ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from hive_tpu_torch.ops import band_update as bu
from hive_tpu_torch.ops import tsdf_sparse as P

H, W = 48, 64
K = np.array([[50.0, 0.0, 31.5], [0.0, 50.0, 23.5], [0.0, 0.0, 1.0]], np.float32)
BOUNDS = np.array([[-1.6, 1.6], [-1.2, 1.2], [0.0, 3.2]], np.float32)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _frames(num_frames=2, seed=0):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(0.8, 2.5, size=(num_frames, H, W)).astype(np.float32)
    depths[:, :, :5] = 0.0
    colors = rng.integers(0, 255, size=(num_frames, H, W, 3)).astype(np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 0.2, num_frames) + 0.01237
    poses[:, 1, 3] = 0.00731
    return depths, colors, poses


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _assert_same_bits(a, b):
    for name, x, y in zip(("tsdf", "weight", "color"), a, b):
        assert torch.equal(_bits(x), _bits(y)), name


def _volume(dtype, color_mode, block_size):
    # A small band capacity forces many CPU trips per frame.
    return P.SparseTSDFVolume(BOUNDS, voxel_size=0.05, dtype=DTYPES[dtype],
                              color_mode=color_mode, block_size=block_size,
                              band_capacity_fraction=0.01, device="cpu")


def _band_stage(volume, depth, color, pose, obs_weight=1.0):
    """The integrator's per-frame stages up to the band update: (integrator,
    packed frame, band mask, R, t, scalars)."""
    integ = volume._integrator(H, W, None)
    depth, color = torch.as_tensor(depth), torch.as_tensor(color)
    w2c = torch.linalg.inv(torch.as_tensor(pose))
    R, t = w2c[:3, :3], w2c[:3, 3]
    intr = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    origins = volume.block_origins_device
    sample = integ.pack_frame(depth, color)
    pyramid = P.build_flat_pyramid(depth, H, W, packed_u16=volume.color_mode == "rgb565d16")
    classes, dmin, dmax, free_ok = integ.classify_refined(origins, pyramid, R, t,
                                                          tuple(intr))
    band_flat, _, _ = integ.slab_masks(origins, classes, dmin, dmax, free_ok, R, t,
                                       torch.tensor(obs_weight))
    scal = integ.band_scalars(intr, R, torch.tensor(obs_weight))
    return integ, sample, band_flat, R, t, scal


def _clone(state):
    return P.SparseTSDFState(*(x.clone() for x in state))


@pytest.mark.parametrize("block_size", [(8, 8, 8), (8, 8, 16)], ids=["sub1", "sub2"])
@pytest.mark.parametrize("color_mode", ["rgb565d16", "rgb888"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_frame_wide_plain_equals_trip_loop(dtype, color_mode, block_size):
    depths, colors, poses = _frames()
    volume = _volume(dtype, color_mode, block_size)
    volume.integrate_frames(colors[:1], depths[:1], K, poses[:1])
    integ, sample, band_flat, R, t, scal = _band_stage(volume, depths[1], colors[1], poses[1])
    assert integ.SUB == block_size[2] // 8
    origins = volume.block_origins_device

    trips = _clone(volume.state)
    slabs = integ.to_slabs(trips)
    band_trips = integ._trips(band_flat, integ.chunk)
    assert len(band_trips) >= 2
    for ids in band_trips:
        integ.update_band(slabs, origins, ids, sample, R, t, scal)

    whole = _clone(volume.state)
    ids = torch.nonzero(band_flat).reshape(-1)
    bu.band_update_plain(integ.to_slabs(whole), ids, integ.slab_base(origins, ids, R, t),
                         scal, sample, block=integ.block, sub=integ.SUB)

    _assert_same_bits(whole, trips)
    changed = (whole.weight != volume.state.weight).sum()
    assert int(changed) > 1000


@pytest.mark.parametrize("color_mode", ["rgb565d16", "rgb888"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_zero_weight_frame_leaves_state_unchanged(dtype, color_mode):
    depths, colors, poses = _frames()
    volume = _volume(dtype, color_mode, (8, 8, 8))
    volume.integrate_frames(colors[:1], depths[:1], K, poses[:1])
    before = _clone(volume.state)
    assert float(before.weight.float().sum()) > 0

    integ, sample, band_flat, R, t, scal = _band_stage(volume, depths[1], colors[1],
                                                       poses[1], obs_weight=0.0)
    ids = torch.nonzero(band_flat).reshape(-1)
    assert ids.numel() > 0
    bu.band_update(integ.to_slabs(volume.state), ids,
                   integ.slab_base(volume.block_origins_device, ids, R, t), scal, sample,
                   block=integ.block, sub=integ.SUB)
    _assert_same_bits(volume.state, before)

    volume.integrate_frames(colors[1:], depths[1:], K, poses[1:],
                            obs_weights=np.zeros((1,), np.float32))
    _assert_same_bits(volume.state, before)


def test_trips_split_the_cpu_band_and_keep_the_card_band_whole():
    volume = _volume("f32", "rgb565d16", (8, 8, 8))
    integ = volume._integrator(H, W, None)
    mask = torch.zeros(10 * integ.chunk + 3, dtype=torch.bool)
    mask[::2] = True
    ids = torch.nonzero(mask).reshape(-1)
    cpu = integ._trips(mask, integ.chunk)
    card = integ._trips(mask, None)
    assert [len(x) for x in cpu[:-1]] == [integ.chunk] * (len(cpu) - 1)
    assert torch.equal(torch.cat(cpu), ids)
    assert len(card) == 1 and torch.equal(card[0], ids)
    assert integ._trips(torch.zeros(5, dtype=torch.bool), None) == []


def _tiny_inputs(dtype=torch.float32):
    """Two 8-voxel slab rows (blocks of 2 x 2 x 2) seen by a camera 1 m in
    front of them, and a 4 x 4 frame of 1 m depth words."""
    state = P.SparseTSDFState(torch.full((3, 8), 0.5, dtype=dtype),
                              torch.ones((3, 8), dtype=dtype),
                              torch.full((3, 24), 100.0, dtype=dtype))
    ids = torch.tensor([0, 2])
    base = torch.tensor([[-0.05, -0.05, 1.0], [0.0, 0.0, 1.02]])
    scal = bu.band_scalars(torch.tensor([2.0, 2.0, 1.5, 1.5]), torch.tensor(0.1),
                           torch.tensor(10.0), torch.tensor(1.0), torch.eye(3) * 0.05)
    frames = (torch.full((4, 4), 1000 | (31 << 16), dtype=torch.int32),)
    return state, ids, base, scal, frames


def test_band_update_wrapper_takes_the_plain_version_on_cpu():
    bu.launches = 0
    state, ids, base, scal, frames = _tiny_inputs()
    want = _clone(state)
    bu.band_update_plain(want, ids, base, scal, frames, block=(2, 2), sub=1)
    bu.band_update(state, ids, base, scal, frames, block=(2, 2), sub=1)
    _assert_same_bits(state, want)
    assert bu.launches == 0
    # Row 1 is not in ids; rows 0 and 2 saw the 1 m surface.
    assert torch.equal(state.weight[1], torch.ones(8))
    assert float(state.weight[0].min()) == 2.0
    assert float(state.color[0, :8].max()) > 100.0


def test_band_update_checks_its_inputs():
    state, ids, base, scal, frames = _tiny_inputs()
    call = dict(block=(2, 2), sub=1)
    with pytest.raises(ValueError, match="int64"):
        bu.band_update(state, ids.int(), base, scal, frames, **call)
    with pytest.raises(ValueError, match="base"):
        bu.band_update(state, ids, base[:1], scal, frames, **call)
    with pytest.raises(ValueError, match="scal"):
        bu.band_update(state, ids, base, scal[:7], frames, **call)
    with pytest.raises(ValueError, match="frames"):
        bu.band_update(state, ids, base, scal, (frames[0].float(),), **call)
    with pytest.raises(ValueError, match="frames"):
        bu.band_update(state, ids, base, scal, frames * 3, **call)
    with pytest.raises(ValueError, match="dtype"):
        bu.band_update(state._replace(weight=state.weight.double()), ids, base, scal,
                       frames, **call)
    with pytest.raises(ValueError, match="color"):
        bu.band_update(state._replace(color=state.color[:, :8]), ids, base, scal, frames,
                       **call)
    with pytest.raises(ValueError, match="do not fit"):
        bu.band_update(state, ids, base, scal, frames, block=(3, 2), sub=1)
    with pytest.raises(ValueError, match="unsupported device"):
        bu.band_update(tuple(x.to("meta") for x in state), ids.to("meta"),
                       base.to("meta"), scal.to("meta"), (frames[0].to("meta"),), **call)
