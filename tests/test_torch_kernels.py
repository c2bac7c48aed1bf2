"""The contracts of hive_tpu_torch's two kernels, held on the CPU against the
Pallas kernels they replace, run in the Pallas interpreter as hive_tpu's own
tests run them: the plain versions (what the CUDA kernels are compared with
on the card) must equal the TPU kernels bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hive_tpu.ops.pallas_refine import (padded_pyramid_rows, query_flat_pyramid_pallas,
                                        window_rows)
from hive_tpu.ops.pallas_sampler import PH, PW, build_patch_sampler
from hive_tpu.ops.tsdf_sparse import SparseTSDFVolume as JaxSparseTSDFVolume
from hive_tpu.ops.tsdf_sparse import build_flat_pyramid as jax_pyramid
from hive_tpu_torch.ops import band_sampler, refine_query
from hive_tpu_torch.ops.tsdf_sparse import (SparseTSDFVolume, build_flat_pyramid,
                                            pyramid_layout)


@pytest.mark.parametrize("height,width", [(96, 128), (120, 1280)])
def test_refine_plain_equals_pallas_kernel(height, width):
    """As tests/test_tsdf_sparse.py:673-711: the wide frame exercises the
    width-derived window of the TPU kernel."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 4.0, (height, width)).astype(np.float32)
    depth[rng.random((height, width)) < 0.1] = 0.0

    layout = pyramid_layout(height, width)
    total = int(layout[0][-1]) + int(layout[2][-1]) * int(layout[1][-1])
    rows = padded_pyramid_rows(total, window_rows(width))
    jpyr = jax_pyramid(jnp.asarray(depth), height, width)
    pyr2d = jnp.pad(jpyr, (0, rows * 128 - jpyr.shape[0])).reshape(rows, 128)

    cap = 16
    ext_u = rng.uniform(1, 40, cap).astype(np.float32)
    ext_v = ext_u * rng.uniform(0.5, 1.5, cap).astype(np.float32)
    u0 = rng.uniform(0, width - 1 - ext_u).astype(np.float32)
    v0 = rng.uniform(0, height - 1 - ext_v).astype(np.float32)
    u1, v1 = u0 + ext_u, v0 + ext_v

    want = query_flat_pyramid_pallas(pyr2d, layout, *(jnp.asarray(x) for x in (u0, u1, v0, v1)),
                                     height, width, interpret=True)
    pyramid = build_flat_pyramid(torch.as_tensor(depth), height, width)
    got = refine_query.refine_query(pyramid, layout,
                                    *(torch.as_tensor(x) for x in (u0, u1, v0, v1)),
                                    height, width)
    for name, g, w in zip(("dmin", "dmax", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_band_sampler_plain_equals_pallas_kernel():
    """In-window coordinates: the TPU sampler's contract is packed[v, u] for
    every coordinate inside the block's 64 x 256 window."""
    height, width, k, groups = 64, 256, 8, 4
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 2 ** 32, (height, width), dtype=np.uint64).astype(np.uint32)
    v = rng.integers(0, height, (k, groups, 128)).astype(np.int32)
    u = rng.integers(0, width, (k, groups, 128)).astype(np.int32)
    zeros = jnp.zeros((k,), jnp.int32)

    sampler = build_patch_sampler(height, width, k, groups, interpret=True)
    want = np.asarray(sampler(zeros, zeros, jnp.asarray(frame), jnp.asarray(v),
                              jnp.asarray(u)))
    got = band_sampler.band_sample(torch.as_tensor(frame.view(np.int32)),
                                   torch.as_tensor(v), torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    assert (PH, PW) == (height, width)


def test_integrate_equals_pallas_sampler_state():
    """As tests/test_tsdf_sparse.py:443-479: the port's integrate (plain
    sampler here, the kernel on the card) and hive_tpu's integrate through
    the interpreted Pallas sampler give the same state, bit for bit."""
    height, width = 64, 256
    k = np.array([[90.0, 0.0, (width - 1) / 2],
                  [0.0, 90.0, (height - 1) / 2],
                  [0.0, 0.0, 1.0]], np.float32)
    rng = np.random.default_rng(3)
    depths = rng.uniform(0.8, 1.8, (1, height, width)).astype(np.float32)
    colors = rng.integers(0, 255, (1, height, width, 3)).astype(np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
    poses[:, 0, 3] = [0.0123]
    bounds = np.array([[-0.5, 0.5], [-0.5, 0.5], [0.0, 1.2]], np.float32)

    ref = JaxSparseTSDFVolume(bounds, voxel_size=1.0 / 16, pallas_sampler="interpret",
                              chunk_voxels=4096)
    ref.integrate_frames(colors, depths, k, poses)
    assert next(iter(ref._integrators.values())).use_pallas

    ours = SparseTSDFVolume(bounds, voxel_size=1.0 / 16, chunk_voxels=4096, device="cpu")
    ours.integrate_frames(colors, depths, k, poses)
    assert float(ours.state.weight.sum()) > 0
    for name, got, want in zip(("tsdf", "weight", "color"), ours.state, ref.state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
