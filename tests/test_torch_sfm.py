"""The pose layer of the port (hive_tpu_torch.ops.homography, .ops.pnp,
hive_tpu_torch.sfm, FeatureExtractor and the TUM ``--estimate_pose`` path
without COLMAP) against OpenCV 5.0.0 and hive_tpu on the same inputs.

Tolerances, each with the value measured when it was set:

* homography (the port's MSAC score against ``cv2.USAC_MAGSAC``), 400
  matches with 30% outliers and 0.7 px noise: inlier sets within
  H_SYMDIFF 0.02 of cv2's count (measured: equal), H within H_TRANSFER
  0.5 px of cv2's over cv2's inliers (measured 0.018-0.066 px);
* RANSAC PnP: inlier sets within PNP_SYMDIFF 0.02 (measured: equal), the
  refined pose within PNP_ROT_DEG 1e-4 degrees and PNP_T_M 1e-6 m of
  cv2's (measured 1.2e-6 degrees, 3.4e-8 m), volumetric and planar points;
* Rodrigues both ways: 1e-12 (measured 1.1e-16), 1e-7 back from a
  rotation by pi (measured 1.1e-8);
* odometry on tests/test_sfm.py's ``make_sequence`` scene: the port's
  trajectory within SEQ_POSE_M 5 mm of hive_tpu's (measured 1.2 mm: FLANN
  and the exact k-NN keep slightly different matches) and both within
  SEQ_ATE 0.05 m of the ground truth (test_sfm.py's own bound; measured
  0.0119 and 0.0122);
* ``FeatureExtractor._match_pair`` on the same two frames: the inlier count
  within MATCH_COUNT_RATIO 0.1 of hive_tpu's (measured: 23 and 23), and
  MATCH_SHARE 0.9 of hive_tpu's inlier points among the port's (measured
  1.0);
* the TUM conversion with ``--estimate_pose`` and no COLMAP binary, 10
  frames of the textured wall at 320x240: the ATE within TUM_ATE_M 0.01 m
  of the ground truth in both packages (measured 2.40 mm and 2.14 mm) and
  the two trajectories within TUM_POSE_M 2 mm of each other (measured
  0.53 mm).
"""

import logging
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import (H_SYMDIFF, PNP_ROT_DEG, PNP_SYMDIFF, PNP_T_M, ate_m, wall_trajectory,
                        write_wall_tum)
from hive_tpu import sfm as jax_sfm
from hive_tpu.dataset_adaptors import TUMAdaptor as JaxTUMAdaptor
from hive_tpu.geometric import Trajectory as JaxTrajectory
from hive_tpu.options import COLMAPOptions as JaxCOLMAPOptions
from hive_tpu.options import InpaintingMode as JaxInpaintingMode
from hive_tpu.pose_optimisation import FeatureExtractionOptions as JaxOptions
from hive_tpu.pose_optimisation import FeatureExtractor as JaxFeatureExtractor
from hive_tpu_torch import sfm
from hive_tpu_torch.dataset_adaptors import TUMAdaptor
from hive_tpu_torch.ops import homography, pnp
from hive_tpu_torch.options import COLMAPOptions, InpaintingMode
from hive_tpu_torch.pose_optimisation import FeatureExtractionOptions, FeatureExtractor
from tests.test_sfm import HEIGHT, WIDTH, K, make_sequence

# H_SYMDIFF and the PNP_* tolerances live in chip_smoke.py, which holds the
# card to the CPU with them.
H_TRANSFER = 0.5
SEQ_POSE_M, SEQ_ATE = 5e-3, 0.05
MATCH_COUNT_RATIO, MATCH_SHARE = 0.1, 0.9
TUM_ATE_M, TUM_POSE_M = 0.01, 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these stages are thousands of small tensor ops,
    which stall behind each other's thread barriers when test workers share
    the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def noisy_matches(seed, n=400, outliers=0.3):
    rng = np.random.default_rng(seed)
    p = rng.uniform([0, 0], [320, 240], (n, 2))
    H = np.array([[1.02, 0.03, 5], [-0.02, 0.99, -3], [1e-4, -5e-5, 1]])
    q = cv2.perspectiveTransform(p[None], H)[0] + rng.normal(0, 0.7, (n, 2))
    bad = rng.random(n) < outliers
    q[bad] = rng.uniform([0, 0], [320, 240], (bad.sum(), 2))
    return p.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_homography_matches_cv2_magsac(seed):
    p, q = noisy_matches(seed)
    H_cv, mask_cv = cv2.findHomography(p, q, cv2.USAC_MAGSAC)
    H, mask = homography.find_homography(torch.from_numpy(p), torch.from_numpy(q))
    mask_cv, mask = mask_cv.ravel() > 0, mask.numpy()
    assert (mask ^ mask_cv).sum() <= H_SYMDIFF * mask_cv.sum()
    inliers = p[mask_cv].astype(np.float64)
    ours = cv2.perspectiveTransform(inliers[None], H.numpy())[0]
    theirs = cv2.perspectiveTransform(inliers[None], H_cv)[0]
    assert np.linalg.norm(ours - theirs, axis=1).max() <= H_TRANSFER


def test_homography_scores_msac_not_magsac():
    """The named difference: the port scores a hypothesis by MSAC's
    truncated quadratic, sum(min(e^2, t^2)) over the forward transfer
    errors e, where MAGSAC++ marginalises over noise scales; the inlier
    mask is the points within 3 px either way. With fewer than four
    points there is no model (OpenCV raises there)."""
    p, q = noisy_matches(3, n=60)
    H, mask = homography.find_homography(torch.from_numpy(p), torch.from_numpy(q))
    errors = homography.transfer_errors(H[None], torch.from_numpy(p).double(),
                                        torch.from_numpy(q).double())[0]
    assert torch.equal(mask, errors < homography.THRESHOLD ** 2)
    assert homography.find_homography(torch.from_numpy(p[:3]), torch.from_numpy(q[:3])) == \
        (None, None)


def projected_points(seed, planar):
    rng = np.random.default_rng(seed)
    n = 300
    if planar:
        points = np.c_[rng.uniform(-2, 2, (n, 2)), np.full(n, 3.0)]
    else:
        points = rng.uniform([-2.5, -2, 3], [2.5, 2, 4.5], (n, 3))
    rvec, tvec = rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.1
    pixels = cv2.projectPoints(points, rvec, tvec, K, None)[0][:, 0]
    pixels += rng.normal(0, 0.5, (n, 2))
    bad = rng.random(n) < 0.3
    pixels[bad] = rng.uniform([0, 0], [WIDTH, HEIGHT], (bad.sum(), 2))
    return points, pixels


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_matches_cv2(seed, planar):
    """hive_tpu's two calls (``solvePnPRansac`` then ``solvePnP`` with the
    guess on its inliers) against the port's on the same points."""
    points, pixels = projected_points(seed, planar)
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(
        points, pixels, K, None, reprojectionError=4.0, iterationsCount=200,
        flags=cv2.SOLVEPNP_ITERATIVE)
    ok, rvec, tvec = cv2.solvePnP(points[inliers[:, 0]], pixels[inliers[:, 0]], K, None,
                                  rvec=rvec, tvec=tvec, useExtrinsicGuess=True,
                                  flags=cv2.SOLVEPNP_ITERATIVE)
    P, X, KK = (torch.from_numpy(a) for a in (points, pixels, K))
    ours_ok, r, t, ours = pnp.solve_pnp_ransac(P, X, KK)
    r, t = pnp.refine_pose(P[ours], X[ours], KK, r, t)
    assert ours_ok and ok
    assert len(set(ours.tolist()) ^ set(inliers[:, 0].tolist())) <= PNP_SYMDIFF * len(inliers)
    R_cv = cv2.Rodrigues(rvec)[0]
    R = pnp.rodrigues_to_matrix(r).numpy()
    angle = np.degrees(np.arccos(np.clip((np.trace(R_cv.T @ R) - 1) / 2, -1, 1)))
    assert angle <= PNP_ROT_DEG
    np.testing.assert_allclose(t.numpy(), tvec.ravel(), rtol=0, atol=PNP_T_M)


def test_rodrigues_matches_cv2_both_ways():
    rng = np.random.default_rng(4)
    for scale in (0.0, 1e-9, 0.1, 1.0, 3.0, np.pi):
        r = rng.normal(size=3)
        r = r / np.linalg.norm(r) * scale
        R_cv = cv2.Rodrigues(r)[0]
        np.testing.assert_allclose(pnp.rodrigues_to_matrix(torch.from_numpy(r)).numpy(), R_cv,
                                   rtol=0, atol=1e-12)
        # At pi the axis comes from square roots of the diagonal, which
        # magnify the orthonormalising SVD's rounding (measured 1.1e-8).
        np.testing.assert_allclose(pnp.matrix_to_rodrigues(torch.from_numpy(R_cv)).numpy(),
                                   cv2.Rodrigues(R_cv)[0].ravel(), rtol=0,
                                   atol=1e-7 if scale == np.pi else 1e-12)


def sequence_ate(gt, values):
    truth = JaxTrajectory.from_homogenous_transforms(gt)
    ate = truth.calculate_ate(JaxTrajectory(np.asarray(values)))
    return float(np.sqrt(np.mean(np.sum(ate ** 2, axis=-1))))


def test_relative_pose_matches_hive_tpu():
    frames, depths, gt = make_sequence(num_frames=2)
    theirs = jax_sfm.PnPOdometry(K).relative_pose(frames[0], depths[0], frames[1])
    ours = sfm.PnPOdometry(K, device="cpu").relative_pose(frames[0], depths[0], frames[1])
    expected = gt[1] @ np.linalg.inv(gt[0])
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=SEQ_POSE_M)
    np.testing.assert_allclose(ours[:3, 3], expected[:3, 3], atol=0.02)   # test_sfm.py's bound


@pytest.mark.parametrize("frame_step", [1, 2])
def test_estimate_camera_poses_native_matches_hive_tpu(frame_step):
    frames, depths, gt = make_sequence(num_frames=5)
    rgb = [np.repeat(f[..., None], 3, axis=2) for f in frames]
    theirs = jax_sfm.estimate_camera_poses_native(rgb, depths, K, frame_step=frame_step)
    ours = sfm.estimate_camera_poses_native(rgb, depths, K, frame_step=frame_step,
                                            device="cpu")
    assert len(ours) == len(theirs) == 5
    np.testing.assert_allclose(ours.values, theirs.values, rtol=0, atol=SEQ_POSE_M)
    np.testing.assert_allclose(ours[0], [0, 0, 0, 1, 0, 0, 0], atol=1e-12)
    if frame_step == 1:
        # Two frames apart (0.1 m, 2 degrees) neither package solves this
        # scene's pairs; both keep the identity.
        assert sequence_ate(gt, ours.values) <= SEQ_ATE
        assert sequence_ate(gt, theirs.values) <= SEQ_ATE


def test_untextured_pair_and_fallback_match_hive_tpu(caplog):
    """No features: no pose (None), and the chain falls back to constant
    velocity with the reference's warning."""
    blank = np.zeros((HEIGHT, WIDTH), np.uint8)
    depth = np.ones((HEIGHT, WIDTH), np.float32)
    odometry = sfm.PnPOdometry(K, device="cpu")
    assert odometry.relative_pose(blank, depth, blank) is None
    with caplog.at_level(logging.WARNING):
        trajectory = odometry.estimate_trajectory([blank] * 3, [depth] * 3)
    assert "PnP odometry failed for 2/2 pairs (used constant-velocity fallback)." in caplog.text
    np.testing.assert_array_equal(trajectory.values, np.tile([0, 0, 0, 1, 0, 0, 0], (3, 1)))


def extractors(tmp_path, visualise=False):
    """hive_tpu's and the port's extractors on make_sequence's two frames,
    set up as tests/test_pose_optimisation.py sets hive_tpu's up."""
    from types import SimpleNamespace

    images, depths, _ = make_sequence(num_frames=2, seed=3)
    dataset = SimpleNamespace(camera_matrix=K, num_frames=2)
    theirs = JaxFeatureExtractor.__new__(JaxFeatureExtractor)
    theirs.dataset, theirs.frame_pairs = dataset, [(0, 1)]
    theirs.options = JaxOptions(save_match_visualisations=visualise)
    theirs.debug_path = str(tmp_path / "theirs")
    theirs.frames, theirs.depth_maps, theirs.masks = list(images), list(depths), None
    theirs.sift = cv2.SIFT_create(nfeatures=2048)
    theirs.matcher = cv2.FlannBasedMatcher(dict(algorithm=1, trees=5), dict(checks=50))

    ours = FeatureExtractor(dataset, [(0, 1)], FeatureExtractionOptions(
        save_match_visualisations=visualise), debug_path=str(tmp_path / "ours"), device="cpu")
    ours.frames = [torch.from_numpy(i) for i in images]
    ours.depth_maps = [torch.from_numpy(d) for d in depths]
    ours.masks = None
    return theirs, ours


def test_match_pair_matches_hive_tpu(tmp_path):
    theirs, ours = extractors(tmp_path)
    want, got = theirs._match_pair((0, 1)), ours._match_pair((0, 1))
    assert want is not None and got is not None
    assert abs(len(got) - len(want)) <= MATCH_COUNT_RATIO * len(want)
    for side in ("frame_i", "frame_j"):
        a, b = getattr(got, side), getattr(want, side)
        assert a.points.dtype == b.points.dtype == np.float32
        assert a.depth.dtype == b.depth.dtype and (a.index == b.index[0]).all()
    keys = set(map(tuple, got.frame_i.points.tolist()))
    shared = [tuple(p) in keys for p in want.frame_i.points.tolist()]
    assert np.mean(shared) >= MATCH_SHARE


def test_match_jpegs_named_and_sized_as_hive_tpus(tmp_path):
    """The named difference: the match JPEGs have hive_tpu's names, sizes
    and line endpoints, drawn without anti-aliasing and written by the
    port's encoder, so their pixels differ."""
    theirs, ours = extractors(tmp_path, visualise=True)
    theirs._match_pair((0, 1))
    ours._match_pair((0, 1))
    for suffix in ("accepted", "rejected"):
        name = f"000000-000001-{suffix}.jpg"
        with Image.open(tmp_path / "theirs" / "matches" / name) as a, \
                Image.open(tmp_path / "ours" / "matches" / name) as b:
            assert a.size == b.size == (2 * WIDTH, HEIGHT)
    from hive_tpu_torch.pose_optimisation import draw_matches
    canvas = draw_matches(np.zeros((4, 6), np.uint8), np.zeros((4, 6), np.uint8),
                          np.array([[1.2, 0.6]], np.float32), np.array([[4.4, 2.5]], np.float32),
                          (0, 192, 0))
    assert canvas.shape == (4, 12, 3)
    assert (canvas[1, 1] == (0, 192, 0)).all() and (canvas[2, 10] == (0, 192, 0)).all()


@pytest.fixture(scope="module")
def wall_tum(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("wall") / "tum")
    poses = wall_trajectory(10)
    write_wall_tum(base, 10, 320, 240, poses)
    return base, poses


def test_tum_estimate_pose_without_colmap(wall_tum, tmp_path, monkeypatch, caplog):
    """``--estimate_pose`` with no COLMAP binary converts in both packages
    (the port refused here before), with the same warning, the Kinect prior
    and trajectories within TUM_ATE_M of the ground truth."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "no_weights"))
    base, poses = wall_tum
    missing = str(tmp_path / "no_colmap")
    with caplog.at_level(logging.WARNING):
        ours = TUMAdaptor(base, str(tmp_path / "ours"), colmap_options=COLMAPOptions(
            binary_path=missing)).convert(True, False, InpaintingMode.Off, device="cpu")
    assert f"COLMAP binary not found at {missing}" in caplog.text
    theirs = JaxTUMAdaptor(base, str(tmp_path / "theirs"), colmap_options=JaxCOLMAPOptions(
        binary_path=missing)).convert(True, False, JaxInpaintingMode.Off)
    assert ours.metadata.estimate_pose
    np.testing.assert_array_equal(ours.camera_matrix, theirs.camera_matrix)
    got, want = ours.camera_trajectory.values, theirs.camera_trajectory.values
    np.testing.assert_allclose(got, want, rtol=0, atol=TUM_POSE_M)
    assert ate_m(poses, got) <= TUM_ATE_M and ate_m(poses, want) <= TUM_ATE_M
    assert os.path.isfile(tmp_path / "ours" / "camera_trajectory.txt")
