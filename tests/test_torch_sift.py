"""The feature layer of the port (hive_tpu_torch.ops.sift, .matching)
against OpenCV 5.0.0, which hive_tpu runs for the same steps: grey
conversion, the SIFT pyramid's resize and blurs, SIFT keypoints and
descriptors (through hive_tpu's own ``PnPOdometry._detect``), and k-NN
matching with Lowe's ratio (FLANN, through hive_tpu's ``_match``).

Tolerances, each with the value measured when it was set (OpenCV 5.0.0,
320x240 and 640x480 frames of the textured wall):

* grey conversion, the Gaussian kernels, the 2x resize, every blur and
  every octave's halving: bit for bit (measured: equal);
* keypoints: the same count as cv2's (measured: equal in every case);
  every keypoint of each side within 0.5 px of one of the other's
  (KP_SHARE 0.99; measured 1.0); the same (x, y, angle) to the bit for
  EXACT_SHARE 0.9 of them (measured 0.92-0.97: OpenCV's vectorised build
  fuses some multiply-adds of the orientation histogram and uses its own
  ``exp``, and ``powf`` rounds the size differently in a few ulp);
* descriptors of keypoints at the same position and angle: DESC_SHARE 0.98
  within DESC_L2 2.0 of cv2's (measured 1.0), all within DESC_L2_MAX 20
  (measured max 1.0);
* k-NN: the exact search's two neighbours and float32 distances equal a
  brute-force search in whole numbers (measured: all; OpenCV's
  ``BFMatcher`` rounds 1.4% of its distances 1 ulp away); FLANN (5 trees,
  50 checks, approximate) agrees on FLANN_AGREE 0.9 of the queries
  (measured 0.95), and where they differ the exact one is never farther.
"""

import cv2
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from chip_smoke import (DESC_L2, DESC_SHARE, KP_SHARE, render_wall, wall_camera,
                        wall_texture, wall_trajectory)
from hive_tpu.sfm import PnPOdometry as JaxPnPOdometry
from hive_tpu_torch.ops import matching, sift

# KP_SHARE, DESC_L2 and DESC_SHARE live in chip_smoke.py, which holds the
# card to the CPU with them.
EXACT_SHARE = 0.9
DESC_L2_MAX = 20.0
FLANN_AGREE = 0.9


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these stages are thousands of small tensor ops,
    which stall behind each other's thread barriers when test workers share
    the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def wall_frames(num_frames=2, width=320, height=240):
    texture, K = wall_texture(), wall_camera()
    poses = wall_trajectory(num_frames)
    return [render_wall(texture, p, K, width, height) for p in poses]


def grey_of(rgb):
    return cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)


def compare_features(ours: sift.SiftFeatures, keypoints, descriptors) -> dict:
    """Shares of agreement between the port's keypoints and OpenCV's."""
    theirs = np.array([k.pt for k in keypoints], np.float32).reshape(-1, 2)
    mine = ours.pt
    near_theirs = cKDTree(mine).query(theirs)[0] < 0.5
    near_mine = cKDTree(theirs).query(mine)[0] < 0.5
    index = {}
    for i, key in enumerate(zip(mine[:, 0].tolist(), mine[:, 1].tolist(),
                                ours.angle.tolist())):
        index[key] = i
    exact, distances = 0, []
    for j, k in enumerate(keypoints):
        i = index.get((k.pt[0], k.pt[1], k.angle))
        if i is not None:
            exact += 1
            distances.append(np.linalg.norm(ours.descriptors[i].numpy() - descriptors[j]))
    return dict(count=len(mine), their_count=len(theirs),
                share=min(near_theirs.mean(), near_mine.mean()),
                exact=exact / max(len(theirs), 1), distances=np.array(distances))


def test_grey_conversion_is_cv2s():
    rng = np.random.default_rng(0)
    for shape in ((1, 1, 3), (240, 320, 3), (37, 53, 3)):
        rgb = rng.integers(0, 256, shape, dtype=np.uint8)
        got = sift.rgb_to_grey(torch.from_numpy(rgb)).numpy()
        np.testing.assert_array_equal(got, cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    # Every colour with one channel at a time, where a rounding would show.
    ramp = np.zeros((256, 3, 3), np.uint8)
    for c in range(3):
        ramp[:, c, c] = np.arange(256)
    np.testing.assert_array_equal(sift.rgb_to_grey(torch.from_numpy(ramp)).numpy(),
                                  cv2.cvtColor(ramp, cv2.COLOR_RGB2GRAY))


def test_gaussian_kernels_are_cv2s():
    for sigma in sift.octave_sigmas()[1:] + list(np.linspace(0.5, 9.0, 120)):
        n = int(np.rint(sigma * 8 + 1)) | 1
        np.testing.assert_array_equal(sift.gaussian_kernel(sigma),
                                      cv2.getGaussianKernel(n, sigma, cv2.CV_32F).ravel())


@pytest.mark.parametrize("width", [3, 5, 8, 10, 12, 15, 20, 31, 33, 64, 321])
def test_blur_is_cv2s_bit_for_bit(width):
    """Widths that reach OpenCV's scalar tails (4-lane row pass, 8-lane
    column pass) and its reflected borders past a small image."""
    rng = np.random.default_rng(width)
    image = (rng.random((9 + width % 7, width)) * 255).astype(np.float32)
    for sigma in sift.octave_sigmas()[1:]:
        got = sift.gaussian_blur(torch.from_numpy(image), sigma).numpy()
        np.testing.assert_array_equal(got, cv2.GaussianBlur(image, (0, 0), sigma, sigma))


def test_pyramid_is_cv2s_bit_for_bit():
    grey = grey_of(wall_frames(1)[0][0])
    base = sift.base_image(torch.from_numpy(grey))
    doubled = cv2.resize(grey.astype(np.float32), (640, 480),
                         interpolation=cv2.INTER_LINEAR_EXACT)
    np.testing.assert_array_equal(sift.resize_linear_2x(torch.from_numpy(
        grey.astype(np.float32))).numpy(), doubled)
    sigma = np.float32(1.6)
    sig_diff = float(np.sqrt(sigma * sigma - np.float32(1.0)))
    np.testing.assert_array_equal(base.numpy(),
                                  cv2.GaussianBlur(doubled, (0, 0), sig_diff, sig_diff))
    pyramid = sift.gaussian_pyramid(base, sift.num_octaves(*grey.shape))
    assert len(pyramid) == 8            # cvRound(log2(480) - 2) + 1
    sigmas = sift.octave_sigmas()
    for o, layers in enumerate(pyramid):
        layers = layers.numpy()
        if o:
            prev = pyramid[o - 1][3].numpy()
            np.testing.assert_array_equal(layers[0], cv2.resize(
                prev, (prev.shape[1] // 2, prev.shape[0] // 2),
                interpolation=cv2.INTER_NEAREST))
        for i in range(1, len(layers)):
            np.testing.assert_array_equal(
                layers[i], cv2.GaussianBlur(layers[i - 1], (0, 0), sigmas[i], sigmas[i]))


@pytest.mark.parametrize("case", ["wall_320_2048", "wall_320_200", "wall_640_2048",
                                  "wall_640_500_masked", "splats_320_2048"])
def test_sift_matches_hive_tpus(case):
    """hive_tpu's ``PnPOdometry._detect`` (cv2 SIFT, nfeatures = the
    odometry's max_features, the dynamic mask inverted) against the port's
    on the same grey frame and mask."""
    source, size, nfeatures, *masked = case.split("_")
    width = int(size)
    if source == "wall":
        grey = grey_of(wall_frames(1, width, width * 3 // 4)[0][0])
    else:
        from tests.test_sfm import make_sequence
        grey = make_sequence(num_frames=1, seed=1)[0][0]
    mask = None
    if masked:
        mask = np.zeros(grey.shape, np.uint8)
        mask[:, : grey.shape[1] // 2] = 1               # a "moving object"
    reference = JaxPnPOdometry(np.eye(3), max_features=int(nfeatures))
    keypoints, descriptors = reference._detect(grey, mask)
    ours = sift.detect_and_compute(
        torch.from_numpy(grey), None if mask is None else torch.from_numpy(
            np.where(mask > 0, 0, 255).astype(np.uint8)), nfeatures=int(nfeatures))
    stats = compare_features(ours, keypoints, descriptors)
    assert stats["count"] == stats["their_count"] > 50
    assert stats["share"] >= KP_SHARE, stats
    assert stats["exact"] >= EXACT_SHARE, stats
    assert (stats["distances"] <= DESC_L2).mean() >= DESC_SHARE, stats
    assert stats["distances"].max() <= DESC_L2_MAX, stats
    assert ours.descriptors.dtype == torch.float32
    assert torch.equal(ours.descriptors, ours.descriptors.round())
    assert float(ours.descriptors.max()) <= 255 and float(ours.descriptors.min()) >= 0


def test_nfeatures_cut_comes_before_the_mask():
    """OpenCV keeps the best nfeatures of the whole frame, then drops the
    masked ones: a half-masked frame keeps fewer than nfeatures, in both."""
    grey = grey_of(wall_frames(1)[0][0])
    mask = np.full(grey.shape, 255, np.uint8)
    mask[:, : grey.shape[1] // 2] = 0
    keypoints, _ = cv2.SIFT_create(nfeatures=60).detectAndCompute(grey, mask)
    ours = sift.detect_and_compute(torch.from_numpy(grey), torch.from_numpy(mask), 60)
    everything = sift.detect_and_compute(torch.from_numpy(grey), nfeatures=60)
    assert len(everything) >= 60
    assert len(ours) == len(keypoints) < 60
    assert (ours.pt[:, 0] >= grey.shape[1] // 2 - 0.5).all()


def test_knn_is_exact_and_agrees_with_flann():
    frames = wall_frames(2)
    a, b = (sift.detect_and_compute(torch.from_numpy(grey_of(f[0])), nfeatures=2048)
            for f in frames)
    indices, distances = matching.knn2(a.descriptors, b.descriptors)
    da, db = a.descriptors.numpy(), b.descriptors.numpy()
    # The exact squared distances, as whole numbers; the two smallest.
    squared = ((da[:, None, :].astype(np.int64) - db[None].astype(np.int64)) ** 2).sum(-1)
    order = np.argsort(squared, axis=1, kind="stable")[:, :2]
    np.testing.assert_array_equal(indices.numpy(), order)
    np.testing.assert_array_equal(
        distances.numpy(), np.sqrt(np.take_along_axis(squared, order, 1).astype(np.float32)))

    flann = cv2.FlannBasedMatcher(dict(algorithm=1, trees=5), dict(checks=50))
    approximate = flann.knnMatch(da, db, k=2)
    flann_first = np.array([m.trainIdx for m, _ in approximate])
    flann_distance = np.array([m.distance for m, _ in approximate], np.float32)
    agree = flann_first == indices[:, 0].numpy()
    assert agree.mean() >= FLANN_AGREE
    assert (distances[:, 0].numpy() <= flann_distance).all()


def test_ratio_tests_match_hive_tpus():
    """The odometry accepts m < 0.75 n (``hive_tpu/sfm.py:88``), the
    extractor rejects m > 0.7 n (``pose_optimisation.py:360``), compared in
    float64 like Python compares OpenCV's float32 distances."""
    d = torch.tensor([[3.0, 4.0], [7.0, 10.0], [0.0, 0.0], [2.0, 2.5]], dtype=torch.float32)
    assert matching.ratio_test(d, 0.75, strict=True).tolist() == [False, True, False, False]
    assert matching.ratio_test(d, 0.7, strict=False).tolist() == [False, True, True, False]

    frames = wall_frames(2)
    greys = [grey_of(f[0]) for f in frames]
    reference = JaxPnPOdometry(np.eye(3))
    (_, desc_a), (_, desc_b) = (reference._detect(g, None) for g in greys)
    theirs = reference._match(desc_a, desc_b)
    ours = matching.match_descriptors(torch.from_numpy(desc_a), torch.from_numpy(desc_b),
                                      0.75, strict=True)
    ours = set(map(tuple, ours.tolist()))
    assert len(set(theirs) & ours) >= FLANN_AGREE * max(len(theirs), len(ours))
    assert matching.match_descriptors(torch.from_numpy(desc_a[:1]), torch.from_numpy(desc_b),
                                      0.75).shape == (0, 2)


def test_histograms_are_summed_by_the_ordered_kernel(monkeypatch):
    """Both histogram passes go through ``ops.ordered_hist`` (36 orientation
    bins, (4 + 2)^2 (8 + 2) = 360 descriptor bins), whose plain version here
    is today's in-order ``scatter_add_``: the features equal those of a run
    that sums with ``scatter_add_`` directly."""
    from hive_tpu_torch.ops import ordered_hist

    grey = torch.from_numpy(grey_of(wall_frames(1, 160, 120)[0][0]))
    widths = []

    def recording(index, value, bins):
        widths.append(bins)
        return ordered_hist.ordered_hist(index, value, bins)

    monkeypatch.setattr(sift, "ordered_hist", recording)
    ours = sift.detect_and_compute(grey)
    assert {36, 360} <= set(widths)

    def scatter(index, value, bins):
        out = torch.zeros((index.shape[0], bins), dtype=torch.float32)
        return out.scatter_add_(1, index.long(), value)

    monkeypatch.setattr(sift, "ordered_hist", scatter)
    plain = sift.detect_and_compute(grey)
    assert len(ours) > 10
    for field in ("xy", "angle", "descriptors"):
        assert torch.equal(getattr(ours, field), getattr(plain, field)), field
