"""The port's motion segmenter (hive_tpu_torch.models.segmentation) against
OpenCV and hive_tpu: MOG2's raw 0 / 127 / 255 output bit for bit against
cv2's on seeded sequences (noise, a moving blob, a global dimming that makes
shadows, mode churn past the 200-frame history), the 5x5 open and close,
cv2's component numbering, whole instance masks against hive_tpu's
``PersonSegmenter`` without weights, and the refusal of weighted backends."""

import cv2
import numpy as np
import pytest
import torch

from hive_tpu.models.segmentation import PersonSegmenter as JaxPersonSegmenter
from hive_tpu_torch.models.segmentation import PersonSegmenter, _MotionBackend, open_close


def blob_sequence(seed, frames=24, height=48, width=64):
    """A textured wall with noise, a (200, 64, 64) blob crossing it, and the
    whole frame dimmed to 60% in the second half (shadows)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height, 0:width]
    wall = np.stack([xs * 3 % 256, ys * 5 % 256, (xs + ys) * 2 % 256], -1).astype(np.float64)
    out = []
    for i in range(frames):
        frame = wall * (0.6 if i > frames // 2 else 1.0)
        frame[(xs - 5 - 3 * i) ** 2 + (ys - height // 2) ** 2 < 64] = (200, 64, 64)
        out.append(np.clip(frame + rng.normal(0, 3, frame.shape), 0, 255).astype(np.uint8))
    return np.stack(out)


def churn_sequence(seed, kind, frames=230, height=12, width=16):
    """Past the history of 200 frames, where the learning rate is 1/200 and
    weak modes are pruned: pure noise (every mode replaced), a few colours
    per pixel (several live modes), and black pixels (zero means)."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 256, (6, height, width, 3))
    rows, cols = np.arange(height)[:, None], np.arange(width)[None]
    out = []
    for _ in range(frames):
        if kind == "noise":
            frame = rng.integers(0, 256, (height, width, 3))
        elif kind == "multimodal":
            frame = levels[rng.integers(0, 6, (height, width)), rows, cols]
        else:
            frame = np.where(rng.random((height, width, 1)) < 0.1, 0,
                             levels[1] + rng.normal(0, 2, (height, width, 3)))
        out.append(np.clip(frame, 0, 255).astype(np.uint8))
    return np.stack(out)


def assert_mog2_matches_opencv(frames_bgr):
    subtractor = cv2.createBackgroundSubtractorMOG2(history=200, varThreshold=32,
                                                    detectShadows=True)
    ours = _MotionBackend(device="cpu")
    seen = set()
    for i, frame in enumerate(frames_bgr):
        want = subtractor.apply(frame, learningRate=-1)
        got = ours.apply(torch.from_numpy(frame)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
        seen |= set(np.unique(want).tolist())
    return seen


def test_mog2_matches_opencv_with_blob_and_shadows():
    """The reference's own call order: the first batch replayed in reverse,
    then every frame in order, RGB turned to BGR. Bit-equal on every frame,
    and the sequence reaches all three labels."""
    frames = blob_sequence(0)
    bgr = np.concatenate([frames[:8][::-1], frames])[..., ::-1]
    assert assert_mog2_matches_opencv(np.ascontiguousarray(bgr)) == {0, 127, 255}


@pytest.mark.parametrize("kind", ["noise", "multimodal", "black_pixels"])
def test_mog2_matches_opencv_past_its_history(kind):
    assert_mog2_matches_opencv(churn_sequence(1, kind))


def test_open_and_close_match_opencv():
    """The 5x5 open, then the close with three iterations, at the borders
    too (OpenCV's default border neither erodes nor dilates)."""
    rng = np.random.default_rng(2)
    kernel = np.ones((5, 5), np.uint8)
    masks = (rng.random((4, 37, 53)) < np.array([0.05, 0.3, 0.6, 0.9])[:, None, None])
    got = open_close(torch.from_numpy(masks)).numpy()
    for fg, ours in zip(masks.astype(np.uint8), got):
        want = cv2.morphologyEx(cv2.morphologyEx(fg, cv2.MORPH_OPEN, kernel),
                                cv2.MORPH_CLOSE, kernel, iterations=3)
        np.testing.assert_array_equal(ours, want.astype(bool))


def test_component_order_is_opencvs():
    """cv2 numbers 8-connected components by their first 2x2 block in a
    raster scan of blocks, not by their first pixel: a lone pixel at (1, 0)
    comes before one at (0, 8)."""
    backend = _MotionBackend(device="cpu", min_area_fraction=0.0)
    fg = np.zeros((4, 10), bool)
    fg[1, 0] = fg[0, 8] = True
    expected = np.zeros((4, 10), np.uint8)
    expected[1, 0], expected[0, 8] = 1, 2
    np.testing.assert_array_equal(backend.instances(fg), expected)

    rng = np.random.default_rng(3)
    for shape in ((31, 45), (30, 44), (1, 9)):
        fg = rng.random(shape) < 0.1
        count, labels = cv2.connectedComponents(fg.astype(np.uint8), connectivity=8)
        assert count <= 256
        np.testing.assert_array_equal(backend.instances(fg), labels.astype(np.uint8))


def test_small_components_dropped_and_ids_capped():
    """Components under 0.1% of the frame are dropped; ids stop at 255."""
    fg = np.zeros((100, 100), bool)
    fg[0, 0] = True                          # 1 pixel < 10: dropped
    fg[10:14, 10:14] = True                  # 16 pixels: kept
    ids = _MotionBackend(device="cpu").instances(fg)
    assert ids[0, 0] == 0 and (ids[10:14, 10:14] == 1).all() and ids.max() == 1

    fg = np.zeros((64, 64), bool)
    fg[::2, ::2] = True                      # 1024 isolated pixels
    ids = _MotionBackend(device="cpu", min_area_fraction=0.0).instances(fg)
    assert ids.max() == 255 and (ids > 0).sum() == 255


def test_predict_batch_matches_hive_tpu(tmp_path, monkeypatch):
    """Batches of 8 in video order, as create_masks feeds them, without
    weights: the same uint8 instance masks as hive_tpu's segmenter."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    frames = blob_sequence(4, frames=20)
    theirs, ours = JaxPersonSegmenter(), PersonSegmenter(device="cpu")
    found = 0
    for start in range(0, len(frames), 8):
        batch = frames[start:start + 8]
        for got, want in zip(ours.predict_batch(batch), theirs.predict_batch(batch)):
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            found += int(want.max() > 0)
    assert found >= 8


@pytest.mark.parametrize("filename", ["maskrcnn_coco.npz", "person_unet.npz"])
def test_weights_file_is_refused(tmp_path, monkeypatch, filename):
    """With a weights file the reference would take a weighted backend; the
    port refuses rather than give motion masks in its place."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    (tmp_path / filename).write_bytes(b"")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        PersonSegmenter(device="cpu")
