"""Mask R-CNN (hive_tpu_torch.models.maskrcnn) against hive_tpu's on the
same inputs and weights: the converter and the loader, the box utilities
with planted ties and -inf slots, ROIAlign at each level, each module with
the check weights (``maskrcnn.check_params``) carried from the Flax tree,
the whole detector's outputs and instance masks at the reference test's
small canvas, the host resize against OpenCV, and three planted faults.

Tolerances, float32: a module within 1e-4 of its output's largest
magnitude (XLA's and torch's CPU kernels sum in other orders; measured
<= 2.2e-6); the detector's scores within 5e-5 (measured 8e-6), boxes within
5e-3 canvas px (measured 4e-4), mask probabilities within 1e-3 (measured
2.1e-4: the check weights' mask logits are x4); the discrete results
(validity, detection order, instance ids) equal.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hive_tpu.models import maskrcnn as jax_maskrcnn
from hive_tpu.models.convert_utils import unflatten_params
from hive_tpu.models.selftest import make_fake_torchvision_state_dict
from hive_tpu_torch.models import maskrcnn
from hive_tpu_torch.models.flax_layers import load_flax_params

SEED = 0
MODULE_TOL = 1e-4
SCORE_TOL = 5e-5
BOX_TOL = 5e-3
MASK_TOL = 1e-3
# The reference test's small canvas (tests/test_maskrcnn.py): 120 x 160
# frames in a 192 x 256 canvas.
INPUT_HW = (120, 160)
CANVAS = dict(canvas_min_side=160, canvas_max_side=224)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.numpy().transpose(0, 2, 3, 1)


def scene(rng, height=INPUT_HW[0], width=INPUT_HW[1]) -> np.ndarray:
    """A textured wall with three ellipses of random colours, and noise."""
    ys, xs = np.mgrid[0:height, 0:width]
    image = np.stack([60 + 40 * np.sin(xs / 7.0), xs * 255.0 / width, ys * 255.0 / height], -1)
    for _ in range(3):
        cy, cx = rng.uniform(20, height - 20), rng.uniform(20, width - 20)
        ry, rx = rng.uniform(10, 30), rng.uniform(6, 15)
        image[((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < 1] = rng.integers(0, 256, 3)
    return np.clip(image + rng.normal(0, 3, image.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def flat():
    return maskrcnn.check_params(SEED)


def subtree(flat, prefix):
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# Weights: the converter and the loader.
# ---------------------------------------------------------------------------

def test_converters_write_one_npz(tmp_path):
    """The selftest's fake torchvision state dict through both converters:
    the same keys, bit-equal arrays; and the port loads the result."""
    torch.save(make_fake_torchvision_state_dict(), tmp_path / "maskrcnn.pth")
    jax_maskrcnn.convert_torch_checkpoint(str(tmp_path / "maskrcnn.pth"), str(tmp_path / "jax.npz"))
    maskrcnn.convert_torch_checkpoint(str(tmp_path / "maskrcnn.pth"), str(tmp_path / "torch.npz"))
    theirs, ours = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
    assert sorted(ours.files) == sorted(theirs.files) and len(ours.files) == 201
    for key in theirs.files:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    maskrcnn.load_params(str(tmp_path / "torch.npz"), "cpu")


@pytest.mark.parametrize("fault", ["missing", "unused", "misshaped"])
def test_loader_refuses_a_bad_key(flat, fault):
    bad = dict(flat)
    if fault == "missing":
        del bad["mask_head/conv5_mask/bias"]
        error, match = KeyError, "missing \\['mask_head/conv5_mask/bias'\\]"
    elif fault == "unused":
        bad["box_head/fc8/kernel"] = np.zeros(1, np.float32)
        error, match = KeyError, "unused \\['box_head/fc8/kernel'\\]"
    else:
        bad["fpn/inner0/kernel"] = np.zeros((1, 1, 256, 128), np.float32)
        error, match = ValueError, "Mask R-CNN parameter fpn/inner0/kernel"
    with pytest.raises(error, match=match):
        maskrcnn.load_params(bad, "cpu")


def test_check_params_cover_the_references_tree(flat):
    """The check weights have the Flax model's leaves and shapes."""
    import flax

    shapes = jax.eval_shape(jax_maskrcnn.MaskRCNN().init, jax.random.PRNGKey(0),
                            jnp.zeros((128, 128, 3)), jnp.asarray([128, 128]))
    want = {"/".join(k): tuple(v.shape) for k, v in
            flax.traverse_util.flatten_dict(flax.core.unfreeze(shapes["params"])).items()}
    assert {k: v.shape for k, v in flat.items()} == want


# ---------------------------------------------------------------------------
# Box utilities.
# ---------------------------------------------------------------------------

def random_boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(1, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def tied_scores(rng, n):
    """Scores on a coarse grid (many exact ties) with a quarter -inf."""
    scores = np.round(rng.uniform(0, 1, n) * 8) / 8
    scores[rng.random(n) < 0.25] = -np.inf
    return scores.astype(np.float32)


def test_decode_boxes_matches_jax():
    """Both weightings, deltas past the log-size clip: within 1e-5 of
    the box size (measured: equal)."""
    rng = np.random.default_rng(1)
    anchors = random_boxes(rng, 500)
    deltas = rng.normal(0, 2, (500, 4)).astype(np.float32)
    deltas[:10, 2:] = 9.0
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = np.asarray(jax.jit(jax_maskrcnn.decode_boxes, static_argnums=2)(
            anchors, deltas, weights))
        got = maskrcnn.decode_boxes(torch.from_numpy(anchors), torch.from_numpy(deltas),
                                    weights).numpy()
        assert rel_err(got, want) < 1e-5


def test_box_iou_matrix_matches_jax():
    rng = np.random.default_rng(2)
    a, b = random_boxes(rng, 60), random_boxes(rng, 70)
    a[0] = b[0]                                   # identical
    a[1] = [5, 5, 5, 20]                          # empty
    want = np.asarray(jax.jit(jax_maskrcnn.box_iou_matrix)(a, b))
    got = maskrcnn.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_nms_match_jax_with_ties_and_inf_slots(seed):
    """fast_nms and greedy_nms_topk on scores with many exact ties and -inf
    slots (whose boxes still overlap others), and a batch of two: keep,
    picks and validity equal; more steps than valid boxes, so the trailing
    slots pick among -inf."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 40, (2, 300, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (2, 300, 2))], -1).astype(np.float32)
    scores = np.stack([tied_scores(rng, 300) for _ in range(2)])
    for b in range(2):
        keep = np.asarray(jax.jit(jax_maskrcnn.fast_nms, static_argnums=2)(
            boxes[b], scores[b], 0.7))
        idx, valid = jax.jit(jax_maskrcnn.greedy_nms_topk, static_argnums=(2, 3))(
            boxes[b], scores[b], 0.5, 100)
        np.testing.assert_array_equal(
            maskrcnn.fast_nms(torch.from_numpy(boxes[b]), torch.from_numpy(scores[b]), 0.7), keep)
        got_idx, got_valid = maskrcnn.greedy_nms_topk(torch.from_numpy(boxes), torch.from_numpy(
            scores), 0.5, 100)
        np.testing.assert_array_equal(got_idx[b].numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_valid[b].numpy(), np.asarray(valid))
        assert 0 < np.asarray(valid).sum() < 100


def test_top_k_keeps_jax_order_on_ties():
    rng = np.random.default_rng(5)
    scores = tied_scores(rng, 600)
    values, indices = jax.lax.top_k(scores, 300)
    got_values, got_indices = maskrcnn.top_k(torch.from_numpy(scores), 300)
    np.testing.assert_array_equal(got_indices.numpy(), np.asarray(indices))
    np.testing.assert_array_equal(got_values.numpy(), np.asarray(values))


def test_planted_fault_topk_in_place_of_the_stable_sort():
    """``torch.topk`` orders tied values otherwise than jax.lax.top_k."""
    scores = tied_scores(np.random.default_rng(5), 600)
    _, indices = jax.lax.top_k(scores, 300)
    _, faulty = torch.topk(torch.from_numpy(scores), 300)
    assert not np.array_equal(faulty.numpy(), np.asarray(indices))


# ---------------------------------------------------------------------------
# ROIAlign.
# ---------------------------------------------------------------------------

# (level, feature side): the levels of a 192 x 256 canvas, P5 padded to the
# window as the reference pads it.
LEVELS = {"P2": (48, 64), "P3": (48, 48), "P4": (48, 48), "P5": (48, 48)}


def roi_inputs(level, seed=6):
    rng = np.random.default_rng(seed)
    h, w = LEVELS[level]
    feature = rng.standard_normal((h, w, 16)).astype(np.float32)
    boxes = random_boxes(rng, 40, float(min(h, w)))
    boxes[0] = [2.3, 3.7, 2.3 + 60.5, 9.1]       # longer than the window
    boxes[1] = [10.0, 10.0, 10.0, 10.0]          # empty
    boxes[2] = [w - 3.5, h - 6.2, w + 4.0, h]    # past the edge
    return feature, boxes


def roi_align_one_level(feature: np.ndarray, boxes: np.ndarray, out_size: int) -> np.ndarray:
    """The port's ROIAlign of every box on one (H, W, C) level: a table
    of that level's rows alone."""
    h, w, c = feature.shape
    n = len(boxes)
    base, height, width = torch.tensor([0, h, w])[:, None].expand(3, n)
    return maskrcnn.roi_align_rows(torch.from_numpy(feature).reshape(h * w, c), base, height,
                                   width, torch.from_numpy(boxes), out_size).numpy()


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_roi_align_matches_jax(level, out_size):
    """Every level's shape, with a box longer than the window, an empty
    one and one past the edge: within 1e-5 of the feature's range."""
    feature, boxes = roi_inputs(level)
    want = np.asarray(jax.jit(jax_maskrcnn.roi_align, static_argnums=2)(feature, boxes, out_size))
    got = roi_align_one_level(feature, boxes, out_size)
    assert got.shape == want.shape == (40, out_size, out_size, 16)
    assert rel_err(got, want) < 1e-5


def test_pyramid_roi_align_matches_jax():
    """Level assignment over P2..P5 and the per-level merge, boxes of every
    size in a batch of two frames: within 1e-5."""
    rng = np.random.default_rng(7)
    shapes = [(48, 64), (24, 32), (12, 16), (6, 8), (3, 4)]
    pyramid = [rng.standard_normal((2, h, w, 8)).astype(np.float32) for h, w in shapes]
    boxes = np.stack([np.concatenate([random_boxes(rng, 30, 60.0), random_boxes(rng, 30, 250.0)])
                      for _ in range(2)])
    got = maskrcnn.pyramid_roi_align([to_nchw(p) for p in pyramid], torch.from_numpy(boxes), 7)
    for b in range(2):
        want = jax.jit(lambda p, x: jax_maskrcnn.MaskRCNN._pyramid_roi_align(None, p, x, 7))(
            [p[b:b + 1] for p in pyramid], boxes[b])
        assert rel_err(got[b].numpy(), np.asarray(want)) < 1e-5


def test_planted_fault_aligned_half_pixel_shift():
    """ROIAlign with torchvision's aligned=True (samples half a pixel
    earlier) is caught at the tolerance above."""
    feature, boxes = roi_inputs("P2")
    want = np.asarray(jax.jit(jax_maskrcnn.roi_align, static_argnums=2)(feature, boxes, 7))
    shifted = roi_align_one_level(feature, boxes - 0.5, 7)
    assert rel_err(shifted, want) > 1e-2


# ---------------------------------------------------------------------------
# Modules, each against its flax twin with the check weights.
# ---------------------------------------------------------------------------

def test_resnet50_and_fpn_match_flax(flat):
    x = np.random.default_rng(8).standard_normal((2, 64, 96, 3)).astype(np.float32)
    tree = unflatten_params(flat, leaf=jnp.asarray)
    want = jax.jit(jax_maskrcnn.ResNet50().apply)({"params": tree["body"]}, x)
    with torch.no_grad():
        got = load_flax_params(maskrcnn.ResNet50(), subtree(flat, "body"))(to_nchw(x))
    for g, w in zip(got, want):
        assert rel_err(to_nhwc(g), w) < MODULE_TOL

    feats = [np.asarray(w) for w in want]
    want = jax.jit(jax_maskrcnn.FPN().apply)({"params": tree["fpn"]}, feats)
    with torch.no_grad():
        got = load_flax_params(maskrcnn.FPN(), subtree(flat, "fpn"))([to_nchw(f) for f in feats])
    assert [tuple(g.shape[2:]) for g in got] == [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    for g, w in zip(got, want):
        assert rel_err(to_nhwc(g), w) < MODULE_TOL


def test_rpn_head_matches_flax(flat):
    rng = np.random.default_rng(9)
    feats = [rng.standard_normal((2, s, s + 2, 256)).astype(np.float32) for s in (8, 4, 2)]
    logits, deltas = jax.jit(jax_maskrcnn.RPNHead().apply)(
        {"params": unflatten_params(subtree(flat, "rpn_head"))}, feats)
    with torch.no_grad():
        got_logits, got_deltas = load_flax_params(maskrcnn.RPNHead(), subtree(flat, "rpn_head"))(
            [to_nchw(f) for f in feats])
    for g, w in zip(got_logits, logits):
        assert rel_err(g.numpy(), np.asarray(w).reshape(2, -1)) < MODULE_TOL
    for g, w in zip(got_deltas, deltas):
        assert rel_err(g.numpy(), np.asarray(w).reshape(2, -1, 4)) < MODULE_TOL


def test_box_head_matches_flax(flat):
    x = np.random.default_rng(10).uniform(0, 3, (64, 7, 7, 256)).astype(np.float32)
    want = jax.jit(jax_maskrcnn.BoxHead().apply)(
        {"params": unflatten_params(subtree(flat, "box_head"))}, x)
    with torch.no_grad():
        got = load_flax_params(maskrcnn.BoxHead(), subtree(flat, "box_head"))(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < MODULE_TOL


def deconv_pair(flat):
    params = {"kernel": flat["mask_head/conv5_mask/kernel"],
              "bias": flat["mask_head/conv5_mask/bias"]}
    x = np.random.default_rng(11).uniform(0, 2, (8, 14, 14, 256)).astype(np.float32)
    want = np.asarray(jax.jit(jax_maskrcnn.BlockDeconv2x(256).apply)({"params": params}, x))
    return params, x, want


def test_block_deconv_matches_flax(flat):
    params, x, want = deconv_pair(flat)
    with torch.no_grad():
        got = load_flax_params(maskrcnn.BlockDeconv2x(256, 256), params)(to_nchw(x))
    assert rel_err(to_nhwc(got), want) < MODULE_TOL


def test_planted_fault_flipped_deconv_kernel(flat):
    """The kernel's 2x2 taps flipped (as flax's own ConvTranspose takes
    them) is caught."""
    params, x, want = deconv_pair(flat)
    flipped = dict(params, kernel=params["kernel"][:, ::-1, ::-1])
    with torch.no_grad():
        got = load_flax_params(maskrcnn.BlockDeconv2x(256, 256), flipped)(to_nchw(x))
    assert rel_err(to_nhwc(got), want) > 0.1


def test_mask_head_matches_flax(flat):
    x = np.random.default_rng(12).uniform(0, 3, (8, 14, 14, 256)).astype(np.float32)
    want = jax.jit(jax_maskrcnn.MaskHead().apply)(
        {"params": unflatten_params(subtree(flat, "mask_head"))}, x)
    with torch.no_grad():
        got = load_flax_params(maskrcnn.MaskHead(), subtree(flat, "mask_head"))(to_nchw(x))
    assert got.shape == (8, 91, 28, 28)
    assert rel_err(to_nhwc(got), want) < MODULE_TOL


def test_maskrcnn_flops_counts_every_product():
    """The analytic count equals the multiply-adds of every conv, dense
    layer and deconv, counted from the shapes of a forward, plus ROIAlign's
    samples as its docstring counts them; and it scales with the batch."""
    model = maskrcnn.MaskRCNN().eval()
    counted = []

    def hook(module, inputs, output):
        if isinstance(module, (maskrcnn.Conv, maskrcnn.BlockDeconv2x)):
            kernel = module.kernel
            per_output = kernel.shape[1] * kernel.shape[2] * kernel.shape[3] \
                if isinstance(module, maskrcnn.Conv) else kernel.shape[0]
            counted.append(2 * output.numel() * per_output)
        elif isinstance(module, maskrcnn.Dense):
            counted.append(2 * output.numel() * module.kernel.shape[1])

    for m in model.modules():
        m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, 192, 256), (160, 213))
    # A bin: four samples of four weighted taps a channel (6 multiplies, 3
    # adds), their average (3 adds, a divide).
    roi_align = sum(count * side * side * 256 * (4 * 9 + 4)
                    for count, side in ((maskrcnn.POST_NMS_TOP_N, 7), (maskrcnn.MASK_TOP_N, 14)))
    assert sum(counted) + roi_align == maskrcnn.maskrcnn_flops((192, 256))
    assert maskrcnn.maskrcnn_flops((832, 1088), batch=8) == 8 * maskrcnn.maskrcnn_flops((832, 1088))


# ---------------------------------------------------------------------------
# The whole detector.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def detectors(flat):
    """hive_tpu's jitted detector (compiled once) and the port's on the CPU,
    the same check weights, both at the small canvas."""
    theirs = jax_maskrcnn.MaskRCNNDetector(unflatten_params(flat, leaf=jnp.asarray),
                                           input_hw=INPUT_HW, **CANVAS)
    ours = maskrcnn.MaskRCNNDetector(maskrcnn.load_params(flat, "cpu"), input_hw=INPUT_HW,
                                     **CANVAS)
    assert ours.canvas_hw == (192, 256) and ours.scaled_hw == theirs.scaled_hw
    return theirs, ours


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(SEED)
    return np.stack([scene(rng) for _ in range(3)])


@pytest.fixture(scope="module")
def outputs(detectors, frames):
    """Each frame's raw outputs from hive_tpu, and the port's batch of
    three and single frames."""
    theirs, ours = detectors
    jax_out = [jax.tree.map(np.asarray, theirs._forward(theirs.params, jnp.asarray(f)))
               for f in frames]
    return jax_out, ours.forward(frames), [ours.forward(f[None]) for f in frames]


def test_detector_matches_hive_tpu(outputs):
    """Validity equal; boxes, scores and masks within tolerance on the
    valid slots."""
    jax_out, batch, _ = outputs
    for i, want in enumerate(jax_out):
        valid = want["valid"]
        np.testing.assert_array_equal(batch["valid"][i], valid)
        np.testing.assert_allclose(batch["boxes"][i][valid], want["boxes"][valid],
                                   atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(batch["scores"][i], want["scores"], atol=SCORE_TOL, rtol=0)
        np.testing.assert_allclose(batch["masks"][i], want["masks"], atol=MASK_TOL, rtol=0)


def test_check_weights_detect_with_margins(outputs):
    """The check weights make the detector's decisions informative: at
    least 3 detections over 0.5 a frame (measured 5, 8, 7), each score at
    least 1e-3 (20 x SCORE_TOL) from the threshold and from the next
    (measured >= 0.0039), and no two of them overlapping past an IoU of
    0.49 (measured <= 0.466). Among all valid detections, the closest IoU
    to the NMS's 0.5 is 0.49998 (frame 2): a near-tie, which the equal
    validity in test_detector_matches_hive_tpu needs on the same side."""
    for want in outputs[0]:
        kept = want["valid"] & (want["scores"] >= 0.5)
        scores = want["scores"][kept]
        assert kept.sum() >= 3
        assert np.abs(scores - 0.5).min() > 1e-3 and -np.diff(scores).min() > 1e-3
        iou = np.asarray(jax_maskrcnn.box_iou_matrix(want["boxes"][kept], want["boxes"][kept]))
        assert np.triu(iou, 1).max() < 0.49


def test_instance_masks_match_hive_tpu(detectors, frames):
    """``instance_mask`` pixel for pixel (ids 1..N by score), except where a
    mask's probability lies within MASK_TOL of 0.5 (the masks' own float
    tolerance: 131, 173 and 155 of these frames' 19,200 pixels, under the
    2% allowed; all of them agreed too when measured)."""
    theirs, ours = detectors
    for frame, got in zip(frames, ours.instance_masks(frames)):
        want = theirs.instance_mask(frame)
        near = ours.threshold_distance(theirs.detect(frame)) <= MASK_TOL
        assert got.dtype == want.dtype == np.uint8
        assert want.max() >= 3 and near.sum() < 0.02 * near.size
        np.testing.assert_array_equal(got[~near], want[~near])


def test_batch_equals_single_frames(outputs):
    """A frame's result in a batch of three equals its result alone."""
    _, batch, singles = outputs
    for i, single in enumerate(singles):
        np.testing.assert_array_equal(batch["valid"][i], single["valid"][0])
        valid = single["valid"][0]
        np.testing.assert_allclose(batch["boxes"][i][valid], single["boxes"][0][valid],
                                   atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(batch["scores"][i], single["scores"][0], atol=SCORE_TOL,
                                   rtol=0)
        np.testing.assert_allclose(batch["masks"][i], single["masks"][0], atol=MASK_TOL, rtol=0)


# ---------------------------------------------------------------------------
# The host resize of the masks.
# ---------------------------------------------------------------------------

def test_resize_linear_f32_is_opencvs():
    """``cv2.resize(..., INTER_LINEAR)`` of 28 x 28 float32 masks to boxes
    of every size from 1 to 129 px a side, up and down, bit for bit."""
    rng = np.random.default_rng(13)
    sizes = [tuple(s) for s in rng.integers(1, 130, (300, 2))] + [(14, 14), (56, 56), (28, 28),
                                                                   (28, 14), (1, 1), (2, 3)]
    for width, height in sizes:
        mask = rng.random((28, 28)).astype(np.float32)
        want = cv2.resize(mask, (int(width), int(height)), interpolation=cv2.INTER_LINEAR)
        got = maskrcnn.resize_linear_f32(mask, int(width), int(height))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"{width}x{height}")


def test_canvas_geometry_is_the_references():
    """The scale, the scaled frame and the canvas of the reference's
    detector (built unjitted, no weights) for common frame sizes."""
    for hw in ((480, 640), (120, 160), (48, 64), (720, 1280), (1080, 1920), (640, 480)):
        theirs = jax_maskrcnn.MaskRCNNDetector(None, input_hw=hw)
        assert maskrcnn.canvas_geometry(hw) == (theirs.scale, theirs.scaled_hw, theirs.canvas_hw)
    assert maskrcnn.canvas_geometry((480, 640))[2] == (832, 1088)
