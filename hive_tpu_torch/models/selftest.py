"""Converter confidence pass on fabricated upstream checkpoints.

Counterpart of ``hive_tpu/models/selftest.py``. ``python -m
hive_tpu_torch.models.convert --selftest`` is the first command to run with
the released weights at hand: it fabricates the exact upstream layouts of
the four released checkpoints with random tensors (DPT-Hybrid NYU,
big-lama, torchvision's Mask R-CNN, LPIPS AlexNet and linear heads),
converts each with the converter users run, loads the result through the
runtime loaders under a temporary ``$WEIGHTS_PATH``, runs each network and
checks it (LPIPS against a torch re-implementation, LaMa's compositing, the
CNNs' parameter trees through the loaders' key and shape checks). A green
selftest means the conversion path is sound; a problem with real weights
is then in the files, not the tooling.

The fabricators are copies of the reference's, so that the port needs
nothing of ``hive_tpu``; ``tests/test_torch_convert.py`` holds them equal.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Synthetic upstream checkpoints (exact released layouts, random tensors).
# ---------------------------------------------------------------------------

def make_fake_dpt_state_dict():
    """The timm vitb_rn50_384 + DPT scratch layout at full size."""
    import torch

    rng = np.random.default_rng(0)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(scale=0.02, size=shape).astype(np.float32))

    state = {}
    vit = "pretrained.model"
    resnet = f"{vit}.patch_embed.backbone"

    # ResNetV2 stem.
    state[f"{resnet}.stem.conv.weight"] = tensor(64, 3, 7, 7)
    state[f"{resnet}.stem.norm.weight"] = tensor(64)
    state[f"{resnet}.stem.norm.bias"] = tensor(64)

    for stage, (blocks, width) in enumerate([(3, 64), (4, 128), (9, 256)]):
        in_ch = 64 * 4 * (2 ** (stage - 1)) if stage > 0 else 64

        for block in range(blocks):
            src = f"{resnet}.stages.{stage}.blocks.{block}"
            prev = in_ch if block == 0 else width * 4

            # Post-activation layout (timm preact=False, the layout the
            # released checkpoint stores): norm{k} follows conv{k}, sized
            # to its output width; the projection shortcut has its own norm.
            state[f"{src}.conv1.weight"] = tensor(width, prev, 1, 1)
            state[f"{src}.norm1.weight"] = tensor(width)
            state[f"{src}.norm1.bias"] = tensor(width)
            state[f"{src}.conv2.weight"] = tensor(width, width, 3, 3)
            state[f"{src}.norm2.weight"] = tensor(width)
            state[f"{src}.norm2.bias"] = tensor(width)
            state[f"{src}.conv3.weight"] = tensor(width * 4, width, 1, 1)
            state[f"{src}.norm3.weight"] = tensor(width * 4)
            state[f"{src}.norm3.bias"] = tensor(width * 4)

            if block == 0:
                state[f"{src}.downsample.conv.weight"] = tensor(width * 4, prev, 1, 1)
                state[f"{src}.downsample.norm.weight"] = tensor(width * 4)
                state[f"{src}.downsample.norm.bias"] = tensor(width * 4)

    # Patch embed + tokens.
    state[f"{vit}.patch_embed.proj.weight"] = tensor(768, 1024, 1, 1)
    state[f"{vit}.patch_embed.proj.bias"] = tensor(768)
    state[f"{vit}.cls_token"] = tensor(1, 1, 768)
    state[f"{vit}.pos_embed"] = tensor(1, 577, 768)

    # Transformer blocks.
    for i in range(12):
        src = f"{vit}.blocks.{i}"
        state[f"{src}.norm1.weight"] = tensor(768)
        state[f"{src}.norm1.bias"] = tensor(768)
        state[f"{src}.norm2.weight"] = tensor(768)
        state[f"{src}.norm2.bias"] = tensor(768)
        state[f"{src}.attn.qkv.weight"] = tensor(2304, 768)
        state[f"{src}.attn.qkv.bias"] = tensor(2304)
        state[f"{src}.attn.proj.weight"] = tensor(768, 768)
        state[f"{src}.attn.proj.bias"] = tensor(768)
        state[f"{src}.mlp.fc1.weight"] = tensor(3072, 768)
        state[f"{src}.mlp.fc1.bias"] = tensor(3072)
        state[f"{src}.mlp.fc2.weight"] = tensor(768, 3072)
        state[f"{src}.mlp.fc2.bias"] = tensor(768)

    # Reassemble.
    state["pretrained.act_postprocess3.0.project.0.weight"] = tensor(768, 1536)
    state["pretrained.act_postprocess3.0.project.0.bias"] = tensor(768)
    state["pretrained.act_postprocess4.0.project.0.weight"] = tensor(768, 1536)
    state["pretrained.act_postprocess4.0.project.0.bias"] = tensor(768)
    state["pretrained.act_postprocess3.3.weight"] = tensor(768, 768, 1, 1)
    state["pretrained.act_postprocess3.3.bias"] = tensor(768)
    state["pretrained.act_postprocess4.3.weight"] = tensor(768, 768, 1, 1)
    state["pretrained.act_postprocess4.3.bias"] = tensor(768)
    state["pretrained.act_postprocess4.4.weight"] = tensor(768, 768, 3, 3)
    state["pretrained.act_postprocess4.4.bias"] = tensor(768)

    # Scratch.
    for i, ch in enumerate([256, 512, 768, 768], start=1):
        state[f"scratch.layer{i}_rn.weight"] = tensor(256, ch, 3, 3)

    for name in ("refinenet1", "refinenet2", "refinenet3", "refinenet4"):
        src = f"scratch.{name}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            state[f"{src}.{unit}.conv1.weight"] = tensor(256, 256, 3, 3)
            state[f"{src}.{unit}.conv1.bias"] = tensor(256)
            state[f"{src}.{unit}.conv2.weight"] = tensor(256, 256, 3, 3)
            state[f"{src}.{unit}.conv2.bias"] = tensor(256)
        state[f"{src}.out_conv.weight"] = tensor(256, 256, 1, 1)
        state[f"{src}.out_conv.bias"] = tensor(256)

    # Head.
    state["scratch.output_conv.0.weight"] = tensor(128, 256, 3, 3)
    state["scratch.output_conv.0.bias"] = tensor(128)
    state["scratch.output_conv.2.weight"] = tensor(32, 128, 3, 3)
    state["scratch.output_conv.2.bias"] = tensor(32)
    state["scratch.output_conv.4.weight"] = tensor(1, 32, 1, 1)
    state["scratch.output_conv.4.bias"] = tensor(1)

    return state


def make_fake_biglama_state_dict(ngf=8, num_downsamples=2, num_blocks=2,
                                 ratio=0.75):
    """Random tensors with the exact saic-mdal/lama FFCResNetGenerator
    sequential layout (scaled-down config), wrapped like the released
    pytorch-lightning checkpoint (``state_dict`` with a ``generator.``
    prefix)."""
    import torch

    rng = np.random.default_rng(7)
    sd = {}

    def t(name, *shape, positive=False):
        arr = rng.normal(scale=0.1, size=shape).astype(np.float32)
        if positive:
            arr = np.abs(arr) + 0.5
        sd[f"generator.model.{name}"] = torch.from_numpy(arr)

    def bn(idx_prefix, c):
        t(f"{idx_prefix}.weight", c)
        t(f"{idx_prefix}.bias", c)
        t(f"{idx_prefix}.running_mean", c)
        t(f"{idx_prefix}.running_var", c, positive=True)

    def spectral(prefix, cin, cout):
        half = cout // 2
        t(f"{prefix}.conv1.0.weight", half, cin, 1, 1)
        bn(f"{prefix}.conv1.1", half)
        t(f"{prefix}.fu.conv_layer.weight", 2 * half, 2 * half, 1, 1)
        bn(f"{prefix}.fu.bn", 2 * half)
        t(f"{prefix}.conv2.weight", cout, half, 1, 1)

    # stem (model.1): 4 -> ngf, kernel 7, no global branch.
    t("1.ffc.convl2l.weight", ngf, 4, 7, 7)
    bn("1.bn_l", ngf)

    idx = 2
    feats = ngf
    for i in range(num_downsamples):
        last = i == num_downsamples - 1
        out = feats * 2
        out_g = int(out * ratio) if last else 0
        out_l = out - out_g
        t(f"{idx}.ffc.convl2l.weight", out_l, feats, 3, 3)
        bn(f"{idx}.bn_l", out_l)
        if last:
            t(f"{idx}.ffc.convl2g.weight", out_g, feats, 3, 3)
            bn(f"{idx}.bn_g", out_g)
        feats = out
        idx += 1

    cg = int(feats * ratio)
    cl = feats - cg
    for _ in range(num_blocks):
        for conv in ("conv1", "conv2"):
            p = f"{idx}.{conv}"
            t(f"{p}.ffc.convl2l.weight", cl, cl, 3, 3)
            t(f"{p}.ffc.convg2l.weight", cl, cg, 3, 3)
            t(f"{p}.ffc.convl2g.weight", cg, cl, 3, 3)
            spectral(f"{p}.ffc.convg2g", cg, cg)
            bn(f"{p}.bn_l", cl)
            bn(f"{p}.bn_g", cg)
        idx += 1

    idx += 1  # ConcatTupleLayer
    for _ in range(num_downsamples):
        t(f"{idx}.weight", feats, feats // 2, 3, 3)  # ConvTranspose2d (in,out)
        t(f"{idx}.bias", feats // 2)
        bn(f"{idx + 1}", feats // 2)
        feats //= 2
        idx += 3

    idx += 1  # ReflectionPad2d
    t(f"{idx}.weight", 3, feats, 7, 7)
    t(f"{idx}.bias", 3)

    return {"state_dict": sd, "epoch": 40}


def make_fake_torchvision_state_dict():
    """Random tensors with the exact torchvision maskrcnn_resnet50_fpn
    layout (classic naming variant)."""
    import torch

    rng = np.random.default_rng(42)
    sd = {}

    def t(*shape, scale=0.05):
        sd[name] = torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32))

    def conv(prefix, cout, cin, k):
        nonlocal name
        name = f"{prefix}.weight"; t(cout, cin, k, k)

    def conv_b(prefix, cout, cin, k):
        nonlocal name
        conv(prefix, cout, cin, k)
        name = f"{prefix}.bias"; t(cout)

    def bn(prefix, c):
        nonlocal name
        name = f"{prefix}.weight"; t(c)
        name = f"{prefix}.bias"; t(c)
        name = f"{prefix}.running_mean"; t(c)
        sd[f"{prefix}.running_var"] = torch.from_numpy(
            np.abs(rng.normal(size=c)).astype(np.float32) + 0.5)

    def fc(prefix, cout, cin):
        nonlocal name
        name = f"{prefix}.weight"; t(cout, cin)
        name = f"{prefix}.bias"; t(cout)

    name = ""
    conv("backbone.body.conv1", 64, 3, 7)
    bn("backbone.body.bn1", 64)

    cin = 64
    for stage, (blocks, width) in enumerate([(3, 64), (4, 128), (6, 256),
                                             (3, 512)]):
        for i in range(blocks):
            p = f"backbone.body.layer{stage + 1}.{i}"
            conv(f"{p}.conv1", width, cin if i == 0 else width * 4, 1)
            bn(f"{p}.bn1", width)
            conv(f"{p}.conv2", width, width, 3)
            bn(f"{p}.bn2", width)
            conv(f"{p}.conv3", width * 4, width, 1)
            bn(f"{p}.bn3", width * 4)
            if i == 0:
                conv(f"{p}.downsample.0", width * 4, cin, 1)
                bn(f"{p}.downsample.1", width * 4)
        cin = width * 4

    for i, c in enumerate([256, 512, 1024, 2048]):
        conv_b(f"backbone.fpn.inner_blocks.{i}", 256, c, 1)
        conv_b(f"backbone.fpn.layer_blocks.{i}", 256, 256, 3)

    conv_b("rpn.head.conv", 256, 256, 3)
    conv_b("rpn.head.cls_logits", 3, 256, 1)
    conv_b("rpn.head.bbox_pred", 12, 256, 1)

    fc("roi_heads.box_head.fc6", 1024, 256 * 7 * 7)
    fc("roi_heads.box_head.fc7", 1024, 1024)
    fc("roi_heads.box_predictor.cls_score", 91, 1024)
    fc("roi_heads.box_predictor.bbox_pred", 91 * 4, 1024)

    for i in range(4):
        conv_b(f"roi_heads.mask_head.mask_fcn{i + 1}", 256, 256, 3)
    name = "roi_heads.mask_predictor.conv5_mask.weight"
    t(256, 256, 2, 2)  # torch ConvTranspose2d: (in, out, kh, kw)
    name = "roi_heads.mask_predictor.conv5_mask.bias"
    t(256)
    conv_b("roi_heads.mask_predictor.mask_fcn_logits", 91, 256, 1)

    return sd


LPIPS_CONV_SHAPES = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
                     (256, 256, 3)]


def make_fake_lpips_state_dicts():
    """Random tensors with the torchvision AlexNet ``features.*`` layout and
    the lpips package's ``lin{i}.model.1`` head layout (weights/v0.1/alex)."""
    import torch

    rng = np.random.default_rng(0)

    alexnet = {}
    for src, (co, ci, k) in zip([0, 3, 6, 8, 10], LPIPS_CONV_SHAPES):
        alexnet[f"features.{src}.weight"] = torch.from_numpy(
            (rng.normal(size=(co, ci, k, k)) * 0.05).astype(np.float32))
        alexnet[f"features.{src}.bias"] = torch.from_numpy(
            (rng.normal(size=co) * 0.05).astype(np.float32))

    lins = {}
    for i, c in enumerate([64, 192, 384, 256, 256]):
        lins[f"lin{i}.model.1.weight"] = torch.from_numpy(
            np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32))

    return alexnet, lins


def lpips_torch_oracle(alexnet, lins, img_a, img_b) -> float:
    """LPIPS v0.1 re-implemented in torch on the raw state dicts (the
    numerical oracle the converted scorer must match)."""
    import torch
    import torch.nn.functional as F

    shift = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
    scale = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)

    def taps(img):
        x = torch.from_numpy(img.transpose(2, 0, 1)[None]
                             .astype(np.float32)) / 127.5 - 1.0
        x = (x - shift) / scale
        outs = []
        for j, (src, (_, _, k)) in enumerate(
                zip([0, 3, 6, 8, 10], LPIPS_CONV_SHAPES)):
            if j in (1, 2):
                x = F.max_pool2d(x, 3, stride=2)
            stride = 4 if j == 0 else 1
            pad = {0: 2, 1: 2}.get(j, 1)
            x = F.relu(F.conv2d(x, alexnet[f"features.{src}.weight"],
                                alexnet[f"features.{src}.bias"],
                                stride=stride, padding=pad))
            outs.append(x)
        return outs

    total = 0.0
    for j, (ta, tb) in enumerate(zip(taps(img_a), taps(img_b))):
        na = ta / (ta.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
        nb = tb / (tb.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
        diff = (na - nb) ** 2
        w = lins[f"lin{j}.model.1.weight"]
        total = total + F.conv2d(diff, w).mean()
    return float(total)


# ---------------------------------------------------------------------------
# The selftest runner.
# ---------------------------------------------------------------------------

# The fabricated big-lama's configuration.
LAMA_SMALL = dict(base_features=8, num_downsamples=2, num_blocks=2)


def _selftest_dpt(workdir: str, device) -> str:
    import torch

    from hive_tpu_torch.models.convert import convert_dpt
    from hive_tpu_torch.models.dpt import DPTDepthEstimator

    ckpt = os.path.join(workdir, "dpt_hybrid_nyu.pt")
    torch.save(make_fake_dpt_state_dict(), ckpt)
    convert_dpt(ckpt, workdir)

    estimator = DPTDepthEstimator(net_size=(96, 128), device=device)
    if not estimator.weights_loaded:
        raise AssertionError("the estimator did not pick up the converted npz")
    frame = np.random.default_rng(1).integers(0, 255, (1, 96, 128, 3)).astype(np.uint8)
    depth = estimator.predict_batch(frame)
    if not (np.isfinite(depth).all() and (depth > 0).all()):
        raise AssertionError("DPT gave non-finite or non-positive depth from converted weights")
    return "convert + load + forward ok (finite positive depth)"


def _selftest_lama(workdir: str, device) -> str:
    import torch

    from hive_tpu_torch.models import lama
    from hive_tpu_torch.models.convert import convert_lama

    ckpt = os.path.join(workdir, "best.ckpt")
    torch.save(make_fake_biglama_state_dict(), ckpt)
    out = convert_lama(ckpt, workdir, **LAMA_SMALL)

    model = lama.load_params(lama.build_generator(device, torch.float32, **LAMA_SMALL), out)
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.uniform(0, 1, (1, 3, 32, 32)).astype(np.float32))
    mask = torch.zeros(1, 1, 32, 32)
    mask[..., 8:16, 8:16] = 1.0
    with torch.no_grad():
        result = model(image.to(model.head.kernel.device),
                       mask.to(model.head.kernel.device)).cpu()
    if not torch.isfinite(result).all():
        raise AssertionError("LaMa gave non-finite values")
    known = (mask == 0).expand_as(image)
    err = float((result[known] - image[known]).abs().max())
    if err > 0:
        raise AssertionError(f"known pixels must pass through exactly (compositing); "
                             f"max |d| = {err:.2e}")
    return "convert + structure + forward ok (compositing exact)"


def _selftest_maskrcnn(workdir: str, device) -> str:
    import torch

    from hive_tpu_torch.models import maskrcnn
    from hive_tpu_torch.models.convert import convert_maskrcnn

    ckpt = os.path.join(workdir, "maskrcnn_resnet50_fpn.pth")
    torch.save(make_fake_torchvision_state_dict(), ckpt)
    out = convert_maskrcnn(ckpt, workdir)

    detector = maskrcnn.MaskRCNNDetector(maskrcnn.load_params(out, device), input_hw=(120, 160),
                                         canvas_min_side=160, canvas_max_side=224)
    frames = np.random.default_rng(0).integers(0, 255, (1, 120, 160, 3)).astype(np.uint8)
    detection = detector.detect_batch(frames)[0]
    if not np.isfinite(detection["boxes"]).all():
        raise AssertionError("Mask R-CNN gave non-finite boxes")
    mask = detector.paste(detection)
    if mask.shape != (120, 160) or mask.dtype != np.uint8:
        raise AssertionError("the instance mask broke the mask-id contract")
    return "convert + structure + detect ok (finite, mask contract holds)"


def _selftest_lpips(workdir: str, device) -> str:
    import torch

    from hive_tpu_torch.models import lpips
    from hive_tpu_torch.models.convert import convert_lpips

    alexnet, lins = make_fake_lpips_state_dicts()
    alex_path = os.path.join(workdir, "alexnet.pth")
    lin_path = os.path.join(workdir, "alex.pth")
    torch.save(alexnet, alex_path)
    torch.save(lins, lin_path)
    convert_lpips(alex_path, lin_path, workdir)

    scorer = lpips.load_scorer(device=device)
    if scorer is None:
        raise AssertionError("load_scorer did not pick up the converted npz")
    rng = np.random.default_rng(0)
    img_a = rng.integers(0, 255, (64, 80, 3)).astype(np.uint8)
    img_b = rng.integers(0, 255, (64, 80, 3)).astype(np.uint8)

    got = scorer(img_a, img_b)
    want = lpips_torch_oracle(alexnet, lins, img_a, img_b)
    if abs(got - want) >= 1e-3 * max(abs(want), 1.0):
        raise AssertionError(f"LPIPS {got:.6f} vs the torch oracle's {want:.6f} exceeds 1e-3 "
                             f"relative")
    if scorer(img_a, img_a) >= 1e-6:
        raise AssertionError("identical images must score ~0")
    return f"torch-oracle match ({got:.6f} vs {want:.6f}), self-score ~0"


def run_selftest(workdir: Optional[str] = None, device=None) -> int:
    """Run the four converter selftests, the networks on ``device``
    (default ``cuda:0``); returns the count of failures."""
    from hive_tpu_torch import get_device

    device = get_device(device)
    stages: List[Tuple[str, Callable[[str, object], str]]] = [
        ("lpips", _selftest_lpips),
        ("lama", _selftest_lama),
        ("maskrcnn", _selftest_maskrcnn),
        ("dpt", _selftest_dpt),
    ]

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="hive_convert_selftest_")
        workdir = own_tmp.name

    # The runtime loaders read $WEIGHTS_PATH: point them at the workdir for
    # the duration, so that the selftest takes the path users take.
    saved = os.environ.get("WEIGHTS_PATH")
    os.environ["WEIGHTS_PATH"] = workdir

    failures = 0
    try:
        for label, stage in stages:
            start = time.monotonic()
            try:
                detail = stage(workdir, device)
                print(f"[ok] {label}: {detail} ({time.monotonic() - start:.1f} s)")
            except Exception as exc:  # noqa: BLE001 — run the rest, report all
                failures += 1
                print(f"[FAILED] {label}: {type(exc).__name__}: {exc}")
    finally:
        if saved is None:
            os.environ.pop("WEIGHTS_PATH", None)
        else:
            os.environ["WEIGHTS_PATH"] = saved
        if own_tmp is not None:
            own_tmp.cleanup()

    if failures:
        print(f"{failures} converter selftest(s) FAILED: do not trust conversions of real "
              f"checkpoints until this passes.")
    else:
        print("All converter selftests passed: the conversion path is sound. Now run "
              "`python -m hive_tpu_torch.models.convert --all <dir>` on the real checkpoints.")
    return failures
