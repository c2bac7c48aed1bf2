"""hive_tpu_torch.scripts.compare_image_pair(s) against
scripts/compare_image_pair(s).py on the CPU, on seeded textured pairs
(96 x 128: blurred binary noise and a copy moved by a sub-pixel shift) as
RGB, grey and RGBA PNGs and RGB and grey JPEGs.

Tolerances, those of tests/test_torch_render_metrics.py: SSIM within 1e-9
(``metrics.ssim_psnr`` follows the host ``ssim``'s float64 correlation;
cv2's ``filter2D`` in hive_tpu may take its DFT route), PSNR equal (the
squared error summed exactly), MIFD within MIFD_RTOL (the port's SIFT and
exact k-NN against cv2's SIFT and FLANN), LPIPS NaN in both without
weights and within 1e-4 relative with the same check weights. The two
loaders (``io.load_image`` and imageio) give equal pixels. Printed outputs
are held token by token: text equal, numbers within those tolerances at
their printed precision.
"""

import json
import os
import re
import sys

import cv2
import imageio.v3 as iio
import numpy as np
import pytest
import torch

from hive_tpu import metrics as jax_metrics
from hive_tpu_torch import metrics
from hive_tpu_torch.io import load_image
from hive_tpu_torch.scripts import compare_image_pair, compare_image_pairs
from scripts import compare_image_pair as jax_pair
from scripts import compare_image_pairs as jax_pairs

MIFD_RTOL = 0.01
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


@pytest.fixture(autouse=True)
def no_lpips_weights(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(metrics, "_lpips_models", {})
    monkeypatch.setattr(jax_metrics, "_lpips_model", None)
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "weights"))
    # scripts/compare_image_pairs.py imports its sibling by its bare name.
    monkeypatch.syspath_prepend(SCRIPTS)
    return tmp_path / "weights"


def _pair(seed, kind, shape=(96, 128)):
    rng = np.random.default_rng(seed)
    noise = ((rng.uniform(0, 255, shape) > 127) * 255).astype(np.uint8)
    grey = cv2.GaussianBlur(noise, (5, 5), 1.0)
    moved = cv2.warpAffine(grey, np.float32([[1, 0, 2.3], [0, 1, -1.7]]), shape[::-1])
    if kind == "grey":
        return grey, moved
    tint = rng.integers(0, 40, 3)
    a, b = (np.clip(np.stack([x, 255 - x, x // 2], -1) + tint, 0, 255).astype(np.uint8)
            for x in (grey, moved))
    if kind == "rgba":
        alpha = rng.integers(0, 256, (*shape, 1)).astype(np.uint8)
        a, b = np.concatenate([a, alpha], -1), np.concatenate([b, alpha], -1)
    return a, b


def _write_pair(folder, seed, kind, ext, names=("a", "b")):
    os.makedirs(folder, exist_ok=True)
    paths = []
    for name, image in zip(names, _pair(seed, kind)):
        path = os.path.join(folder, f"{name}.{ext}")
        iio.imwrite(path, image)
        paths.append(path)
    return paths


def _assert_metrics_close(got, want):
    assert list(got) == list(want)
    for metric, w in want.items():
        g = got[metric]
        if w is None or np.isnan(w):
            assert g is None or np.isnan(g), (metric, g, w)
            continue
        tolerance = {"ssim": 1e-9, "psnr": 0.0, "lpips": 1e-4 * abs(w),
                     "mifd": MIFD_RTOL * abs(w)}[metric]
        assert abs(g - w) <= tolerance, (metric, g, w)


NUMBER = re.compile(r"-?\d[\d,]*\.\d+|-?inf|nan")


def _assert_text_close(got: str, want: str):
    """Equal text with numbers within MIFD_RTOL (plus their last printed
    digit); every other number prints the same to the digit."""
    assert NUMBER.split(got) == NUMBER.split(want)
    for g, w in zip(NUMBER.findall(got), NUMBER.findall(want)):
        if g == w:
            continue
        step = 10.0 ** -len(w.split(".")[1])
        gv, wv = float(g.replace(",", "")), float(w.replace(",", ""))
        assert abs(gv - wv) <= MIFD_RTOL * abs(wv) + step, (g, w)


CASES = [("rgb", "png"), ("grey", "png"), ("rgba", "png"), ("rgb", "jpg"), ("grey", "jpg")]


@pytest.mark.parametrize("kind,ext", CASES)
def test_compare_images_matches_hive_tpu(tmp_path, kind, ext):
    path_a, path_b = _write_pair(tmp_path / "pair", 1, kind, ext)
    images = []
    for path in (path_a, path_b):
        got, want = compare_image_pair.ensure_rgb(load_image(path)), jax_pair.ensure_rgb(
            iio.imread(path))
        assert got.shape == want.shape and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want)
        images.append(got)
    got = compare_image_pair.compare_images(*images, device="cpu")
    want = jax_pair.compare_images(*images)
    _assert_metrics_close(got, want)
    assert np.isnan(got["lpips"]) and np.isfinite(got["mifd"]) and got["mifd"] > 1.0


def test_compare_images_with_lpips_weights_matches_hive_tpu(no_lpips_weights):
    from hive_tpu_torch.models import lpips as lpips_model

    no_lpips_weights.mkdir()
    np.savez(no_lpips_weights / lpips_model.WEIGHTS_FILENAME, **lpips_model.check_params(5))
    a, b = _pair(2, "rgb")
    got = compare_image_pair.compare_images(a, b, device="cpu")
    want = jax_pair.compare_images(a, b)
    assert np.isfinite(got["lpips"])
    _assert_metrics_close(got, want)


def _run_jax_main(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["script", *argv])
    main()
    return capsys.readouterr().out


@pytest.mark.parametrize("as_json", [False, True])
@pytest.mark.parametrize("same", [False, True])
def test_pair_main_matches_hive_tpu(tmp_path, monkeypatch, capsys, as_json, same):
    path_a, path_b = _write_pair(tmp_path / "pair", 3, "rgb", "png")
    argv = [path_a, path_a if same else path_b] + (["--json"] if as_json else [])
    compare_image_pair.main(argv, device="cpu")
    got = capsys.readouterr().out
    want = _run_jax_main(jax_pair.main, argv, monkeypatch, capsys)
    if as_json:
        got, want = json.loads(got), json.loads(want)
        assert got.pop("skipped") == want.pop("skipped") == {"lpips": "skipped: weights absent"}
        _assert_metrics_close(got, want)
        assert got["lpips"] is None
        if same:
            assert got["psnr"] is None and got["ssim"] == 1.0 and got["mifd"] == 0.0
    else:
        _assert_text_close(got, want)
        assert "LPIPS: skipped (weights absent)" in got
        if same:
            assert "  PSNR: inf" in got


def test_pair_main_refusals_match_hive_tpu(tmp_path, monkeypatch):
    path_a, _ = _write_pair(tmp_path / "a", 4, "rgb", "png")
    iio.imwrite(tmp_path / "small.png", np.zeros((32, 48, 3), np.uint8))
    argv = [path_a, str(tmp_path / "small.png")]
    with pytest.raises(RuntimeError) as got:
        compare_image_pair.main(argv, device="cpu")
    monkeypatch.setattr(sys, "argv", ["script", *argv])
    with pytest.raises(RuntimeError) as want:
        jax_pair.main()
    assert str(got.value) == str(want.value) == (
        "Image shapes differ: (96, 128, 3) vs (32, 48, 3)")


def _folders(tmp_path):
    """Three pairs: RGB PNG, grey JPEG, RGBA PNG, named so that sorting
    pairs them."""
    folder_a, folder_b = tmp_path / "A", tmp_path / "B"
    for index, (kind, ext) in enumerate([("rgb", "png"), ("grey", "jpg"), ("rgba", "png")]):
        for folder, image in zip((folder_a, folder_b), _pair(10 + index, kind)):
            os.makedirs(folder, exist_ok=True)
            iio.imwrite(folder / f"{index:02d}_{kind}.{ext}", image)
    return str(folder_a), str(folder_b)


def test_compare_folders_and_latex_match_hive_tpu(tmp_path):
    folder_a, folder_b = _folders(tmp_path)
    got = compare_image_pairs.compare_folders(folder_a, folder_b, device="cpu")
    want = jax_pairs.compare_folders(folder_a, folder_b)
    assert [row["name"] for row in got["pairs"]] == [row["name"] for row in want["pairs"]]
    for got_row, want_row in zip(got["pairs"], want["pairs"]):
        _assert_metrics_close({k: v for k, v in got_row.items() if k != "name"},
                              {k: v for k, v in want_row.items() if k != "name"})
    _assert_metrics_close(got["mean"], want["mean"])
    assert got["skipped"] == want["skipped"] == {"lpips": "skipped: weights absent"}
    # The same results give the same table, byte for byte.
    for results in (got, want):
        assert compare_image_pairs.to_latex(results) == jax_pairs.to_latex(results)
    assert "Mean & " in compare_image_pairs.to_latex(got)
    assert "skipped: weights absent" in compare_image_pairs.to_latex(got)


@pytest.mark.parametrize("latex", [False, True])
def test_pairs_main_matches_hive_tpu(tmp_path, monkeypatch, capsys, latex):
    folder_a, folder_b = _folders(tmp_path)
    argv = [folder_a, folder_b] + (["--latex"] if latex else [])
    compare_image_pairs.main(argv, device="cpu")
    got = capsys.readouterr().out
    want = _run_jax_main(jax_pairs.main, argv, monkeypatch, capsys)
    _assert_text_close(got, want)
    assert ("skipped: weights absent" in got) and (
        latex or "note: lpips skipped: weights absent" in got)


def test_pairs_count_refusal_matches_hive_tpu(tmp_path):
    folder_a, folder_b = _folders(tmp_path)
    os.remove(os.path.join(folder_b, sorted(os.listdir(folder_b))[0]))
    with pytest.raises(RuntimeError) as got:
        compare_image_pairs.compare_folders(folder_a, folder_b, device="cpu")
    with pytest.raises(RuntimeError) as want:
        jax_pairs.compare_folders(folder_a, folder_b)
    assert str(got.value) == str(want.value) == "Folders contain different image counts: 3 vs 2"


def test_entry_points_refuse_without_a_card(tmp_path):
    """Without CUDA the entry points run only where the CPU was asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path_a, path_b = _write_pair(tmp_path / "pair", 5, "grey", "png")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compare_image_pair.main([path_a, path_b])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compare_image_pairs.compare_folders(str(tmp_path / "pair"), str(tmp_path / "pair"))
