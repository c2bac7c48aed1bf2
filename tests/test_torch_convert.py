"""The weights tooling (hive_tpu_torch.models.lpips, .convert, .selftest)
against hive_tpu's.

* LPIPS: both converters write one npz from the reference selftest's fake
  torchvision AlexNet and lpips heads; the port's score equals hive_tpu's
  within 1e-5 relative (measured: 1e-7) and the torch oracle's within the
  reference selftest's 1e-3 relative; identical images score ~0.
* The converters refuse a checkpoint with an extra tensor and tolerate BN
  trip counters.
* The CLI: ``--selftest`` routing, ``--all`` over a folder of released file
  names, an empty folder, the torch-hub hash check, as
  tests/test_weight_conversion.py holds hive_tpu's.
* ``run_selftest`` end to end on the CPU, and the selftest's fabricated
  checkpoints equal to the reference's (the two full-size ones compared by
  the draws they make).
"""

import hashlib

import numpy as np
import pytest
import torch

from hive_tpu.models import lpips as jax_lpips
from hive_tpu.models import selftest as jax_selftest
from hive_tpu_torch.models import convert, lama, lpips, selftest


def save_fake_lpips(folder):
    alexnet, lins = selftest.make_fake_lpips_state_dicts()
    torch.save(alexnet, folder / "alexnet.pth")
    torch.save(lins, folder / "lpips_alex.pth")
    return alexnet, lins


def test_lpips_matches_hive_tpu_and_the_oracle(tmp_path):
    alexnet, lins = save_fake_lpips(tmp_path)
    paths = (str(tmp_path / "alexnet.pth"), str(tmp_path / "lpips_alex.pth"))
    jax_lpips.convert_torch_checkpoint(*paths, str(tmp_path / "jax.npz"))
    lpips.convert_torch_checkpoint(*paths, str(tmp_path / "torch.npz"))
    with np.load(tmp_path / "jax.npz") as theirs, np.load(tmp_path / "torch.npz") as ours:
        assert sorted(ours.files) == sorted(theirs.files)
        for key in theirs.files:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)

    rng = np.random.default_rng(0)
    img_a = rng.integers(0, 255, (64, 80, 3)).astype(np.uint8)
    img_b = rng.integers(0, 255, (64, 80, 3)).astype(np.uint8)
    scorer = lpips.LPIPSScorer(str(tmp_path / "torch.npz"), device="cpu")
    got = scorer(img_a, img_b)
    want = jax_lpips.LPIPSScorer(jax_lpips.load_params(str(tmp_path / "jax.npz")))(img_a, img_b)
    oracle = selftest.lpips_torch_oracle(alexnet, lins, img_a, img_b)
    assert got > 0.1
    assert abs(got - want) <= 1e-5 * abs(want)
    assert abs(got - oracle) <= 1e-3 * abs(oracle)
    assert scorer(img_a, img_a) < 1e-6


def test_load_scorer_reads_weights_path(tmp_path, monkeypatch):
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    assert lpips.load_scorer(device="cpu") is None
    save_fake_lpips(tmp_path)
    lpips.convert_torch_checkpoint(str(tmp_path / "alexnet.pth"),
                                   str(tmp_path / "lpips_alex.pth"),
                                   str(tmp_path / "lpips_alex.npz"))
    assert isinstance(lpips.load_scorer(device="cpu"), lpips.LPIPSScorer)


def test_converters_refuse_an_extra_tensor(tmp_path):
    alexnet, lins = selftest.make_fake_lpips_state_dicts()
    alexnet["features.12.weight"] = torch.zeros(2)
    torch.save(alexnet, tmp_path / "alexnet.pth")
    torch.save(lins, tmp_path / "lins.pth")
    with pytest.raises(ValueError, match="features.12.weight"):
        lpips.convert_torch_checkpoint(str(tmp_path / "alexnet.pth"), str(tmp_path / "lins.pth"),
                                       str(tmp_path / "out.npz"))

    state = selftest.make_fake_biglama_state_dict()
    state["state_dict"]["generator.model.1.extra"] = torch.zeros(2)
    torch.save(state, tmp_path / "best.ckpt")
    with pytest.raises(ValueError, match="model.1.extra"):
        lama.convert_torch_checkpoint(str(tmp_path / "best.ckpt"), str(tmp_path / "out.npz"),
                                      **selftest.LAMA_SMALL)


def test_converters_tolerate_bn_counters(tmp_path):
    state = selftest.make_fake_biglama_state_dict()
    state["state_dict"]["generator.model.1.bn_l.num_batches_tracked"] = torch.tensor(5)
    torch.save(state, tmp_path / "best.ckpt")
    out = lama.convert_torch_checkpoint(str(tmp_path / "best.ckpt"), str(tmp_path / "out.npz"),
                                        **selftest.LAMA_SMALL)
    assert "stem/bn_l/scale" in out


class RecordingRng:
    """Stands in for ``np.random.default_rng``: records each draw's
    arguments and returns zeros, so that two fabricators of a full-size
    checkpoint are compared by the draws they make (a real generator with
    one seed would return the same values for the same draws) without
    drawing 122M normals each."""

    def __init__(self, seed):
        self.calls = [("seed", seed)]
        RecordingRng.last = self

    def normal(self, loc=0.0, scale=1.0, size=None):
        self.calls.append(("normal", loc, scale, tuple(np.atleast_1d(size))))
        return np.zeros(size)


@pytest.mark.parametrize("name", ["make_fake_dpt_state_dict", "make_fake_torchvision_state_dict"])
def test_full_size_fabricators_draw_as_the_references(monkeypatch, name):
    draws = []
    for module in (selftest, jax_selftest):
        monkeypatch.setattr(np.random, "default_rng", RecordingRng)
        state = getattr(module, name)()
        monkeypatch.undo()
        draws.append((RecordingRng.last.calls,
                      [(key, tuple(value.shape), value.dtype) for key, value in state.items()]))
    assert draws[0] == draws[1]
    assert len(draws[0][0]) > 100


def test_small_fabricators_equal_the_references():
    ours = selftest.make_fake_biglama_state_dict()
    theirs = jax_selftest.make_fake_biglama_state_dict()
    assert ours["epoch"] == theirs["epoch"]
    assert list(ours["state_dict"]) == list(theirs["state_dict"])
    for key, value in theirs["state_dict"].items():
        assert torch.equal(ours["state_dict"][key], value), key
    for ours, theirs in zip(selftest.make_fake_lpips_state_dicts(),
                            jax_selftest.make_fake_lpips_state_dicts()):
        assert list(ours) == list(theirs)
        assert all(torch.equal(ours[key], theirs[key]) for key in theirs)


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

def test_selftest_flag_invokes_runner(monkeypatch):
    calls = []
    monkeypatch.setattr(selftest, "run_selftest",
                        lambda device=None: calls.append(device) or 0)
    assert convert.main(["--selftest", "--device", "cpu"]) == 0
    monkeypatch.setattr(selftest, "run_selftest", lambda device=None: 2)
    assert convert.main(["--selftest"]) == 1
    assert calls == ["cpu"]


def test_all_converts_found_checkpoints_and_skips_missing(tmp_path, capsys):
    """--all over a folder holding a big-lama and the LPIPS pair under
    their released names: both convert (the npz files hive_tpu reads); DPT
    and Mask R-CNN are reported as skipped."""
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    torch.save(selftest.make_fake_biglama_state_dict(), ckpts / "big-lama.ckpt")
    save_fake_lpips(ckpts)

    out = tmp_path / "weights"
    rc = convert.main(["--all", str(ckpts), "--output", str(out),
                       "--lama_base_features", "8", "--lama_num_downsamples", "2",
                       "--lama_num_blocks", "2"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    assert sorted(p.name for p in out.iterdir()) == ["big-lama.npz", "lpips_alex.npz"]
    assert "[skipped] no checkpoint found for: dpt, maskrcnn" in captured.out
    lama.load_params(lama.LamaGenerator(**selftest.LAMA_SMALL), str(out / "big-lama.npz"))


def test_empty_folder_fails_with_expected_names(tmp_path, capsys):
    empty = tmp_path / "none"
    empty.mkdir()
    assert convert.main(["--all", str(empty), "--output", str(tmp_path / "w")]) == 1
    err = capsys.readouterr().err
    assert "dpt_hybrid_nyu.pt" in err and "big-lama.ckpt" in err


def test_nothing_to_do_is_an_error(capsys):
    with pytest.raises(SystemExit):
        convert.main([])


def test_hub_hash_verification(tmp_path):
    payload = b"synthetic-checkpoint-bytes"
    good = tmp_path / f"dpt_hybrid_nyu-{hashlib.sha256(payload).hexdigest()[:8]}.pt"
    good.write_bytes(payload)
    bad = tmp_path / "dpt_hybrid_nyu-2ce69ec7.pt"
    bad.write_bytes(payload)
    unhashed = tmp_path / "dpt_hybrid_nyu.pt"
    unhashed.write_bytes(payload)

    assert convert.verify_hub_hash(str(good)) is True
    assert convert.verify_hub_hash(str(bad)) is False
    assert convert.verify_hub_hash(str(unhashed)) is None


def test_corrupt_hub_download_fails_loudly(tmp_path, capsys):
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    (ckpts / "dpt_hybrid_nyu-2ce69ec7.pt").write_bytes(b"junk")
    assert convert.main(["--all", str(ckpts), "--output", str(tmp_path / "w")]) == 1
    assert "SHA256" in capsys.readouterr().err


def test_run_selftest_end_to_end(tmp_path, capsys):
    """Fabricate the four checkpoints, convert, load through the runtime
    loaders, run each network on the CPU."""
    assert selftest.run_selftest(str(tmp_path), device="cpu") == 0
    out = capsys.readouterr().out
    for label in ("lpips", "lama", "maskrcnn", "dpt"):
        assert f"[ok] {label}:" in out
