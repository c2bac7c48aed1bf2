"""``hive_tpu_torch.models.lpips.load_scorer`` against hive_tpu's: the same
signature (``weights_filename`` first, default ``lpips_alex.npz``; the port
adds ``device`` as a keyword), ``None`` without the file, and a warning and
``None`` for a file that does not load.

A truncated npz (``zipfile.BadZipFile``) gives ``None`` and a warning in both
packages. A file whose keys do not fit the model: the port's loader checks
the keys, warns and gives ``None``; hive_tpu's builds a scorer that raises at
its first call (flax looks the parameters up lazily). That is a difference
by design, named here."""

import inspect
import logging

import numpy as np
import pytest
import torch

from hive_tpu.models import lpips as jax_lpips
from hive_tpu_torch.models import lpips, selftest


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """``$WEIGHTS_PATH`` holding a good ``lpips_alex.npz`` (the selftest's
    fake AlexNet and heads, converted), a truncated copy and a copy with
    one key renamed."""
    alexnet, lins = selftest.make_fake_lpips_state_dicts()
    torch.save(alexnet, tmp_path / "alexnet.pth")
    torch.save(lins, tmp_path / "lins.pth")
    good = tmp_path / "lpips_alex.npz"
    lpips.convert_torch_checkpoint(str(tmp_path / "alexnet.pth"), str(tmp_path / "lins.pth"),
                                   str(good))
    blob = good.read_bytes()
    (tmp_path / "truncated.npz").write_bytes(blob[:len(blob) // 2])
    with np.load(good) as flat:
        arrays = dict(flat)
    key = sorted(arrays)[0]
    arrays["renamed/" + key] = arrays.pop(key)
    np.savez(tmp_path / "wrong_key.npz", **arrays)
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path))
    return tmp_path


def test_load_scorer_signature_matches_hive_tpu():
    ours = inspect.signature(lpips.load_scorer).parameters
    theirs = inspect.signature(jax_lpips.load_scorer).parameters
    assert list(theirs) == ["weights_filename"]
    assert list(ours)[:1] == ["weights_filename"]
    assert ours["weights_filename"].default == theirs["weights_filename"].default
    assert ours["device"].kind is inspect.Parameter.KEYWORD_ONLY


def test_good_and_missing_files_load_as_in_hive_tpu(weights):
    assert isinstance(lpips.load_scorer(device="cpu"), lpips.LPIPSScorer)
    assert isinstance(jax_lpips.load_scorer(), jax_lpips.LPIPSScorer)
    assert lpips.load_scorer("missing.npz", device="cpu") is None
    assert jax_lpips.load_scorer("missing.npz") is None


def test_truncated_file_warns_and_gives_none_in_both(weights, caplog):
    with caplog.at_level(logging.WARNING):
        assert lpips.load_scorer("truncated.npz", device="cpu") is None
        assert jax_lpips.load_scorer("truncated.npz") is None
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 2
    assert all(w.startswith("Could not load LPIPS weights") for w in warnings)


def test_wrong_key_warns_at_load_in_the_port(weights, caplog):
    """The named difference: the port refuses the file at load; hive_tpu's
    scorer fails at its first call."""
    with caplog.at_level(logging.WARNING):
        assert lpips.load_scorer("wrong_key.npz", device="cpu") is None
    assert any("do not fit the model" in r.getMessage() for r in caplog.records)

    scorer = jax_lpips.load_scorer("wrong_key.npz")
    assert scorer is not None
    image = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(Exception, match="conv0"):
        scorer(image, image)


def test_model_state_follows_the_device_context():
    """Every parameter and buffer of ``LPIPSAlex`` is made on the device of
    the ``torch.device`` context it is built in, as ``LPIPSScorer`` builds it
    (the normalisation buffers came from ``torch.from_numpy`` and stayed on
    the CPU, so a scorer on the card failed at its first call)."""
    with torch.device("meta"):
        model = lpips.LPIPSAlex()
    assert {t.device.type for t in (*model.parameters(), *model.buffers())} == {"meta"}
