"""The port's PNG and JPEG codecs (hive_tpu_torch.image_codecs, io.decode_png)
against Pillow, which the JAX package uses for the same files: PNG pixels
round-trip exactly; JPEG is held to Pillow's own quality-92 encode and decode
by bounds, since libjpeg's integer DCT and ours round differently."""

import io

import numpy as np
import pytest
from PIL import Image

from hive_tpu_torch.image_codecs import decode_jpeg, encode_jpeg, encode_png, quality_tables
from hive_tpu_torch.io import decode_png


def natural_crop(seed=0, height=192, width=256):
    """A smooth colour gradient plus sensor-like noise."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height, 0:width]
    base = np.stack([xs * 255 / width, ys * 255 / height, (xs + ys) * 255 / (width + height)], -1)
    return np.clip(base + rng.normal(0, 8, (height, width, 3)), 0, 255).astype(np.uint8)


def pillow_jpeg(image, quality=92):
    out = io.BytesIO()
    Image.fromarray(image).save(out, format="JPEG", quality=quality)
    return out.getvalue()


def pillow_decode(blob):
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "grey_alpha", "grey16", "odd_size"])
def test_png_round_trips_exactly(kind):
    rng = np.random.default_rng(1)
    image = {
        "rgb": natural_crop(1),
        "rgba": np.dstack([natural_crop(2), rng.integers(0, 256, (192, 256), dtype=np.uint8)]),
        "grey": natural_crop(3)[..., 1],
        "grey_alpha": natural_crop(4)[..., :2],
        "grey16": rng.integers(0, 65536, (61, 83)).astype(np.uint16),
        "odd_size": rng.integers(0, 256, (1, 7, 3), dtype=np.uint8),
    }[kind]
    blob = encode_png(image)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))), image)
    # decode_png gives the arrays the HIVE loader wants: colour as RGB with
    # alpha dropped, grey + alpha as RGB.
    ours = decode_png(blob)
    want = {"rgba": image[..., :3], "grey_alpha": np.repeat(image[..., :1], 3, axis=-1)}
    np.testing.assert_array_equal(ours, want.get(kind, image))
    assert ours.dtype == image.dtype


def test_png_filters_compress_like_pillow():
    image = natural_crop(5)
    ours = len(encode_png(image))
    out = io.BytesIO()
    Image.fromarray(image).save(out, format="PNG")
    assert ours <= 1.15 * len(out.getvalue())


def test_png_refuses_what_it_cannot_write():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 5), np.uint8))


def test_jpeg_quality_tables_are_pillows():
    """Our q92 DQT and DHT segments are the bytes Pillow writes."""
    ours, theirs = encode_jpeg(natural_crop(6)), pillow_jpeg(natural_crop(6))

    def segments(blob, marker):
        found, pos = [], 2
        while blob[pos + 1] != 0xDA:
            length = int.from_bytes(blob[pos + 2:pos + 4], "big")
            if blob[pos + 1] == marker:
                found.append(blob[pos + 4:pos + 2 + length])
            pos += 2 + length
        return found

    assert b"".join(segments(ours, 0xDB)) == b"".join(segments(theirs, 0xDB))
    assert b"".join(segments(ours, 0xC4)) == b"".join(segments(theirs, 0xC4))
    luma, chroma = quality_tables(92)
    assert luma[0] == 3 and chroma[0] == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_jpeg_encode_matches_pillow_quality_and_size(seed):
    image = natural_crop(seed)
    ours, theirs = encode_jpeg(image, 92), pillow_jpeg(image, 92)
    ours_psnr = psnr(pillow_decode(ours), image)
    theirs_psnr = psnr(pillow_decode(theirs), image)
    assert abs(ours_psnr - theirs_psnr) <= 0.5, (ours_psnr, theirs_psnr)
    assert len(ours) <= 1.15 * len(theirs), (len(ours), len(theirs))


@pytest.mark.parametrize("shape", [(192, 256), (37, 53), (1, 1), (17, 16), (120, 201)])
def test_jpeg_decode_matches_pillow(shape):
    rng = np.random.default_rng(shape[0])
    image = natural_crop(7, *shape) if min(shape) > 16 else rng.integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    for blob in (pillow_jpeg(image), encode_jpeg(image)):
        ours, theirs = decode_jpeg(blob), pillow_decode(blob)
        assert ours.shape == theirs.shape == image.shape and ours.dtype == np.uint8
        assert np.abs(ours.astype(np.int64) - theirs).mean() <= 1.0


def test_jpeg_decode_grey_and_restart_intervals():
    grey = natural_crop(8)[..., 0]
    out = io.BytesIO()
    Image.fromarray(grey).save(out, format="JPEG", quality=80)
    ours = decode_jpeg(out.getvalue())
    assert ours.shape == grey.shape
    assert np.abs(ours.astype(np.int64) - pillow_decode(out.getvalue())[..., 0]).mean() <= 1.0

    # Restart markers after every MCU row (a DRI segment, RSTn in the scan).
    image = natural_crop(9, 64, 80)
    out = io.BytesIO()
    Image.fromarray(image).save(out, format="JPEG", quality=92, restart_marker_rows=1)
    blob = out.getvalue()
    assert b"\xff\xdd" in blob and b"\xff\xd0" in blob
    ours, theirs = decode_jpeg(blob), pillow_decode(blob)
    assert np.abs(ours.astype(np.int64) - theirs).mean() <= 1.0


def test_jpeg_refuses_progressive_and_non_rgb():
    out = io.BytesIO()
    Image.fromarray(natural_crop(10, 32, 32)).save(out, format="JPEG", progressive=True)
    with pytest.raises(NotImplementedError, match="progressive"):
        decode_jpeg(out.getvalue())
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError):
        decode_jpeg(b"not a jpeg")
