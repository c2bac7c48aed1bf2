"""The port's PNG and JPEG codecs (hive_tpu_torch.image_codecs, io.decode_png)
against Pillow, which the JAX package uses for the same files: PNG pixels
round-trip exactly, and palette, 1/2/4-bit grey and interlaced (Adam7) PNGs
decode to Pillow's arrays; JPEG (baseline, progressive, non-interleaved)
decodes to Pillow's pixels bit for bit (libjpeg's islow IDCT and fancy
upsampling), natively and with the plain Python decoder; the encoder
writes Pillow's bytes (libjpeg's islow DCT and edge handling); and
ImageFolderDataset reads a folder of JPEGs as hive_tpu's does."""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from hive_tpu.io import ImageFolderDataset as JaxImageFolderDataset
from hive_tpu_torch.image_codecs import decode_jpeg, encode_jpeg, encode_png, quality_tables
from hive_tpu_torch.io import ImageFolderDataset, decode_png, load_image


def natural_crop(seed=0, height=192, width=256):
    """A smooth colour gradient plus sensor-like noise."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height, 0:width]
    base = np.stack([xs * 255 / width, ys * 255 / height, (xs + ys) * 255 / (width + height)], -1)
    return np.clip(base + rng.normal(0, 8, (height, width, 3)), 0, 255).astype(np.uint8)


def pillow_jpeg(image, quality=92, **options):
    out = io.BytesIO()
    Image.fromarray(image).save(out, format="JPEG", quality=quality, **options)
    return out.getvalue()


def assert_decodes_as_pillow(blob):
    """Native and plain decodes both equal Pillow's pixels."""
    with Image.open(io.BytesIO(blob)) as image:
        want = np.asarray(image)
    for native in (True, False):
        got = decode_jpeg(blob, native=native)
        assert got.dtype == np.uint8 and got.shape == want.shape, native
        np.testing.assert_array_equal(got, want, err_msg=f"native={native}")


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


def test_png_native_unfilter_equals_plain():
    """The native unfilter against the numpy wavefronts, on images whose
    rows use all five filter types, 8- and 16-bit, 1 to 4 channels."""
    rng = np.random.default_rng(6)
    images = [natural_crop(6), natural_crop(7)[..., 0],
              np.dstack([natural_crop(8), rng.integers(0, 256, (192, 256), dtype=np.uint8)]),
              (natural_crop(9)[..., 1].astype(np.uint16) * 257)[:61, :83]]
    types = set()
    for image in images:
        blob = encode_png(image)
        rows = zlib.decompress(blob[blob.index(b"IDAT") + 4:blob.index(b"IEND") - 8])
        stride = len(rows) // image.shape[0]
        types |= set(rows[::stride])
        ours = decode_png(blob, native=True)
        np.testing.assert_array_equal(ours, decode_png(blob, native=False))
        np.testing.assert_array_equal(ours, image if image.ndim == 2 else image[..., :3])
    assert types == {0, 1, 2, 3, 4}


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
    """The texture setting (quality 92): Pillow's bytes, so its quality and
    size too."""
    image = natural_crop(seed)
    assert encode_jpeg(image, 92) == pillow_jpeg(image, 92)


@pytest.mark.parametrize("shape, quality", [
    ((48, 64), 75), ((480, 640), 75), ((37, 53), 75), ((53, 37), 75), ((17, 33), 75),
    ((9, 9), 75), ((1, 1), 75), ((2, 3), 75), ((16, 24), 75), ((24, 16), 75),
    ((48, 64), 100), ((48, 64), 10), ((37, 53), 92)])
def test_jpeg_encode_writes_pillows_bytes(shape, quality):
    """Quality 75 4:2:0 is how hive_tpu writes converted frames: libjpeg's
    colour conversion, downsampling, islow DCT and quantiser, and at sizes
    that are not whole MCUs its edge padding and dummy blocks, give the same
    file byte for byte, on a noisy gradient and on pure noise."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + quality)
    images = [natural_crop(shape[0], *shape) if min(shape) > 1 else None,
              rng.integers(0, 256, (*shape, 3), dtype=np.uint8)]
    for image in filter(lambda x: x is not None, images):
        assert encode_jpeg(image, quality) == pillow_jpeg(image, quality)


@pytest.mark.parametrize("shape", [(192, 256), (37, 53), (1, 1), (17, 16), (120, 201)])
def test_jpeg_decode_matches_pillow(shape):
    rng = np.random.default_rng(shape[0])
    image = natural_crop(7, *shape) if min(shape) > 16 else rng.integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    for blob in (pillow_jpeg(image), encode_jpeg(image)):
        assert decode_jpeg(blob).shape == image.shape
        assert_decodes_as_pillow(blob)


def test_jpeg_decode_grey_and_restart_intervals():
    grey = natural_crop(8)[..., 0]
    out = io.BytesIO()
    Image.fromarray(grey).save(out, format="JPEG", quality=80)
    assert decode_jpeg(out.getvalue()).shape == grey.shape
    assert_decodes_as_pillow(out.getvalue())

    # Restart markers after every MCU row (a DRI segment, RSTn in the scan).
    image = natural_crop(9, 64, 80)
    out = io.BytesIO()
    Image.fromarray(image).save(out, format="JPEG", quality=92, restart_marker_rows=1)
    blob = out.getvalue()
    assert b"\xff\xdd" in blob and b"\xff\xd0" in blob
    assert_decodes_as_pillow(blob)


def test_jpeg_refuses_progressive_and_non_rgb():
    """Progressive files decode (as Pillow does); what stays refused, each
    a difference by design (ROADMAP): arithmetic-coded (SOF9), lossless
    (SOF3) and four-component (CMYK) JPEGs."""
    blob = pillow_jpeg(natural_crop(10, 32, 32), 75, progressive=True)
    assert b"\xff\xc2" in blob
    assert_decodes_as_pillow(blob)
    baseline = pillow_jpeg(natural_crop(10, 32, 32), 75)
    at = baseline.index(b"\xff\xc0")
    for marker, name in ((b"\xff\xc9", "arithmetic"), (b"\xff\xc3", "lossless")):
        with pytest.raises(NotImplementedError, match=name):
            decode_jpeg(baseline[:at] + marker + baseline[at + 2:])
    out = io.BytesIO()
    Image.fromarray(natural_crop(10, 32, 32)).convert("CMYK").save(out, format="JPEG")
    with pytest.raises(NotImplementedError, match="4 components"):
        decode_jpeg(out.getvalue())
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError):
        decode_jpeg(b"not a jpeg")


@pytest.mark.parametrize("case", ["q75_420", "q95_420", "q90_422", "q90_444", "grey",
                                  "restart_blocks", "odd_37x53_420", "odd_37x53_444",
                                  "q100_noise"])
def test_progressive_jpeg_decodes_as_pillow(case):
    """Pillow's progressive script (jpeg_simple_progression): DC first and
    refinement scans, AC first and refinement scans with end-of-band runs,
    natively and in the plain decoder, bit for bit."""
    rng = np.random.default_rng(17)
    image = natural_crop(15, 48, 64)
    blob = {
        "q75_420": lambda: pillow_jpeg(image, 75, progressive=True),
        "q95_420": lambda: pillow_jpeg(image, 95, progressive=True),
        "q90_422": lambda: pillow_jpeg(image, 90, subsampling=1, progressive=True),
        "q90_444": lambda: pillow_jpeg(image, 90, subsampling=0, progressive=True),
        "grey": lambda: pillow_jpeg(image[..., 1], 75, progressive=True),
        "restart_blocks": lambda: pillow_jpeg(image, 75, restart_marker_blocks=3,
                                              progressive=True),
        "odd_37x53_420": lambda: pillow_jpeg(natural_crop(16, 37, 53), 75, progressive=True),
        "odd_37x53_444": lambda: pillow_jpeg(natural_crop(16, 37, 53), 75, subsampling=0,
                                             progressive=True),
        "q100_noise": lambda: pillow_jpeg(rng.integers(0, 256, (29, 35, 3), dtype=np.uint8),
                                          100, progressive=True),
    }[case]()
    assert blob.count(b"\xff\xda") > 3            # several scans
    assert_decodes_as_pillow(blob)


def non_interleaved_jpeg(image, quality=90):
    """``encode_jpeg``'s headers (4:2:0) followed by one baseline scan per
    component: Y, then Cb, then Cr, each block by block over the component's
    own block grid (libjpeg reads such files; Pillow cannot write them)."""
    from hive_tpu_torch.image_codecs import (_entropy_tokens, _forward_dct_quantised,
                                             _pack_tokens, _rgb_to_ycbcr)

    height, width = image.shape[:2]
    ycc = _rgb_to_ycbcr(image)
    luma_table, chroma_table = quality_tables(quality)

    def blocks(plane, table):
        h, w = plane.shape
        padded = np.pad(plane, ((0, -h % 8), (0, -w % 8)), mode="edge")
        return _forward_dct_quantised(padded, table).reshape(-1, 64)

    header = encode_jpeg(image, quality)
    header = header[:header.index(b"\xff\xda")]
    scans = b""
    for cid, plane, table in ((1, ycc[..., 0], luma_table),
                              (2, ycc[::2, ::2, 1], chroma_table),
                              (3, ycc[::2, ::2, 2], chroma_table)):
        zz = blocks(plane, table)
        zz[1:, 0] = zz[1:, 0] - zz[:-1, 0].copy()
        data = _pack_tokens(*_entropy_tokens(zz, np.full(len(zz), cid == 1)))
        selector = 0x00 if cid == 1 else 0x11
        body = bytes([1, cid, selector, 0, 63, 0])
        scans += b"\xff\xda" + struct.pack(">H", len(body) + 2) + body + data
    return header + scans + b"\xff\xd9"


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_non_interleaved_jpeg_decodes_as_pillow(shape):
    """A baseline file in three single-component scans: each component's
    blocks over its own grid (the luma's without the MCU padding)."""
    blob = non_interleaved_jpeg(natural_crop(18, *shape))
    assert blob.count(b"\xff\xda") == 3
    assert_decodes_as_pillow(blob)


def test_jpeg_refuses_a_dc_category_over_15():
    """A DC table whose symbols are magnitude categories of 200 bits (a
    corrupt or hostile file) is refused, natively and in the plain decode."""
    blob = bytearray(pillow_jpeg(natural_crop(14, 16, 16)[..., 0], 75))
    at = blob.index(b"\xff\xc4")
    assert blob[at + 4] == 0x00                     # class 0 (DC), table 0
    symbols = at + 5 + 16
    blob[symbols:symbols + sum(blob[at + 5:symbols])] = b"\xc8" * sum(blob[at + 5:symbols])
    for native in (True, False):
        with pytest.raises(ValueError, match="DC magnitude category over 15"):
            decode_jpeg(bytes(blob), native=native)


@pytest.mark.parametrize("case", ["q75_420", "q92_420", "q90_422", "q90_444", "grey",
                                  "restart_blocks", "odd_37x53_420", "odd_37x53_422", "q100_noise",
                                  "q5"])
def test_jpeg_decode_is_pillows_bit_for_bit(case):
    """Quality 75 4:2:0 is what hive_tpu converts frames to; the odd sizes
    reach fancy upsampling's edge rows and columns."""
    rng = np.random.default_rng(11)
    image = natural_crop(12, 48, 64)
    blob = {
        "q75_420": lambda: pillow_jpeg(image, 75),
        "q92_420": lambda: pillow_jpeg(image, 92),
        "q90_422": lambda: pillow_jpeg(image, 90, subsampling=1),
        "q90_444": lambda: pillow_jpeg(image, 90, subsampling=0),
        "grey": lambda: pillow_jpeg(image[..., 1], 75),
        "restart_blocks": lambda: pillow_jpeg(image, 75, restart_marker_blocks=3),
        "odd_37x53_420": lambda: pillow_jpeg(natural_crop(13, 37, 53), 75),
        "odd_37x53_422": lambda: pillow_jpeg(natural_crop(13, 37, 53), 75, subsampling=1),
        "q100_noise": lambda: pillow_jpeg(rng.integers(0, 256, (29, 35, 3), dtype=np.uint8), 100),
        "q5": lambda: pillow_jpeg(image, 5),
    }[case]()
    assert_decodes_as_pillow(blob)


def raw_png(samples, depth, colour, palette=None):
    """A PNG of (H, W) samples of 1, 2, 4 or 8 bits, written by hand (Pillow
    writes no 2- or 4-bit grey), rows alternately unfiltered and Sub."""
    height, width = samples.shape
    per_byte = 8 // depth
    padded = np.zeros((height, -(-width // per_byte) * per_byte), np.uint8)
    padded[:, :width] = samples
    groups = padded.reshape(height, -1, per_byte).astype(np.int64)
    shifts = depth * np.arange(per_byte - 1, -1, -1)
    rows = (groups << shifts).sum(axis=-1).astype(np.uint8)
    body = []
    for r, row in enumerate(rows):
        if r % 2:
            row = (row.astype(np.int64) - np.concatenate([[0], row[:-1]])) & 0xFF
        body.append(bytes([r % 2]) + row.astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    chunks = chunk(b"IHDR", header)
    if palette is not None:
        chunks += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + chunks + chunk(b"IDAT", zlib.compress(b"".join(body)))
            + chunk(b"IEND", b""))


# Adam7's passes: (first column, first row, column step, row step).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def filter_rows(rows, bpp):
    """PNG-filter (H, stride) bytes, the row's filter type cycling through
    None, Sub, Up, Average and Paeth."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        kind = r % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        predictor = [0, left, prev, (left + prev) // 2, paeth][kind]
        out.append(bytes([kind]) + ((row - predictor) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def adam7_png(image, colour, depth):
    """An interlaced PNG written by hand: each of Adam7's seven passes a
    sub-image of its own, filtered on its own."""
    height, width = image.shape[:2]
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = image[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        data = sub.astype(">u2" if depth == 16 else np.uint8).tobytes()
        raw += filter_rows(np.frombuffer(data, np.uint8).reshape(sub.shape[0], -1),
                           max(1, channels * depth // 8))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour, depth", [(0, 8), (2, 8), (4, 8), (6, 8), (0, 16), (2, 16)])
def test_adam7_png_decodes_as_pillow(colour, depth):
    """Interlaced PNGs, natively and in numpy, at sizes where some of the
    seven passes are empty (1x1, 3x5) and where all are whole."""
    rng = np.random.default_rng(colour * 100 + depth)
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    for height, width in ((1, 1), (3, 5), (13, 17), (48, 64)):
        shape = (height, width, channels) if channels > 1 else (height, width)
        blob = adam7_png(rng.integers(0, 1 << depth, shape), colour, depth)
        with Image.open(io.BytesIO(blob)) as image:
            want = np.asarray(image if image.mode in ("L", "I;16") else image.convert("RGB"))
        for native in (True, False):
            got = decode_png(blob, native=native)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colour, depth", [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4),
                                           (3, 8)])
def test_png_palette_and_low_bit_grey_match_pillow(colour, depth):
    """As hive_tpu loads them: 2- and 4-bit grey stay grey (scaled to 8
    bits), 1-bit grey and palettes become RGB."""
    rng = np.random.default_rng(depth)
    samples = rng.integers(0, 1 << depth, (13, 19)).astype(np.uint8)
    palette = rng.integers(0, 256, (1 << depth, 3)) if colour == 3 else None
    blob = raw_png(samples, depth, colour, palette)
    with Image.open(io.BytesIO(blob)) as image:
        want = np.asarray(image if image.mode in ("L", "I;16") else image.convert("RGB"))
    got = decode_png(blob)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_image_folder_reads_jpeg_like_hive_tpu(tmp_path):
    """A converted dataset's folders: q75 JPEG frames (colour and grey),
    16-bit depth and 8-bit mask PNGs, told apart by signature."""
    frames = [natural_crop(20 + i, 48, 64) for i in range(3)]
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(tmp_path / f"{i:06d}.jpg", quality=75)
    Image.fromarray(frames[0][..., 0]).save(tmp_path / "000003.jpg", quality=75)
    Image.fromarray(np.arange(48 * 64, dtype=np.uint16).reshape(48, 64)).save(
        tmp_path / "000004.png")
    Image.fromarray(frames[1][..., 2]).save(tmp_path / "000005.png")
    ours, theirs = ImageFolderDataset(tmp_path), JaxImageFolderDataset(tmp_path)
    assert len(ours) == len(theirs) == 6
    for i in range(6):
        got, want = ours[i], theirs[i]
        assert got.dtype == want.dtype and got.shape == want.shape, i
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_image(os.path.join(tmp_path, "000000.jpg")), theirs[0])
    os.makedirs(tmp_path / "rgb")
    for i in range(3):
        os.rename(tmp_path / f"{i:06d}.jpg", tmp_path / "rgb" / f"{i:06d}.jpg")
    pairs = zip(ImageFolderDataset(tmp_path / "rgb").batches(2),
                JaxImageFolderDataset(tmp_path / "rgb").batches(2))
    assert [np.array_equal(*pair) and len(pair[0]) for pair in pairs] == [2, 1]
