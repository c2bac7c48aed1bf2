"""Video input of hive_tpu_torch (``hive_tpu_torch.video``) against cv2 5.0.0,
whose bundled FFmpeg decodes H.264, HEVC, Motion JPEG and MPEG-4 Part 2 (HEVC
in tests/test_torch_hevc.py, tests/test_torch_hevc_intra.py and
tests/test_torch_hevc_inter.py, MPEG-4 Part 2
in tests/test_torch_mpeg4.py): the MP4 demuxer's sizes, rate, frame count
and order, edit lists included; the I_PCM writer and the H.264 decoder
(lossless, so the seeded planes come back exactly; the decoder's other
macroblock types and P slices against cv2 here too, the rest in
tests/test_torch_h264.py); Motion JPEG (cv2's own MJPG writer, and Pillow's
4:2:0, 4:2:2, 4:4:4 and grey JPEGs muxed by the port) through FFmpeg's
simple IDCT; the YUV -> BGR conversions; the uint8 resize and the rotation;
the codecs and layouts refused by name. All of them are exact: no tolerance
is stated because none is needed (FFmpeg's x86 SIMD IDCT gives its C simple
IDCT's pixels here)."""

import io
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from hive_tpu_torch.image_processing import resize_linear_u8, rotate
from hive_tpu_torch.video import color, h264, h264_bits, mjpeg, mp4
from hive_tpu_torch.video.capture import VideoCapture


def seeded_planes(num_frames, width, height, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (height, width), dtype=np.uint8),
             rng.integers(0, 256, (height // 2, width // 2), dtype=np.uint8),
             rng.integers(0, 256, (height // 2, width // 2), dtype=np.uint8))
            for _ in range(num_frames)]


def write_clip(path, num_frames=6, width=64, height=48, seed=0, **options):
    """A seeded I_PCM MP4; returns its planes in display order."""
    frames = seeded_planes(num_frames, width, height, seed)
    frames[1][0][:] = 0            # long zero runs: emulation prevention
    frames[2][1][:, ::3] = 3
    idr_every = options.pop("idr_every", None)
    h264.write_h264_mp4(str(path), frames, h264.PcmPlanner(width, height, idr_every),
                        **options)
    return frames


def cv2_read(path):
    """cv2's properties and every frame a read() loop returns."""
    capture = cv2.VideoCapture(str(path))
    try:
        props = (int(capture.get(cv2.CAP_PROP_FRAME_WIDTH)),
                 int(capture.get(cv2.CAP_PROP_FRAME_HEIGHT)), capture.get(cv2.CAP_PROP_FPS))
        frames = []
        while True:
            ok, frame = capture.read()
            if not ok:
                break
            frames.append(frame)
    finally:
        capture.release()
    return props, frames


# Each layout the demuxer must read as cv2 does: out of order (ctts and an
# elst that shifts the presentation), NTSC rates, heights that SPS cropping
# trims (40 and 120 are not multiples of 16), one edit with a media-time
# offset, and display matrices (cv2 5.0.0 turns the frames and swaps the
# reported size for 90 and 270 degrees).
LAYOUTS = {
    "in_order": dict(),
    "out_of_order": dict(reorder=True),
    "ntsc": dict(fps=(30000, 1001)),
    "ntsc_out_of_order": dict(fps=(30000, 1001), reorder=True),
    "cropped_40": dict(height=40),
    "cropped_120": dict(width=160, height=120),
    "edit": dict(edit_frames=2),
    "edit_out_of_order": dict(edit_frames=3, reorder=True),
    "rotated_90": dict(rotation=90),
    "rotated_180": dict(rotation=180),
    "rotated_270": dict(rotation=270, height=40),
}


def split_options(options):
    sizes = {k: options[k] for k in ("width", "height") if k in options}
    return sizes, {k: v for k, v in options.items() if k not in sizes}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_demuxer_properties_match_cv2(tmp_path, layout):
    """CAP_PROP_FRAME_WIDTH / HEIGHT (cropped, then rotated), CAP_PROP_FPS
    (the stts rate as FFmpeg's avg_frame_rate) and the grab-loop count
    (the edit applied) equal cv2's."""
    sizes, options = split_options(LAYOUTS[layout])
    path = tmp_path / "clip.mp4"
    write_clip(path, num_frames=7, **sizes, **options)
    (width, height, fps), frames = cv2_read(path)
    capture = VideoCapture(str(path), device="cpu")
    assert (capture.width, capture.height) == (width, height)
    assert capture.fps == fps
    assert capture.frame_count == len(frames)
    assert frames[0].shape == (height, width, 3)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cpu_reader_returns_the_seeded_planes_and_cv2s_frames(tmp_path, layout):
    """I_PCM is lossless: the CPU reader's planes are the seeded samples, in
    display order, less the frames the edit cuts; their BGR conversion
    (rotated as cv2 rotates) equals cv2's frames byte for byte."""
    sizes, options = split_options(LAYOUTS[layout])
    path = tmp_path / "clip.mp4"
    planes = write_clip(path, num_frames=7, **sizes, **options)
    _, frames = cv2_read(path)
    capture = VideoCapture(str(path), device="cpu")
    first = options.get("edit_frames", 0)
    got = list(capture.planes())
    assert len(got) == len(frames) == 7 - first
    for (y, u, v), want in zip(got, planes[first:]):
        for plane, expected in zip((y, u, v), want):
            np.testing.assert_array_equal(plane.numpy(), expected)
    for index, (bgr, want) in enumerate(zip(capture.frames(), frames)):
        np.testing.assert_array_equal(bgr.numpy(), want, err_msg=f"frame {index}")


@pytest.mark.parametrize("index", [0, 3, 6])
def test_single_frame_seeks_from_the_sync_sample(tmp_path, index):
    """``frame(i)`` equals cv2's ``set(CAP_PROP_POS_FRAMES, i)`` + ``read()``
    in an out-of-order stream."""
    path = tmp_path / "clip.mp4"
    write_clip(path, num_frames=7, reorder=True)
    capture = cv2.VideoCapture(str(path))
    capture.set(cv2.CAP_PROP_POS_FRAMES, index)
    ok, want = capture.read()
    capture.release()
    assert ok
    np.testing.assert_array_equal(VideoCapture(str(path), device="cpu").frame(index).numpy(),
                                  want)


@pytest.mark.parametrize("full_range,matrix", [(False, None), (True, None), (False, 1),
                                               (True, 1), (False, 6), (False, 4), (False, 7)])
def test_colour_conversion_equals_cv2(tmp_path, full_range, matrix):
    """The YUV -> BGR conversion equals cv2's, pixel for pixel, on seeded
    planes and on 16,384 seeded (Y, U, V) triples; cv2 honours the VUI's
    full-range flag and colour matrix (BT.709, SMPTE 170M, FCC, SMPTE 240M),
    and so does the port. A sweep of all 16.7M triples
    (tests/torch_video_sweep.py) finds the formula exact."""
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (2, 128, 128), dtype=np.uint8)
    u = rng.integers(0, 256, (2, 64, 64), dtype=np.uint8)
    v = rng.integers(0, 256, (2, 64, 64), dtype=np.uint8)
    # Frame 1: a seeded sample of triples, each 2 x 2 block one (U, V) pair
    # with four Y values.
    triples = rng.integers(0, 256, (64 * 64, 6), dtype=np.uint8)
    u[1], v[1] = triples[:, 0].reshape(64, 64), triples[:, 1].reshape(64, 64)
    y[1] = triples[:, 2:].reshape(64, 64, 2, 2).transpose(0, 2, 1, 3).reshape(128, 128)
    frames = [(y[i], u[i], v[i]) for i in range(2)]
    path = tmp_path / "colour.mp4"
    h264.write_h264_mp4(str(path), frames, h264.PcmPlanner(128, 128), full_range=full_range,
                        matrix=matrix)
    _, want = cv2_read(path)
    for (yi, ui, vi), expected in zip(frames, want):
        got = color.yuv420_to_bgr(torch.from_numpy(yi), torch.from_numpy(ui),
                                  torch.from_numpy(vi), full_range,
                                  color.UNSPECIFIED if matrix is None else matrix)
        np.testing.assert_array_equal(got.numpy(), expected)


def test_colour_matrices_outside_the_table_are_refused():
    with pytest.raises(ValueError, match="matrix_coefficients 9"):
        color.coefficients(False, 9)


@pytest.mark.parametrize("source,target", [
    ((48, 64), (480, 640)), ((120, 160), (360, 640)), ((1080 // 8, 1920 // 8), (45, 80)),
    ((37, 53), (61, 29)), ((31, 47), (16, 23)), ((64, 48), (480, 360)), ((2, 3), (7, 5)),
    ((100, 100), (50, 50)), ((25, 17), (25, 40))])
@pytest.mark.parametrize("channels", [0, 1, 3])
def test_resize_linear_u8_equals_cv2(source, target, channels):
    """INTER_LINEAR on uint8 frames, up- and downscale, odd sizes, 1 and 3
    channels: cv2's bytes, from numpy and from a CPU tensor alike."""
    rng = np.random.default_rng(sum(source) + sum(target) + channels)
    shape = source + ((channels,) if channels else ())
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    want = cv2.resize(image, (target[1], target[0])).reshape(target + shape[2:])
    got = resize_linear_u8(image, target[1], target[0])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(resize_linear_u8(torch.from_numpy(image), target[1],
                                                   target[0]).numpy(), want)


@pytest.mark.parametrize("code", [cv2.ROTATE_90_CLOCKWISE, cv2.ROTATE_180,
                                  cv2.ROTATE_90_COUNTERCLOCKWISE])
@pytest.mark.parametrize("dtype,shape", [(np.uint8, (5, 7, 3)), (np.uint16, (6, 9)),
                                         (np.float32, (4, 3))])
def test_rotate_equals_cv2(code, dtype, shape):
    image = np.random.default_rng(code).integers(0, 5000, shape).astype(dtype)
    np.testing.assert_array_equal(rotate(image, code), cv2.rotate(image, code))
    if dtype != np.uint16:                         # torch's flip has no uint16 kernel
        np.testing.assert_array_equal(rotate(torch.from_numpy(image), code).numpy(),
                                      cv2.rotate(image, code))


def write_other_codec(path, fourcc, config_box):
    if fourcc == b"mp4v":
        entry = mp4.mp4v_entry(64, 48, MPEG2_OTI)
    else:
        entry = mp4.visual_entry(fourcc, 64, 48, mp4.box(config_box, bytes(23)))
    mp4.write_mp4(str(path), entry, [bytes(16)], width=64, height=48, timescale=30,
                  durations=[1])


MPEG2_OTI = 0x61                   # MPEG-2 Main Profile video in an mp4v entry


def test_hevc_and_mp4v_are_refused_by_name(tmp_path):
    """HEVC (hvc1 / hev1) outside the subset decoded so far (tiles, ROADMAP
    sub-item 9c-3; Main 10, 9c-4: tests/test_torch_hevc.py refuses each
    feature), an mp4v entry of an object type the port does not decode
    (MPEG-2 video, objectTypeIndication 0x61) and Motion JPEG B (mjpb) are
    refused naming the feature or codec and the ROADMAP item, before any
    decode. (HEVC I, P and B pictures decode: tests/test_torch_hevc_intra.py,
    tests/test_torch_hevc_inter.py; mp4v of objectTypeIndication 0x20,
    MPEG-4 Part 2: tests/test_torch_mpeg4.py.)"""
    from tests.test_torch_hevc import refusal_clip

    for fourcc, item in ((b"hvc1", "Queue 1 item 9c-3"), (b"hev1", "Queue 1 item 9c-4"),
                         (b"mp4v", "Queue 1 item 9d"), (b"mjpb", "Queue 1 item 9d")):
        if fourcc in (b"hvc1", b"hev1"):
            path = refusal_clip(tmp_path, "tiles" if fourcc == b"hvc1" else "main10", fourcc)
        else:
            path = tmp_path / f"{fourcc.decode()}.mp4"
            write_other_codec(path, fourcc, b"hvcC")
        name = {b"mp4v": r"MPEG-2 video \(sample entry 'mp4v'.*0x61",
                b"mjpb": "Motion JPEG B", b"hvc1": "HEVC video uses tiles",
                b"hev1": "HEVC video uses 10-bit samples"}[fourcc]
        with pytest.raises(mp4.UnsupportedVideoError, match=f"{name}.*{item}"):
            VideoCapture(str(path), device="cpu")


def test_cv2_mp4v_writer_file_decodes_as_cv2_reads_it(tmp_path):
    """cv2's own VideoWriter with the mp4v fourcc (MPEG-4 Part 2,
    objectTypeIndication 0x20), once refused: now read as cv2 reads it,
    every frame equal."""
    path = str(tmp_path / "cv2.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for i in range(3):
        writer.write(np.full((48, 64, 3), 40 * i, np.uint8))
    writer.release()
    (width, height, fps), frames = cv2_read(path)
    capture = VideoCapture(path, device="cpu")
    assert capture.codec == mp4.MPEG4
    assert (capture.width, capture.height, capture.fps, capture.frame_count) == \
        (width, height, fps, len(frames)) == (64, 48, 30.0, 3)
    for index, (got, want) in enumerate(zip(capture.frames(), frames)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"frame {index}")


def test_more_than_one_edit_is_refused(tmp_path):
    """Two edits in the file written with one and patched (the entry count
    and a copy of the entry, box sizes fixed up): once refused, now read as
    cv2 reads them, the media played twice from frame 1."""
    path = tmp_path / "clip.mp4"
    write_clip(path, num_frames=3, edit_frames=1)
    data = bytearray(path.read_bytes())
    at = data.index(b"elst")
    entry = bytes(data[at + 12:at + 24])
    # Two edits: the entry count and a second entry (box sizes patched).
    data[at + 8:at + 12] = struct.pack(">I", 2)
    data[at + 24:at + 24] = entry
    for name in (b"elst", b"edts", b"trak", b"moov"):
        start = data.rindex(name, 0, at + 4) - 4
        size = struct.unpack(">I", data[start:start + 4])[0]
        data[start:start + 4] = struct.pack(">I", size + 12)
    path.write_bytes(bytes(data))
    (_, _, fps), frames = cv2_read(path)
    capture = VideoCapture(str(path), device="cpu")
    assert len(frames) == capture.frame_count == 4 and capture.fps == fps
    for index, (got, want) in enumerate(zip(capture.frames(), frames)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"frame {index}")


# Edit lists, as (segment duration, media time) in frames of the 30 fps
# track (-1: an empty edit), each read by cv2 through FFmpeg's
# mov_fix_index. "nonsync" clips have an IDR picture every third frame, so
# their edits start on non-sync samples after a sync sample other than the
# first; "reorder" clips are out of order (ctts).
EDIT_LISTS = {
    "two": dict(edits=[(3, 0), (2, 4)]),
    "three": dict(edits=[(2, 0), (1, 5), (3, 2)]),
    "leading_empty": dict(edits=[(5, -1), (4, 2)]),
    "two_leading_empty": dict(edits=[(5, -1), (2, -1), (4, 1)]),
    "nonsync": dict(edits=[(3, 4)], idr_every=3),
    "nonsync_two": dict(edits=[(2, 1), (3, 5)], idr_every=3),
    "repeated_range": dict(edits=[(3, 1), (3, 1)]),
    "overlapping_ranges": dict(edits=[(4, 1), (3, 3)]),
    "empty_in_the_middle": dict(edits=[(2, 0), (3, -1), (2, 4)]),
    "reorder_repeated": dict(edits=[(4, 2), (2, 2)], reorder=True),
    "past_the_end": dict(edits=[(20, 5)]),
}


@pytest.mark.parametrize("case", sorted(EDIT_LISTS))
def test_edit_lists_give_cv2s_frames_in_cv2s_order(tmp_path, case):
    """Each edit list's frames, their order, the grab-loop count and the
    rate equal cv2's; the CPU reader's planes are the seeded planes of the
    frames cv2 shows."""
    path = tmp_path / "clip.mp4"
    planes = write_clip(path, num_frames=8, **EDIT_LISTS[case])
    (width, height, fps), frames = cv2_read(path)
    capture = VideoCapture(str(path), device="cpu")
    assert (capture.width, capture.height, capture.fps) == (width, height, fps)
    assert capture.frame_count == len(frames) > 0
    got = [frame.numpy() for frame in capture.frames()]
    assert len(got) == len(frames)
    for index, (frame, want) in enumerate(zip(got, frames)):
        np.testing.assert_array_equal(frame, want, err_msg=f"frame {index}")
    shown = [next(i for i, p in enumerate(planes)
                  if np.array_equal(color.yuv420_to_bgr(*map(torch.from_numpy, p)).numpy(), f))
             for f in frames]
    for (y, _, _), index in zip(capture.planes(), shown):
        np.testing.assert_array_equal(y.numpy(), planes[index][0])
    np.testing.assert_array_equal(capture.frame(len(frames) - 1).numpy(), frames[-1])


def mjpeg_frames(num_frames, width, height, seed=0):
    """Smooth seeded BGR frames: a JPEG's error stays small, its IDCT not
    trivial."""
    rng = np.random.default_rng(seed)
    return [cv2.GaussianBlur(rng.integers(0, 256, (height, width, 3), dtype=np.uint8),
                             (5, 5), 1.2) for _ in range(num_frames)]


def pillow_jpeg(bgr, subsampling, grey=False, quality=90):
    image = Image.fromarray(np.ascontiguousarray(bgr[..., ::-1]))
    out = io.BytesIO()
    if grey:
        image.convert("L").save(out, format="JPEG", quality=quality)
    else:
        image.save(out, format="JPEG", quality=quality, subsampling=subsampling)
    return out.getvalue()


def write_mjpeg(path, samples, width, height, **options):
    mp4.write_mp4(str(path), mp4.mjpeg_entry(width, height), samples, width=width,
                  height=height, timescale=30, durations=[1] * len(samples), **options)


def assert_reads_as_cv2(path, count):
    (width, height, fps), frames = cv2_read(path)
    capture = VideoCapture(str(path), device="cpu")
    assert capture.codec == mp4.MJPEG
    assert (capture.width, capture.height, capture.fps) == (width, height, fps)
    assert capture.frame_count == len(frames) == count
    for index, (got, want) in enumerate(zip(capture.frames(), frames)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"frame {index}")
    return capture


@pytest.mark.parametrize("width,height", [(64, 48), (160, 120)])
def test_cv2_motion_jpeg_reads_as_cv2(tmp_path, width, height):
    """cv2's MJPG writer stores Motion JPEG under an mp4v entry whose esds
    names JPEG (0x6C); the port reads its frames, rate and count as cv2
    does, bit for bit."""
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24, (width, height))
    for frame in mjpeg_frames(4, width, height):
        writer.write(frame)
    writer.release()
    track = mp4.read_track(path)
    assert (track.fourcc, track.codec) == (b"mp4v", mp4.MJPEG)
    assert assert_reads_as_cv2(path, 4).fps == 24.0


@pytest.mark.parametrize("layout", ["420", "422", "444", "grey"])
def test_pillow_motion_jpeg_layouts_read_as_cv2(tmp_path, layout):
    """Pillow's 4:2:0, 4:2:2, 4:4:4 and grey JPEGs muxed by the port (a
    90-degree display matrix on one of them) read as cv2 reads them; the
    native and numpy decodes give the same planes."""
    width, height = (160, 120) if layout != "422" else (64, 48)
    frames = mjpeg_frames(3, width, height, seed=len(layout))
    samples = [pillow_jpeg(f, {"420": 2, "422": 1}.get(layout, 0), grey=layout == "grey")
               for f in frames]
    path = tmp_path / "clip.mp4"
    write_mjpeg(path, samples, width, height, rotation=90 if layout == "444" else 0)
    assert_reads_as_cv2(path, 3)
    native = mjpeg.decode_sample(samples[1], height, native=True)
    plain = mjpeg.decode_sample(samples[1], height, native=False)
    assert len(native) == (1 if layout == "grey" else 3)
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)


def test_motion_jpeg_without_dht_and_with_avi1_reads_as_cv2(tmp_path):
    """Samples with their DHT segments stripped (the standard tables then
    hold, as Pillow wrote them) and samples with an AVI1 APP0 segment."""
    frames = mjpeg_frames(2, 64, 48, seed=5)
    samples = []
    for frame in frames:
        blob = pillow_jpeg(frame, 2)
        pos, stripped = 2, blob[:2]
        while blob[pos + 1] != 0xDA:
            length = struct.unpack(">H", blob[pos + 2:pos + 4])[0]
            if blob[pos + 1] != 0xC4:
                stripped += blob[pos:pos + 2 + length]
            pos += 2 + length
        samples.append(stripped + blob[pos:])
    avi1 = b"\xff\xe0" + struct.pack(">H", 16) + b"AVI1" + bytes(10)
    samples += [blob[:2] + avi1 + blob[2:] for blob in (pillow_jpeg(f, 2) for f in frames)]
    assert b"\xff\xc4" not in samples[0][:samples[0].index(b"\xff\xda")]
    path = tmp_path / "clip.mp4"
    write_mjpeg(path, samples, 64, 48)
    assert_reads_as_cv2(path, 4)
    assert mjpeg.sample_header(samples[2])["avi1"] == 0


def test_motion_jpeg_is_not_the_libjpeg_decode():
    """The planes differ from libjpeg's islow IDCT (Pillow's decode) on
    these samples: the IDCT choice is what makes the frames cv2's."""
    from hive_tpu_torch.image_codecs import decode_jpeg_planes

    blob = pillow_jpeg(mjpeg_frames(1, 64, 48, seed=7)[0], 2)
    simple = decode_jpeg_planes(blob, idct="simple").planes
    islow = decode_jpeg_planes(blob, idct="islow").planes
    assert any((a != b).any() for a, b in zip(simple, islow))


def test_motion_jpeg_refusals_name_the_layout(tmp_path):
    """Interlaced two-field samples (a frame header half the track's
    height), subsampled chroma at an odd height, and 4:1:1 are refused by
    name before any decode."""
    blob = pillow_jpeg(mjpeg_frames(1, 64, 24, seed=2)[0], 2)
    path = tmp_path / "fields.mp4"
    write_mjpeg(path, [blob], 64, 48)
    with pytest.raises(mp4.UnsupportedVideoError, match="interlaced.*24 of the track's 48"):
        VideoCapture(str(path), device="cpu")

    odd = pillow_jpeg(mjpeg_frames(1, 64, 49, seed=3)[0], 2)
    path = tmp_path / "odd.mp4"
    write_mjpeg(path, [odd], 64, 49)
    with pytest.raises(mp4.UnsupportedVideoError, match="yuvj420p of odd height"):
        VideoCapture(str(path), device="cpu")

    sof = blob.index(b"\xff\xc0")
    four_one_one = bytearray(blob)
    four_one_one[sof + 11] = 0x41                       # Y sampled 4 x 1
    path = tmp_path / "411.mp4"
    write_mjpeg(path, [bytes(four_one_one)], 64, 24)
    with pytest.raises(mp4.UnsupportedVideoError, match=r"sampling factors.*\(4, 1\)"):
        VideoCapture(str(path), device="cpu")


# mb_type of an I slice -> (the writer's plan kind, its 16x16 prediction mode).
MB_TYPE_PLANS = {0: (h264.PLAN_I4, 2), 25: (h264.PLAN_PCM, 2),
                 **{t: (h264.PLAN_I16, (t - 1) % 4) for t in range(1, 25)}}


def write_mb_types(path, first_mb_type, later_mb_type=None, width=32, height=32):
    """Two I pictures (an IDR picture, then a non-IDR one) whose first
    macroblock has the given mb_type and the others ``later_mb_type`` (or
    the first's); the writer's counts."""
    mbs_w, mbs_h = width // 16, height // 16
    rng = np.random.default_rng(first_mb_type)

    def plan(index, dpb):
        records = []
        for a in range(mbs_w * mbs_h):
            mb_type = later_mb_type if a and later_mb_type is not None else first_mb_type
            kind, mode = MB_TYPE_PLANS[mb_type]
            records.append(h264.plan_record(kind, 26, i16_mode=mode,
                                            i4_modes=rng.integers(0, 9, 16)))
        return h264.PicturePlan(h264.I_SLICE, np.stack(records),
                                [h264.SlicePlan(0, mbs_w * mbs_h)], idr=index == 0)

    frames = [(y, u, v) for y, u, v in seeded_planes(2, width, height)]
    return h264.write_h264_mp4(str(path), frames, plan)


@pytest.mark.parametrize("first,later,name", [(0, None, "I_NxN"),
                                              (1, None, "I_16x16_0_0_0"),
                                              (25, 0, "I_NxN"), (25, 13, "I_16x16_0_0_15")])
def test_cpu_reader_refuses_other_macroblocks_by_name(tmp_path, first, later, name):
    """Macroblocks of the named type (after an I_PCM one where two are
    given), which the I_PCM reader refused: the H.264 decoder now decodes
    them, on the CPU as on the card, to cv2's frames."""
    path = tmp_path / "clip.mp4"
    stats = write_mb_types(path, first, later)
    kind, mode = MB_TYPE_PLANS[later if later is not None else first]
    assert stats["i_pcm" if kind == h264.PLAN_PCM else
                 f"i16x16_mode_{mode}" if kind == h264.PLAN_I16 else "i4x4_mode_2"] > 0, name
    _, frames = cv2_read(path)
    got = [f.numpy() for f in VideoCapture(str(path), device="cpu").frames()]
    assert len(got) == len(frames) == 2
    for frame, want in zip(got, frames):
        np.testing.assert_array_equal(frame, want)


def test_cpu_reader_refuses_p_slices_and_cabac(tmp_path):
    """P slices and CABAC (the refusals this test once held) now decode to
    cv2's frames, and so does a weighted prediction PPS (refused until B
    slices decoded); redundant pictures are refused by name, citing ROADMAP
    Queue 1 item 9f."""
    for cabac in (False, True):
        path = tmp_path / f"clip_{cabac}.mp4"
        h264.write_h264_mp4(str(path), seeded_planes(6, 64, 48),
                            h264.Exerciser(64, 48, 2, gop=10), cabac=cabac,
                            profile=77 if cabac else 66)
        assert {t for t in h264_slice_types(path)} == {h264.I_SLICE, h264.P_SLICE}
        _, frames = cv2_read(path)
        got = [f.numpy() for f in VideoCapture(str(path), device="cpu").frames()]
        assert len(got) == len(frames) == 6
        for frame, want in zip(got, frames):
            np.testing.assert_array_equal(frame, want)
    decoder = h264.H264Decoder()
    decoder.decode([h264.encode_sps(32, 16), h264.encode_pps()])

    def pps(weighted, redundant):
        bits = h264_bits.BitWriter().ue(0).ue(0).u(1, 1).u(1, 0).ue(0).ue(0).ue(0)
        bits.u(1, weighted).u(2, 0).se(0).se(0).se(0).u(1, 1).u(1, 0).u(1, redundant)
        return h264_bits.nal_unit(3, h264_bits.NAL_PPS, np.frombuffer(bits.align(True), np.uint8))

    decoder.decode([pps(1, 0)])
    assert decoder.pps[0]["weighted_pred"] == 1
    with pytest.raises(mp4.UnsupportedVideoError,
                       match=r"redundant pictures.*Queue 1 item 9f\)"):
        decoder.decode([pps(1, 1)])


def h264_slice_types(path):
    """The slice types of an H.264 MP4's pictures, in decode order."""
    capture = VideoCapture(str(path), device="cpu")
    decoder = h264.H264Decoder(pixels=False)
    decoder.decode(capture.sps_units + capture.pps_units)
    return [t for k in range(len(capture.track.sizes))
            for t in decoder.decode(capture._nal_units(k)).slice_types]


def test_emulation_prevention_round_trips():
    """Escaped payloads hold no 0x000000, 0x000001 or 0x000002 and unescape
    to the input, whatever their runs of zeros."""
    rng = np.random.default_rng(3)
    for _ in range(300):
        data = rng.choice(np.array([0, 0, 0, 1, 2, 3, 4, 255], np.uint8), rng.integers(1, 60))
        escaped = h264_bits.escape(data).tobytes()
        for k in range(len(escaped) - 2):
            assert escaped[k:k + 2] != b"\x00\x00" or escaped[k + 2] >= 3, escaped
        assert h264_bits.unescape(b"\x65" + escaped)[1:] == data.tobytes()


def test_sps_parse_reads_the_written_fields():
    sps = h264.parse_sps(h264_bits.unescape(
        h264.encode_sps(1920, 1080, reorder=1, full_range=True, matrix=1)))
    assert (sps["width"], sps["height"], sps["mbs_h"]) == (1920, 1080, 68)
    assert (sps["full_range"], sps["matrix"], sps["reorder"]) == (True, 1, 1)
