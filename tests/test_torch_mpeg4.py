"""MPEG-4 Part 2 Simple Profile video in hive_tpu_torch
(``hive_tpu_torch.video.mpeg4``, ``native/src/mpeg4_decode.cpp``) against
cv2 5.0.0, whose bundled FFmpeg decodes it: the files of cv2's own writer
(its ``mp4v``, ``XVID``, ``DIVX`` and ``FMP4`` fourccs, all stored as
``mp4v``), the port's writer's files (one per option: motion fields past
every edge, 4MV, intra, not_coded, DQUANT, AC prediction, resync markers,
GOP length, N-VOPs, the three escapes, user data, the x86 no-rounding
averages on 0 next to odd samples), an edit list that starts at a P-VOP,
and each feature the reader refuses by name before any decode. Every
comparison is exact, to the bit: the properties, the frame count and every
frame ``VideoCapture(device="cpu")`` returns equal what
``cv2.VideoCapture`` returns."""

import cv2
import numpy as np
import pytest
import torch

from hive_tpu_torch import native
from hive_tpu_torch.video import color, mp4, mpeg4
from hive_tpu_torch.video.capture import VideoCapture


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


def assert_reads_as_cv2(path, count=None):
    """VideoCapture on the CPU gives cv2's size, rate, count and frames."""
    (width, height, fps), frames = cv2_read(path)
    capture = VideoCapture(str(path), device="cpu")
    assert (capture.width, capture.height, capture.fps) == (width, height, fps)
    assert capture.frame_count == len(frames) > 0
    if count is not None:
        assert len(frames) == count
    got = [frame.numpy() for frame in capture.frames()]
    assert len(got) == len(frames)
    for index, (frame, want) in enumerate(zip(got, frames)):
        np.testing.assert_array_equal(frame, want, err_msg=f"frame {index}")
    return capture, frames


def scene_bgr(num_frames, width, height, seed=0):
    """A blurred-noise texture with noise on top, moving by whole, half and
    odd pixels a frame, dark enough in places to clip at 0."""
    rng = np.random.default_rng(seed)
    texture = cv2.GaussianBlur(rng.integers(0, 256, (height + 96, width + 96, 3))
                               .astype(np.float32), (0, 0), 2.5)
    texture = (texture - texture.min()) / (texture.max() - texture.min()) * 330 - 40
    frames = []
    for i in range(num_frames):
        dx, dy = 10 + 0.5 * i + i % 3, 10 + 1.5 * i
        warp = np.float32([[1, 0, -dx], [0, 1, -dy]])
        frame = cv2.warpAffine(texture, warp, (width, height), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REFLECT)
        frames.append(np.clip(frame + rng.normal(0, 5, frame.shape), 0, 255).astype(np.uint8))
    return frames


def scene_planes(num_frames, width, height, seed=0):
    return [color.rgb_to_yuv420(np.ascontiguousarray(f[..., ::-1]))
            for f in scene_bgr(num_frames, width, height, seed)]


def vop_types(path):
    """(coding type, rounding type) of each sample's VOP."""
    track = mp4.read_track(str(path))
    data = open(path, "rb").read()
    headers = mpeg4.StreamHeaders()
    headers.parse(track.config)
    types = []
    for offset, size in zip(track.offsets, track.sizes):
        sample = data[offset:offset + size]
        vop = mpeg4.parse_vop_header(sample, headers.parse(sample), headers)
        types.append((vop.coding_type, vop.rounding))
    return types


# ---------------------------------------------------------------------------
# cv2's writer.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(64, 48), (176, 144), (200, 120)], ids=str)
@pytest.mark.parametrize("fourcc", ["mp4v", "XVID", "DIVX", "FMP4"])
def test_cv2_written_files_read_as_cv2_reads_them(tmp_path, fourcc, size):
    """cv2's writer (FFmpeg's mpeg4 encoder; the MP4 muxer stores each
    fourcc as mp4v) at three sizes, 200 x 120 not a multiple of 16: I-VOPs
    at GOP boundaries, P-VOPs of both rounding types with half-pel motion
    and AC prediction; every frame equals cv2's."""
    width, height = size
    path = tmp_path / f"{fourcc}.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30, size)
    for frame in scene_bgr(32, width, height):
        writer.write(frame)
    writer.release()
    track = mp4.read_track(str(path))
    assert (track.fourcc, track.codec) == (b"mp4v", mp4.MPEG4)
    types = vop_types(path)
    assert sum(t == mpeg4.I_VOP for t, _ in types) >= 2
    assert {r for t, r in types if t == mpeg4.P_VOP} == {0, 1}
    assert_reads_as_cv2(path, count=32)


def test_cv2_user_data_is_an_unflagged_libavcodec_build(tmp_path):
    """cv2's writer names its libavcodec in the VOL's user data; that build
    turns on no workaround, so it decodes with the plain simple IDCT."""
    path = tmp_path / "clip.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for frame in scene_bgr(3, 64, 48):
        writer.write(frame)
    writer.release()
    headers = mpeg4.StreamHeaders()
    headers.parse(mp4.read_track(str(path)).config)
    assert headers.user_data[0].startswith(b"Lavc") and headers.lavc_build > 4713
    assert (headers.xvid_build, headers.divx_version) == (-1, -1)


@pytest.mark.parametrize("writer, packets", [("cv2", False), ("port", False), ("port", True)])
def test_vol_resync_marker_flag_reads_as_written(tmp_path, writer, packets):
    """The VOL's resync_marker_disable: cv2's writer sets it (its files hold
    no video packets); the port's writer clears it when it writes them."""
    path = tmp_path / "clip.mp4"
    if writer == "cv2":
        video = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
        for frame in scene_bgr(3, 64, 48):
            video.write(frame)
        video.release()
    else:
        mpeg4.write_mpeg4_mp4(str(path), scene_planes(3, 64, 48), resync_every=3 * packets)
    headers = mpeg4.StreamHeaders()
    headers.parse(mp4.read_track(str(path)).config)
    assert headers.resync_markers == packets


# ---------------------------------------------------------------------------
# The port's writer, one option at a time.
# ---------------------------------------------------------------------------

W, H = 200, 120                          # 13 x 8 macroblocks, both edges cropped
MBW, MBH = 13, 8
N = 14


def random_field(seed, extent, shape=(N, MBH, MBW, 2)):
    return np.random.default_rng(seed).integers(-extent, extent + 1, shape)


def past_the_edges(index):
    """Vectors that point past each edge of the picture, more at its
    borders, reversed on odd frames."""
    xs = np.linspace(-90, 90, MBW).astype(int)
    ys = np.linspace(-70, 70, MBH).astype(int)
    field = np.stack(np.broadcast_arrays(xs[None, :], ys[:, None]), -1)
    return field if index % 2 else -field - 1


def four_past_the_edges(index):
    field = np.array([[-70, -70], [71, -69], [-69, 71], [91, 93]])
    return np.tile(field, (MBH, MBW, 1, 1)) * (1 if index % 2 else -1)


every = np.ones((MBH, MBW), bool)
rng = np.random.default_rng(11)
WRITER_CASES = {
    "intra_only": (dict(gop=1), {}),
    "one_mv": (dict(motion=random_field(1, 24)), {}),
    "one_mv_past_the_edges": (dict(motion=past_the_edges), {}),
    "four_mv": (dict(motion=random_field(2, 40, (N, MBH, MBW, 4, 2)), four_mv=every),
                dict(four_mv=1)),
    "four_mv_past_the_edges": (dict(motion=four_past_the_edges, four_mv=every),
                               dict(four_mv=1)),
    "forced_intra": (dict(motion=random_field(3, 8), intra=rng.random((N, MBH, MBW)) < 0.4),
                     dict(intra=1)),
    "not_coded": (dict(motion=random_field(4, 8), not_coded=rng.random((N, MBH, MBW)) < 0.4),
                  dict(not_coded=1)),
    "dquant": (dict(motion=random_field(5, 8), mb_qscale=rng.integers(1, 32, (N, MBH, MBW))),
               dict(dquant=1)),
    "ac_pred_on": (dict(ac_pred=True, qscale=2), dict(ac_pred=1)),
    "ac_pred_off": (dict(ac_pred=False, qscale=2), {}),
    "resync_every_row": (dict(motion=random_field(6, 16), resync_every=MBW),
                         dict(packets=1)),
    "resync_every_5": (dict(motion=random_field(7, 16), four_mv=rng.random((N, MBH, MBW)) < .3,
                            intra=rng.random((N, MBH, MBW)) < 0.2, resync_every=5),
                       dict(packets=1, four_mv=1, intra=1)),
    # Packets longer than a row: the DC, AC and vector predictions of the
    # row below a packet's start (its resync column, the one before it).
    "resync_every_17": (dict(motion=random_field(14, 16), intra=rng.random((N, MBH, MBW)) < .5,
                             resync_every=17, gop=2), dict(packets=1, intra=1)),
    "gop_3": (dict(motion=random_field(8, 16), gop=3), {}),
    "low_qp_escapes": (dict(motion=random_field(9, 16), qscale=1),
                       dict(escape1=1, escape2=1, escape3=1)),
    "n_vops": (dict(motion=random_field(10, 16), n_vops=[3, 8]), {}),
    "user_data": (dict(motion=random_field(12, 16), user_data=b"Lavc62.28.101"), {}),
    "everything": (dict(motion=random_field(13, 30, (N, MBH, MBW, 4, 2)),
                        four_mv=rng.random((N, MBH, MBW)) < 0.3,
                        intra=rng.random((N, MBH, MBW)) < 0.15,
                        not_coded=rng.random((N, MBH, MBW)) < 0.15,
                        mb_qscale=rng.integers(1, 32, (N, MBH, MBW)), resync_every=7, gop=5),
                   dict(four_mv=1, intra=1, not_coded=1, dquant=1, packets=1)),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_writer_files_read_as_cv2_reads_them(tmp_path, case):
    """Each option of write_mpeg4_mp4 is used (its counts say so) and the
    file reads as cv2 reads it, frame for frame."""
    options, used = WRITER_CASES[case]
    path = tmp_path / f"{case}.mp4"
    totals = mpeg4.write_mpeg4_mp4(str(path), scene_planes(N, W, H), **options)
    for name, least in used.items():
        assert totals[name] >= least, (name, totals)
    assert totals["rounding_1"] > 0 or options.get("gop") == 1
    assert_reads_as_cv2(path, count=N - len(options.get("n_vops", ())))


@pytest.mark.parametrize("vector", [(1, 0), (0, 1), (-3, 0), (0, -3), (1, 1)], ids=str)
@pytest.mark.parametrize("four", [False, True], ids=["1mv", "4mv"])
def test_no_rounding_half_pel_averages_equal_cv2(tmp_path, vector, four):
    """vop_rounding_type 1 on a reference of 0 next to odd samples, the
    residue lifting the result clear of the clip at 0: FFmpeg's x86 8-wide
    no-rounding averages (4MV blocks, chroma) are its inexact ones, the
    16-wide ones exact, and the port's equal them."""
    rng = np.random.default_rng(3)
    y = rng.choice(np.array([0, 0, 1, 3, 5, 7, 0], np.uint8), (48, 64))
    u = rng.choice(np.array([0, 0, 1, 3, 5, 7, 0], np.uint8), (24, 32))
    frames = [(y, u, u), (y + 100, u + 100, u + 100)] * 2
    field = np.broadcast_to(np.array(vector), (3, 4, 2))
    options = dict(motion=np.repeat(field[:, :, None], 4, 2), four_mv=np.ones((3, 4), bool)) \
        if four else dict(motion=field)
    path = tmp_path / "zeros.mp4"
    totals = mpeg4.write_mpeg4_mp4(str(path), frames, qscale=1, gop=2, **options)
    assert totals["rounding_1"] == 2
    assert_reads_as_cv2(path, count=4)


def test_writer_round_trips_the_scene(tmp_path):
    """The writer codes what it is given: at qscale 2 every frame lies
    within 2 levels of the seeded planes on average (PSNR > 38 dB)."""
    planes = scene_planes(6, W, H)
    path = tmp_path / "clip.mp4"
    mpeg4.write_mpeg4_mp4(str(path), planes, qscale=2, motion=random_field(1, 4)[:6])
    got = list(VideoCapture(str(path), device="cpu").planes())
    for (y, _, _), (want, _, _) in zip(got, planes):
        error = np.mean((y.numpy().astype(float) - want) ** 2)
        assert 10 * np.log10(255 ** 2 / error) > 38


def test_n_vops_give_no_frame_as_in_cv2(tmp_path):
    """A VOP with vop_coded 0 makes FFmpeg return no frame: cv2's grab loop
    counts the samples less the N-VOPs, and so does the port;
    set(CAP_PROP_POS_FRAMES, i) counts decoded frames, as frame(i) does."""
    path = tmp_path / "clip.mp4"
    mpeg4.write_mpeg4_mp4(str(path), scene_planes(8, 64, 48), n_vops=[2, 5],
                          motion=np.ones((3, 4, 2), int))
    assert len(mp4.read_track(str(path)).sizes) == 8
    capture, frames = assert_reads_as_cv2(path, count=6)
    grabbed = cv2.VideoCapture(str(path))
    count = 0
    while grabbed.grab():
        count += 1
    assert count == capture.frame_count == 6
    for index in (2, 5):
        seek = cv2.VideoCapture(str(path))
        seek.set(cv2.CAP_PROP_POS_FRAMES, index)
        ok, want = seek.read()
        assert ok
        np.testing.assert_array_equal(capture.frame(index).numpy(), want)


def test_edit_list_starting_at_a_p_vop_reads_as_cv2(tmp_path):
    """One edit whose media time falls on a P-VOP (frame 5 of a 12-frame
    GOP): decoded from the I-VOP before it, the frames cv2 shows."""
    path = tmp_path / "clip.mp4"
    mpeg4.write_mpeg4_mp4(str(path), scene_planes(12, 64, 48), gop=12,
                          motion=random_field(2, 12, (12, 3, 4, 2)), edits=[(5, 5)])
    assert not mp4.read_track(str(path)).sync[5]
    capture, frames = assert_reads_as_cv2(path, count=5)
    np.testing.assert_array_equal(capture.frame(0).numpy(), frames[0])


def test_1080p_clip_crops_the_coded_lines(tmp_path):
    """1080 lines are 68 macroblock rows (1088 coded): a few frames of the
    phone clip's size, 4MV and a resync marker every row, equal cv2's."""
    width, height = 1920, 1080
    rng = np.random.default_rng(2)
    texture = cv2.GaussianBlur(rng.integers(0, 256, (height + 32, width + 32), np.uint8),
                               (0, 0), 2)
    planes = []
    for i in range(3):
        y = np.ascontiguousarray(texture[2 * i:2 * i + height, 3 * i:3 * i + width])
        c = np.ascontiguousarray(cv2.resize(y, (width // 2, height // 2)))
        planes.append((y, c, 255 - c))
    four = np.zeros((68, 120), bool)
    four[:, ::3] = True
    path = tmp_path / "hd.mp4"
    mpeg4.write_mpeg4_mp4(str(path), planes, motion=np.broadcast_to(np.array([5, 3]), (68, 120, 2)),
                          four_mv=four, resync_every=120)
    assert_reads_as_cv2(path, count=3)


def coded_vops(path):
    """The stream's headers and (sample, VOP header, reference picture) of
    each sample of ``path``, decoded in order."""
    track = mp4.read_track(str(path))
    data = open(path, "rb").read()
    decoder = mpeg4.Mpeg4Decoder(track.config)
    vops, reference = [], None
    for offset, size in zip(track.offsets, track.sizes):
        sample = data[offset:offset + size]
        vop = decoder.check(sample)
        vops.append((sample, vop, reference))
        reference = mpeg4.decode_macroblocks(sample, vop, decoder.headers, reference)
    return decoder.headers, vops


def test_truncated_samples_are_refused_as_corrupt(tmp_path):
    """Every VOP of the writer's busiest file (4MV, intra, not_coded,
    DQUANT, packets) cut at its first macroblock, and a quarter, half and
    three quarters into its macroblocks: the decode stops with the named
    error. (A sample cut in its last byte can still decode: the bits lost
    may be stuffing, or decode as the zeros that pad a sample.)"""
    path = tmp_path / "clip.mp4"
    mpeg4.write_mpeg4_mp4(str(path), scene_planes(N, W, H), **WRITER_CASES["everything"][0])
    headers, vops = coded_vops(path)
    for sample, vop, reference in vops:
        start = (vop.bit_pos + 7) // 8
        for cut in (start, start + (len(sample) - start) // 4,
                    start + (len(sample) - start) // 2, start + 3 * (len(sample) - start) // 4):
            with pytest.raises(ValueError, match="corrupt MPEG-4 VOP"):
                mpeg4.decode_macroblocks(sample[:cut], vop, headers, reference)


@pytest.mark.parametrize("qscale", [1, 8])
def test_bit_flips_decode_or_are_refused_as_corrupt(tmp_path, qscale):
    """Single and burst bit flips in the macroblocks of every VOP (qscale 1
    writes all three escapes): each damaged sample either decodes to a
    picture of the coded size or stops with the named error."""
    path = tmp_path / "clip.mp4"
    options = dict(WRITER_CASES["everything"][0], qscale=qscale)
    options.pop("mb_qscale")
    mpeg4.write_mpeg4_mp4(str(path), scene_planes(N, W, H), **options)
    headers, vops = coded_vops(path)
    rng = np.random.default_rng(qscale)
    outcomes = set()
    for sample, vop, reference in vops:
        for _ in range(40):
            damaged = np.frombuffer(sample, np.uint8).copy()
            first = int(rng.integers(vop.bit_pos, 8 * len(sample)))
            for bit in range(first, min(first + int(rng.choice([1, 1, 9, 64])), 8 * len(sample))):
                damaged[bit >> 3] ^= 0x80 >> (bit & 7)
            try:
                y, u, v = mpeg4.decode_macroblocks(damaged.tobytes(), vop, headers, reference)
            except ValueError as e:
                assert str(e).startswith("corrupt MPEG-4 VOP"), e
                outcomes.add("refused")
            else:
                assert (y.shape, u.shape, v.shape) == ((16 * MBH, 16 * MBW), (8 * MBH, 8 * MBW),
                                                       (8 * MBH, 8 * MBW))
                outcomes.add("decoded")
    assert outcomes == {"refused", "decoded"}


def test_a_seek_moves_only_the_wanted_picture_to_the_device(tmp_path):
    """Frame 11 of a 12-frame GOP decodes samples 0 to 11 on the host and
    gives (so moves to the device) sample 11's planes alone."""
    path = tmp_path / "clip.mp4"
    mpeg4.write_mpeg4_mp4(str(path), scene_planes(12, 64, 48), gop=12,
                          motion=random_field(2, 12, (12, 3, 4, 2)))
    capture = VideoCapture(str(path), device="cpu")
    given = list(capture._planes(0, np.array([11])))
    assert [sample for sample, _ in given] == [11]
    np.testing.assert_array_equal(capture.to_bgr(*given[0][1]).numpy(),
                                  capture.frame(11).numpy())


# ---------------------------------------------------------------------------
# Refusals, by name, before any decode.
# ---------------------------------------------------------------------------

def vol(*, vo_type=1, verid=1, control=True, chroma=1, low_delay=1, shape=0, interlaced=0,
        sprite=0, not_8_bit=0, quant_type=0, quarter=0, complexity_off=1, partitioned=0,
        rvlc=0, newpred=0, reduced=0, scalability=0, full_range=None):
    """A VOL header (after the VOS and VO ones) with the given fields;
    ``full_range`` writes the VO's video_signal_type."""
    w = mpeg4._Writer()
    w.u(32, mpeg4.VOS_START).u(8, 1)
    w.u(32, mpeg4.VO_START).u(1, 0).u(4, 1).u(1, full_range is not None)
    if full_range is not None:
        w.u(3, 5).u(1, full_range).u(1, 0)
    w.stuffing()
    w.u(32, 0x100).u(32, 0x120).u(1, 0).u(8, vo_type)
    w.u(1, 1).u(4, verid).u(3, 1)
    w.u(4, 1).u(1, int(control))
    if control:
        w.u(2, chroma).u(1, low_delay).u(1, 0)
    w.u(2, shape).u(1, 1).u(16, 30).u(1, 1).u(1, 0)
    w.u(1, 1).u(13, 64).u(1, 1).u(13, 48).u(1, 1)
    w.u(1, interlaced).u(1, 1).u(1 if verid == 1 else 2, sprite).u(1, not_8_bit)
    w.u(1, quant_type)
    if verid != 1:
        w.u(1, quarter)
    w.u(1, complexity_off).u(1, 1).u(1, partitioned)
    if partitioned:
        w.u(1, rvlc)
    if verid != 1:
        w.u(1, newpred).u(1, reduced)
    w.u(1, scalability).stuffing()
    return w.bytes()


def i_vop():
    return mpeg4._vop_header(mpeg4.I_VOP, 0, 0, 5, 4).stuffing().bytes()


def vop_of_type(coding_type):
    return mpeg4._Writer().u(32, mpeg4.VOP_START).u(2, coding_type).u(1, 0).u(1, 1) \
        .u(5, 1).u(1, 1).u(1, 1).u(1, 0).u(3, 0).u(5, 4).u(3, 1).stuffing().bytes()


def user_data(text):
    return mpeg4.USER_DATA.to_bytes(4, "big") + text


REFUSALS = {
    "b_vop_low_delay_0": (vol(low_delay=0), [i_vop()], r"B-VOPs \(the VOL's low_delay is 0\)"),
    "b_vop_in_a_sample": (vol(), [i_vop(), vop_of_type(mpeg4.B_VOP)], "B-VOPs"),
    "s_vop": (vol(), [i_vop(), vop_of_type(mpeg4.S_VOP)], "S-VOPs"),
    "interlaced": (vol(interlaced=1), [i_vop()], "an interlaced VOL"),
    "quarter_pel": (vol(verid=2, quarter=1), [i_vop()], "quarter-pel"),
    "static_sprite": (vol(sprite=1), [i_vop()], "sprites"),
    "gmc": (vol(verid=2, sprite=2), [i_vop()], "sprites .*GMC"),
    "mpeg_quant": (vol(quant_type=1), [i_vop()], r"quant_type 1 \(MPEG quantisation"),
    "data_partitioning": (vol(partitioned=1), [i_vop()], "data partitioning"),
    "reversible_vlc": (vol(partitioned=1, rvlc=1), [i_vop()], "reversible VLCs"),
    "binary_shape": (vol(shape=1), [i_vop()], "video_object_layer_shape 1"),
    "not_8_bit": (vol(not_8_bit=1), [i_vop()], "not_8_bit"),
    "scalability": (vol(scalability=1), [i_vop()], "scalability"),
    "newpred": (vol(verid=2, newpred=1), [i_vop()], "NEWPRED"),
    "reduced_resolution": (vol(verid=2, reduced=1), [i_vop()], "reduced-resolution"),
    "complexity_estimation": (vol(complexity_off=0), [i_vop()], "complexity estimation"),
    "chroma_4_2_2": (vol(chroma=2), [i_vop()], "chroma_format 2"),
    "short_video_header": (b"", [bytes([0, 0, 0x80, 0x02, 0x1C]) + bytes(20)],
                           r"short_video_header \(H.263 baseline"),
    "xvid": (vol() + user_data(b"XviD0050"), [i_vop()], "Xvid user data"),
    "divx": (vol() + user_data(b"DivX503Build1031p"), [i_vop()], "DivX user data"),
    "old_lavc": (vol() + user_data(b"Lavc0.4.8"), [i_vop()], "libavcodec build"),
    "lavc_iedge": (vol() + user_data(b"Lavc56.60.100"), [i_vop()], "libavcodec build"),
    "old_ffmpeg": (vol() + user_data(b"FFmpeg0.4.9b4655"), [i_vop()], "libavcodec build"),
    "in_band_xvid": (vol(), [user_data(b"XviD0046") + i_vop()], "Xvid user data"),
    "video_signal_full_range": (vol(full_range=1), [i_vop()], "video signal type"),
    "studio_profile": (b"\x00\x00\x01\xb0\xe1" + vol()[5:], [i_vop()], "studio profile"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unsupported_features_are_refused_by_name(tmp_path, case, monkeypatch):
    """Each feature the reader does not decode is refused when the capture
    opens (the VOL and every VOP header are read first), naming it and
    ROADMAP Queue 1 item 9d; no VOP is decoded."""
    config, samples, name = REFUSALS[case]
    path = tmp_path / f"{case}.mp4"
    entry = mp4.mp4v_entry(64, 48, mp4.MPEG4_PART2_OTI, config)
    mp4.write_mp4(str(path), entry, samples, width=64, height=48, timescale=30,
                  durations=[1] * len(samples))

    def no_decode(*args, **kwargs):
        raise AssertionError("a VOP was decoded")

    monkeypatch.setattr(mpeg4, "decode_macroblocks", no_decode)
    with pytest.raises(mp4.UnsupportedVideoError, match=f"{name}.*Queue 1 item 9d"):
        VideoCapture(str(path), device="cpu")


def test_unflagged_user_data_is_accepted():
    """User data that sets no workaround (a current Lavc build, text) is
    read and kept."""
    headers = mpeg4.StreamHeaders()
    headers.parse(vol() + user_data(b"Lavc62.28.101") + user_data(b"made by hand"))
    assert headers.lavc_build == (62 << 16) + (28 << 8) + 101
    assert headers.user_data == [b"Lavc62.28.101", b"made by hand"]


def test_without_the_native_library_decode_raises_naming_the_build(tmp_path, monkeypatch):
    """There is no numpy decoder beside the native one: without the library
    the decode raises, naming why the build failed."""
    path = tmp_path / "clip.mp4"
    mpeg4.write_mpeg4_mp4(str(path), scene_planes(2, 64, 48))
    monkeypatch.setattr(native, "get_native_lib", lambda: None)
    monkeypatch.setattr(native, "_build_error", "g++ -c mpeg4_decode.cpp did not run")
    capture = VideoCapture(str(path), device="cpu")
    with pytest.raises(RuntimeError, match="mpeg4_decode.cpp.*did not run"):
        capture.frame(0)
