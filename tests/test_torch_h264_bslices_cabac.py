"""H.264 B slices with CABAC in hive_tpu_torch (``hive_tpu_torch.video.h264``,
``native/src/h264_decode.cpp``) against cv2 5.0.0: the writer's seeded
High profile B clips (the 8x8 transform on half the macroblocks; spatial
and temporal direct with and without direct_8x8_inference; each
weighted_bipred_idc; each cabac_init_idc, its B contexts among them:
mb_skip_flag, mb_type and sub_mb_type of B slices, ref_idx_l1, mvd_l1),
every frame bit-equal to cv2's; the B contexts of chip_smoke.py's CABAC B
clip; damaged CABAC B slices."""

import copy

import numpy as np
import pytest

import chip_smoke
from hive_tpu_torch.video import h264, h264_bits, mp4
from tests.test_torch_h264 import CORRUPT
from tests.test_torch_h264_bslices import write_case
from tests.test_torch_mpeg4 import assert_reads_as_cv2, scene_planes

N = 12
HIGH = dict(profile=100, cabac=True, transform_8x8=True)
# The contexts only B slices read: mb_skip_flag, mb_type, sub_mb_type.
B_CONTEXTS = range(24, 40)

# name -> (write_h264_mp4 options, Exerciser options, a writer count the
# case must make nonzero)
CASES = {
    "spatial_direct": (HIGH, dict(bframes=2, spatial=1.0, t8x8=0.5, init_idcs=(0,)),
                       "spatial_direct_slices"),
    "spatial_direct_without_8x8_inference": (
        dict(HIGH, direct_8x8_inference=False),
        dict(bframes=2, spatial=1.0, t8x8=0.5, init_idcs=(1,)), "direct_col_zero"),
    "temporal_direct": (HIGH, dict(bframes=3, pyramid=True, spatial=0.0, t8x8=0.5,
                                   init_idcs=(2,)), "direct_ref_mapped"),
    "temporal_direct_without_8x8_inference": (
        dict(HIGH, direct_8x8_inference=False),
        dict(bframes=3, spatial=0.0, t8x8=0.5, init_idcs=(0, 1, 2)), "temporal_direct_slices"),
    "explicit_weights": (dict(HIGH, weighted_pred=True, weighted_bipred=1),
                         dict(bframes=2, weights=1.0, t8x8=0.5, init_idcs=(0, 1, 2)),
                         "b_weight_tables"),
    "implicit_weights": (dict(HIGH, weighted_bipred=2),
                         dict(bframes=3, pyramid=True, t8x8=0.5, init_idcs=(0, 1, 2)),
                         "b_slices_implicit_weights"),
    "main_profile_long_terms": (dict(profile=77, cabac=True, num_ref_frames=4),
                                dict(bframes=3, pyramid=True, gop=12, mmco=0.8,
                                     init_idcs=(0, 1, 2), b_anchors=0.3),
                                "long_term_in_list1"),
}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    folder = tmp_path_factory.mktemp("bslices_cabac")
    return {case: (folder / f"{case}.mp4", write_case(folder / f"{case}.mp4", case, cases=CASES))
            for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cabac_b_clips_read_as_cv2(written, case):
    """Each CABAC B clip reads as cv2 reads it, every frame; the writer
    coded its path and B slices' contexts, and no CAVLC codeword."""
    path, stats = written[case]
    assert_reads_as_cv2(path, count=N)
    assert stats[CASES[case][2]] > 0 and stats["b_pictures"] > 0
    coded = stats["coverage"]["cabac_contexts"]
    assert coded[1:, 24:40].sum() > 0 and stats["coverage"]["coeff_token"].sum() == 0


def test_cabac_b_clips_code_every_b_macroblock_path(written):
    """Over the CABAC cases: every B macroblock type and sub_mb_type, each
    list and both, I_PCM and other intra macroblocks in B slices."""
    totals = {}
    for _, stats in written.values():
        for name, value in stats.items():
            if name != "coverage":
                totals[name] = totals.get(name, 0) + value
    paths = [name for name in h264.STAT_NAMES if name.startswith(("b_", "pred_"))]
    assert [name for name in paths + ["intra_in_b", "cabac_i_pcm"] if not totals[name]] == []


def test_chip_smoke_cabac_b_clip_codes_every_b_context(tmp_path):
    """chip_smoke.py's CABAC B exerciser clip codes every context only B
    slices read (mb_skip_flag 24-26, mb_type 27-35, sub_mb_type 36-39)
    under each cabac_init_idc's table."""
    index = next(k for k, clip in enumerate(chip_smoke.H264_EXERCISER_CLIPS)
                 if clip[0] == "b_cabac_implicit")
    _, stats = chip_smoke.write_h264_exerciser(str(tmp_path), index)
    coded = stats["coverage"]["cabac_contexts"]
    assert [(t, c) for t in (1, 2, 3) for c in B_CONTEXTS if not coded[t, c]] == []


def test_damaged_cabac_b_slices_decode_or_are_refused_as_corrupt(tmp_path):
    """Each CABAC B picture's first slice cut short, and burst bit flips in
    it: refused as corrupt, or decoded at its size."""
    path = tmp_path / "b_cabac.mp4"
    h264.write_h264_mp4(str(path), scene_planes(6, 64, 48),
                        h264.Exerciser(64, 48, 5, bframes=2, t8x8=0.5, init_idcs=(0, 1, 2)),
                        **HIGH, weighted_bipred=2)
    track = mp4.read_track(str(path))
    length, sps, pps = mp4.parse_avcc(track.config)
    decoder = h264.H264Decoder()
    decoder.decode(sps + pps)
    rng = np.random.default_rng(9)
    outcomes = set()
    with open(path, "rb") as f:
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            sample = mp4.split_nal_units(f.read(int(size)), length)
            if decoder.headers([sample[0]])[0][1].slice_type == h264.B_SLICE:
                unit = sample[0]
                for cut in (len(unit) // 4, len(unit) // 2):
                    with pytest.raises(ValueError, match=CORRUPT):
                        copy.deepcopy(decoder).decode([unit[:max(cut, 2)]] + sample[1:])
                for _ in range(15):
                    data = np.frombuffer(h264_bits.unescape(unit), np.uint8).copy()
                    first = int(rng.integers(40, 8 * len(data)))
                    for bit in range(first, min(first + int(rng.choice([1, 9])), 8 * len(data))):
                        data[bit >> 3] ^= 0x80 >> (bit & 7)
                    damaged = bytes([data[0]]) + h264_bits.escape(data[1:]).tobytes()
                    try:
                        picture = copy.deepcopy(decoder).decode([damaged] + sample[1:])
                    except mp4.UnsupportedVideoError:
                        outcomes.add("refused by name")
                    except ValueError as e:
                        assert any(s in str(e) for s in CORRUPT.split("|")), e
                        outcomes.add("refused")
                    else:
                        assert picture.y.shape == (48, 64)
                        outcomes.add("decoded")
            decoder.decode(sample)
    assert "refused" in outcomes or "decoded" in outcomes
