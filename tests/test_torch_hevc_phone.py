"""chip_smoke.py's HEVC phone clip, bit-equal to cv2 5.0.0's frames: the
first PHONE_HEVC_FRAMES 1920x1080 wall renders written as x265 codes a clip
at its medium preset (``video.hevc.InterPlanner``: CTB 64, B pyramids of
four, three references, an open-GOP CRA picture with RASL pictures,
weightp, TMVP, MaxNumMergeCand 3, SAO, sign hiding, four slices). The file
and cv2's frames hash to ``chip_smoke.PHONE_HEVC_DIGESTS``, by which the
script holds the card's host, which has no cv2; cv2 reads the clip three
times (its FFmpeg decodes HEVC on frame threads)."""

import chip_smoke
from tests.test_torch_hevc_inter import read_three_times
from tests.test_torch_mpeg4 import assert_reads_as_cv2


def test_the_phone_clip_reads_as_cv2_and_hashes_to_its_digests(tmp_path):
    """The clip as chip_smoke.py writes it: cv2's frames three times, the
    port's frames and count on the CPU equal to cv2's, and the file and the
    frames hashed to the digests chip_smoke.py holds the card's host to."""
    path = str(tmp_path / "phone_hevc.mp4")
    chip_smoke.write_hevc_phone_clip(path)
    frames = read_three_times(path)
    assert_reads_as_cv2(path, count=chip_smoke.PHONE_HEVC_FRAMES)
    got = (chip_smoke.file_digest(path), chip_smoke.frames_digest(frames))
    assert got == chip_smoke.PHONE_HEVC_DIGESTS
