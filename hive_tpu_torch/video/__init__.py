"""Video input: an MP4 demuxer (:mod:`.mp4`), H.264 decode on the host
(:mod:`.h264`, I, P and B slices, CAVLC or CABAC, with
``native/src/h264_decode.cpp``), HEVC intra decode on the host
(:mod:`.hevc`, with ``native/src/hevc_decode.cpp``),
H.264's bit I/O (:mod:`.h264_bits`, HEVC's too), Motion JPEG and
MPEG-4 Part 2 decode on the host (:mod:`.mjpeg`, :mod:`.mpeg4`), NVDEC's
bindings (:mod:`.nvdec`, not on the decode path: ROADMAP Queue 1 item
9b), the YUV to BGR conversions of OpenCV's FFmpeg backend (:mod:`.color`),
and :class:`.capture.VideoCapture`, which puts them together as
``cv2.VideoCapture`` reads a file."""
