"""Video input: an MP4 demuxer (:mod:`.mp4`), H.264 decode on the card
through NVDEC (:mod:`.nvdec`), the I_PCM subset of H.264 both ways for the
CPU (:mod:`.h264_pcm`), Motion JPEG decode on the host (:mod:`.mjpeg`), the
YUV to BGR conversions of OpenCV's FFmpeg backend (:mod:`.color`), and
:class:`.capture.VideoCapture`, which puts them together as
``cv2.VideoCapture`` reads a file."""
