"""NVDEC bindings: NVIDIA's ``libnvcuvid.so.1`` by ``ctypes``, kept for
when the card's machine opens NVDEC (ROADMAP.md Queue 1 item 9b).
:class:`~hive_tpu_torch.video.capture.VideoCapture` does not use them: H.264
(:mod:`.h264`) and HEVC (:mod:`.hevc`, I, P and B pictures) decode on the
host for every device.

The parser (``cuvidCreateVideoParser`` / ``cuvidParseVideoData``) reads an
Annex-B stream and calls back: at each sequence header (the decoder is made
there, ``cuvidCreateDecoder``, NV12 output at the coded size), for each
picture in decode order (``cuvidDecodePicture``) and for each picture in
display order (``cuvidMapVideoFrame64``: the NV12 surface is wrapped as a
tensor through ``__cuda_array_interface__`` with the surface's pitch as its
row stride, cropped to the format's display area, split into Y / U / V
planes and cloned on torch's current stream, then ``cuvidUnmapVideoFrame64``).
``cuvidGetDecoderCaps`` says what the card decodes.

The decoder works in torch's primary context (``cuCtxGetCurrent`` after
torch has made it current) under a ``cuvidCtxLock``; the post-processing of
each mapped frame runs on torch's current stream. An exception raised in a
callback would be printed and swallowed by ``ctypes``: it is stored, the
callback returns 0, and it is raised after ``cuvidParseVideoData``. Every
failure raises :class:`NvdecError` naming the call and its ``CUresult``;
there is no fallback to the CPU.

The structures declare the fields the port reads or fills in the Video
Codec SDK's layout (``nvcuvid.h``, ``cuviddec.h``), padded with reserved
words the driver ignores. Where the container does not grant the driver's
``video`` capability, ``cuvidGetDecoderCaps`` and ``cuvidCreateDecoder``
fail with CUresult 2 (CUDA_ERROR_OUT_OF_MEMORY) while the parser still
runs; past the parser these layouts are checked only where a decode runs
(ROADMAP.md Queue 1 item 9b).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterable, Iterator, List, Optional, Tuple

import torch

# cudaVideoCodec.
CODECS = {"MPEG-4": 2, "H.264": 4, "HEVC": 8, "VP9": 10, "AV1": 11}
H264 = CODECS["H.264"]
CHROMA_420 = 1
SURFACE_NV12 = 0
CREATE_PREFER_CUVID = 4
DEINTERLACE_WEAVE = 0
PKT_END_OF_STREAM, PKT_TIMESTAMP, PKT_END_OF_PICTURE = 0x01, 0x02, 0x08
# Pictures the parser holds before display (the SDK samples' default);
# display order itself follows the stream's POC.
DISPLAY_DELAY = 1


class NvdecError(RuntimeError):
    """A failed NVDEC or CUDA driver call."""


class Rect16(ctypes.Structure):
    _fields_ = [("left", ctypes.c_short), ("top", ctypes.c_short),
                ("right", ctypes.c_short), ("bottom", ctypes.c_short)]


class DecodeCaps(ctypes.Structure):
    """CUVIDDECODECAPS."""
    _fields_ = [("eCodecType", ctypes.c_int), ("eChromaFormat", ctypes.c_int),
                ("nBitDepthMinus8", ctypes.c_uint), ("reserved1", ctypes.c_uint * 3),
                ("bIsSupported", ctypes.c_ubyte), ("nNumNVDECs", ctypes.c_ubyte),
                ("nOutputFormatMask", ctypes.c_ushort), ("nMaxWidth", ctypes.c_uint),
                ("nMaxHeight", ctypes.c_uint), ("nMaxMBCount", ctypes.c_uint),
                ("nMinWidth", ctypes.c_ushort), ("nMinHeight", ctypes.c_ushort),
                ("reserved3", ctypes.c_uint * 11)]


class DecodeCreateInfo(ctypes.Structure):
    """CUVIDDECODECREATEINFO."""
    _fields_ = [("ulWidth", ctypes.c_ulong), ("ulHeight", ctypes.c_ulong),
                ("ulNumDecodeSurfaces", ctypes.c_ulong), ("CodecType", ctypes.c_int),
                ("ChromaFormat", ctypes.c_int), ("ulCreationFlags", ctypes.c_ulong),
                ("bitDepthMinus8", ctypes.c_ulong), ("ulIntraDecodeOnly", ctypes.c_ulong),
                ("ulMaxWidth", ctypes.c_ulong), ("ulMaxHeight", ctypes.c_ulong),
                ("Reserved1", ctypes.c_ulong), ("display_area", Rect16),
                ("OutputFormat", ctypes.c_int), ("DeinterlaceMode", ctypes.c_int),
                ("ulTargetWidth", ctypes.c_ulong), ("ulTargetHeight", ctypes.c_ulong),
                ("ulNumOutputSurfaces", ctypes.c_ulong), ("vidLock", ctypes.c_void_p),
                ("target_rect", Rect16), ("enableHistogram", ctypes.c_ulong),
                ("Reserved2", ctypes.c_ulong * 4)]


class VideoFormat(ctypes.Structure):
    """CUVIDEOFORMAT."""
    _fields_ = [("codec", ctypes.c_int), ("frame_rate_num", ctypes.c_uint),
                ("frame_rate_den", ctypes.c_uint), ("progressive_sequence", ctypes.c_ubyte),
                ("bit_depth_luma_minus8", ctypes.c_ubyte),
                ("bit_depth_chroma_minus8", ctypes.c_ubyte),
                ("min_num_decode_surfaces", ctypes.c_ubyte), ("coded_width", ctypes.c_uint),
                ("coded_height", ctypes.c_uint), ("display_left", ctypes.c_int),
                ("display_top", ctypes.c_int), ("display_right", ctypes.c_int),
                ("display_bottom", ctypes.c_int), ("chroma_format", ctypes.c_int),
                ("bitrate", ctypes.c_uint), ("aspect_x", ctypes.c_int), ("aspect_y", ctypes.c_int),
                ("signal", ctypes.c_ubyte * 4), ("seqhdr_data_length", ctypes.c_uint)]


class ParserDispInfo(ctypes.Structure):
    """CUVIDPARSERDISPINFO."""
    _fields_ = [("picture_index", ctypes.c_int), ("progressive_frame", ctypes.c_int),
                ("top_field_first", ctypes.c_int), ("repeat_first_field", ctypes.c_int),
                ("timestamp", ctypes.c_longlong)]


class ProcParams(ctypes.Structure):
    """CUVIDPROCPARAMS."""
    _fields_ = [("progressive_frame", ctypes.c_int), ("second_field", ctypes.c_int),
                ("top_field_first", ctypes.c_int), ("unpaired_field", ctypes.c_int),
                ("reserved_flags", ctypes.c_uint), ("reserved_zero", ctypes.c_uint),
                ("raw_input_dptr", ctypes.c_ulonglong), ("raw_input_pitch", ctypes.c_uint),
                ("raw_input_format", ctypes.c_uint), ("raw_output_dptr", ctypes.c_ulonglong),
                ("raw_output_pitch", ctypes.c_uint), ("Reserved1", ctypes.c_uint),
                ("output_stream", ctypes.c_void_p), ("Reserved", ctypes.c_uint * 46),
                ("histogram_dptr", ctypes.c_void_p), ("Reserved2", ctypes.c_void_p * 1)]


SEQUENCE_CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                     ctypes.POINTER(VideoFormat))
DECODE_CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
DISPLAY_CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                    ctypes.POINTER(ParserDispInfo))


class ParserParams(ctypes.Structure):
    """CUVIDPARSERPARAMS."""
    _fields_ = [("CodecType", ctypes.c_int), ("ulMaxNumDecodeSurfaces", ctypes.c_uint),
                ("ulClockRate", ctypes.c_uint), ("ulErrorThreshold", ctypes.c_uint),
                ("ulMaxDisplayDelay", ctypes.c_uint), ("flags", ctypes.c_uint),
                ("uReserved1", ctypes.c_uint * 4), ("pUserData", ctypes.c_void_p),
                ("pfnSequenceCallback", SEQUENCE_CALLBACK),
                ("pfnDecodePicture", DECODE_CALLBACK),
                ("pfnDisplayPicture", DISPLAY_CALLBACK),
                ("pfnGetOperatingPoint", ctypes.c_void_p), ("pfnGetSEIMsg", ctypes.c_void_p),
                ("pvReserved2", ctypes.c_void_p * 5), ("pExtVideoInfo", ctypes.c_void_p)]


class SourceDataPacket(ctypes.Structure):
    """CUVIDSOURCEDATAPACKET."""
    _fields_ = [("flags", ctypes.c_ulong), ("payload_size", ctypes.c_ulong),
                ("payload", ctypes.c_char_p), ("timestamp", ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def _libraries() -> Tuple[ctypes.CDLL, ctypes.CDLL]:
    """(libnvcuvid, libcuda), with their signatures declared."""
    try:
        cuvid = ctypes.CDLL("libnvcuvid.so.1")
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise NvdecError(f"NVDEC is not available: {e} (the NVIDIA driver's libnvcuvid.so.1 "
                         f"and libcuda.so.1 are needed)") from e
    pointer = ctypes.c_void_p
    for name, args in (
            ("cuvidGetDecoderCaps", [ctypes.POINTER(DecodeCaps)]),
            ("cuvidCreateDecoder", [ctypes.POINTER(pointer), ctypes.POINTER(DecodeCreateInfo)]),
            ("cuvidDestroyDecoder", [pointer]),
            ("cuvidDecodePicture", [pointer, pointer]),
            ("cuvidMapVideoFrame64", [pointer, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_ulonglong),
                                      ctypes.POINTER(ctypes.c_uint),
                                      ctypes.POINTER(ProcParams)]),
            ("cuvidUnmapVideoFrame64", [pointer, ctypes.c_ulonglong]),
            ("cuvidCtxLockCreate", [ctypes.POINTER(pointer), pointer]),
            ("cuvidCtxLockDestroy", [pointer]),
            ("cuvidCreateVideoParser", [ctypes.POINTER(pointer),
                                        ctypes.POINTER(ParserParams)]),
            ("cuvidParseVideoData", [pointer, ctypes.POINTER(SourceDataPacket)]),
            ("cuvidDestroyVideoParser", [pointer])):
        function = getattr(cuvid, name)
        function.argtypes, function.restype = args, ctypes.c_int
    cuda.cuCtxGetCurrent.argtypes, cuda.cuCtxGetCurrent.restype = [
        ctypes.POINTER(pointer)], ctypes.c_int
    cuda.cuGetErrorName.argtypes, cuda.cuGetErrorName.restype = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)], ctypes.c_int
    return cuvid, cuda


def _check(result: int, call: str) -> None:
    if result != 0:
        name = ctypes.c_char_p()
        _, cuda = _libraries()
        known = cuda.cuGetErrorName(result, ctypes.byref(name)) == 0 and name.value
        raise NvdecError(f"{call} failed: CUresult {result}"
                         + (f" ({name.value.decode()})" if known else ""))


def _context(device: torch.device) -> ctypes.c_void_p:
    """torch's primary context on ``device``, made current on this thread."""
    torch.cuda.init()
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    _, cuda = _libraries()
    context = ctypes.c_void_p()
    _check(cuda.cuCtxGetCurrent(ctypes.byref(context)), "cuCtxGetCurrent")
    if not context.value:
        raise NvdecError("cuCtxGetCurrent found no current CUDA context after torch's init")
    return context


def decoder_caps(device, codec: int = H264, width: int = 1920, height: int = 1440,
                 bit_depth: int = 8) -> dict:
    """``cuvidGetDecoderCaps`` for 4:2:0 ``codec`` on ``device``: whether
    the card decodes it, its NVDEC count and limits, and whether
    ``width`` x ``height`` lies within them."""
    device = torch.device(device)
    _context(device)
    cuvid, _ = _libraries()
    caps = DecodeCaps(eCodecType=codec, eChromaFormat=CHROMA_420,
                      nBitDepthMinus8=bit_depth - 8)
    _check(cuvid.cuvidGetDecoderCaps(ctypes.byref(caps)), "cuvidGetDecoderCaps")
    fits = (bool(caps.bIsSupported) and caps.nMinWidth <= width <= caps.nMaxWidth
            and caps.nMinHeight <= height <= caps.nMaxHeight
            and -(-width // 16) * -(-height // 16) <= caps.nMaxMBCount)
    return dict(supported=bool(caps.bIsSupported), nvdecs=caps.nNumNVDECs,
                output_formats=caps.nOutputFormatMask, max_width=caps.nMaxWidth,
                max_height=caps.nMaxHeight, max_macroblocks=caps.nMaxMBCount,
                min_width=caps.nMinWidth, min_height=caps.nMinHeight, fits=fits)


class _Surface:
    """A mapped NV12 surface (rows x pitch bytes) for ``torch.as_tensor``."""

    def __init__(self, pointer: int, rows: int, pitch: int):
        self.__cuda_array_interface__ = dict(shape=(rows, pitch), typestr="|u1",
                                             data=(pointer, False), version=2)


class NvdecDecoder:
    """One H.264 stream decoded on ``device``. Feed it Annex-B access units
    with :meth:`decode` (each with a timestamp, given back with its
    picture), then :meth:`flush`; both return the pictures that came out in
    display order as (timestamp, Y, U, V) uint8 tensors on the device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.context = _context(self.device)
        self.cuvid, _ = _libraries()
        self.lock = ctypes.c_void_p()
        _check(self.cuvid.cuvidCtxLockCreate(ctypes.byref(self.lock), self.context),
               "cuvidCtxLockCreate")
        self.decoder = ctypes.c_void_p()
        self.parser = ctypes.c_void_p()
        self.format: Optional[dict] = None
        # What the parser's sequence callback last reported (logged by
        # chip_smoke.py where the decoder cannot be made).
        self.reported: Optional[dict] = None
        self.frames: List[tuple] = []
        self.error: Optional[BaseException] = None
        # The callbacks must outlive the parser.
        self._callbacks = (SEQUENCE_CALLBACK(self._on_sequence),
                           DECODE_CALLBACK(self._on_decode),
                           DISPLAY_CALLBACK(self._on_display))
        params = ParserParams(CodecType=H264, ulMaxNumDecodeSurfaces=1, ulClockRate=0,
                              ulErrorThreshold=0, ulMaxDisplayDelay=DISPLAY_DELAY,
                              pfnSequenceCallback=self._callbacks[0],
                              pfnDecodePicture=self._callbacks[1],
                              pfnDisplayPicture=self._callbacks[2])
        _check(self.cuvid.cuvidCreateVideoParser(ctypes.byref(self.parser),
                                                 ctypes.byref(params)),
               "cuvidCreateVideoParser")

    # -- callbacks (called inside cuvidParseVideoData) -------------------------
    def _guarded(self, fn, *args) -> int:
        if self.error is not None:
            return 0
        try:
            return fn(*args)
        except BaseException as e:  # re-raised by _parse after the C call returns
            self.error = e
            return 0

    def _on_sequence(self, _, fmt) -> int:
        return self._guarded(self._sequence, fmt.contents)

    def _on_decode(self, _, pic_params) -> int:
        return self._guarded(self._decode_picture, pic_params)

    def _on_display(self, _, info) -> int:
        return self._guarded(self._display, info)

    def _sequence(self, fmt: VideoFormat) -> int:
        self.reported = dict(codec=fmt.codec, coded=(fmt.coded_height, fmt.coded_width),
                             display=(fmt.display_left, fmt.display_top, fmt.display_right,
                                      fmt.display_bottom),
                             chroma_format=fmt.chroma_format,
                             bit_depth=8 + fmt.bit_depth_luma_minus8,
                             min_surfaces=fmt.min_num_decode_surfaces)
        if fmt.codec != H264:
            raise NvdecError(f"the parser reported codec {fmt.codec}, not H.264")
        if fmt.chroma_format != CHROMA_420 or fmt.bit_depth_luma_minus8 or \
                fmt.bit_depth_chroma_minus8:
            raise NvdecError(f"the stream is chroma format {fmt.chroma_format} at "
                             f"{8 + fmt.bit_depth_luma_minus8} bits; the port decodes 8-bit "
                             f"4:2:0 H.264")
        caps = decoder_caps(self.device, H264, fmt.coded_width, fmt.coded_height)
        if not caps["fits"]:
            raise NvdecError(f"cuvidGetDecoderCaps: the card does not decode 8-bit 4:2:0 "
                             f"H.264 at {fmt.coded_width}x{fmt.coded_height} ({caps})")
        surfaces = min(32, fmt.min_num_decode_surfaces + 2)
        self._destroy_decoder()
        width, height = fmt.coded_width, fmt.coded_height
        info = DecodeCreateInfo(
            ulWidth=width, ulHeight=height, ulNumDecodeSurfaces=surfaces, CodecType=H264,
            ChromaFormat=CHROMA_420, ulCreationFlags=CREATE_PREFER_CUVID, bitDepthMinus8=0,
            ulMaxWidth=width, ulMaxHeight=height,
            display_area=Rect16(0, 0, width, height), OutputFormat=SURFACE_NV12,
            DeinterlaceMode=DEINTERLACE_WEAVE, ulTargetWidth=width, ulTargetHeight=height,
            ulNumOutputSurfaces=2, vidLock=self.lock)
        _check(self.cuvid.cuvidCreateDecoder(ctypes.byref(self.decoder), ctypes.byref(info)),
               "cuvidCreateDecoder")
        self.format = dict(coded=(height, width), left=fmt.display_left, top=fmt.display_top,
                           right=fmt.display_right, bottom=fmt.display_bottom)
        return surfaces

    def _decode_picture(self, pic_params) -> int:
        _check(self.cuvid.cuvidDecodePicture(self.decoder, pic_params), "cuvidDecodePicture")
        return 1

    def _display(self, info) -> int:
        if not info:                                # end of stream
            return 1
        info = info.contents
        params = ProcParams(progressive_frame=info.progressive_frame,
                            top_field_first=info.top_field_first,
                            unpaired_field=int(info.repeat_first_field < 0),
                            output_stream=torch.cuda.current_stream(self.device).cuda_stream)
        pointer, pitch = ctypes.c_ulonglong(), ctypes.c_uint()
        _check(self.cuvid.cuvidMapVideoFrame64(self.decoder, info.picture_index,
                                               ctypes.byref(pointer), ctypes.byref(pitch),
                                               ctypes.byref(params)),
               "cuvidMapVideoFrame64")
        try:
            coded_h, _ = self.format["coded"]
            luma_rows = (coded_h + 1) & ~1
            surface = torch.as_tensor(_Surface(pointer.value, luma_rows + coded_h // 2,
                                               pitch.value), device=self.device)
            top, bottom = self.format["top"], self.format["bottom"]
            left, right = self.format["left"], self.format["right"]
            y = surface[top:bottom, left:right].clone()
            chroma = surface[luma_rows + top // 2:luma_rows + bottom // 2, left:right]
            chroma = chroma.reshape(chroma.shape[0], -1, 2)
            u, v = chroma[..., 0].clone(), chroma[..., 1].clone()
            # The copies read the surface: finish them before it is unmapped.
            torch.cuda.current_stream(self.device).synchronize()
        finally:
            _check(self.cuvid.cuvidUnmapVideoFrame64(self.decoder, pointer),
                   "cuvidUnmapVideoFrame64")
        self.frames.append((info.timestamp, y, u, v))
        return 1

    # -- feeding --------------------------------------------------------------
    def _parse(self, packet: SourceDataPacket, payload) -> List[tuple]:
        result = self.cuvid.cuvidParseVideoData(self.parser, ctypes.byref(packet))
        del payload
        if self.error is not None:
            error, self.error = self.error, None
            raise error
        _check(result, "cuvidParseVideoData")
        frames, self.frames = self.frames, []
        return frames

    def decode(self, access_unit: bytes, timestamp: int) -> List[tuple]:
        payload = ctypes.create_string_buffer(access_unit, len(access_unit))
        packet = SourceDataPacket(flags=PKT_TIMESTAMP | PKT_END_OF_PICTURE,
                                  payload_size=len(access_unit),
                                  payload=ctypes.cast(payload, ctypes.c_char_p),
                                  timestamp=timestamp)
        return self._parse(packet, payload)

    def flush(self) -> List[tuple]:
        return self._parse(SourceDataPacket(flags=PKT_END_OF_STREAM), None)

    def decode_all(self, access_units: Iterable[Tuple[bytes, int]]) -> Iterator[tuple]:
        for unit, timestamp in access_units:
            yield from self.decode(unit, timestamp)
        yield from self.flush()

    # -- lifetime -------------------------------------------------------------
    def _destroy_decoder(self) -> None:
        if self.decoder.value:
            _check(self.cuvid.cuvidDestroyDecoder(self.decoder), "cuvidDestroyDecoder")
            self.decoder = ctypes.c_void_p()

    def close(self) -> None:
        if self.parser.value:
            _check(self.cuvid.cuvidDestroyVideoParser(self.parser), "cuvidDestroyVideoParser")
            self.parser = ctypes.c_void_p()
        self._destroy_decoder()
        if self.lock.value:
            _check(self.cuvid.cuvidCtxLockDestroy(self.lock), "cuvidCtxLockDestroy")
            self.lock = ctypes.c_void_p()

    def __enter__(self) -> "NvdecDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
