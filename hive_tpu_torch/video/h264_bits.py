"""H.264's bit I/O: the exp-Golomb writer and reader, emulation prevention
and NAL units, which :mod:`.h264`'s reader and writer share; and what
:mod:`.hevc` shares with it: the same bit I/O and the output order
(:func:`display_order`).
"""

from __future__ import annotations

import heapq
from typing import Iterable, Iterator, List, Optional

import numpy as np

NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8
LOG2_MAX_POC_LSB = 16


# ---------------------------------------------------------------------------
# Bits.
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, n: int, value: int) -> "BitWriter":
        self.bits.extend((value >> i) & 1 for i in range(n - 1, -1, -1))
        return self

    def ue(self, value: int) -> "BitWriter":
        code = value + 1
        return self.u(code.bit_length() - 1, 0).u(code.bit_length(), code)

    def se(self, value: int) -> "BitWriter":
        return self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align(self, stop_bit: bool) -> bytes:
        """The bits as bytes, after an optional stop bit and zero padding."""
        if stop_bit:
            self.u(1, 1)
        self.bits.extend([0] * (-len(self.bits) % 8))
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        first, last = self.pos >> 3, (self.pos + n + 7) >> 3
        if last > len(self.data):
            raise ValueError("H.264 syntax element past the end of its NAL unit")
        word = int.from_bytes(self.data[first:last], "big")
        value = (word >> ((last << 3) - self.pos - n)) & ((1 << n) - 1)
        self.pos += n
        return value

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("corrupt Exp-Golomb code")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def byte_aligned(self) -> int:
        """Skip to the next byte boundary; the byte offset there."""
        self.pos = -(-self.pos // 8) * 8
        return self.pos >> 3


def escape(rbsp: np.ndarray) -> np.ndarray:
    """Insert emulation-prevention bytes (0x03) into an RBSP, as H.264 7.4.1
    asks: after two zero bytes whenever the next byte is 0-3, and at the end
    when the payload ends with a zero."""
    rbsp = np.asarray(rbsp, np.uint8)
    zero = np.concatenate([[False], rbsp == 0, [False]]).astype(np.int8)
    edges = np.diff(zero)
    starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)
    lengths = ends - starts
    at: List[np.ndarray] = []
    # Inside each run of k zeros, before zeros 2, 4, ... (< k).
    long = lengths > 2
    if long.any():
        counts = (lengths[long] - 1) // 2
        base = np.repeat(starts[long], counts)
        step = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        at.append(base + 2 + 2 * step)
    # After a run of an even length, before a following byte of 1-3 (or at
    # the end of the payload).
    even = (lengths % 2 == 0)
    after = ends[even]
    nxt = np.where(after < len(rbsp), rbsp[np.minimum(after, len(rbsp) - 1)], 0)
    at.append(after[nxt <= 3])
    at = np.sort(np.concatenate(at))
    return np.insert(rbsp, at, np.uint8(3))


def unescape(nal: bytes) -> bytes:
    """Remove emulation-prevention bytes: each 0x03 after two zero bytes."""
    data = np.frombuffer(nal, np.uint8)
    if len(data) < 3:
        return bytes(nal)
    hit = np.flatnonzero((data[2:] == 3) & (data[1:-1] == 0) & (data[:-2] == 0)) + 2
    if len(hit) == 0:
        return bytes(nal)
    keep = np.ones(len(data), bool)
    keep[hit] = False
    return data[keep].tobytes()


def nal_unit(ref_idc: int, nal_type: int, rbsp: np.ndarray) -> bytes:
    return bytes([(ref_idc << 5) | nal_type]) + escape(rbsp).tobytes()


# ---------------------------------------------------------------------------
# Output order.
# ---------------------------------------------------------------------------

def display_order(pictures: Iterable, reorder: Optional[int]) -> Iterator:
    """Pictures (each with ``poc`` and ``flush``) in display order, as FFmpeg
    outputs them: a buffer of ``reorder`` pictures (absent, 0) ordered by
    POC, flushed before each picture whose ``flush`` is set (H.264: an IDR
    picture or MMCO 5; HEVC: an IRAP picture with NoRaslOutputFlag) and at
    the end."""
    heap: list = []
    count = 0
    for picture in pictures:
        if picture.flush:
            while heap:
                yield heapq.heappop(heap)[2]
        heapq.heappush(heap, (picture.poc, count, picture))
        count += 1
        if len(heap) > (reorder or 0):
            yield heapq.heappop(heap)[2]
    while heap:
        yield heapq.heappop(heap)[2]


def out_of_order(pictures: Iterable, reorder: Optional[int]) -> bool:
    """Whether :func:`display_order` with ``reorder`` leaves two pictures
    between flushes out of POC order: a stream whose output order the
    reorder depth does not give."""
    last = None
    for picture in display_order(pictures, reorder):
        if picture.flush:
            last = None
        if last is not None and picture.poc <= last:
            return True
        last = picture.poc
    return False
