"""float32 rounding helpers shared by the modules that mirror another
library's float32 arithmetic bit for bit (OpenCV's SIFT and MOG2, XLA:CPU's
rasteriser).

:func:`fma_f32` is a correctly rounded float32 ``fma(a, b, c)`` on any
device. The product of two float32 values is exact in float64, but the
float64 sum ``s = a*b + c`` is itself rounded, and rounding ``s`` again to
float32 can land on the wrong side when ``s`` falls exactly halfway between
two float32 values (e.g. a = 2^-24 (1 + 2^-12), b = 1 - 2^-12 + 2^-24,
c = 1: the exact sum 1 + 2^-24 + 2^-60 rounds in float64 to the float32 tie
1 + 2^-24, which ties-to-even takes down to 1.0 where a true FMA gives
1.0000001). Such sums are rare, so the helper finds them with an exact
test on ``s``'s bits and only those take TwoSum's residue ``e = (a*b + c) -
s``: when ``e`` is not 0 and ``s``'s last bit is even, ``s`` steps one
float64 ulp toward ``e`` (round to odd), which the cast to float32 then
rounds once, correctly. Sums in float32's subnormal range take the same
step.
"""

from __future__ import annotations

import numpy as np
import torch

# The low 29 bits of a float64 that lies exactly halfway between two
# normal float32 values: bit 28 set, bits 0-27 clear.
_HALF_MASK, _HALF_BITS = (1 << 29) - 1, 1 << 28
_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _operand(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor or a Python number holding a float32 value) as a
    float64 tensor on ``like``'s device."""
    if torch.is_tensor(x):
        return x.to(device=like.device, dtype=torch.float64)
    return torch.full((1,), x, dtype=torch.float64, device=like.device)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``fma(a, b, c)`` of float32 values (``b``
    and ``c`` may be tensors, float64 included, or Python numbers that hold
    float32 values), broadcast, on ``a``'s device."""
    b64, c64 = _operand(b, a), _operand(c, a)
    # One float64 multiply-add (a is promoted inside the op): a*b is exact,
    # so s is the exact sum rounded once.
    s = torch.addcmul(c64, a, b64)
    out = s.float()
    bits = s.view(torch.int64)
    suspect = ((bits & _HALF_MASK) == _HALF_BITS) | ((s.abs() < _F32_MIN_NORMAL) & (s != 0))
    index = torch.nonzero(suspect, as_tuple=True)
    if index[0].numel():
        shape = s.shape
        p = a.expand(shape)[index].double() * b64.expand(shape)[index]
        cs, ss = c64.expand(shape)[index], s[index]
        z = ss - p                             # TwoSum: p + cs == ss + e exactly
        e = (p - (ss - z)) + (cs - z)
        even = (ss.view(torch.int64) & 1) == 0
        toward = torch.nextafter(ss, torch.where(e > 0, torch.inf, -torch.inf)
                                 .to(torch.float64))
        out[index] = torch.where((e != 0) & even, toward, ss).float()
    return out
