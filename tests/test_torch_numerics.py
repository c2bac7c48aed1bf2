"""The float32 helpers of ``hive_tpu_torch.core.numerics`` and the ordered
histogram of ``hive_tpu_torch.ops.ordered_hist`` on the CPU, against exact
arithmetic:

* ``fma_f32`` equals a correctly rounded FMA, computed here with
  ``fractions.Fraction`` and rounded to float32 by hand, on every case:
  exactly (an FMA has one right answer). The cases are the double-rounding
  operands of the module's docstring, families built to land the float64
  sum on a float32 midpoint (above and below it, both signs, and in
  float32's subnormal range), and a seeded sweep over random exponents;
* ``ordered_hist`` (its plain version here) equals each row's float32 sum
  in entry order, one rounded add at a time, bit for bit, on values whose
  sums depend on the order.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from hive_tpu_torch.core.numerics import f32, fma_f32
from hive_tpu_torch.ops.ordered_hist import ordered_hist, ordered_hist_plain


def exact_fma_f32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """The correctly rounded float32 of a*b + c (ties to even)."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    guess = np.float32(float(x))               # within one float32 ulp of the answer
    candidates = [np.nextafter(guess, np.float32(-np.inf)), guess,
                  np.nextafter(guess, np.float32(np.inf))]
    candidates = [v for v in candidates if np.isfinite(v)]

    def key(v):
        even = int(np.float32(v).view(np.int32)) & 1
        return abs(Fraction(float(v)) - x), even

    return min(candidates, key=key)


def check_against_exact(a, b, c):
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([exact_fma_f32(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    return got


def test_fma_rounds_the_double_rounding_case_once():
    a, b = 2.0 ** -24 * (1 + 2.0 ** -12), 1 - 2.0 ** -12 + 2.0 ** -24
    assert f32(a) == a and f32(b) == b
    got = fma_f32(torch.tensor([a]), torch.tensor([b]), 1.0)
    assert got.dtype == torch.float32
    assert got.item() == float(np.float32(1.0000001))
    # What float64 then float32 gives: the tie 1 + 2^-24 rounded to even.
    assert float(np.float32(np.float64(a) * b + 1.0)) == 1.0
    # Python numbers and float64 operands of float32 values, broadcast.
    wide = fma_f32(torch.full((2, 3), a), torch.tensor([b], dtype=torch.float64),
                   torch.ones(2, 1))
    assert wide.shape == (2, 3) and (wide == got).all()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fma_at_float32_midpoints(sign):
    """a*b + c whose float64 sum is a float32 midpoint, the exact sum just
    above it (2^-60 relative) or just below it, for c of odd and even
    mantissas over many binades; then at float32's subnormal midpoints."""
    rng = np.random.default_rng(1 if sign > 0 else 2)
    n = 400
    exponent = rng.integers(-100, 100, n)
    mantissa = 1 + rng.integers(0, 1 << 23, n) / float(1 << 23)
    c = sign * np.ldexp(mantissa, exponent)
    up = rng.random(n) < 0.5
    # (1 + 2^-12)(1 - 2^-12 + 2^-24) = 1 + 2^-36; (1 + 2^-18)(1 - 2^-18) = 1 - 2^-36.
    a = sign * np.ldexp(np.where(up, 1 + 2.0 ** -12, 1 + 2.0 ** -18), exponent - 24)
    b = np.where(up, 1 - 2.0 ** -12 + 2.0 ** -24, 1 - 2.0 ** -18)
    got = check_against_exact(a, b, c)
    # The family really tests the correction: double rounding is wrong on
    # about half of the cases (those that tie the wrong way).
    twice = (a.astype(np.float32).astype(np.float64) * b.astype(np.float32)
             + c.astype(np.float32)).astype(np.float32)
    assert (twice != got).mean() > 0.25

    # 2^-130 + 2^-150 (1 + 2^-36): a midpoint between float32 subnormals.
    tiny = np.ldexp(np.ones(4), [-130, -140, -149, -126]) * sign
    check_against_exact(np.full(4, sign * 2.0 ** -75 * (1 + 2.0 ** -12)),
                        np.full(4, 2.0 ** -75 * (1 - 2.0 ** -12 + 2.0 ** -24)), tiny)


def test_fma_sweep_equals_exact_arithmetic():
    """A seeded sweep of float32 operands over random exponents (products
    from float32's subnormal range to its overflow edge), zeros and exact
    cancellations included."""
    rng = np.random.default_rng(0)
    n = 6000
    a = rng.standard_normal(n) * np.ldexp(1.0, rng.integers(-70, 60, n))
    b = rng.standard_normal(n) * np.ldexp(1.0, rng.integers(-70, 60, n))
    c = rng.standard_normal(n) * np.ldexp(1.0, rng.integers(-140, 120, n))
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    c[:500] = -(a[:500].astype(np.float64) * b[:500]).astype(np.float32)  # near cancellation
    c[500:600] = 0
    a[600:700] = 0
    finite = np.isfinite(a.astype(np.float64) * b + c) & (np.abs(a.astype(np.float64) * b + c)
                                                         < 3e38)
    check_against_exact(a[finite], b[finite], c[finite])


def test_f32_rounds_to_float32():
    assert f32(0.1) == float(np.float32(0.1)) != 0.1
    assert f32(1.5) == 1.5


def in_order_sums(index: np.ndarray, value: np.ndarray, bins: int) -> np.ndarray:
    """Each row's bins summed in entry order, in float32, one add at a time."""
    out = np.zeros((len(index), bins), np.float32)
    for r in range(len(index)):
        for b, v in zip(index[r].tolist(), value[r]):
            out[r, b] = np.float32(out[r, b] + v)
    return out


@pytest.mark.parametrize("rows,entries,bins", [(3, 200, 36), (5, 1000, 360), (1, 7, 4),
                                               (4, 0, 36)])
def test_ordered_hist_sums_each_row_in_entry_order(rows, entries, bins):
    """Values of wildly different sizes, so that another order of adds
    gives other float32 sums; the plain version (scatter_add_ on the CPU)
    equals the in-order sum bit for bit."""
    rng = np.random.default_rng(rows * 1000 + entries)
    index = rng.integers(0, bins, (rows, entries)).astype(np.int32)
    value = (rng.standard_normal((rows, entries))
             * np.ldexp(1.0, rng.integers(-20, 20, (rows, entries)))).astype(np.float32)
    want = in_order_sums(index, value, bins)
    got = ordered_hist(torch.from_numpy(index), torch.from_numpy(value), bins)
    assert got.dtype == torch.float32 and got.shape == (rows, bins)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    plain = ordered_hist_plain(torch.from_numpy(index), torch.from_numpy(value), bins)
    assert torch.equal(plain, got)
    if entries > 1:
        shuffled = in_order_sums(index[:, ::-1], value[:, ::-1], bins)
        assert (shuffled != want).any()          # the order does matter here


def test_ordered_hist_checks_its_inputs():
    index = torch.zeros((2, 3), dtype=torch.int32)
    value = torch.zeros((2, 3))
    with pytest.raises(ValueError):
        ordered_hist(index.long(), value, 4)
    with pytest.raises(ValueError):
        ordered_hist(index, value.double(), 4)
    with pytest.raises(ValueError):
        ordered_hist(index, value[:, :2], 4)
