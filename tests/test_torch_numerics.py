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
  sums depend on the order; so does a numpy model of the CUDA kernel's
  schedule (steps of 32 entries, each step's lanes that hit one bin added
  by the lowest in lane order, +-0 and out-of-range entries skipped), on
  ``chip_smoke.ORDERED_HIST_LAYOUTS``'s adversarial rows. On the card
  (``cuda`` marker) the kernel equals the plain version on those layouts.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from chip_smoke import (ORDERED_HIST_LAYOUTS, check_ordered_hist_layouts, ordered_hist_case,
                        ordered_hist_in_range)
from hive_tpu_torch.core.numerics import f32, fma_f32
from hive_tpu_torch.ops import ordered_hist as ordered_hist_module
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
    """Each row's bins summed in entry order, in float32, one add at a
    time, from +0; an index outside [0, bins) is skipped."""
    out = np.zeros((len(index), bins), np.float32)
    for r in range(len(index)):
        for b, v in zip(index[r].tolist(), value[r]):
            if 0 <= b < bins:
                out[r, b] = np.float32(out[r, b] + v)
    return out


def kernel_schedule_sums(index: np.ndarray, value: np.ndarray, bins: int) -> np.ndarray:
    """A model of ``csrc/ordered_hist.cu``'s schedule: a row's entries in
    steps of 32, lane l holding entry e0 + l; an entry is skipped when its
    index lies outside [0, bins) or its value is +0 or -0; the lanes of a
    step that hit one bin form a group, and its lowest lane adds its own
    value and then its peers' in lane order into the bin's running value,
    one float32 add each."""
    out = np.zeros((len(index), bins), np.float32)
    for r in range(len(index)):
        hist = out[r]
        for e0 in range(0, index.shape[1], 32):
            lane_bins = index[r, e0:e0 + 32].tolist()
            lane_values = value[r, e0:e0 + 32]
            active = [0 <= b < bins and (int(v.view(np.uint32)) << 1) & 0xFFFFFFFF != 0
                      for b, v in zip(lane_bins, lane_values)]
            groups = {}
            for lane, b in enumerate(lane_bins):
                if active[lane]:
                    groups.setdefault(b, []).append(lane)
            for b, lanes in groups.items():       # different bins: any order
                total = np.float32(hist[b] + lane_values[lanes[0]])
                for lane in lanes[1:]:
                    total = np.float32(total + lane_values[lane])
                hist[b] = total
    return out


@pytest.mark.parametrize("layout,rows,entries,bins", [
    pytest.param(*case, id="-".join(map(str, case[1:])) if case[0] == "random"
                 else "-".join(map(str, case))) for case in ORDERED_HIST_LAYOUTS])
def test_ordered_hist_sums_each_row_in_entry_order(layout, rows, entries, bins):
    """Values of wildly different sizes, so that another order of adds
    gives other float32 sums; the plain version (scatter_add_ on the CPU,
    given the entries the kernel adds) and the model of the kernel's
    schedule both equal the in-order sum bit for bit."""
    rng = np.random.default_rng(rows * 1000 + entries)
    index, value = ordered_hist_case(layout, rows, entries, bins, rng)
    want = in_order_sums(index, value, bins)
    np.testing.assert_array_equal(kernel_schedule_sums(index, value, bins).view(np.int32),
                                  want.view(np.int32))
    kept_index, kept_value = ordered_hist_in_range(index, value, bins)
    got = ordered_hist(torch.from_numpy(kept_index), torch.from_numpy(kept_value), bins)
    assert got.dtype == torch.float32 and got.shape == (rows, bins)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    plain = ordered_hist_plain(torch.from_numpy(kept_index), torch.from_numpy(kept_value), bins)
    assert torch.equal(plain, got)
    if layout == "signed_zeros":                 # a row of zeros alone sums to +0
        assert not np.signbit(want[0]).any() and not want[0].any()
    if entries > 1:
        shuffled = in_order_sums(index[:, ::-1], value[:, ::-1], bins)
        assert (shuffled != want).any()          # the order does matter here


@pytest.mark.cuda
@pytest.mark.parametrize("case", [pytest.param(case, id="-".join(map(str, case)))
                                  for case in ORDERED_HIST_LAYOUTS])
def test_ordered_hist_kernel_on_card_equals_plain(case):
    """The kernel on the card equals the plain version on the CPU bit for
    bit on each layout, with rows that fill no whole block (chip_smoke's
    check, one layout a case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    assert check_ordered_hist_layouts("cuda", [case]) == [
        f"{case[0]} {case[1] * ordered_hist_module.WARPS_PER_BLOCK + 3}x{case[2]}->{case[3]}"]


def test_ordered_hist_checks_its_inputs():
    index = torch.zeros((2, 3), dtype=torch.int32)
    value = torch.zeros((2, 3))
    with pytest.raises(ValueError):
        ordered_hist(index.long(), value, 4)
    with pytest.raises(ValueError):
        ordered_hist(index, value.double(), 4)
    with pytest.raises(ValueError):
        ordered_hist(index, value[:, :2], 4)
