"""The gates of chip_smoke.py read on the CPU: `max_err` and
`softmax_part_err`, which hold every kernel against its plain version on
the card, report NaN where any difference is NaN (a NaN in the kernel's
output or in the plain version's), so that every gate that reads them
fails; two non-finite values count as equal only when they are the same
value in the same place."""

import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _pair():
    gen = torch.Generator().manual_seed(0)
    want = torch.randn((6, 5), generator=gen)
    return want + 1e-7 * torch.randn((6, 5), generator=gen), want


@pytest.mark.parametrize("side", ["kernel", "plain", "both"])
@pytest.mark.parametrize("relative", [False, True])
def test_max_err_is_nan_on_a_planted_nan(side, relative):
    """A NaN planted in the kernel's output, the plain version's or both
    (two NaN are not equal) makes both gates NaN; without it they read the
    small difference."""
    got, want = _pair()
    assert 0.0 < chip_smoke.max_err([got], [want], relative) < 1e-5
    if side in ("kernel", "both"):
        got[2, 3] = math.nan
    if side in ("plain", "both"):
        want[2, 3] = math.nan
    assert math.isnan(chip_smoke.max_err([got], [want], relative))
    assert math.isnan(chip_smoke.softmax_part_err([got], [want], [want]))


def test_max_err_nan_in_any_tensor_of_the_list():
    """A NaN in the first of several outputs is not hidden by a later
    finite error (Python's max(0.0, nan) is 0.0)."""
    got, want = _pair()
    bad = got.clone()
    bad[0, 0] = math.nan
    assert math.isnan(chip_smoke.max_err([bad, got], [want, want]))
    assert math.isnan(chip_smoke.max_err([got, bad], [want, want]))
    assert math.isnan(chip_smoke.softmax_part_err([bad, got], [want, want],
                                                  [want, want]))


@pytest.mark.parametrize("value", [math.inf, -math.inf])
def test_equal_infinities_in_one_place_count_as_equal(value):
    got, want = _pair()
    got[1, 1] = want[1, 1] = value
    base = chip_smoke.max_err([got], [want])
    assert math.isfinite(base) and base < 1e-5
    assert math.isfinite(chip_smoke.max_err([got], [want], relative=True))


@pytest.mark.parametrize("got_value,want_value", [
    (math.inf, -math.inf), (math.inf, 1.0), (1.0, -math.inf)])
def test_other_non_finite_values_fail(got_value, want_value):
    """An infinity against another value is an infinite error, which the
    gates read as a failure."""
    got, want = _pair()
    got[4, 0], want[4, 0] = got_value, want_value
    assert not math.isfinite(chip_smoke.max_err([got], [want]))


@pytest.mark.parametrize("value", [math.inf, -math.inf])
def test_equal_infinities_in_other_places_fail(value):
    got, want = _pair()
    got[0, 1] = want[0, 2] = value
    assert not math.isfinite(chip_smoke.max_err([got], [want]))


def test_kernel_row_refuses_a_nan_error():
    """kernel_row checks the error before it times anything: a NaN fails
    it."""
    with pytest.raises(AssertionError, match="max err nan"):
        chip_smoke.kernel_row("k", "case", torch.float32, math.nan, 1e-5,
                              None, None, None, 0, 0, 1)
