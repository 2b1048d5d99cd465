"""The MSM work count at shapes worked out by hand."""
import pytest

from portbench import workcount as wc


def test_peaks():
    assert wc.WIDE_MADS_PER_S == 132 * 64 * 1.98e9 / 2
    # the repository's 8.375e12 (67 TFLOP/s over 8), within 0.2 %
    assert abs(wc.WIDE_MADS_PER_S / 8.375e12 - 1) < 2e-3
    assert wc.MEM_BYTES_PER_S == 3.35e12


def test_products_per_operation():
    assert wc.wide_mads_per_product(377) == 2 * 12 * 12 + 12     # Fq
    assert wc.wide_mads_per_product(253) == 2 * 8 * 8 + 8        # Fr
    assert wc.GROUP_OP_PRODUCTS[1] == {"madd": 11, "add": 16, "dbl": 7}
    assert wc.GROUP_OP_PRODUCTS[2] == {"madd": 29, "add": 43, "dbl": 16}


def test_signed_digits_by_hand():
    # 3 = 0b11 at c = 2: the digit 3 passes 2, so -1 and a carry: 3 = -1 + 4
    # (windows, digits, buckets, live windows, running-sum additions)
    w = wc.scalar_words([3], 2)
    assert wc.digit_counts(w, 2, 2) == (2, 2, 2, 2, 0)
    # 1, 2, 3, 0: digits (1), (2), (-1, 1), (); buckets {1, 2} then {1}
    w = wc.scalar_words([1, 2, 3, 0], 2)
    assert wc.digit_counts(w, 2, 2) == (2, 4, 3, 2, 2)
    assert wc.digit_counts(w, 2, 3) == (1, 3, 3, 1, 4)
    # bits: one window, one bucket, nothing to sum
    w = wc.scalar_words([1, 0, 1, 1], 253)
    assert wc.digit_counts(w, 253, 16) == (1, 3, 1, 1, 0)


def test_digits_across_a_word():
    # a 70-bit scalar whose window at c = 10 spans words 0 and 1
    s = (0b1011 << 62) | 5
    w = wc.scalar_words([s], 70)
    assert wc._window(w, 60, 10) == (s >> 60) & 0x3FF


def test_msm_bound_by_hand():
    counts = wc.DigitCounts([1, 2, 3, 0], 2)
    b = wc.msm_bound(counts, 377, 1)
    # c = 2: 1 madd (4 digits, 3 buckets), 2 (2 - 1) + 1 = 3 adds, 2
    # doublings: 11 + 48 + 14 = 73 products; c = 3: one window, no madd
    # (3 digits in 3 buckets), 2 (3 - 1) = 4 adds: 64; c = 4: the same 64
    assert b["window"] == 3
    assert b["compute_s"] == pytest.approx(64 * 300 / wc.WIDE_MADS_PER_S)
    assert b["bytes_s"] == pytest.approx((4 * (96 + 1) + 96) / 3.35e12)
    assert b["bound"] == "compute" and b["seconds"] == b["compute_s"]
    g2 = wc.msm_bound(counts, 377, 2)
    assert g2["compute_s"] == pytest.approx(4 * 43 * 300 / wc.WIDE_MADS_PER_S)
    assert g2["bytes_s"] == pytest.approx((4 * (192 + 1) + 192) / 3.35e12)


def test_zero_scalars_cost_no_additions():
    counts = wc.DigitCounts([0] * 64, 253)
    assert counts.at(4)[1] == 0
    assert wc.msm_bound(counts, 377, 1)["bound"] == "bytes"


def test_best_window_of_a_large_msm():
    """2^16 uniform full-width scalars: the walk's window is the best of
    every window from 2 to 20."""
    r = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
    counts = wc.uniform_counts(1 << 16, r)
    b = wc.msm_bound(counts, 377, 1)
    per = wc.GROUP_OP_PRODUCTS[1]
    every = {c: wc._products(counts, c, per) for c in range(2, 21)}
    assert b["window"] == min(every, key=every.get)
    assert b["bound"] == "compute"
