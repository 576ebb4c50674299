"""The frozen work counts against hand-computed values at small sizes."""

import pytest

from benchmark.work import counts as W


def test_mont_mul_word_ops():
    # 2 W^2 + (floor(15 L / 32) + 1) (2 W + 1)
    assert W.mont_mul_word_ops(18) == 2 * 81 + 9 * 19 == 333
    assert W.mont_mul_word_ops(21) == 2 * 100 + 10 * 21 == 410
    assert W.mont_mul_word_ops(26) == 2 * 144 + 13 * 25 == 613


def test_add_word_ops():
    assert W.add_word_ops(26, 13) == 13 * 613
    assert W.add_word_ops(21, 114) == 114 * 410


def test_msm_work_point_adds_by_hand():
    # n = 8, 8-bit scalars, c = 4: 2 windows + the carry one (4 | 8),
    # 2^3 + 1 buckets: 3 (8 + 18) + 3 (4 + 1)
    assert W.signed_num_windows(8, 4) == 3
    assert W.signed_num_windows(8, 3) == 3
    assert W.msm_work_point_adds(8, 8, 4) == 93
    assert W.msm_work_point_adds(8, 8, 3) == 3 * (8 + 10) + 3 * 4


@pytest.mark.parametrize("n", [1, 7, 100, 1 << 12, (1 << 20) - 99])
def test_best_window_is_the_counts_minimum(n):
    c = W.best_window(n, 255)
    assert all(W.msm_work_point_adds(n, 255, c) <= W.msm_work_point_adds(n, 255, k) for k in range(1, 25))
    assert W.msm_ops(n, 255, 10) == W.msm_work_point_adds(n, 255, c) * 10
    assert W.msm_ops(0, 255, 10) == 0


def test_ntt_and_witness_map():
    assert W.ntt_butterflies(8) == 12
    assert W.ntt_butterflies(1 << 17) == (1 << 16) * 17
    assert W.witness_map_ops(8, 5, 18) == (7 * 12 + 5 + 48) * 333
    # 255-bit Fr: 32 bytes packed; 298-bit: 40
    assert W.witness_map_bytes(10, 5, 8, 32) == 320 + 5 * 36 + 256


def test_limbs_and_peaks():
    bls_fr = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
    assert W.limbs(bls_fr) == 18 and W.packed_bytes(bls_fr) == 32
    assert W.PEAK_INT32_OPS == pytest.approx(16.727e12, rel=1e-4)
    assert W.bound_s(16.727e12, 0) == pytest.approx(1.0, rel=1e-4)
    assert W.bound_s(0, 3.35e12) == 1.0
