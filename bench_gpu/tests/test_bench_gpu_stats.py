"""The end-to-end arithmetic over all blocks of a window."""

from __future__ import annotations

import statistics

import pytest

from bench_gpu import stats


def test_percentile_is_nearest_rank_over_all_blocks():
    v = list(range(1, 101))
    assert stats.percentile(v, 95.0) == 95
    assert stats.percentile(v, 100.0) == 100
    assert stats.percentile([7.0], 95.0) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95.0)


def test_a_stall_shows_in_the_tail_and_in_the_rate():
    steady = [3.0] * 1000
    stalled = [3.0] * 940 + [50.0] * 60          # 6 % of the blocks stall
    assert stats.percentile(steady, 95.0) == 3.0
    assert stats.percentile(stalled, 95.0) == 50.0
    n = 4_000_000
    r0 = stats.rate(len(steady) * n, sum(steady) / 1e3)
    r1 = stats.rate(len(stalled) * n, sum(stalled) / 1e3)
    assert r1 == pytest.approx(r0 * sum(steady) / sum(stalled))
    with pytest.raises(ValueError):
        stats.rate(n, 0.0)


def test_spread_and_quartiles_follow_statistics_quantiles():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.quartiles(v) == (q1, med, q3)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)
