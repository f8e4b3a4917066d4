"""The benchmark's own arithmetic: percentiles over every sample, rates
over the whole window, the union of device intervals."""

import pytest

from gpbench.harness import stats


def test_percentile_over_all_samples():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([3.0], 95) == 3.0
    # order does not matter, every sample counts
    assert stats.percentile(list(reversed(xs)), 95) == pytest.approx(95.05)
    assert stats.percentile([1, 1, 1, 1, 1000], 95) == pytest.approx(1 + 0.8 * 999)


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_over_the_window():
    assert stats.rate(4096 * 1000, 20.0) == pytest.approx(204800.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_counts_overlap_once():
    assert stats.intervals_union([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert stats.intervals_union([(2, 3), (0, 1)]) == pytest.approx(2.0)
    assert stats.intervals_union([]) == 0.0
