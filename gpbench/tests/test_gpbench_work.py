"""The operation and byte counts behind the rooflines and the mfu, against
hand-worked small shapes."""

import pytest

from gpbench.harness import work


def test_tile():
    # 4 x 5 entries, d = 2: distance 2d + 1 = 5, Matern-5/2's map 10
    assert work.tile_flops(4, 5, 2, "matern52") == 4 * 5 * 15
    assert work.tile_flops(4, 5, 2, "rbf") == 4 * 5 * 8


def test_b1():
    ops, nbytes = work.b1(4, 5, 2, 3, "matern52")
    assert ops == 300 + 2 * 4 * 5 * 3
    assert nbytes == 4 * ((4 + 5) * 2 + 5 * 3 + 4 * 3)


def test_b3():
    ops, nbytes = work.b3(10, 2, 3, "matern52")
    assert ops == 100 * 15 + 2 * 100 * 3 + 14 * 10 * 3
    assert nbytes == 4 * (10 * 2 + 8 * 10 * 3 + 7 * 3)


def test_grad():
    ops, nbytes = work.grad(10, 2, 3)
    assert ops == 100 * (6 + 20 + 6 + 8)
    assert nbytes == 4 * (20 + 60 + 40)


def test_query():
    ops, _ = work.query(10, 4, 2, 3, "matern52")
    assert ops == 40 * 15 + 2 * 40 + 2 * 40 * 3 + 2 * 9 * 4 + 2 * 3 * 4


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(495e12, 0.0, "highest") == pytest.approx(1.0)
    assert work.least_seconds(989e12, 0.0, "mixed") == pytest.approx(1.0)
    assert work.least_seconds(1.0, 3.35e12, "highest") == pytest.approx(1.0)


def test_kin40k_step_work():
    """The training step's work at the cells' sizes, as PERF.md states it."""
    n, d, t = 25600, 8, 9
    step = 25 * work.b3(n, d, t, "matern52")[0] + work.b1(n, n, d, t, "matern52")[0] \
        + work.grad(n, d, t)[0]
    assert 0.82e12 < step < 0.84e12
