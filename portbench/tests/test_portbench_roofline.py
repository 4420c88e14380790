"""The yardstick's arithmetic: work counted from shapes, and the peaks."""

import pytest

from portbench import roofline


def test_trailing_steps_count_the_lower_triangle_of_each_trailing_matrix():
    # n=4·nb, tb=nb: trailing matrices of 3, 2, 1 tiles: 3, 1, 0 tiles below
    # the diagonal, and 3, 2, 1 diagonal tiles of nb·(nb + 1)/2 elements
    nb = tb = 8
    steps = list(roofline.trailing_steps(4 * nb, nb, tb, 4))
    elems = [nb * nb * below + diag * nb * (nb + 1) // 2 for below, diag in ((3, 3), (1, 2), (0, 1))]
    assert [f for f, _ in steps] == [2.0 * nb * e for e in elems]
    m = [3 * nb, 2 * nb, nb]
    assert [b for _, b in steps] == [4 * (mi * nb + 2 * e) for mi, e in zip(m, elems)]
    # the same count as a trailing matrix's lower triangle, m·(m + 1)/2
    assert elems == [mi * (mi + 1) // 2 for mi in m]


@pytest.mark.parametrize("n,nb", [(61440, 1024), (24576, 1024), (8192, 512)])
def test_trailing_flops_are_most_of_the_factorization(n, nb):
    total = sum(f for f, _ in roofline.trailing_steps(n, nb, nb, 8))
    assert 0.9 * roofline.potrf_flops(n) < total < roofline.potrf_flops(n)


def test_bound_is_the_larger_of_compute_and_memory():
    assert roofline.bound_s(67e12, 0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(67e12, 6.7e12, 67e12) == pytest.approx(2.0)


def test_peaks():
    assert roofline.peak_flops("float64") == 67e12
    assert roofline.peak_flops("float32", "highest") == 67e12
    assert roofline.peak_flops("float32", "high") == pytest.approx(989e12 / 3)
    assert roofline.peak_flops("float32", "default") == 989e12


def test_solve_work_and_bound():
    f, b = roofline.solve_work(1000, 10, 8)
    assert f == 2.0 * 1000 * 1000 * 10
    assert b == 8 * (1000 * 1001 + 2 * 1000 * 10)
    # a narrow query is bound by reading L twice, a wide one by its flops
    assert roofline.solve_bound_s(24576, 64, "float64") == pytest.approx(
        8 * (24576 * 24577 + 2 * 24576 * 64) / 3.35e12)
    assert roofline.solve_bound_s(24576, 1024, "float64") == pytest.approx(
        2.0 * 24576**2 * 1024 / 67e12)


def test_trailing_bound_is_a_sum_of_step_bounds():
    n, nb = 4096, 512
    want = sum(max(f / (989e12 / 3), b / 3.35e12) for f, b in roofline.trailing_steps(n, nb, nb, 4))
    assert roofline.trailing_bound_s(n, nb, nb, "float32", "high") == pytest.approx(want)
