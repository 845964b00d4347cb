"""Bit-exact libstdc++ std::sort (introsort) replica.

The reference sorts spawn cells by height with a NON-STABLE std::sort and a
tie-returning-false comparator (scenario_collect.cpp:124-132); which of the
equal-height cells end up in the "peaks" segment therefore depends on the
exact introsort permutation. Reference-stream layout parity (PARITY.md
deviation #8) needs that permutation, so this module replicates libstdc++'s
std::sort element-move sequence exactly (GCC 12 bits/stl_algo.h + stl_heap.h):

    __sort = __introsort_loop (quicksort, median-of-3 pivot moved to first,
             unguarded partition, depth limit 2*floor(log2 n) -> heapsort
             fallback) + __final_insertion_sort (threshold 16).

Verified against golden permutations from the in-container g++ libstdc++
(tests/golden/refsort_golden.cpp, tests/test_refsort.py).
"""

from __future__ import annotations

from typing import Callable, List, TypeVar

T = TypeVar("T")

_S_THRESHOLD = 16  # _S_threshold, stl_algo.h


def _lg(n: int) -> int:
    return n.bit_length() - 1


# ---------------------------------------------------------------- heap ops
# stl_heap.h: __push_heap / __adjust_heap / __pop_heap / __make_heap /
# __sort_heap, operating on a[first:first+len].

def _push_heap(a, first, hole, top, value, comp):
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value, comp):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if length & 1 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, comp)


def _make_heap(a, first, last, comp):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, comp)
        if parent == 0:
            return
        parent -= 1


def _sort_heap(a, first, last, comp):
    while last - first > 1:
        last -= 1
        value = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, value, comp)


def _heap_sort_range(a, first, last, comp):
    # __partial_sort(first, last, last): heap_select is make_heap (the
    # trailing loop is empty when middle == last), then sort_heap.
    _make_heap(a, first, last, comp)
    _sort_heap(a, first, last, comp)


# ------------------------------------------------------------- insertion
def _unguarded_linear_insert(a, last, comp):
    val = a[last]
    nxt = last - 1
    while comp(val, a[nxt]):
        a[nxt + 1] = a[nxt]
        nxt -= 1
    a[nxt + 1] = val


def _insertion_sort(a, first, last, comp):
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            val = a[i]
            a[first + 1:i + 1] = a[first:i]  # move_backward
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, comp)


def _final_insertion_sort(a, first, last, comp):
    if last - first > _S_THRESHOLD:
        _insertion_sort(a, first, first + _S_THRESHOLD, comp)
        for i in range(first + _S_THRESHOLD, last):
            _unguarded_linear_insert(a, i, comp)
    else:
        _insertion_sort(a, first, last, comp)


# ------------------------------------------------------------- quicksort
def _move_median_to_first(a, result, i1, i2, i3, comp):
    if comp(a[i1], a[i2]):
        if comp(a[i2], a[i3]):
            a[result], a[i2] = a[i2], a[result]
        elif comp(a[i1], a[i3]):
            a[result], a[i3] = a[i3], a[result]
        else:
            a[result], a[i1] = a[i1], a[result]
    elif comp(a[i1], a[i3]):
        a[result], a[i1] = a[i1], a[result]
    elif comp(a[i2], a[i3]):
        a[result], a[i3] = a[i3], a[result]
    else:
        a[result], a[i2] = a[i2], a[result]


def _unguarded_partition(a, first, last, pivot, comp):
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, comp):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
    return _unguarded_partition(a, first + 1, last, first, comp)


def _introsort_loop(a, first, last, depth_limit, comp):
    while last - first > _S_THRESHOLD:
        if depth_limit == 0:
            _heap_sort_range(a, first, last, comp)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, comp)
        _introsort_loop(a, cut, last, depth_limit, comp)
        last = cut


def std_sort(a: List[T], comp: Callable[[T, T], bool]) -> None:
    """In-place libstdc++ std::sort(a.begin(), a.end(), comp)."""
    n = len(a)
    if n == 0:
        return
    _introsort_loop(a, 0, n, 2 * _lg(n), comp)
    _final_insertion_sort(a, 0, n, comp)
