"""Faithful replica of libstdc++'s ``std::sort`` permutation.

The reference sorts several report vectors with ``std::sort`` under
comparators that leave many elements *equal* (e.g. DD split reads all
compare equal in ``comp_simple_read_pos``, search_MEI_util.cpp:42-54).
``std::sort`` is not stable: the final order of equal elements is decided
by introsort's median-of-3 quicksort partitioning and the final
insertion-sort pass.  To reproduce the reference's byte-exact report
files we replicate the exact algorithm from libstdc++ bits/stl_algo.h /
stl_heap.h (introsort: quicksort to depth 2*floor(log2 n), heapsort
fallback, final insertion sort; threshold 16).

``comp(a, b)`` must be a strict less-than, exactly like the C++ side.
"""
from __future__ import annotations

from typing import Callable, List, TypeVar

T = TypeVar("T")

_S_THRESHOLD = 16


def _push_heap(a, first, hole, top, val, comp):
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], val):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = val


def _adjust_heap(a, first, hole, length, val, comp):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, val, comp)


def _heap_sort(a, first, last, comp):
    """__make_heap + __sort_heap (the introsort depth-limit fallback)."""
    length = last - first
    if length >= 2:
        parent = (length - 2) // 2
        while True:
            val = a[first + parent]
            _adjust_heap(a, first, parent, length, val, comp)
            if parent == 0:
                break
            parent -= 1
    last_i = last
    while last_i - first > 1:
        last_i -= 1
        val = a[last_i]
        a[last_i] = a[first]
        _adjust_heap(a, first, 0, last_i - first, val, comp)


def _move_median_to_first(a, result, x, y, z, comp):
    if comp(a[x], a[y]):
        if comp(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif comp(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif comp(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif comp(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


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


def _introsort_loop(a, first, last, depth_limit, comp):
    while last - first > _S_THRESHOLD:
        if depth_limit == 0:
            _heap_sort(a, first, last, comp)
            return
        depth_limit -= 1
        mid = first + (last - first) // 2
        _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
        cut = _unguarded_partition(a, first + 1, last, first, comp)
        _introsort_loop(a, cut, last, depth_limit, comp)
        last = cut


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
            a[first + 1:i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, comp)


def cxx_sort(a: List[T], comp: Callable[[T, T], bool]) -> None:
    """In-place ``std::sort(a.begin(), a.end(), comp)``."""
    n = len(a)
    if n <= 1:
        return
    _introsort_loop(a, 0, n, 2 * (n.bit_length() - 1), comp)
    if n > _S_THRESHOLD:
        _insertion_sort(a, 0, _S_THRESHOLD, comp)
        for i in range(_S_THRESHOLD, n):
            _unguarded_linear_insert(a, i, comp)
    else:
        _insertion_sort(a, 0, n, comp)


def cxx_sort_reversed(a: List[T], comp: Callable[[T, T], bool]) -> None:
    """``std::sort(a.rbegin(), a.rend(), comp)``: sort the reversed view."""
    rev = a[::-1]
    cxx_sort(rev, comp)
    a[:] = rev[::-1]
