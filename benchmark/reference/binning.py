"""Bin boundaries and bin codes, written out plainly from LightGBM's
BinMapper::FindBin (bin.cpp, v2): a row sample, the distinct sampled
values with the sample's zeros counted in, greedy count-balanced
boundaries at the midpoints between distinct values, and the filter that
drops a feature no split could use.  A value's bin is the first boundary
at or above it.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def sample_rows(n: int, sample_cnt: int, seed: int) -> np.ndarray:
    """The rows bin finding looks at: all of them, or `sample_cnt` drawn
    without replacement by RandomState(seed).choice, in row order."""
    if n <= sample_cnt:
        return np.arange(n)
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(n, sample_cnt, replace=False))


def distinct(values: np.ndarray, total: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted distinct non-zero sample values with their counts, zero
    inserted with the count of the sample's zeros (total minus the
    non-zero values)."""
    values = np.asarray(values, np.float64)
    values = values[(values != 0.0) & ~np.isnan(values)]
    vals, counts = np.unique(values, return_counts=True)
    zeros = total - values.size
    if zeros > 0:
        pos = int(np.searchsorted(vals, 0.0))
        vals = np.insert(vals, pos, 0.0)
        counts = np.insert(counts, pos, zeros)
    return vals, counts.astype(np.int64)


def greedy_bounds(vals: np.ndarray, counts: np.ndarray, total: int,
                  max_bin: int, min_data_in_bin: int
                  ) -> Tuple[List[float], List[int]]:
    """(upper bounds, samples in each bin) of GreedyFindBin."""
    n = len(vals)
    vals = [float(v) for v in vals]
    counts = [int(c) for c in counts]
    if n <= max_bin:
        upper, cnt_in_bin, cur = [], [], 0
        for i in range(n - 1):
            cur += counts[i]
            if cur >= min_data_in_bin:
                upper.append((vals[i] + vals[i + 1]) / 2.0)
                cnt_in_bin.append(cur)
                cur = 0
        cnt_in_bin.append(cur + counts[-1])
        upper.append(np.inf)
        return upper, cnt_in_bin
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total // min_data_in_bin))
    mean_bin_size = total / max_bin
    zero_cnt = next((c for v, c in zip(vals, counts) if v == 0.0), 0)
    if zero_cnt > mean_bin_size:
        max_bin = min(max_bin,
                      1 + (total - zero_cnt) // max(min_data_in_bin, 1))
    is_big = [c >= mean_bin_size for c in counts]
    rest_bin_cnt = max_bin - sum(is_big)
    rest_sample_cnt = total - sum(c for c, b in zip(counts, is_big) if b)
    if rest_bin_cnt > 0:
        mean_bin_size = rest_sample_cnt / rest_bin_cnt
    upper, lower, cnt_in_bin = [], [vals[0]], []
    cur = 0
    for i in range(n - 1):
        if not is_big[i]:
            rest_sample_cnt -= counts[i]
        cur += counts[i]
        if (is_big[i] or cur >= mean_bin_size
                or (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            upper.append(vals[i])
            lower.append(vals[i + 1])
            cnt_in_bin.append(cur)
            if len(upper) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                if rest_bin_cnt > 0:
                    mean_bin_size = rest_sample_cnt / rest_bin_cnt
    cnt_in_bin.append(total - sum(cnt_in_bin))
    bounds = [(upper[i] + lower[i + 1]) / 2.0 for i in range(len(upper))]
    return bounds + [np.inf], cnt_in_bin


def usable(cnt_in_bin: List[int], total: int, min_split_data: int) -> bool:
    """Whether some threshold leaves min_split_data samples on each side."""
    left = 0
    for c in cnt_in_bin[:-1]:
        left += c
        if left >= min_split_data and total - left >= min_split_data:
            return True
    return False


def find_bounds(values: np.ndarray, total: int, max_bin: int,
                min_data_in_bin: int, min_split_data: int
                ) -> Optional[np.ndarray]:
    """A numerical feature's upper bounds from its sampled values, or
    None where the feature has one bin or no usable split."""
    vals, counts = distinct(values, total)
    if vals.size == 0:
        return None
    upper, cnt_in_bin = greedy_bounds(vals, counts, total, max_bin,
                                      min_data_in_bin)
    if len(upper) <= 1 or not usable(cnt_in_bin, total, min_split_data):
        return None
    return np.asarray(upper, np.float64)
