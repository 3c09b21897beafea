"""Exact leaf-wise tree learner, single device.

Port of lightgbm_tpu/learner/serial.py (`SerialTreeLearner` and its
steps), the JAX package's learner for `tree_growth=exact` (and for
`auto` everywhere but the TPU).  It keeps the reference's leaf-wise
policy: the global greedy choice of the leaf with the largest gain, one
split at a time, the smaller child histogrammed and the larger one taken
by subtraction from the parent's histogram, and a direct recompute when
the parent's histogram was not kept (the histogram pool's miss).

Rows are assigned to leaves by a per-row `leaf_id` updated by the
split's store-space predicate; a leaf's rows are compacted into an index
vector of static power-of-two size (cumsum and scatter, padded with the
sentinel row N — JAX's `nonzero(size=cap)` without a host read) and
histogrammed through `histogram_from_indices`, which launches kernel K5
on CUDA tensors.  Histograms stay in store space (EFB bundle columns
when the dataset has a bundle plan) and are unbundled to the original
features for split search.  The split loop runs on the host and reads
one small tensor from the device per split (the two children's split
records); `last_host_syncs` counts these reads per tree.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..binning import CATEGORICAL
from ..config import Config
from ..dataset import Dataset
from ..ops.histogram import histogram_from_indices
from ..ops.split import (best_split, bundle_predicate_params,
                         identity_feat_table, maybe_unbundle, store_go_left)
from ..tree import CATEGORICAL_DECISION, NUMERICAL_DECISION, Tree
from .common import make_split_kw, padded_bin_count, sentinel_bins_feed


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def compact_rows(mask: torch.Tensor, cap: int, fill: int,
                 arange: torch.Tensor) -> torch.Tensor:
    """[cap] int32 ids of the rows where `mask` holds, in row order,
    padded with `fill` (JAX's `nonzero(mask, size=cap, fill_value=fill)`:
    rows past the cap are dropped).  `arange` is [N] int32 0..N-1."""
    m = mask.to(torch.int32)
    pos = torch.cumsum(m, 0, dtype=torch.int32) - m
    dest = torch.where(mask & (pos < cap), pos.long(),
                       torch.full((), cap, dtype=torch.int64,
                                  device=mask.device))
    out = torch.full((cap + 1,), fill, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dest, arange)
    return out[:cap]


def _root_step(bins_t, grad_pad, hess_pad, idx, num_bins, is_cat, fmask,
               unb, *, num_bins_padded, split_kw, count=None,
               num_store_bins=None):
    """Histogram of the rows `idx` (the first `count` positions), its
    (sum_grad, sum_hess, count) from store column 0 (every row has a bin
    there, bundled or not) and its best split.  Returns (hist, record
    [11], sums [3])."""
    hist = histogram_from_indices(bins_t, grad_pad, hess_pad, idx,
                                  num_bins_padded=num_bins_padded,
                                  count=count, num_store_bins=num_store_bins)
    sums = hist[0].sum(dim=-1)
    h = maybe_unbundle(hist, unb, sums)
    rec = best_split(h, num_bins, is_cat, fmask, sums[0], sums[1], sums[2],
                     **split_kw)
    return hist, rec, sums


class _LeafInfo:
    __slots__ = ("sum_grad", "sum_hess", "count", "depth", "hist", "best")

    def __init__(self, sum_grad, sum_hess, count, depth, hist, best):
        self.sum_grad = sum_grad
        self.sum_hess = sum_hess
        self.count = count
        self.depth = depth
        self.hist = hist      # device [C, 3, B] store-space histogram or None
        self.best = best      # numpy packed record or None


class SerialTreeLearner:
    """One tree at a time, one split at a time, on `config.device_type`."""

    def __init__(self, dataset: Dataset, config: Config):
        self.dataset = dataset
        self.config = config
        self.device = torch.device(config.device_type)
        self.N = dataset.num_data
        self.F = dataset.num_features              # original features
        # the bin axis of the store serves the unbundled split search too:
        # a bundle column holds at least as many bins as any member
        self.B = padded_bin_count(dataset.max_num_bin)
        # kernel K5's feed: [N+1, C] in the store's bytes (uint8 up to
        # 256 bins); the partition and the tree walk read the int32
        # [C, N+1] store
        bt = sentinel_bins_feed(dataset)
        self.bins_t = torch.as_tensor(bt, device=self.device)
        self.bins = torch.as_tensor(np.ascontiguousarray(bt.T, np.int32),
                                    device=self.device)
        self.num_store_bins = int(dataset.max_num_bin)
        self.num_bins_dev = torch.as_tensor(
            dataset.num_bins.astype(np.int64), device=self.device)
        self.is_cat_dev = torch.as_tensor(dataset.is_categorical,
                                          device=self.device)
        ft = dataset.bundle_feat_table()
        # the predicate table stays on the host: each split's (feature,
        # threshold) is a host value already
        self.ftbl = (identity_feat_table(dataset.num_bins) if ft is None
                     else torch.as_tensor(ft))
        unb = dataset.unbundle_tables(self.B)
        self.unb = (None if unb is None else
                    (torch.as_tensor(unb[0], device=self.device),
                     torch.as_tensor(unb[1], device=self.device)))
        cfg = config
        self.split_kw = make_split_kw(cfg)
        self._feat_rng = np.random.RandomState(cfg.feature_fraction_seed)
        # keep per-leaf histograms only when the full set fits the pool
        # (cached histograms are store-space: bundling shrinks them)
        hist_bytes = dataset.num_store_columns * 3 * self.B * 4
        pool_budget = (cfg.histogram_pool_size * 1e6
                       if cfg.histogram_pool_size > 0 else 1.5e9)
        self.keep_hists = hist_bytes * cfg.num_leaves <= pool_budget
        self._arange = torch.arange(self.N, dtype=torch.int32,
                                    device=self.device)
        self.leaf_id: Optional[torch.Tensor] = None
        self.last_host_syncs = 0

    # -- helpers -----------------------------------------------------------

    @property
    def walk_bins(self) -> torch.Tensor:
        """The [C, N] store on the device, for walking trees over the
        training rows (the score update of bagged iterations, DART's
        drops, rollback and the replay of a resumed model)."""
        return self.bins[:, :self.N]

    def _feature_mask(self) -> torch.Tensor:
        frac = self.config.feature_fraction
        m = np.ones(self.F, dtype=bool)
        if frac < 1.0:
            k = max(1, int(round(self.F * frac)))
            sel = self._feat_rng.choice(self.F, size=k, replace=False)
            m[:] = False
            m[sel] = True
        return torch.as_tensor(m, device=self.device)

    def _cap(self, count: int) -> int:
        return min(_next_pow2(max(int(count), 1)), self.N)

    def _can_split(self, info: _LeafInfo) -> bool:
        cfg = self.config
        if info.count < 2 * cfg.min_data_in_leaf:
            return False
        if info.sum_hess < 2 * cfg.min_sum_hessian_in_leaf:
            return False
        if cfg.max_depth > 0 and info.depth >= cfg.max_depth:
            return False
        return True

    def _rows_of(self, leaf: int, cap: int) -> torch.Tensor:
        return compact_rows(self.leaf_id == leaf, cap, self.N, self._arange)

    def _live(self, count: int) -> Optional[int]:
        """The row count handed to the histogram, so that it reads no
        sentinel position past the leaf's rows: the split records' counts
        are float32, exact below 2^24 rows (beyond, every position is
        read)."""
        return int(count) if self.N < (1 << 24) else None

    def _hist(self, idx: torch.Tensor, count: int) -> torch.Tensor:
        return histogram_from_indices(
            self.bins_t, self._grad_pad, self._hess_pad, idx,
            num_bins_padded=self.B, count=self._live(count),
            num_store_bins=self.num_store_bins)

    def _root(self, idx: torch.Tensor, count: int):
        hist, rec, sums = _root_step(
            self.bins_t, self._grad_pad, self._hess_pad, idx,
            self.num_bins_dev, self.is_cat_dev, self._fmask, self.unb,
            num_bins_padded=self.B, split_kw=self.split_kw,
            count=self._live(count), num_store_bins=self.num_store_bins)
        host = torch.cat([rec, sums]).cpu().numpy()
        self.last_host_syncs += 1
        return hist, host[:11], host[11:].astype(np.float64)

    def _direct_hist_best(self, leaf: int, info: _LeafInfo):
        """Histogram a leaf directly (no subtraction): the pool-miss
        path (reference HistogramPool miss -> recompute)."""
        hist, rec, _ = self._root(self._rows_of(leaf, self._cap(info.count)),
                                  info.count)
        return hist, rec

    def _partition(self, parent: int, new_leaf: int, feat: int, thr: int,
                   is_cat: bool) -> None:
        """Move the parent's right-going rows to new_leaf, evaluating the
        original-space split (feat, thr) on the store through its
        store-space predicate."""
        col, T, lo, hi1, dl = (int(v[0]) for v in bundle_predicate_params(
            self.ftbl, torch.tensor([feat]), torch.tensor([thr]),
            torch.tensor([is_cat])))
        pred = store_go_left(self.bins[col, :self.N], T, lo, hi1, bool(dl),
                             is_cat)
        self.leaf_id = torch.where((self.leaf_id == parent) & ~pred,
                                   torch.full((), new_leaf, dtype=torch.int32,
                                              device=self.device),
                                   self.leaf_id)

    def _sums_dev(self, info: _LeafInfo) -> torch.Tensor:
        return torch.tensor([info.sum_grad, info.sum_hess, float(info.count)],
                            dtype=torch.float32, device=self.device)

    # -- main --------------------------------------------------------------

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag_idx: Optional[torch.Tensor] = None,
              bag_count: Optional[int] = None) -> Tuple[Tree, torch.Tensor]:
        """Grow one tree.  grad/hess: [N] float32 on the device; bag_idx:
        [cap] int32 in-bag row ids padded with N (or None).

        Returns (tree, leaf_id) with leaf_id[i] the leaf of row i (-1 for
        out-of-bag rows), for the training-score update."""
        cfg = self.config
        N = self.N
        dev = self.device
        self.last_host_syncs = 0
        zero = torch.zeros(1, dtype=grad.dtype, device=dev)
        self._grad_pad = torch.cat([grad, zero])
        self._hess_pad = torch.cat([hess, zero])
        self._fmask = self._feature_mask()

        if bag_idx is None:
            self.leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
            root_count = N
            idx = self._arange
        else:
            root_count = int(bag_count)
            # out-of-bag rows get leaf -1; the sentinel ids N land in the
            # extra slot that is sliced off
            lid = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
            lid[bag_idx.long()] = 0
            self.leaf_id = lid[:N]
            idx = bag_idx.to(torch.int32)

        hist, rec, sums = self._root(idx, root_count)
        tree = Tree(cfg.num_leaves)
        leaves: Dict[int, _LeafInfo] = {
            0: _LeafInfo(sums[0], sums[1], root_count, 0, hist, rec)}

        for _ in range(cfg.num_leaves - 1):
            # the best leaf (global greedy, serial_tree_learner.cpp:203-210)
            best_leaf, best_gain = -1, 0.0
            for lf, info in leaves.items():
                if info.best is None:
                    continue
                g = float(info.best[0])
                if np.isfinite(g) and g > best_gain:
                    best_leaf, best_gain = lf, g
            if best_leaf < 0:
                break
            info = leaves[best_leaf]
            rec = info.best
            feat = int(rec[1])
            thr = int(rec[2])
            l_sum = (float(rec[3]), float(rec[4]), int(round(float(rec[5]))))
            r_sum = (float(rec[6]), float(rec[7]), int(round(float(rec[8]))))
            l_out, r_out = float(rec[9]), float(rec[10])
            real_feat = self.dataset.inner_to_real(feat)
            mapper = self.dataset.mappers[real_feat]
            bin_type = (CATEGORICAL_DECISION if mapper.bin_type == CATEGORICAL
                        else NUMERICAL_DECISION)
            new_leaf = tree.split(
                best_leaf, feat, bin_type, thr, real_feat,
                mapper.bin_to_value(thr), l_out, r_out, l_sum[2], r_sum[2],
                best_gain)

            child_depth = info.depth + 1
            left = _LeafInfo(l_sum[0], l_sum[1], l_sum[2], child_depth,
                             None, None)
            right = _LeafInfo(r_sum[0], r_sum[1], r_sum[2], child_depth,
                              None, None)
            need_l, need_r = self._can_split(left), self._can_split(right)
            self._partition(best_leaf, new_leaf, feat, thr,
                            bin_type == CATEGORICAL_DECISION)

            if need_l or need_r:
                # the smaller child is histogrammed, the larger one is
                # its parent minus it (serial_tree_learner.cpp:344-422)
                small_is_left = l_sum[2] <= r_sum[2]
                small_leaf = best_leaf if small_is_left else new_leaf
                small = left if small_is_left else right
                large = right if small_is_left else left
                need_small = need_l if small_is_left else need_r
                need_large = need_r if small_is_left else need_l
                with_subtract = info.hist is not None
                idx = self._rows_of(small_leaf, self._cap(small.count))
                hist_small = self._hist(idx, small.count)
                ss = self._sums_dev(small)
                recs = [best_split(maybe_unbundle(hist_small, self.unb, ss),
                                   self.num_bins_dev, self.is_cat_dev,
                                   self._fmask, ss[0], ss[1], ss[2],
                                   **self.split_kw)]
                if with_subtract:
                    hist_large = info.hist - hist_small
                    ls = self._sums_dev(large)
                    recs.append(best_split(
                        maybe_unbundle(hist_large, self.unb, ls),
                        self.num_bins_dev, self.is_cat_dev, self._fmask,
                        ls[0], ls[1], ls[2], **self.split_kw))
                recs = torch.stack(recs).cpu().numpy()
                self.last_host_syncs += 1
                if need_small:
                    small.hist, small.best = hist_small, recs[0]
                if need_large:
                    if with_subtract:
                        large.hist, large.best = hist_large, recs[1]
                    else:
                        # the parent's histogram was not kept: recompute
                        # the larger child directly
                        lg_leaf = new_leaf if small_is_left else best_leaf
                        large.hist, large.best = self._direct_hist_best(
                            lg_leaf, large)
                if not self.keep_hists:
                    small.hist = None
                    large.hist = None

            leaves[best_leaf] = left
            leaves[new_leaf] = right
            info.hist = None

        return tree, self.leaf_id
