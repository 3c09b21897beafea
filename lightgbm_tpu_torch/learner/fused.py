"""The fused single-split tree builder, device tree arrays and the
tree-learner factory.

Port of lightgbm_tpu/learner/fused.py for one device: `TreeArrays`,
`build_tree`, `pack_tree_arrays` / `unpack_tree_arrays` /
`tree_arrays_to_host`, `FusedTreeLearner` and `create_tree_learner`.

`build_tree` grows a whole tree leaf-wise, one split at a time, with
static shapes and no host read inside the tree: the JAX builder was one
`lax.fori_loop` of `num_leaves - 1` steps; here it is a Python loop of
the same steps over device tensors.  Each step picks the best leaf on
the device (argmax over the gated per-leaf records), repartitions the
rows with a mask, histograms the smaller child in one full pass over
every row (`histogram_full_masked`: kernel K2 on CUDA, with one slot
whose leaf ids are device tensors; `histogram_full_sparse`: kernel K8
with K=1 over the sparse store), takes the larger child from the parent
histogram cache by subtraction, and searches both children in one
batched `best_split`.  A step with nothing left to split (`do` false)
still runs, and every state write is a select that keeps the old value
then; the JAX `mode="drop"` writes land in one spare row that is sliced
off.  Indices stay 1-element device tensors (never 0-d ones, which
would index through a host read).  The finished tree comes back in one
packed read (`pack_tree_arrays` -> `tree_arrays_to_host`).

The multi-device branches of the JAX builder (the data- and feature-
axis collectives, psum_scatter, voting) and the feature/voting learners
are ROADMAP.md §A item 12.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..diagnostics.sanitize import explicit_transfer
from ..ops.histogram import histogram_full_masked, histogram_full_sparse
from ..ops.predict import sparse_bin_lookup
from ..ops.sparse_streams import build_sparse_streams
from ..ops.split import (best_split, bundle_predicate_params, leaf_output,
                         maybe_unbundle, store_go_left)
from ..tree import CATEGORICAL_DECISION, NUMERICAL_DECISION, Tree
from .common import (dense_store_feed, make_split_kw, padded_bin_count,
                     use_parent_hist_cache)

NEG_INF = -math.inf

_MULTI_DEVICE = ("the fused builder's multi-device branches (data/feature "
                 "axes, psum_scatter, voting) are not ported yet "
                 "(ROADMAP.md §A item 12)")


class TreeArrays(NamedTuple):
    """Device tree in the reference's flat-node layout (tree.h:161-196):
    internal nodes 0..n-2, leaves as ~leaf in child arrays."""
    split_feature: torch.Tensor    # [L-1] int32 inner (used-feature) index
    threshold_bin: torch.Tensor    # [L-1] int32
    is_cat: torch.Tensor           # [L-1] bool
    left_child: torch.Tensor       # [L-1] int32
    right_child: torch.Tensor      # [L-1] int32
    split_gain: torch.Tensor       # [L-1] f32
    internal_value: torch.Tensor   # [L-1] f32 (parent output pre-split)
    internal_count: torch.Tensor   # [L-1] f32
    leaf_value: torch.Tensor       # [L] f32
    leaf_count: torch.Tensor       # [L] f32
    leaf_depth: torch.Tensor       # [L] int32
    num_leaves: torch.Tensor       # [] int32


def pack_tree_arrays(arrs: TreeArrays) -> torch.Tensor:
    """Flatten TreeArrays into ONE f32 vector so the host fetches a single
    transfer.  All int fields fit f32 exactly (< 2^24)."""
    return torch.cat([torch.ravel(x).to(torch.float32) for x in arrs]
                     + [torch.zeros(1, dtype=torch.float32,
                                    device=arrs.leaf_value.device)])


def unpack_tree_arrays(vec: np.ndarray, L: int) -> TreeArrays:
    sizes = [L - 1] * 8 + [L] * 3 + [1]
    dts = ([np.int32, np.int32, bool, np.int32, np.int32, np.float32,
            np.float32, np.float32, np.float32, np.float32, np.int32,
            np.int32])
    out, off = [], 0
    for sz, dt in zip(sizes, dts):
        part = vec[off:off + sz]
        out.append(part.astype(dt) if dt != bool else part > 0.5)
        off += sz
    out[-1] = out[-1][0]
    return TreeArrays(*out)


def tree_arrays_to_host(arrs, dataset: Dataset, max_leaves: int) -> Tree:
    """Rehydrate the host Tree (real feature ids + real-valued thresholds
    via the BinMappers) from TreeArrays — device tensors (fetched in one
    transfer) or an already-unpacked numpy TreeArrays."""
    if isinstance(arrs.num_leaves, torch.Tensor):
        # the tree's one deliberate read: legal under the sync guard
        packed = pack_tree_arrays(arrs)
        with explicit_transfer():
            vec = packed.cpu().numpy()
        a = unpack_tree_arrays(vec, max_leaves)
    else:
        a = arrs
    n = int(a.num_leaves)
    t = Tree(max_leaves)
    t.num_leaves = n
    if n < 2:
        t.leaf_value[0] = float(a.leaf_value[0])
        return t
    k = n - 1
    t.split_feature_inner[:k] = a.split_feature[:k]
    t.threshold_in_bin[:k] = a.threshold_bin[:k]
    t.decision_type[:k] = np.where(a.is_cat[:k], CATEGORICAL_DECISION,
                                   NUMERICAL_DECISION)
    t.has_categorical = bool(a.is_cat[:k].any())
    t.left_child[:k] = a.left_child[:k]
    t.right_child[:k] = a.right_child[:k]
    t.split_gain[:k] = a.split_gain[:k]
    t.internal_value[:k] = a.internal_value[:k]
    t.internal_count[:k] = np.round(a.internal_count[:k]).astype(np.int64)
    t.leaf_value[:n] = a.leaf_value[:n]
    t.leaf_count[:n] = np.round(a.leaf_count[:n]).astype(np.int64)
    t.leaf_depth[:n] = a.leaf_depth[:n]
    for node in range(k):
        real = dataset.inner_to_real(int(t.split_feature_inner[node]))
        t.split_feature[node] = real
        t.threshold[node] = dataset.mappers[real].bin_to_value(
            int(t.threshold_in_bin[node]))
    return t


def build_tree(bins, grad, hess, row_mask, num_bins, is_cat, fmask, ftbl,
               unb=None, *,
               num_leaves: int, num_bins_padded: int, split_kw: dict,
               max_depth: int, min_data_in_leaf: int,
               min_sum_hessian_in_leaf: float,
               input_dtype: str = "float32",
               cache_parent_hist: bool = True,
               rows=None) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree on one device, with no host read.

    bins     : [C, N] int store columns (the original per-feature bins,
               or bundled columns under EFB; int8 holds value - 128), or
               the sparse ELL feed (cols [N, R], binsv [N, R], zero_bin
               [C][, streams]) with, on CUDA, the column-sorted entry
               streams of ops/sparse_streams.py
    grad/hess/row_mask : [N] f32 (row_mask is 0 for out-of-bag rows)
    num_bins/is_cat/fmask : per-ORIGINAL-feature metadata
    ftbl     : [5, F] feature->(col, offset, default, nslots, packed)
               table of a bundled store, or None (the store is the
               features)
    unb      : None, or the (src, dmask) unbundle tables of a bundled
               store; every histogram is then unbundled before search
    rows     : the dense store's row-major byte copy, which kernel K2
               reads (optional)
    Returns (TreeArrays, leaf_id [N] int32), all on the store's device;
    leaf_id covers out-of-bag rows too.  One device: the learner and
    the factory refuse the multi-device routes."""
    sparse = isinstance(bins, (tuple, list))
    if sparse:
        sp_cols, sp_bins, sp_zb = bins[:3]
        streams = bins[3] if len(bins) > 3 else None
        C, N = sp_zb.shape[0], sp_cols.shape[0]
        dev = sp_cols.device
    else:
        C, N = bins.shape
        dev = bins.device
    L = num_leaves
    B = num_bins_padded
    skw = dict(split_kw)
    l1, l2 = skw["lambda_l1"], skw["lambda_l2"]
    F = is_cat.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)

    def make_hist(mask):
        if sparse:
            return histogram_full_sparse(
                sp_cols, sp_bins, sp_zb, grad, hess, mask,
                num_columns_padded=C, num_bins_padded=B,
                input_dtype=input_dtype, streams=streams)
        return histogram_full_masked(bins, grad, hess, mask,
                                     num_bins_padded=B,
                                     input_dtype=input_dtype, rows=rows)

    def find_best(hists, sums):
        """Best split records [k, 11] of k leaves' store-space histograms
        [k, C, 3, B] and their (sum_grad, sum_hess, count) [k, 3], with
        the can-split gate (serial_tree_learner.cpp _can_split; the depth
        gate is applied at leaf selection)."""
        rec = best_split(maybe_unbundle(hists, unb, sums), num_bins,
                         is_cat, fmask, sums[:, 0], sums[:, 1], sums[:, 2],
                         **skw)
        can = ((sums[:, 2] >= 2 * min_data_in_leaf)
               & (sums[:, 1] >= 2 * min_sum_hessian_in_leaf))
        g = rec[:, 0]
        rec[:, 0] = torch.where(can & torch.isfinite(g) & (g > 0), g,
                                torch.full_like(g, NEG_INF))
        return rec

    def go_left_row(feat, thr, catf):
        """[N] bool: does each row go left under the ORIGINAL-space split
        (feat, thr)?  The store-space predicate of its column."""
        col, T, lo, hi1, dl = bundle_predicate_params(ftbl, feat, thr, catf)
        if sparse:
            featrow = sparse_bin_lookup(sp_cols, sp_bins, sp_zb,
                                        col.expand(N))
        else:
            featrow = bins.index_select(0, col.long())[0].to(torch.int32)
            if bins.dtype == torch.int8:
                featrow = featrow + 128
        return store_go_left(featrow, T, lo, hi1, dl, catf)

    # ---- root ---------------------------------------------------------------
    hist0 = make_hist(row_mask)
    # every row lands in exactly one bin of each store column, so column
    # 0's bin sums give the leaf totals (summed in f64, so the card's
    # totals are the CPU's)
    root_sums = hist0[0].to(torch.float64).sum(dim=-1).to(torch.float32)
    ar = torch.arange(L + 1, device=dev)

    leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
    leaf_best = torch.full((L, 11), NEG_INF, **f32)
    leaf_best[0] = find_best(hist0[None], root_sums[None])[0]
    # per leaf: value, count, depth, parent node, side (0 left, 1 right)
    leaf_f = torch.zeros((L, 5), **f32)
    leaf_f[0, 0] = leaf_output(root_sums[0], root_sums[1], l1, l2)
    leaf_f[0, 1] = root_sums[2]
    leaf_f[0, 3:4].fill_(-1.0)        # a Python scalar set would copy
    # the parent-subtraction cache; dropped when the pool budget binds
    leaf_hist = None
    if cache_parent_hist:
        leaf_hist = torch.zeros((L,) + tuple(hist0.shape), **f32)
        leaf_hist[0] = hist0
    # per node: feature, threshold bin, is_cat, left, right, gain,
    # internal value, internal count; row L-1 is the drop row
    NODE_W = 8
    node_f = torch.zeros((max(L, 1), NODE_W), **f32)
    n_leaves = torch.ones(1, dtype=torch.int32, device=dev)

    for i in range(L - 1):
        gated = leaf_best[:, 0]
        if max_depth > 0:
            gated = torch.where(leaf_f[:, 2] < max_depth, gated,
                                torch.full_like(gated, NEG_INF))
        bl = torch.argmax(gated, dim=0, keepdim=True)           # [1]
        rec = leaf_best.index_select(0, bl)[0]                  # [11]
        do = gated.index_select(0, bl) > 0                      # [1]
        feat = torch.nan_to_num(rec[1:2], neginf=0.0).to(
            torch.int64).clamp(0, F - 1)
        thr = torch.nan_to_num(rec[2:3], neginf=0.0).to(torch.int64)
        catf = is_cat.index_select(0, feat)
        new_leaf = ar[i + 1:i + 2]

        # ---- partition (DataPartition::Split, mask-based) ------------------
        gl = go_left_row(feat, thr, catf)
        split_mask = do & (leaf_id == bl) & ~gl
        leaf_id2 = torch.where(split_mask, i + 1, leaf_id)

        l_sums = rec[3:6]
        r_sums = rec[6:9]
        small_is_left = l_sums[2:3] <= r_sums[2:3]              # [1]
        small_leaf = torch.where(small_is_left, bl, new_leaf)
        large_leaf = torch.where(small_is_left, new_leaf, bl)

        # ---- smaller child histogram + larger by subtraction -------------
        dof = do.to(torch.float32)
        hist_small = make_hist(
            row_mask * (leaf_id2 == small_leaf).to(torch.float32) * dof)
        if cache_parent_hist:
            hist_large = leaf_hist.index_select(0, bl)[0] - hist_small
        else:
            hist_large = make_hist(
                row_mask * (leaf_id2 == large_leaf).to(torch.float32) * dof)
        small_sums = torch.where(small_is_left, l_sums, r_sums)
        large_sums = torch.where(small_is_left, r_sums, l_sums)
        recs = find_best(torch.stack([hist_small, hist_large]),
                         torch.stack([small_sums, large_sums]))  # [2, 11]
        # rows (best_leaf, new_leaf) take (left, right)
        idx2 = torch.cat([bl, new_leaf])
        sl2 = small_is_left[:, None]
        new_best = torch.where(sl2, recs, recs.flip(0))
        leaf_best.index_copy_(0, idx2, torch.where(
            do[:, None], new_best, leaf_best.index_select(0, idx2)))
        if cache_parent_hist:
            h2 = torch.stack([hist_small, hist_large])
            new_h = torch.where(small_is_left[:, None, None, None], h2,
                                h2.flip(0))
            leaf_hist.index_copy_(0, idx2, torch.where(
                do[:, None, None, None], new_h,
                leaf_hist.index_select(0, idx2)))

        # ---- tree arrays (Tree::Split, tree.cpp:52-97) --------------------
        lrow = leaf_f.index_select(0, bl)[0]
        child_depth = lrow[2:3] + 1.0
        nodev = torch.full((1,), float(i), **f32)
        node_row = torch.cat([
            rec[1:3], catf.to(torch.float32),
            -1.0 - bl.to(torch.float32), -1.0 - new_leaf.to(torch.float32),
            rec[0:1], lrow[0:1], l_sums[2:3] + r_sums[2:3]])
        node_f[i] = torch.where(do, node_row, node_f[i])
        # the parent's child pointer, into the drop row without a parent
        pn, side = lrow[3:4], lrow[4:5]
        tgt = torch.where(do & (pn >= 0), pn * NODE_W + 3 + side,
                          torch.full_like(pn, (L - 1) * NODE_W + 3))
        node_f.view(-1).index_copy_(0, tgt.to(torch.int64), nodev)
        new_leaves = torch.stack([
            torch.cat([rec[9:10], l_sums[2:3], child_depth, nodev,
                       torch.zeros(1, **f32)]),
            torch.cat([rec[10:11], r_sums[2:3], child_depth, nodev,
                       torch.ones(1, **f32)])])
        leaf_f.index_copy_(0, idx2, torch.where(
            do[:, None], new_leaves, leaf_f.index_select(0, idx2)))
        leaf_id = leaf_id2
        n_leaves = n_leaves + do.to(torch.int32)

    k = L - 1
    arrs = TreeArrays(
        split_feature=node_f[:k, 0].to(torch.int32),
        threshold_bin=node_f[:k, 1].to(torch.int32),
        is_cat=node_f[:k, 2] > 0.5,
        left_child=node_f[:k, 3].to(torch.int32),
        right_child=node_f[:k, 4].to(torch.int32),
        split_gain=node_f[:k, 5].clone(),
        internal_value=node_f[:k, 6].clone(),
        internal_count=node_f[:k, 7].clone(),
        leaf_value=leaf_f[:, 0].clone(),
        leaf_count=leaf_f[:, 1].clone(),
        leaf_depth=leaf_f[:, 2].to(torch.int32),
        num_leaves=n_leaves[0])
    return arrs, leaf_id


class FusedTreeLearner:
    """The fused single-split learner on one device (the JAX package's
    `exact` schedule on its accelerator): `build_tree` over the whole
    store each split, one packed read a tree.

    Over an EFB-bundled store (`use_bundle`) the histograms are over
    the bundle columns and unbundled per split; a sparse dataset feeds
    `build_tree` its ELL entries (`_assemble_sparse_feed`), so the store
    never densifies."""

    def __init__(self, dataset: Dataset, config: Config, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MULTI_DEVICE)
        self.dataset = dataset
        self.config = config
        self.device = torch.device(config.device_type)
        self.full_leaf_id = True   # leaf_id valid for out-of-bag rows too
        self.N = dataset.num_data
        self.F = dataset.num_features
        self.B = padded_bin_count(dataset.max_num_bin)
        cfg = config
        plan = dataset.bundle_plan
        self.use_bundle = plan is not None
        self._sparse_feed = dataset.sparse is not None
        self.Cstore = dataset.num_store_columns
        dev = self.device
        self.rows = None
        if self._sparse_feed:
            cols, ell, zb = self._assemble_sparse_feed()
            feed = (torch.as_tensor(cols, device=dev),
                    torch.as_tensor(ell, device=dev),
                    torch.as_tensor(zb, device=dev))
            if dev.type == "cuda":
                # kernel K8 reads the entries sorted by column
                feed += (build_sparse_streams(feed[0], feed[1],
                                              self.Cstore),)
            self.bins_dev = feed
        else:
            self.bins_dev, self.rows = dense_store_feed(dataset, dev,
                                                        "fused_feed")
        nb = dataset.num_bins.astype(np.int64)
        self.num_bins_dev = torch.as_tensor(nb, device=dev)
        self.is_cat_dev = torch.as_tensor(dataset.is_categorical,
                                          device=dev)
        self._base_fmask = np.ones(self.F, bool)
        self._fmask_dev = None
        self._row_mask_dev = torch.ones(self.N, dtype=torch.float32,
                                        device=dev)
        if self.use_bundle:
            self.ftbl = torch.as_tensor(plan.feat_table(), device=dev)
            src, dmask = dataset.unbundle_tables(self.B, self.Cstore)
            self.unb = (torch.as_tensor(src, device=dev),
                        torch.as_tensor(dmask, device=dev))
        else:
            self.ftbl = self.unb = None
        self.split_kw = make_split_kw(cfg)
        self._feat_rng = np.random.RandomState(cfg.feature_fraction_seed)
        self.cache_parent_hist = use_parent_hist_cache(cfg, self.Cstore,
                                                       self.B, dev)
        self.last_host_syncs = 0
        self._kw = dict(num_leaves=int(cfg.num_leaves),
                        num_bins_padded=self.B, split_kw=self.split_kw,
                        max_depth=int(cfg.max_depth),
                        min_data_in_leaf=int(cfg.min_data_in_leaf),
                        min_sum_hessian_in_leaf=float(
                            cfg.min_sum_hessian_in_leaf),
                        cache_parent_hist=self.cache_parent_hist,
                        input_dtype=getattr(cfg, "histogram_dtype",
                                            "float32"),
                        rows=self.rows)

    def _assemble_sparse_feed(self):
        """Host (cols [N, R], binsv [N, R] int32, zero_bin [C]) ELL feed
        of the sparse store for `build_tree`: the store columns' entries
        (the bundle columns' under a plan), front-packed in column order
        with sentinel column C.  That is the dataset's own ELL store; the
        JAX feed's leading feature-shard axis is 1 on one device and is
        left out."""
        sp = self.dataset.sparse
        return (np.ascontiguousarray(sp.cols, np.int32),
                sp.bins.astype(np.int32), sp.zero_bin.astype(np.int32))

    @property
    def bins_t(self):
        """The store a tree walks over the training rows (the score
        replay of DART's drops, rollback, a resumed model): the [C, N]
        store the builder reads, or the sparse ELL triple, so the store
        never densifies for scoring.  The JAX learner's transposed
        [N+1, F] view is the port's [C, N] walk layout."""
        return self.bins_dev[:3] if self._sparse_feed else self.bins_dev

    walk_bins = bins_t   # the name gbdt's score replay reads of a learner

    def _feature_mask(self) -> torch.Tensor:
        frac = self.config.feature_fraction
        if frac >= 1.0:
            # no sampling: one cached device copy
            if self._fmask_dev is None:
                self._fmask_dev = torch.as_tensor(self._base_fmask,
                                                  device=self.device)
            return self._fmask_dev
        m = self._base_fmask.copy()
        k = max(1, int(round(self.F * frac)))
        sel = self._feat_rng.choice(self.F, size=k, replace=False)
        mm = np.zeros(self.F, bool)
        mm[sel] = True
        m &= mm
        # the per-tree host draw is the design (reference rng parity);
        # its upload is deliberate
        with explicit_transfer():
            return torch.as_tensor(m, device=self.device)

    def _row_mask(self, bag_idx: Optional[torch.Tensor]) -> torch.Tensor:
        if bag_idx is None:
            return self._row_mask_dev
        # bag membership: sentinel indices (== N) land in the dropped slot
        m = torch.zeros(self.N + 1, dtype=torch.float32, device=self.device)
        m.index_fill_(0, bag_idx.long(), 1.0)
        return m[:self.N] * self._row_mask_dev

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag_idx: Optional[torch.Tensor] = None,
              bag_count: Optional[int] = None) -> Tuple[Tree, torch.Tensor]:
        """Grow one tree: (host Tree, leaf_id [N] int32 on the device,
        out-of-bag rows included), with one host read."""
        arrs, leaf_id = build_tree(
            self.bins_dev, grad, hess, self._row_mask(bag_idx),
            self.num_bins_dev, self.is_cat_dev, self._feature_mask(),
            self.ftbl, self.unb, **self._kw)
        tree = tree_arrays_to_host(arrs, self.dataset,
                                   self.config.num_leaves)
        self.last_host_syncs = 1
        return tree, leaf_id


def resolve_tree_learner(device_type: str, tree_growth: str = "auto",
                         tree_learner: str = "serial") -> str:
    """The learner a (device, tree_growth, tree_learner) triple runs, as
    the JAX factory resolves it on one device with the CUDA device in
    the TPU's place: "fused" for exact on CUDA (the JAX package's
    accelerator choice), "serial" for exact elsewhere, "rounds" for
    auto and rounds on every device (the port's auto is rounds
    everywhere, the sparse store included)."""
    if tree_learner != "serial":
        raise NotImplementedError(
            f"tree_learner={tree_learner} is not ported yet; this slice "
            "runs the single-device learners (ROADMAP.md §A item 12)")
    if tree_growth == "exact":
        return "fused" if torch.device(device_type).type == "cuda" \
            else "serial"
    return "rounds"


def create_tree_learner(dataset: Dataset, config: Config):
    """Factory (reference tree_learner.cpp:9-33), one device: the
    learner `resolve_tree_learner` names.  The serial learner over a
    sparse store takes the counted dense fallback, as in the JAX
    package; the fused learner reads it sparse."""
    kind = resolve_tree_learner(config.device_type,
                                getattr(config, "tree_growth", "auto"),
                                getattr(config, "tree_learner", "serial"))
    if kind == "fused":
        return FusedTreeLearner(dataset, config)
    if kind == "serial":
        from .serial import SerialTreeLearner
        return SerialTreeLearner(dataset, config)
    from .rounds import RoundsTreeLearner
    return RoundsTreeLearner(dataset, config)
