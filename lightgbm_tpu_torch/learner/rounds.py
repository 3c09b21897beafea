"""Batched-rounds tree learner, single device.

Port of lightgbm_tpu/learner/rounds.py (`build_tree_rounds`,
`RoundsTreeLearner`) for one device, over the dense store or the sparse
CSR/ELL store, with both row feeds (`hist_rows` masked and gathered).
Every round splits all splittable leaves at once (the top-gain leaves
when the num_leaves cap binds), histograms the smaller children of all
splits in multi-leaf passes of up to LEAVES_PER_BATCH slots, and takes
the larger children from parent-histogram subtraction.  The arithmetic
is the JAX learner's, step for step.

The JAX learner grew the whole tree inside one `lax.while_loop` with no
host syncs.  Here the round loop runs on the host, and each round reads
one small tensor from the device: the number of splits (the stop test)
and the live-row totals of each histogram pass (the capacity-tier
choice of the gathered feed).  The final tree fetch is one more read.
`build_tree_rounds` returns that count; the learner keeps it per tree in
`last_host_syncs`.  Removing these reads (CUDA graphs, device-side
control) is later work.

Over an EFB-bundled store (the dataset has a bundle plan) the histograms
and the parent cache are store-space, [C, 3, B] per leaf with C bundle
columns; each is unbundled to the original features (`unbundle_hist`,
through `unb`) before split search, and each split's original-space
(feature, threshold) is translated into its store-space window
(`bundle_predicate_params`, through the feature table `ftbl`) for the
partition table that kernel K4 reads.

With `sparse=True` (the dataset holds a SparseStore) `bins` is the ELL
triple (cols [N, R], bins [N, R], zero_bin [F]), on CUDA with the
column-sorted entry streams as a fourth element: histogram passes
iterate stored entries only (kernels K7/K8, ops/histogram.py
`hist_sparse_multileaf`) and rebuild each column's zero bin from the
slot totals, and the partition probes the row's entries
(`partition_rows_sparse`); the store is never densified.  On CUDA the
sparse store runs the masked row feed, as the JAX package does on its
accelerator.

Index arrays that JAX updated with `mode="drop"` scatters carry one
trailing drop slot here, so inactive updates land in the slot that is
sliced off at the end instead of needing a masked (syncing) index.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from .. import log
from ..dataset import Dataset
from ..ops.histogram import (RowBins, hist_multileaf_gathered,
                             hist_multileaf_masked, hist_sparse_gathered,
                             hist_sparse_multileaf, row_major_bins)
from ..ops.partition import partition_rows, partition_rows_sparse
from ..ops.sparse_streams import build_sparse_streams
from ..ops.split import best_split, bundle_predicate_params, maybe_unbundle
from ..tree import Tree
from .common import (gather_capacity_tiers, gather_scratch_capacity,
                     make_split_kw, padded_bin_count, resolve_hist_rows,
                     use_parent_hist_cache)
from .fused import TreeArrays, tree_arrays_to_host

NEG_INF = -math.inf

# leaves histogrammed per multi-leaf pass (the JAX learner's default)
LEAVES_PER_BATCH = 84


def build_tree_rounds(bins, grad, hess, row_mask, num_bins, is_cat, fmask,
                      *, num_leaves: int, num_bins_padded: int,
                      split_kw: dict, max_depth: int, min_data_in_leaf: int,
                      min_sum_hessian_in_leaf: float,
                      input_dtype: str = "float32",
                      cache_parent_hist: bool = True,
                      hist_rows: str = "masked", sparse: bool = False,
                      ftbl: Optional[torch.Tensor] = None,
                      unb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      rows: Optional[RowBins] = None
                      ) -> Tuple[TreeArrays, torch.Tensor, int]:
    """Grow one tree in batched rounds.

    bins [C, N] int32 store (int8 = value-128), or with sparse=True the
    ELL triple (cols [N, R] int32 with C as the empty-slot sentinel,
    bins [N, R] int32, zero_bin [C] int32 with -1 on padded columns,
    and optionally the SparseStreams of ops/sparse_streams.py);
    grad/hess/row_mask [N] f32; num_bins [F] int, is_cat/fmask [F]
    bool, over the original features — all on one device.  C == F
    unless the store is EFB-bundled; then ftbl is the [5, F] feature
    table and unb the (src, dmask) unbundle tables, both on the device
    (None for an unbundled store).  rows (a dense store of at most 256
    bins) is its row-major byte copy, which the histogram kernels K1 and
    K2 read.
    Returns (TreeArrays on that device, leaf_id [N] int32, host reads
    made).  hist_rows="gathered" keeps the device-resident row
    permutation grouped by leaf with per-leaf (offset, count), stably
    compacted after every round's partition, and histograms only the
    segments a pass needs; "masked" streams all rows every pass."""
    if sparse:
        sp_cols, sp_bins, sp_zb = bins[:3]
        F, N = sp_zb.shape[0], sp_cols.shape[0]
        dev = sp_cols.device
    else:
        F, N = bins.shape
        dev = bins.device
    L = num_leaves
    B = num_bins_padded
    K = LEAVES_PER_BATCH
    n_chunks = (L + K - 1) // K
    gathered = hist_rows == "gathered"
    if gathered:
        tiers_all = gather_capacity_tiers(N)
        tiers_small = gather_capacity_tiers(gather_scratch_capacity(N))
    # any round splits >= 1 leaf, so L-1 rounds bound even a chain
    R = L - 1
    skw = dict(split_kw)
    syncs = 0
    i64 = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def find_best_batch(hists, sums):
        """hists [k, F, 3, B], sums [k, 3] -> packed records [k, 11] with
        the can-split gate applied (depth gates at selection time)."""
        rec = best_split(maybe_unbundle(hists, unb, sums), num_bins,
                         is_cat, fmask, sums[:, 0], sums[:, 1], sums[:, 2],
                         **skw)
        can = ((sums[:, 2] >= 2 * min_data_in_leaf)
               & (sums[:, 1] >= 2 * min_sum_hessian_in_leaf))
        g = rec[:, 0]
        rec[:, 0] = torch.where(can & torch.isfinite(g) & (g > 0), g,
                                torch.full_like(g, NEG_INF))
        return rec

    def hist_masked(lid_, sl_):
        """One masked multi-leaf pass over the whole store, dense or
        nonzero-iterating; both return [K, F, 3, B]."""
        if sparse:
            return hist_sparse_multileaf(
                bins, lid_, gh8, sl_, num_columns_padded=F,
                num_bins_padded=B, input_dtype=input_dtype)
        return hist_multileaf_masked(bins, lid_, gh8, sl_,
                                     num_bins_padded=B,
                                     input_dtype=input_dtype, rows=rows)

    # ---- root --------------------------------------------------------------
    gh8 = torch.stack([grad * row_mask, hess * row_mask, row_mask])
    lid0 = torch.zeros(N, dtype=torch.int32, device=dev)
    hist0 = hist_masked(
        lid0, torch.zeros(1, dtype=torch.int32, device=dev))[0]  # [F, 3, B]
    # summed in f64, so the card's root totals are the CPU's
    root_sums = hist0[0].to(torch.float64).sum(dim=-1).to(torch.float32)

    leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
    if gathered:
        # live rows first in row order (root's segment); sampled-out rows
        # parked past n_active, outside every leaf segment
        live0 = (row_mask > 0).to(torch.int64)
        ecs0 = torch.cumsum(live0, 0) - live0
        n_active = live0.sum()
        posn0 = torch.arange(N, **i64)
        dest0 = torch.where(live0 > 0, ecs0, n_active + (posn0 - ecs0))
        perm = torch.empty(N, **i64)
        perm[dest0] = posn0
        leaf_off = torch.zeros(L + 1, **i64)           # slot L: drop slot
        leaf_cnt = torch.zeros(L + 1, **i64)
        leaf_cnt[0] = n_active
    leaf_best = torch.full((L, 11), NEG_INF, **f32)
    leaf_best[0] = find_best_batch(hist0[None], root_sums[None])[0]
    leaf_depth = torch.zeros(L, **i64)
    leaf_parent = torch.full((L,), -1, **i64)
    leaf_side = torch.zeros(L, **i64)
    leaf_hist = None
    if cache_parent_hist:
        leaf_hist = torch.zeros((L,) + tuple(hist0.shape), **f32)
        leaf_hist[0] = hist0

    # tree arrays; the [L-1] node arrays carry a drop slot at L-1
    sf = torch.zeros(L, **i64)
    thb = torch.zeros(L, **i64)
    icat = torch.zeros(L, dtype=torch.bool, device=dev)
    lch = torch.zeros(L, **i64)
    rch = torch.zeros(L, **i64)
    sgain = torch.zeros(L, **f32)
    ival = torch.zeros(L, **f32)
    icnt = torch.zeros(L, **f32)
    # leaf 0 stays 0.0 until a split assigns it: a no-split tree
    # contributes zero score
    lval = torch.zeros(L, **f32)
    lcnt = torch.zeros(L, **f32)
    lcnt[0] = root_sums[2]
    n_leaves = 1
    slot_ix = torch.arange(L, **i64)

    def hist_slots(slots, tiers, total):
        """[len(slots), F, 3, B] histograms of the given leaves over the
        current row partition (leaf_id, or perm/leaf_off/leaf_cnt)."""
        if gathered:
            cap = next((t for t in tiers if total <= t), tiers[-1])
            if sparse:
                return hist_sparse_gathered(
                    bins, gh8, perm, leaf_off[slots], leaf_cnt[slots],
                    capacity=cap, num_columns_padded=F, num_bins_padded=B,
                    input_dtype=input_dtype)
            return hist_multileaf_gathered(
                bins, gh8, perm, leaf_off[slots], leaf_cnt[slots],
                capacity=cap, num_bins_padded=B, input_dtype=input_dtype,
                rows=rows)
        return hist_masked(leaf_id, slots.to(torch.int32))

    rnd = 0
    while rnd < R and n_leaves < L:
        # ---- select this round's splits (top-gain within the cap) --------
        gated = torch.where((max_depth <= 0) | (leaf_depth < max_depth),
                            leaf_best[:, 0],
                            torch.full((L,), NEG_INF, **f32))
        order = torch.argsort(-gated, stable=True)            # [L]
        sgain_sorted = gated[order]
        remaining = L - n_leaves
        do = (sgain_sorted > 0) & (slot_ix < remaining)       # a prefix
        prefix = torch.cumsum(do.to(torch.int64), 0) - do.to(torch.int64)
        m_dev = do.sum()

        pl_ = order
        rec = leaf_best[pl_]                                  # [L, 11]
        feat = rec[:, 1].to(torch.int64)
        thr = rec[:, 2].to(torch.int64)
        # never-split leaves hold -inf records; their slots are inactive,
        # so only the index has to stay in range
        catf = is_cat[feat.clamp(0, is_cat.shape[0] - 1)]
        new_leaf = n_leaves + prefix
        node = (n_leaves - 1) + prefix
        l_sums = rec[:, 3:6]
        r_sums = rec[:, 6:9]

        # ---- partition all rows in one pass -------------------------------
        colv, Tv, lov, hi1v, dlv = bundle_predicate_params(ftbl, feat, thr,
                                                           catf)
        tbl_idx = torch.where(do, pl_, torch.full_like(pl_, L))
        tbl = torch.zeros((7, L + 1), **f32)
        tbl[:, tbl_idx] = torch.stack([
            colv.to(torch.float32), Tv.to(torch.float32),
            catf.to(torch.float32), new_leaf.to(torch.float32),
            lov.to(torch.float32), hi1v.to(torch.float32),
            dlv.to(torch.float32)])
        # column L collects the non-splitting slots and is never read:
        # leaf ids are < L; zero it so the table stays a pure function
        tbl[:, L] = 0.0
        if sparse:
            leaf_id2 = partition_rows_sparse(sp_cols, sp_bins, sp_zb,
                                             leaf_id, tbl)
        else:
            leaf_id2 = partition_rows(bins, leaf_id, tbl)

        # ---- stable row compaction (DataPartition::Split) -----------------
        if gathered:
            posn = torch.arange(N, **i64)
            n_act = leaf_cnt[:L].sum()
            ol = leaf_id[perm].to(torch.int64)
            nl = leaf_id2[perm].to(torch.int64)
            stay = nl == ol
            csp = torch.cat([torch.zeros(1, **i64),
                             torch.cumsum(stay.to(torch.int64), 0)])
            soff = leaf_off[ol]
            seg_stays = csp[soff]
            rstay = csp[:N] - seg_stays
            ns_row = csp[soff + leaf_cnt[ol]] - seg_stays
            dest = soff + torch.where(stay, rstay,
                                      ns_row + (posn - soff) - rstay)
            dest = torch.where(posn >= n_act, posn, dest)
            perm2 = torch.empty_like(perm)
            perm2[dest] = perm
            ns_leaf = csp[leaf_off[:L] + leaf_cnt[:L]] - csp[leaf_off[:L]]
            ns_p = ns_leaf[pl_]
            nii = torch.where(do, new_leaf, torch.full_like(new_leaf, L))
            pii = torch.where(do, pl_, torch.full_like(pl_, L))
            leaf_off2 = leaf_off.clone()
            leaf_off2[nii] = leaf_off[pl_] + ns_p
            leaf_cnt2 = leaf_cnt.clone()
            leaf_cnt2[nii] = leaf_cnt[pl_] - ns_p
            leaf_cnt2[pii] = ns_p
            leaf_off2[L] = 0
            leaf_cnt2[L] = 0

        # ---- smaller / larger children --------------------------------------
        small_is_left = l_sums[:, 2] <= r_sums[:, 2]
        small_leaf = torch.where(small_is_left, pl_, new_leaf)
        large_leaf = torch.where(small_is_left, new_leaf, pl_)
        small_sums = torch.where(small_is_left[:, None], l_sums, r_sums)
        large_sums = torch.where(small_is_left[:, None], r_sums, l_sums)

        # ---- the round's one host read: split count + per-pass row totals --
        payload = [m_dev.view(1)]
        if gathered:
            pad = n_chunks * K - L

            def chunk_totals(leaves):
                cnt = torch.where(do, leaf_cnt2[leaves.clamp(max=L)],
                                  torch.zeros((), **i64))
                return torch.nn.functional.pad(cnt, (0, pad)).view(
                    n_chunks, K).sum(1)
            payload += [chunk_totals(small_leaf), chunk_totals(large_leaf)]
        host = torch.cat(payload).tolist()
        syncs += 1
        m = int(host[0])
        if m == 0:
            break
        tot_small = host[1:1 + n_chunks] if gathered else [0] * n_chunks
        tot_large = host[1 + n_chunks:] if gathered else [0] * n_chunks
        if gathered:
            perm, leaf_off, leaf_cnt = perm2, leaf_off2, leaf_cnt2
        leaf_id = leaf_id2

        # ---- tree arrays (batched Tree::Split) -------------------------------
        plm = pl_[:m]
        newm = new_leaf[:m]
        nodem = node[:m]
        pn = leaf_parent[plm]
        side = leaf_side[plm]
        lpar = torch.where((pn >= 0) & (side == 0), pn,
                           torch.full_like(pn, L - 1))
        rpar = torch.where((pn >= 0) & (side == 1), pn,
                           torch.full_like(pn, L - 1))
        child_depth = leaf_depth[plm] + 1
        sf[nodem] = feat[:m]
        thb[nodem] = thr[:m]
        icat[nodem] = catf[:m]
        sgain[nodem] = rec[:m, 0]
        ival[nodem] = lval[plm]
        icnt[nodem] = l_sums[:m, 2] + r_sums[:m, 2]
        lch[lpar] = nodem
        lch[nodem] = ~plm
        rch[rpar] = nodem
        rch[nodem] = ~newm
        lval[plm] = rec[:m, 9]
        lval[newm] = rec[:m, 10]
        lcnt[plm] = l_sums[:m, 2]
        lcnt[newm] = r_sums[:m, 2]
        leaf_depth[plm] = child_depth
        leaf_depth[newm] = child_depth
        leaf_parent[plm] = nodem
        leaf_parent[newm] = nodem
        leaf_side[plm] = 0
        leaf_side[newm] = 1

        # ---- batched child histograms and their best splits ----------------
        for c in range((m + K - 1) // K):
            s = c * K
            na = min(K, m - s)
            sil = small_is_left[s:s + na]
            h_small = hist_slots(small_leaf[s:s + na],
                                 tiers_small if gathered else None,
                                 tot_small[c])
            if cache_parent_hist:
                h_large = leaf_hist[pl_[s:s + na]] - h_small
            else:
                h_large = hist_slots(large_leaf[s:s + na],
                                     tiers_all if gathered else None,
                                     tot_large[c])
            rec_s = find_best_batch(h_small, small_sums[s:s + na])
            rec_l = find_best_batch(h_large, large_sums[s:s + na])
            li = pl_[s:s + na]
            ni = new_leaf[s:s + na]
            leaf_best[li] = torch.where(sil[:, None], rec_s, rec_l)
            leaf_best[ni] = torch.where(sil[:, None], rec_l, rec_s)
            if cache_parent_hist:
                s4 = sil[:, None, None, None]
                hL = torch.where(s4, h_small, h_large)
                hR = torch.where(s4, h_large, h_small)
                leaf_hist[li] = hL
                leaf_hist[ni] = hR
        n_leaves += m
        rnd += 1

    arrs = TreeArrays(
        split_feature=sf[:L - 1].to(torch.int32),
        threshold_bin=thb[:L - 1].to(torch.int32),
        is_cat=icat[:L - 1],
        left_child=lch[:L - 1].to(torch.int32),
        right_child=rch[:L - 1].to(torch.int32),
        split_gain=sgain[:L - 1], internal_value=ival[:L - 1],
        internal_count=icnt[:L - 1],
        leaf_value=lval, leaf_count=lcnt,
        leaf_depth=leaf_depth.to(torch.int32),
        num_leaves=torch.tensor(n_leaves, dtype=torch.int32, device=dev))
    return arrs, leaf_id, syncs


class RoundsTreeLearner:
    """Single-device learner using batched-rounds growth."""

    def __init__(self, dataset: Dataset, config: Config):
        self.dataset = dataset
        self.config = config
        self.device = torch.device(config.device_type)
        self.N = dataset.num_data
        self.F = dataset.num_features                  # original features
        self.C = dataset.num_store_columns             # store columns
        self.B = padded_bin_count(dataset.max_num_bin)
        self.sparse = dataset.sparse is not None
        if self.sparse:
            # the ELL triple as built: on one device no column is padded,
            # so the empty-slot sentinel is the column count and no
            # zero_bin is -1.  On CUDA the histogram kernels read the
            # entries sorted by column, built here once per learner
            self.bins_dev = dataset.sparse_triple(self.device)
            if self.device.type == "cuda":
                self.bins_dev += (build_sparse_streams(
                    self.bins_dev[0], self.bins_dev[1], self.C),)
            bins_itemsize = 4
        else:
            store = dataset.dense_bins(site="rounds_feed")     # [F, N]
            if dataset.max_num_bin <= 256:
                # a byte a bin (int8 layout, value - 128): the partition
                # kernel K4 reads one bin of a row's split column, and the
                # feature-major bytes touch the fewest 32-byte sectors
                bins_np = (store.astype(np.int16) - 128).astype(np.int8)
            else:
                bins_np = store.astype(np.int32)
            self.bins_dev = torch.as_tensor(bins_np, device=self.device)
            bins_itemsize = int(bins_np.dtype.itemsize)
        # kernels K1 and K2 read a row's bins from a row-major byte copy of
        # the store ([N, F4] uint8); the [F, N] store stays for the
        # partition
        self.rows = (row_major_bins(self.bins_dev, dataset.max_num_bin)
                     if not self.sparse and dataset.max_num_bin <= 256
                     else None)
        self.num_bins_dev = torch.as_tensor(
            dataset.num_bins.astype(np.int64), device=self.device)
        self.is_cat_dev = torch.as_tensor(dataset.is_categorical,
                                          device=self.device)
        # bundled: histograms unbundle to the original features before
        # split search.  The gather tables' zero sentinel sits past the
        # store's C columns, the columns of every histogram here (the
        # port pads no store column)
        ft = dataset.bundle_feat_table()
        self.ftbl = (None if ft is None
                     else torch.as_tensor(ft, device=self.device))
        unb = dataset.unbundle_tables(self.B, self.C)
        self.unb = (None if unb is None else
                    (torch.as_tensor(unb[0], device=self.device),
                     torch.as_tensor(unb[1], device=self.device)))
        self._base_fmask = np.ones(self.F, bool)
        self._fmask_dev = torch.as_tensor(self._base_fmask,
                                          device=self.device)
        self._row_mask_dev = torch.ones(self.N, dtype=torch.float32,
                                        device=self.device)
        cfg = config
        self.split_kw = make_split_kw(cfg)
        self._feat_rng = np.random.RandomState(cfg.feature_fraction_seed)
        self.cache_parent_hist = use_parent_hist_cache(cfg, self.C, self.B,
                                                       self.device)
        if self.sparse:
            # masked by default; a pinned gathered feed runs on the CPU
            # (plain torch ops) and falls back to masked on CUDA, as the
            # JAX package does on its accelerator
            hr = getattr(cfg, "hist_rows", "auto")
            if hr == "gathered" and self.device.type == "cuda":
                log.warning("hist_rows=gathered over the sparse store "
                            "runs the plain scatter path; using masked "
                            "on CUDA")
                hr = "masked"
            self.hist_rows = "masked" if hr == "auto" else hr
        else:
            self.hist_rows = resolve_hist_rows(
                cfg, device=self.device, num_columns=self.C,
                np_rows=max(1, self.N), bins_itemsize=bins_itemsize)
        self.last_host_syncs = 0
        self._kw = dict(num_leaves=int(cfg.num_leaves),
                        num_bins_padded=self.B, split_kw=self.split_kw,
                        max_depth=int(cfg.max_depth),
                        min_data_in_leaf=int(cfg.min_data_in_leaf),
                        min_sum_hessian_in_leaf=float(
                            cfg.min_sum_hessian_in_leaf),
                        cache_parent_hist=self.cache_parent_hist,
                        hist_rows=self.hist_rows, sparse=self.sparse,
                        ftbl=self.ftbl, unb=self.unb, rows=self.rows,
                        input_dtype=getattr(cfg, "histogram_dtype",
                                            "float32"))

    @property
    def walk_bins(self):
        """The store a tree walks over the training rows (DART's drops,
        rollback, the replay of a resumed or continued model): the [F, N]
        store the partition reads (int8 bytes holding value - 128 up to
        256 bins, int32 past that), or the sparse ELL triple; no copy."""
        return self.bins_dev[:3] if self.sparse else self.bins_dev

    def _feature_mask(self) -> torch.Tensor:
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return self._fmask_dev
        k = max(1, int(round(self.F * frac)))
        sel = self._feat_rng.choice(self.F, size=k, replace=False)
        m = np.zeros(self.F, bool)
        m[sel] = True
        return torch.as_tensor(self._base_fmask & m, device=self.device)

    def _row_mask(self, bag_idx: Optional[torch.Tensor]) -> torch.Tensor:
        if bag_idx is None:
            return self._row_mask_dev
        # bag membership: sentinel indices (== N) land in the dropped slot
        m = torch.zeros(self.N + 1, dtype=torch.float32, device=self.device)
        m[bag_idx.long()] = 1.0
        return m[:self.N] * self._row_mask_dev

    def train_device(self, grad: torch.Tensor, hess: torch.Tensor,
                     bag_idx: Optional[torch.Tensor] = None
                     ) -> Tuple[TreeArrays, torch.Tensor]:
        """Grow one tree: (device TreeArrays, leaf_id [N] int32)."""
        mask = self._row_mask(bag_idx)
        fmask = self._feature_mask()
        arrs, leaf_id, syncs = build_tree_rounds(
            self.bins_dev, grad, hess, mask, self.num_bins_dev,
            self.is_cat_dev, fmask, **self._kw)
        self.last_host_syncs = syncs
        return arrs, leaf_id

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag_idx: Optional[torch.Tensor] = None
              ) -> Tuple[Tree, torch.Tensor]:
        arrs, leaf_id = self.train_device(grad, hess, bag_idx)
        tree = tree_arrays_to_host(arrs, self.dataset, self.config.num_leaves)
        self.last_host_syncs += 1
        return tree, leaf_id
