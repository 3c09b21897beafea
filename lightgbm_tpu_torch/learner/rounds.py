"""Batched-rounds tree learner, on one device or data-parallel.

Port of lightgbm_tpu/learner/rounds.py (`build_tree_rounds`,
`RoundsTreeLearner`), over the dense store or the sparse CSR/ELL
store, with both row feeds (`hist_rows` masked and
gathered), and over a mesh of ranks (sharded/mesh.py: the data axis,
or both axes for data2d) with the psum and psum_scatter histogram
exchanges.
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
from .. import log, profiling
from ..dataset import Dataset
from ..diagnostics.sanitize import explicit_transfer
from ..ops.histogram import (RowBins, hist_multileaf_gathered,
                             hist_multileaf_masked, hist_sparse_gathered,
                             hist_sparse_multileaf)
from ..ops.partition import partition_rows, partition_rows_sparse
from ..ops.sparse_streams import build_sparse_streams
from ..ops.split import (best_split, bundle_predicate_params,
                         combine_sharded_records, maybe_unbundle,
                         sharded_slice_search)
from ..sharded.mesh import (HistExchange, Mesh, RankRows, pad_cols_to_ndev,
                            resolve_hist_exchange, row_block,
                            row_shard_axes, take_rows)
from ..tree import Tree
from .common import (dense_store_feed, gather_capacity_tiers,
                     gather_scratch_capacity, make_split_kw,
                     padded_bin_count, rank_block, resolve_hist_rows,
                     store_feed, use_parent_hist_cache)
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
                      rows: Optional[RowBins] = None, nnz: int = 0,
                      exchange: Optional[HistExchange] = None
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
    made).  The rows and (over the sparse store of `nnz` stored entries)
    the entries its histogram passes read go to the profiling registry's
    tree/hist_rows_touched and tree/sparse_nnz_touched; with a mesh
    `exchange`, the bytes of its histogram collectives and gathered
    split records to tree/hist_exchange_bytes and
    tree/split_records_bytes.
    hist_rows="gathered" keeps the device-resident row
    permutation grouped by leaf with per-leaf (offset, count), stably
    compacted after every round's partition, and histograms only the
    segments a pass needs; "masked" streams all rows every pass.

    Data-parallel (`exchange`, a sharded/mesh.py HistExchange): bins,
    grad, hess and row_mask are this rank's row block, and every
    histogram pass is reduced across the ranks of the row axes by the
    exchange (the dense store's int8 sums exactly, in int32 with shared
    scales; the sparse store's finished float32 sums).  Under
    psum the reduced [k, C, 3, B] histograms are the same on every rank;
    under psum_scatter each rank keeps its [k, C/nd, 3, B] store-column
    slice (nd = the exchange's slices), split-searches it
    (ops/split.sharded_slice_search) and the per-leaf records are
    all_gathered and combined (ops/split.combine_sharded_records): max
    gain, ties to the smallest feature id, the full search's order.  The
    root pass is psummed whole under either exchange, so the root's
    totals are the one-device ones.  Leaf totals, the records and so the
    round's host read and the tree are replicated on every rank; the
    row partition (leaf_id, perm, the per-leaf segments and the gathered
    capacity tiers) is the rank's own.  The returned leaf_id covers the
    rank's rows; the learner all_gathers it under the replicated
    boosting loop, and keeps it in a pre-partitioned world."""
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
        if exchange is not None:
            # smaller/larger is decided on GLOBAL counts, so a rank's
            # share of the globally smaller children can reach all of
            # its rows: keep the N/2 tier and make the full one reachable
            tiers_small = tuple(sorted(set(tiers_small + tiers_all)))
    # any round splits >= 1 leaf, so L-1 rounds bound even a chain
    R = L - 1
    skw = dict(split_kw)
    syncs = 0
    # rows and stored entries the histogram passes read (host counts)
    touched = [0, 0]
    xbytes0 = (dict(exchange.mesh.kind_bytes) if exchange is not None
               else None)
    i64 = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    # psum_scatter: this rank's store-column slice [off, off + Fs)
    hx = exchange is not None and exchange.scatter_axis is not None
    if hx:
        Fs = F // exchange.slices
        off = exchange.slice_index * Fs
        if unb is None:
            nb_s, ic_s = num_bins[off:off + Fs], is_cat[off:off + Fs]
            fm_s = fmask[off:off + Fs]
        else:
            nb_s = ic_s = fm_s = None

    def find_best_batch(hists, sums):
        """hists [k, F, 3, B] (this rank's [k, Fs, 3, B] slice under
        psum_scatter), sums [k, 3] -> packed records [k, 11] with the
        can-split gate applied (depth gates at selection time)."""
        if hx:
            rec = sharded_slice_search(
                hists, sums, off=off, nb_s=nb_s, ic_s=ic_s, fm_s=fm_s,
                num_bins=num_bins, is_cat=is_cat, fmask=fmask, unb=unb,
                skw=skw)
        else:
            rec = best_split(maybe_unbundle(hists, unb, sums), num_bins,
                             is_cat, fmask, sums[:, 0], sums[:, 1],
                             sums[:, 2], **skw)
        # the gate before the combine, as the JAX learner orders them
        can = ((sums[:, 2] >= 2 * min_data_in_leaf)
               & (sums[:, 1] >= 2 * min_sum_hessian_in_leaf))
        g = rec[:, 0]
        rec[:, 0] = torch.where(can & torch.isfinite(g) & (g > 0), g,
                                torch.full_like(g, NEG_INF))
        if hx:
            rec = combine_sharded_records(rec, exchange.mesh,
                                          exchange.scatter_axis)
        return rec

    def hist_masked(lid_, sl_, xch=exchange):
        """One masked multi-leaf pass over the whole store, dense or
        nonzero-iterating; both return [K, F, 3, B] (reduced by `xch`)."""
        touched[0] += N
        touched[1] += nnz if sparse else 0
        if sparse:
            return hist_sparse_multileaf(
                bins, lid_, gh8, sl_, num_columns_padded=F,
                num_bins_padded=B, input_dtype=input_dtype, exchange=xch)
        return hist_multileaf_masked(bins, lid_, gh8, sl_,
                                     num_bins_padded=B,
                                     input_dtype=input_dtype, rows=rows,
                                     exchange=xch)

    # ---- root --------------------------------------------------------------
    gh8 = torch.stack([grad * row_mask, hess * row_mask, row_mask])
    lid0 = torch.zeros(N, dtype=torch.int32, device=dev)
    root_x = exchange
    if hx:
        root_x = HistExchange(exchange.mesh, scatter=False)
    hist0 = hist_masked(lid0, torch.zeros(1, dtype=torch.int32, device=dev),
                        root_x)[0]                            # [F, 3, B]
    # summed in f64, so the card's root totals are the CPU's
    root_sums = hist0[0].to(torch.float64).sum(dim=-1).to(torch.float32)
    if hx:
        hist0 = hist0[off:off + Fs].contiguous()              # [Fs, 3, B]

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
            touched[0] += int(total)
            if sparse:
                return hist_sparse_gathered(
                    bins, gh8, perm, leaf_off[slots], leaf_cnt[slots],
                    capacity=cap, num_columns_padded=F, num_bins_padded=B,
                    input_dtype=input_dtype, exchange=exchange)
            return hist_multileaf_gathered(
                bins, gh8, perm, leaf_off[slots], leaf_cnt[slots],
                capacity=cap, num_bins_padded=B, input_dtype=input_dtype,
                rows=rows, exchange=exchange)
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
            # fill_, not `t[L] = 0`: a Python number assigned into a
            # CUDA tensor is a blocking host-to-device copy
            leaf_off2[L].fill_(0)
            leaf_cnt2[L].fill_(0)

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
        # the round's one read: the split count and the pass totals
        with explicit_transfer():
            # torchlint: allow(host-sync) — counted in last_host_syncs
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
        leaf_side.index_fill_(0, plm.long(), 0)
        leaf_side.index_fill_(0, newm.long(), 1)

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
        num_leaves=torch.full((), n_leaves, dtype=torch.int32, device=dev))
    profiling.count(profiling.HIST_ROWS_TOUCHED, touched[0])
    if exchange is not None:
        exchange.mesh.record_tree_exchange(xbytes0)
    if sparse:
        profiling.count(profiling.SPARSE_NNZ_TOUCHED, touched[1])
    return arrs, leaf_id, syncs


class RoundsTreeLearner:
    """Batched-rounds learner on one device, or data-parallel over a
    mesh (sharded/mesh.py): rows shard over every mesh axis of size > 1
    (`tree_learner=data`: (W, 1); `data2d`: both axes), each rank holding
    its row block of the store, and every histogram pass is exchanged by
    psum or psum_scatter (`hist_exchange`).  Over a pre-partitioned
    dataset (`Dataset.rank_rows`) the rank's rows are its block
    (`RankRows`; the data axis only) and the leaf ids stay local."""

    full_leaf_id = True   # leaf_id valid for out-of-bag rows too

    def __init__(self, dataset: Dataset, config: Config,
                 mesh: Optional[Mesh] = None):
        self.dataset = dataset
        self.config = config
        self.mesh = mesh
        self.tree_name = "rounds/tree"   # the divergence check's label
        self.device = torch.device(config.device_type)
        self.N = dataset.num_data
        self.F = dataset.num_features                  # original features
        self.C = dataset.num_store_columns             # store columns
        self.B = padded_bin_count(dataset.max_num_bin)
        cfg = config
        dd, df = mesh.shape if mesh is not None else (1, 1)
        nsh = dd * df
        # a pre-partitioned dataset holds only this rank's rows: they are
        # its block, padded to the longest rank's count
        self.rank_rows = (RankRows(mesh, self.N) if mesh is not None
                          and dataset.rank_rows is not None else None)
        if self.rank_rows is not None:
            self._block = (0, self.N, self.rank_rows.per_proc)
            self._row_blk = 0
        else:
            # the row block this rank holds: rows [r0, r1) of the N,
            # padded to Nloc = ceil(N / nsh) (the JAX learner's
            # Np = nsh * Nloc)
            self._block = row_block(self.N, nsh, mesh.rank if mesh else 0)
            self._row_blk = mesh.rank if mesh else 0
        if dataset.sparse is not None and self.rank_rows is not None:
            # as the JAX learner does for its multi-process worlds
            log.warning("sparse store is not wired for multi-host runs "
                        "yet; materializing the dense store")
        self.sparse = dataset.sparse is not None and self.rank_rows is None
        self.hist_exchange = "psum"
        self.exchange = None
        Fpad = self.C
        if mesh is not None:
            K_pass = min(LEAVES_PER_BATCH, int(cfg.num_leaves))
            self.hist_exchange = resolve_hist_exchange(
                cfg, ndev=nsh, payload_bytes=4.0 * K_pass * self.C * 3
                * self.B)
            hx = self.hist_exchange == "psum_scatter"
            if hx:
                # the histogram's column axis tiles the scatter axis (the
                # feature axis on a 2-D mesh); the dense int8 store keeps
                # its 32-column group
                Fpad = pad_cols_to_ndev(
                    self.C, df if df > 1 else dd,
                    align=32 if (not self.sparse
                                 and dataset.max_num_bin <= 256) else 1)
            self.exchange = HistExchange(mesh, scatter=hx)
        self.Fpad = Fpad
        self._nnz = dataset.sparse.nnz if self.sparse else 0
        if self.sparse:
            # the ELL triple as built: on one device no column is padded,
            # so the empty-slot sentinel is the column count and no
            # zero_bin is -1.  A mesh rank holds its row block, the
            # sentinel moved past the padded columns (zero_bin -1 there)
            # and the padding rows empty.  On CUDA the histogram kernels
            # read the entries sorted by column, built here once per
            # learner (per rank, over its block)
            if mesh is None:
                self.bins_dev = dataset.sparse_triple(self.device)
            else:
                self.bins_dev = self._rank_sparse_block(dataset, Fpad)
                self._nnz = int((self.bins_dev[0] < Fpad).sum())
            if self.device.type == "cuda":
                self.bins_dev += (build_sparse_streams(
                    self.bins_dev[0], self.bins_dev[1], Fpad),)
            self.rows = None
            bins_itemsize = 4
        elif mesh is None:
            # the partition kernel K4 reads one bin of a row's split
            # column from the [F, N] store; kernels K1 and K2 read a
            # row's bins from its row-major byte copy
            self.bins_dev, self.rows = dense_store_feed(
                dataset, self.device, "rounds_feed")
            bins_itemsize = self.bins_dev.element_size()
        else:
            # this rank's row block, the padded columns and rows at bin 0
            # (padding rows carry a zero mask, padded columns one bin)
            block = rank_block(dataset.dense_bins(site="rounds_feed"),
                               Fpad, 0, self._block[2], self._row_blk,
                               self.N)
            self.bins_dev, self.rows = store_feed(
                block, dataset.max_num_bin, self.device)
            bins_itemsize = self.bins_dev.element_size()
        self._walk = None
        nbv = dataset.num_bins.astype(np.int64)
        icv = np.asarray(dataset.is_categorical, bool)
        self._base_fmask = np.ones(self.F, bool)
        ft = dataset.bundle_feat_table()
        if ft is None and Fpad > self.F:
            # unbundled: the split metadata mirrors the padded columns
            fp = Fpad - self.F
            nbv = np.pad(nbv, (0, fp), constant_values=1)
            icv = np.pad(icv, (0, fp))
            self._base_fmask = np.pad(self._base_fmask, (0, fp))
        self.num_bins_dev = torch.as_tensor(nbv, device=self.device)
        self.is_cat_dev = torch.as_tensor(icv, device=self.device)
        # bundled: histograms unbundle to the original features before
        # split search.  The gather tables' zero sentinel sits past the
        # (padded) store columns, the columns of every histogram here
        self.ftbl = (None if ft is None
                     else torch.as_tensor(ft, device=self.device))
        unb = dataset.unbundle_tables(self.B, Fpad)
        self.unb = (None if unb is None else
                    (torch.as_tensor(unb[0], device=self.device),
                     torch.as_tensor(unb[1], device=self.device)))
        self._fmask_dev = torch.as_tensor(self._base_fmask,
                                          device=self.device)
        self._row_mask_dev = torch.ones(self.N, dtype=torch.float32,
                                        device=self.device)
        self.split_kw = make_split_kw(cfg)
        self._feat_rng = np.random.RandomState(cfg.feature_fraction_seed)
        # under psum_scatter each rank caches only its column slices
        cache_cols = (Fpad // self.exchange.slices
                      if self.exchange is not None else Fpad)
        self.cache_parent_hist = use_parent_hist_cache(cfg, cache_cols,
                                                       self.B, self.device)
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
            # the gathered scratch is per rank, sized from its block
            self.hist_rows = resolve_hist_rows(
                cfg, device=self.device, num_columns=Fpad,
                np_rows=max(1, self._block[2]), bins_itemsize=bins_itemsize)
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
                        nnz=self._nnz,
                        input_dtype=getattr(cfg, "histogram_dtype",
                                            "float32"),
                        exchange=self.exchange)

    def _rank_sparse_block(self, dataset: Dataset, Fpad: int):
        """(cols, bins, zero_bin) tensors of this rank's row block of the
        ELL store: the empty-slot sentinel at Fpad (past any padded
        column), zero_bin -1 on the padded columns, the padding rows
        empty."""
        sp = dataset.sparse
        r0, r1, nloc = self._block
        cols = np.full((nloc, sp.cols.shape[1]), Fpad, np.int32)
        ell = np.zeros((nloc, sp.cols.shape[1]), np.int32)
        c = sp.cols[r0:r1]
        cols[:r1 - r0] = np.where(c >= self.C, Fpad, c)
        ell[:r1 - r0] = sp.bins[r0:r1]
        zb = np.full(Fpad, -1, np.int32)
        zb[:self.C] = sp.zero_bin
        dev = self.device
        return (torch.as_tensor(cols, device=dev),
                torch.as_tensor(ell, device=dev),
                torch.as_tensor(zb, device=dev))

    @property
    def walk_bins(self):
        """The store a tree walks over the training rows (DART's drops,
        rollback, the replay of a resumed or continued model): the [F, N]
        store the partition reads (int8 bytes holding value - 128 up to
        256 bins, int32 past that), or the sparse ELL triple; no copy.
        A mesh rank holds only its row block, so its walk store (the
        dataset's rows: every row under the replicated boosting loop,
        the rank's own in a pre-partitioned world) is made on the first
        walk."""
        if self.mesh is None:
            return self.bins_dev[:3] if self.sparse else self.bins_dev
        if self._walk is None:
            self._walk = (self.dataset.sparse_triple(self.device)
                          if self.sparse else
                          dense_store_feed(self.dataset, self.device,
                                           "rounds_feed")[0])
        return self._walk

    def _feature_mask(self) -> torch.Tensor:
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return self._fmask_dev
        k = max(1, int(round(self.F * frac)))
        sel = self._feat_rng.choice(self.F, size=k, replace=False)
        m = np.zeros(len(self._base_fmask), bool)
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
        """Grow one tree: (device TreeArrays, leaf_id [N] int32).  On a
        mesh the rank grows the tree over its row block: under the
        replicated boosting loop grad/hess are every row's, and the
        blocks' leaf ids are all_gathered; in a pre-partitioned world
        they are the rank's rows, and so are the leaf ids."""
        mask = self._row_mask(bag_idx)
        fmask = self._feature_mask()
        if self.mesh is not None:
            r0, r1, nloc = self._block
            grad, hess, mask = (take_rows(x, r0, r1, nloc)
                                for x in (grad, hess, mask))
        arrs, leaf_id, syncs = build_tree_rounds(
            self.bins_dev, grad, hess, mask, self.num_bins_dev,
            self.is_cat_dev, fmask, **self._kw)
        if self.mesh is not None:
            # rank_rows is set on every rank of a pre-partitioned world
            # torchlint: allow(divergent-collective) — and on none otherwise
            if self.rank_rows is None:
                leaf_id = self.mesh.all_gather(
                    leaf_id, row_shard_axes(*self.mesh.shape)).reshape(-1)
            leaf_id = leaf_id[:self.N]
        self.last_host_syncs = syncs
        return arrs, leaf_id

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag_idx: Optional[torch.Tensor] = None
              ) -> Tuple[Tree, torch.Tensor]:
        arrs, leaf_id = self.train_device(grad, hess, bag_idx)
        tree = tree_arrays_to_host(arrs, self.dataset, self.config.num_leaves,
                                   mesh=self.mesh, name=self.tree_name)
        self.last_host_syncs += 1
        return tree, leaf_id
