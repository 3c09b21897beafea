"""The fused single-split tree builder, device tree arrays and the
tree-learner factory.

Port of lightgbm_tpu/learner/fused.py: `TreeArrays`, `build_tree`,
`pack_tree_arrays` / `unpack_tree_arrays` / `tree_arrays_to_host`,
`FusedTreeLearner` and `create_tree_learner`, on one device and over a
mesh of ranks (sharded/mesh.py).

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

Over a mesh the builder runs on every rank, as the JAX builder ran in
each `shard_map` body, the reference's three network-parallel learners
in one formulation:

- rows shard over the data axis: each rank histograms its row block and
  the histograms are psummed (data-parallel), or reduce-scattered over
  the column axis, each rank searching its column slice and the records
  all_gathered and combined (`hist_exchange=psum_scatter`);
- features shard over the feature axis (`tree_learner=feature`): each
  rank holds a column block of every row, searches it, and the records
  are all_gathered and the first best taken; the owner of a split's
  column decides each row's side, psummed over the axis;
- voting (PV-Tree, `tree_learner=voting`): the histograms stay local,
  each rank votes its top_k features by a relaxed local search, the
  votes are all_gathered, and only the 2k most-voted features'
  histograms are psummed (or reduce-scattered) and searched.

Every rank's tree, leaf values and control flow are replicated; the leaf
ids of each rank's rows are all_gathered by the learner under the
replicated boosting loop, and stay the rank's own in a pre-partitioned
world (`Dataset.rank_rows`, sharded/mesh.py `RankRows`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset, nnz_capacity_tier
from ..diagnostics.sanitize import explicit_transfer
from ..ops.histogram import histogram_full_masked, histogram_full_sparse
from ..ops.predict import sparse_bin_lookup
from ..ops.sparse_streams import build_sparse_streams
from ..ops.split import (best_split, bundle_predicate_params,
                         combine_sharded_records, leaf_output,
                         maybe_unbundle, sharded_slice_search,
                         split_gain_matrix, store_go_left)
from ..sharded.mesh import (Mesh, check_scatter_divisible,
                            check_tree_divergence, make_mesh,
                            pad_cols_to_ndev, resolve_hist_exchange,
                            RankRows, row_block, take_rows)
from ..tree import CATEGORICAL_DECISION, NUMERICAL_DECISION, Tree
from .common import (dense_store_feed, make_split_kw, padded_bin_count,
                     rank_block, store_feed, use_parent_hist_cache)

NEG_INF = -math.inf


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


def tree_arrays_to_host(arrs, dataset: Dataset, max_leaves: int,
                        mesh=None, name: str = "tree") -> Tree:
    """Rehydrate the host Tree (real feature ids + real-valued thresholds
    via the BinMappers) from TreeArrays — device tensors (fetched in one
    transfer) or an already-unpacked numpy TreeArrays.  A mesh learner's
    tree is replicated state: under BENCH_SANITIZE the ranks' digests of
    the packed read are compared (sharded.mesh.check_tree_divergence)."""
    if isinstance(arrs.num_leaves, torch.Tensor):
        # the tree's one deliberate read: legal under the sync guard
        packed = pack_tree_arrays(arrs)
        with explicit_transfer():
            # the callers count this fetch: RoundsTreeLearner.train (+1),
            # FusedTreeLearner.train (1), GBDT._train_device_tree (+1)
            # torchlint: allow(host-sync) — counted in last_host_syncs
            vec = packed.cpu().numpy()
        a = unpack_tree_arrays(vec, max_leaves)
        check_tree_divergence(mesh, name, vec, a.leaf_count)
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
               rows=None, mesh: Optional[Mesh] = None,
               feature_shard_size: int = 0, voting_k: int = 0,
               hist_exchange: str = "psum"
               ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree on one device or one rank of a mesh, with no host
    read.

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
    mesh     : the rank's mesh, or None.  Then bins is the rank's block
               (its row block of the data axis, its column block of
               `feature_shard_size` columns of the feature axis),
               grad/hess/row_mask its rows, num_bins/is_cat/fmask its
               features' (unbundled; a bundled store has no feature
               axis), `voting_k` > 0 the PV-Tree top_k of a voting mesh,
               and `hist_exchange` "psum" or "psum_scatter" (module
               docstring)
    Returns (TreeArrays, leaf_id [N] int32), all on the store's device;
    leaf_id covers out-of-bag rows too (the rank's rows on a mesh)."""
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
    da = mesh is not None and mesh.shape[0] > 1          # rows sharded
    fa = mesh is not None and mesh.shape[1] > 1          # features sharded
    f_off = mesh.index("feature") * feature_shard_size if fa else 0
    Fg = F * mesh.shape[1] if fa else F                  # record id range
    voting = voting_k > 0 and da
    hx = hist_exchange == "psum_scatter" and da and not voting
    hx_vote = hist_exchange == "psum_scatter" and voting
    nd = mesh.shape[0] if da else 1
    if hx:
        check_scatter_divisible("store columns", C, nd)
    Fs = C // nd if hx else C

    def make_local_hist(mask):
        if sparse:
            return histogram_full_sparse(
                sp_cols, sp_bins, sp_zb, grad, hess, mask,
                num_columns_padded=C, num_bins_padded=B,
                input_dtype=input_dtype, streams=streams)
        return histogram_full_masked(bins, grad, hess, mask,
                                     num_bins_padded=B,
                                     input_dtype=input_dtype, rows=rows)

    def make_hist(mask):
        """The leaf's histogram: summed over the data axis, this rank's
        column slice of the sum under psum_scatter, or (voting) the
        rank's own, reduced later for the voted features only."""
        h = make_local_hist(mask)
        if voting or not da:
            return h
        if hx:
            return mesh.psum_scatter(h, "data", 0, kind="hist")
        return mesh.psum(h, "data", kind="hist")

    def can_gate(rec, sums):
        """The can-split gate (serial_tree_learner.cpp _can_split; the
        depth gate is applied at leaf selection)."""
        can = ((sums[:, 2] >= 2 * min_data_in_leaf)
               & (sums[:, 1] >= 2 * min_sum_hessian_in_leaf))
        g = rec[:, 0]
        rec[:, 0] = torch.where(can & torch.isfinite(g) & (g > 0), g,
                                torch.full_like(g, NEG_INF))
        return rec

    def pick_slots(idx, rec):
        """Map each record's feature field, a slot of `idx` [k, n], back
        to the feature id the slot holds."""
        slot = rec[:, 1].to(torch.int64).clamp(0, idx.shape[1] - 1)
        rec[:, 1] = idx.gather(1, slot[:, None])[:, 0].to(torch.float32)
        return rec

    def find_best(hists, sums):
        """Best split records [k, 11] of k leaves' store-space histograms
        [k, C, 3, B] (this rank's [k, Fs, 3, B] slice under psum_scatter,
        its local histograms when voting) and their GLOBAL (sum_grad,
        sum_hess, count) [k, 3], with the can-split gate."""
        if voting:
            return find_best_voting(hists, sums)
        if hx:
            off = mesh.index("data") * Fs
            if unb is None:
                nb_s, ic_s = num_bins[off:off + Fs], is_cat[off:off + Fs]
                fm_s = fmask[off:off + Fs]
                # the feature-shard base folds into the slice offset, so
                # the records carry global feature ids
                off = off + f_off
            else:
                nb_s = ic_s = fm_s = None
            rec = sharded_slice_search(
                hists, sums, off=off, nb_s=nb_s, ic_s=ic_s, fm_s=fm_s,
                num_bins=num_bins, is_cat=is_cat, fmask=fmask, unb=unb,
                skw=skw)
            rec = combine_sharded_records(rec, mesh, "data")
        else:
            rec = best_split(maybe_unbundle(hists, unb, sums), num_bins,
                             is_cat, fmask, sums[:, 0], sums[:, 1],
                             sums[:, 2], **skw)
            if fa:
                rec[:, 1] += float(f_off)
        if fa:
            # the first maximum: the smallest shard, so the smallest
            # feature id among ties (split_info.hpp:100-105)
            allp = mesh.all_gather(rec, "feature",
                                   kind="records")          # [df, k, 11]
            best = torch.argmax(allp[..., 0], dim=0)
            rec = allp.gather(0, best[None, :, None].expand(
                (1,) + tuple(rec.shape)))[0]
        return can_gate(rec, sums)

    def top_k(x, k):
        """Indices of the k largest of each row of x, ties to the lower
        index (jax.lax.top_k's order)."""
        return torch.sort(x, dim=-1, descending=True,
                          stable=True).indices[..., :k]

    def find_best_voting(hist_local, sums):
        """PV-Tree split search (voting_parallel_tree_learner.cpp:163-251):
        local per-feature bests under relaxed constraints -> local top-k
        -> the votes all_gathered -> the global top-2k features -> only
        their histograms reduced -> the exact best split of the subset."""
        k = hist_local.shape[0]
        local_sums = hist_local[:, 0].to(torch.float64).sum(dim=-1).to(
            torch.float32)                                  # [k, 3]
        relaxed = dict(skw)
        relaxed["min_data_in_leaf"] = max(1, skw["min_data_in_leaf"] // nd)
        relaxed["min_sum_hessian_in_leaf"] = (
            skw["min_sum_hessian_in_leaf"] / nd)
        gains = split_gain_matrix(
            hist_local, num_bins, is_cat, fmask, local_sums[:, 0],
            local_sums[:, 1], local_sums[:, 2], **relaxed)[0]
        per_feat = gains.max(dim=-1).values                 # [k, F]
        kv = min(voting_k, F)
        votes_l = top_k(per_feat, kv)                       # [k, kv]
        allv = mesh.all_gather(votes_l, "data")             # [nd, k, kv]
        allv = allv.permute(1, 0, 2).reshape(k, -1)
        votes = torch.zeros((k, F), dtype=torch.int32, device=dev)
        votes.scatter_add_(1, allv, torch.ones_like(allv,
                                                    dtype=torch.int32))
        k2 = min(2 * kv, F)
        sel = top_k(votes, k2)                              # [k, k2]
        if hx_vote:
            # reduce-scatter the voted subset over its slot axis, padded
            # to a data-axis multiple by repeating slot 0 (a duplicate
            # has a larger slot id, so it loses ties to its original)
            k2p = pad_cols_to_ndev(k2, nd)
            selp = (torch.cat([sel, sel[:, :1].expand(k, k2p - k2)], 1)
                    if k2p > k2 else sel)
            hs = mesh.psum_scatter(_take_features(hist_local, selp),
                                   "data", 1, kind="hist")  # [k, ks, 3, B]
            ks = k2p // nd
            base = mesh.index("data") * ks
            sel_s = selp[:, base:base + ks]
            rec = best_split(hs, num_bins[sel_s], is_cat[sel_s],
                             fmask[sel_s], sums[:, 0], sums[:, 1],
                             sums[:, 2], **skw)
            # combine on the GLOBAL slot id, so gain ties break by vote
            # rank as the psum path's flat argmax does
            rec[:, 1] += float(base)
            rec = combine_sharded_records(rec, mesh, "data")
            return can_gate(pick_slots(selp, rec), sums)
        hist_sel = mesh.psum(_take_features(hist_local, sel), "data",
                             kind="hist")
        rec = best_split(hist_sel, num_bins[sel], is_cat[sel], fmask[sel],
                         sums[:, 0], sums[:, 1], sums[:, 2], **skw)
        return can_gate(pick_slots(sel, rec), sums)

    def go_left_row(feat, thr, catf):
        """[N] bool: does each row go left under the ORIGINAL-space split
        (feat, thr)?  The store-space predicate of its column; under the
        feature axis the rank owning the column decides, and the sides
        are psummed over the axis."""
        col, T, lo, hi1, dl = bundle_predicate_params(ftbl, feat, thr, catf)
        if fa:
            lf = col.to(torch.int64) - f_off
            owned = (lf >= 0) & (lf < C)
            col = lf.clamp(0, C - 1)
        if sparse:
            featrow = sparse_bin_lookup(sp_cols, sp_bins, sp_zb,
                                        col.expand(N))
        else:
            featrow = bins.index_select(0, col.long())[0].to(torch.int32)
            if bins.dtype == torch.int8:
                featrow = featrow + 128
        gl = store_go_left(featrow, T, lo, hi1, dl, catf)
        if fa:
            gl = mesh.psum((gl & owned).to(torch.uint8), "feature") > 0
        return gl

    # ---- root ---------------------------------------------------------------
    if hx:
        # the leaf totals gate control flow, so they must be the same
        # bits on every rank: from the psummed column 0, not the slice
        h0_loc = make_local_hist(row_mask)
        col0 = mesh.psum(h0_loc[0], "data", kind="hist")
        hist0 = mesh.psum_scatter(h0_loc, "data", 0, kind="hist")
    else:
        hist0 = make_hist(row_mask)
        # voting keeps hist0 local; its totals are the global ones
        col0 = (mesh.psum(hist0[0], "data", kind="hist") if voting
                else hist0[0])
    # every row lands in exactly one bin of each store column, so column
    # 0's bin sums give the leaf totals (summed in f64, so the card's
    # totals are the CPU's)
    root_sums = col0.to(torch.float64).sum(dim=-1).to(torch.float32)
    if fa:
        # shard 0 always holds real features (padding only at the tail)
        root_sums = mesh.all_gather(root_sums, "feature")[0]
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
            torch.int64).clamp(0, Fg - 1)
        thr = torch.nan_to_num(rec[2:3], neginf=0.0).to(torch.int64)
        if fa:
            # the decision type lives with the owning shard's metadata
            lf = feat - f_off
            own = (lf >= 0) & (lf < F)
            catf = is_cat.index_select(0, lf.clamp(0, F - 1)) & own
            catf = mesh.psum(catf.to(torch.uint8), "feature") > 0
        else:
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


def _take_features(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """hist [k, F, 3, B] at the features idx [k, n] -> [k, n, 3, B]."""
    k, n = idx.shape
    return hist.gather(1, idx[:, :, None, None].expand(
        k, n, hist.shape[2], hist.shape[3]))


class FusedTreeLearner:
    """The fused single-split learner: on one device (the JAX package's
    `exact` schedule on its accelerator), `build_tree` over the whole
    store each split, one packed read a tree; or over a mesh
    (`tree_learner=data|feature|voting`, and data2d with exact growth),
    each rank holding its block of the store: its row block of the data
    axis (rows padded to a multiple of its size, with zero masks) and
    its column block of the feature axis (features padded to a multiple
    of its size, masked out of the search).

    Over an EFB-bundled store (`use_bundle`) the histograms are over
    the bundle columns and unbundled per split; feature sharding and
    voting need per-ORIGINAL-feature columns (ownership and votes are
    per feature), so they take the unbundled view of the same plan.  A
    sparse dataset feeds `build_tree` its ELL entries
    (`_assemble_sparse_feed`; a mesh rank its window of them,
    `_rank_sparse_window`), so the store never densifies."""

    def __init__(self, dataset: Dataset, config: Config,
                 mesh: Optional[Mesh] = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a sharded.mesh.Mesh (make_mesh), "
                            f"not {type(mesh).__name__}")
        self.dataset = dataset
        self.config = config
        self.mesh = mesh
        self.device = torch.device(config.device_type)
        self.full_leaf_id = True   # leaf_id valid for out-of-bag rows too
        self.tree_name = "fused/tree"   # the divergence check's label
        self.N = dataset.num_data
        self.F = dataset.num_features
        self.B = padded_bin_count(dataset.max_num_bin)
        cfg = config
        dd, df = mesh.shape if mesh is not None else (1, 1)
        self.dd, self.df = dd, df
        self._voting = (getattr(cfg, "tree_learner", "") == "voting"
                        and dd > 1)
        plan = dataset.bundle_plan
        self.use_bundle = plan is not None and df == 1 and not self._voting
        # a pre-partitioned dataset holds only this rank's rows: they are
        # its block, padded to the longest rank's count
        self.rank_rows = (RankRows(mesh, self.N) if mesh is not None
                          and dataset.rank_rows is not None else None)
        # the rank's rows feed dense, as in the JAX learner's
        # multi-process worlds (counted as a sparse fallback)
        self._sparse_feed = (dataset.sparse is not None
                             and self.rank_rows is None)
        self.Cstore = dataset.num_store_columns
        dev = self.device
        self.rows = None
        self._walk = None
        # this rank's row block of the data axis (rows [r0, r1) padded to
        # Nloc; the whole store on one device)
        if self.rank_rows is not None:
            self._block = (0, self.N, self.rank_rows.per_proc)
            self._row_blk = 0
        else:
            self._row_blk = mesh.index("data") if mesh else 0
            self._block = row_block(self.N, dd, self._row_blk)
        self.hist_exchange = "psum"
        self.Fp = self.F
        if mesh is not None:
            self._init_mesh_store(dataset, cfg)
        elif self._sparse_feed:
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
        # per-feature metadata: the original features', padded to Fp
        # (masked out), and on the feature axis this rank's Fp/df block
        fp = self.Fp - self.F
        nb = np.pad(dataset.num_bins.astype(np.int64), (0, fp),
                    constant_values=1)
        ic = np.pad(np.asarray(dataset.is_categorical, bool), (0, fp))
        self._base_fmask = np.pad(np.ones(self.F, bool), (0, fp))
        self._fsl = slice(0, self.Fp)
        if df > 1:
            fsh = self.Fp // df
            f0 = mesh.index("feature") * fsh
            self._fsl = slice(f0, f0 + fsh)
        self.num_bins_dev = torch.as_tensor(nb[self._fsl], device=dev)
        self.is_cat_dev = torch.as_tensor(ic[self._fsl], device=dev)
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
        # under psum_scatter each rank caches only its column slices
        cache_cols = self.Cstore // df
        if self._hx_pad:
            cache_cols = max(1, cache_cols // dd)
        self.cache_parent_hist = use_parent_hist_cache(cfg, cache_cols,
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
                        rows=self.rows, mesh=mesh,
                        feature_shard_size=self.Fp // df,
                        voting_k=int(cfg.top_k) if self._voting else 0,
                        hist_exchange=self.hist_exchange)

    @property
    def _hx_pad(self) -> bool:
        return (self.hist_exchange == "psum_scatter" and self.dd > 1
                and not self._voting)

    def _init_mesh_store(self, dataset: Dataset, cfg: Config) -> None:
        """This rank's block of the store: the exchange resolved from
        the per-pass payload (the voted subset under voting), the
        columns padded so the histogram's column axis tiles the data
        axis under psum_scatter, then the (column, row) block."""
        dd, df, mesh = self.dd, self.df, self.mesh
        self.Fp = int(df * math.ceil(self.F / df))
        pay_cols = (self.Cstore if self.use_bundle
                    else max(1, self.Fp // df))
        if self._voting:
            pay_cols = max(1, min(2 * int(cfg.top_k), self.F))
        self.hist_exchange = resolve_hist_exchange(
            cfg, ndev=dd, payload_bytes=4.0 * pay_cols * 3 * self.B)
        if self._hx_pad and not self.use_bundle:
            # each feature shard's Fp/df slice must itself tile the data
            # axis, so the unit is the full df*dd product
            self.Fp = pad_cols_to_ndev(self.F, df * dd)
        if self.use_bundle:
            if self._hx_pad:
                # trivial zero columns so the bundled store tiles the data
                # axis (the unbundle sentinel sits past them)
                self.Cstore = pad_cols_to_ndev(self.Cstore, dd)
            cols, cblock = self.Cstore, 0
        else:
            self.Cstore = self.Fp
            cols, cblock = self.Fp // df, mesh.index("feature")
        if self._sparse_feed:
            self.bins_dev = self._rank_sparse_window(cols, cblock)
            return
        store = (dataset.dense_bins(site="fused_feed")
                 if self.use_bundle or dataset.bundle_plan is None
                 else dataset.unbundled_bins())
        block = rank_block(store, cols, cblock, self._block[2],
                           self._row_blk, self.N)
        self.bins_dev, self.rows = store_feed(block, dataset.max_num_bin,
                                              self.device)

    def _rank_sparse_window(self, cols: int, cblock: int):
        """This rank's window of the sparse store (the JAX learner's
        `_assemble_sparse_feed` block of its shard): the entries of its
        row block and of its `cols`-column block `cblock` (the store's
        bundle columns, or the original features), front-packed a row in
        local column ids with sentinel `cols`, zero_bin -1 on padded
        columns; the padding rows empty.  On CUDA the column-sorted
        streams K8 reads come with it."""
        ds = self.dataset
        if self.use_bundle:
            ri, ci, bi, zb = ds.sparse_entries()
        else:
            ri, ci, bi, zb = ds.unbundled_sparse_entries()
        zb = np.pad(zb.astype(np.int32), (0, self.Cstore - zb.size),
                    constant_values=-1)
        r0, r1, nloc = self._block
        c0 = cblock * cols
        keep = (ri >= r0) & (ri < r1) & (ci >= c0) & (ci < c0 + cols)
        ri, ci, bi = ri[keep] - r0, ci[keep] - c0, bi[keep]
        cnt = np.bincount(ri, minlength=nloc) if ri.size else \
            np.zeros(nloc, np.int64)
        R = nnz_capacity_tier(int(cnt.max(initial=1)))
        cols_np = np.full((nloc, R), cols, np.int32)
        ell_np = np.zeros((nloc, R), np.int32)
        if ri.size:
            order = np.argsort(ri, kind="stable")
            rs = ri[order]
            offs = np.concatenate([[0], np.cumsum(cnt)])
            pos = np.arange(rs.size, dtype=np.int64) - offs[rs]
            cols_np[rs, pos] = ci[order]
            ell_np[rs, pos] = bi[order]
        dev = self.device
        feed = (torch.as_tensor(cols_np, device=dev),
                torch.as_tensor(ell_np, device=dev),
                torch.as_tensor(zb[c0:c0 + cols], device=dev))
        if dev.type == "cuda":
            feed += (build_sparse_streams(feed[0], feed[1], cols),)
        return feed

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
        [N+1, F] view is the port's [C, N] walk layout.  A mesh rank
        holds only its block, so its walk store (every column of the
        dataset's rows: every row under the replicated boosting loop,
        the rank's own in a pre-partitioned world) is made on the first
        walk."""
        if self.mesh is None:
            return self.bins_dev[:3] if self._sparse_feed else self.bins_dev
        if self._walk is None:
            self._walk = (self.dataset.sparse_triple(self.device)
                          if self._sparse_feed else
                          dense_store_feed(self.dataset, self.device,
                                           "fused_feed")[0])
        return self._walk

    walk_bins = bins_t   # the name gbdt's score replay reads of a learner

    def _feature_mask(self) -> torch.Tensor:
        frac = self.config.feature_fraction
        if frac >= 1.0:
            # no sampling: one cached device copy
            if self._fmask_dev is None:
                self._fmask_dev = torch.as_tensor(
                    self._base_fmask[self._fsl], device=self.device)
            return self._fmask_dev
        m = self._base_fmask.copy()
        k = max(1, int(round(self.F * frac)))
        sel = self._feat_rng.choice(self.F, size=k, replace=False)
        mm = np.zeros(len(m), bool)
        mm[sel] = True
        m &= mm
        # the per-tree host draw is the design (reference rng parity; the
        # same draw on every rank); its upload is deliberate
        with explicit_transfer():
            return torch.as_tensor(m[self._fsl], device=self.device)

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
        out-of-bag rows included), with one host read.  On a mesh the
        rank grows the tree over its block: under the replicated
        boosting loop grad/hess are every row's and the data axis's leaf
        ids are all_gathered; in a pre-partitioned world they are the
        rank's rows, and so are the leaf ids."""
        mask = self._row_mask(bag_idx)
        if self.mesh is not None:
            kind0 = dict(self.mesh.kind_bytes)
            r0, r1, nloc = self._block
            grad, hess, mask = (take_rows(x, r0, r1, nloc)
                                for x in (grad, hess, mask))
        arrs, leaf_id = build_tree(
            self.bins_dev, grad, hess, mask,
            self.num_bins_dev, self.is_cat_dev, self._feature_mask(),
            self.ftbl, self.unb, **self._kw)
        if self.dd > 1:
            # rank_rows is set on every rank of a pre-partitioned world
            # torchlint: allow(divergent-collective) — and on none otherwise
            if self.rank_rows is None:
                leaf_id = self.mesh.all_gather(leaf_id, "data").reshape(-1)
            leaf_id = leaf_id[:self.N]
        if self.mesh is not None:
            self.mesh.record_tree_exchange(kind0)
        tree = tree_arrays_to_host(arrs, self.dataset,
                                   self.config.num_leaves, mesh=self.mesh,
                                   name=self.tree_name)
        self.last_host_syncs = 1
        return tree, leaf_id


def resolve_tree_learner(device_type: str, tree_growth: str = "auto",
                         tree_learner: str = "serial",
                         mesh_shape: Optional[Tuple[int, int]] = None) -> str:
    """The learner a (device, tree_growth, tree_learner, mesh) choice
    runs, as the JAX factory resolves it with the CUDA device in the
    TPU's place (the port's `auto` growth is rounds on every device, the
    sparse store included):

    - voting over a mesh -> "fused" (PV-Tree needs the per-split vote
      exchange of the fused builder);
    - rounds growth, unless the mesh shards features for
      tree_learner=feature -> "rounds" (data2d runs the 2-D mesh inside
      the rounds builder);
    - any other mesh -> "fused";
    - one device: exact is "fused" on CUDA, "serial" elsewhere.

    `mesh_shape` is the (data, feature) shape, None for one device."""
    growth = "rounds" if tree_growth == "auto" else tree_growth
    if mesh_shape is not None:
        if tree_learner == "voting":
            return "fused"
        if growth == "rounds" and (mesh_shape[1] == 1
                                   or tree_learner == "data2d"):
            return "rounds"
        return "fused"
    if growth == "exact":
        return "fused" if torch.device(device_type).type == "cuda" \
            else "serial"
    return "rounds"


def create_tree_learner(dataset: Dataset, config: Config):
    """Factory (reference tree_learner.cpp:9-33): tree_learner picks the
    parallelism (serial, or data / feature / voting / data2d over the
    `torch.distributed` world's mesh), tree_growth the schedule, routed
    by `resolve_tree_learner`.  A distributed tree_learner in a world of
    one rank warns and trains on one device, as the JAX factory does
    with one visible device.  The serial learner over a sparse store
    takes the counted dense fallback, as in the JAX package; the fused
    learner reads it sparse."""
    lt = getattr(config, "tree_learner", "serial")
    mesh = None
    if lt in ("data", "feature", "voting", "data2d"):
        mesh = make_mesh(lt, int(getattr(config, "num_machines", 0) or 0))
        if mesh is None:
            import warnings
            warnings.warn(f"tree_learner={lt} requested but the "
                          "torch.distributed world has one rank; running "
                          "single-device")
    kind = resolve_tree_learner(config.device_type,
                                getattr(config, "tree_growth", "auto"), lt,
                                mesh.shape if mesh is not None else None)
    if kind == "fused":
        return FusedTreeLearner(dataset, config, mesh)
    if kind == "serial":
        from .serial import SerialTreeLearner
        return SerialTreeLearner(dataset, config)
    from .rounds import RoundsTreeLearner
    return RoundsTreeLearner(dataset, config, mesh)
