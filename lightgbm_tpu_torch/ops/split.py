"""Vectorized best-split search over histograms.

Port of lightgbm_tpu/ops/split.py: `leaf_split_gain`, `leaf_output`,
`split_gain_matrix`, `best_split`, the Exclusive Feature Bundling
helpers `identity_feat_table`, `bundle_predicate_params`,
`store_go_left`, `unbundle_hist` and `maybe_unbundle`, which translate
between original features (split search, trees) and bundled store
columns (histograms, partition), and the psum_scatter exchange's split
search over one rank's column slice (`unbundle_hist_local`,
`sharded_slice_search`, `combine_sharded_records`).
The f32 operation order follows JAX.  `best_split` on a CUDA tensor
launches the hand-written kernel csrc/split.cu (one launch a call, the
learners' can-split gate fused when asked); a CPU tensor takes the plain
torch version.  `split_children` searches both children of k splits in
one launch and writes their records straight into the learner's
per-leaf table.

Every function takes leading batch dimensions on the histogram (the JAX
learner vmaps one leaf at a time): hist [..., F, 3, B] with per-leaf
sums [...]; the per-feature metadata (num_bins, is_cat, the feature
mask) is [F], or carries the same leading dimensions where each leaf
searches its own feature subset (the voting learner).  Tie-break: the flat argmax over [F, B] picks the smallest
feature, then the smallest threshold (torch.argmax returns the first
maximum); invalid cells hold -inf, never NaN.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import kernels

K_MIN_SCORE = -math.inf

# packed record layout (lightgbm_tpu SplitResult.packed): gain, feature,
# threshold bin, left (grad, hess, count), right (grad, hess, count),
# left output, right output
RECORD_LEN = 11


def leaf_split_gain(G, H, l1: float, l2: float):
    reg = torch.clamp(torch.abs(G) - l1, min=0.0)
    return reg * reg / (H + l2)


def leaf_output(G, H, l1: float, l2: float):
    reg = torch.clamp(torch.abs(G) - l1, min=0.0)
    return -torch.sign(G) * reg / (H + l2)


def split_gain_matrix(hist: torch.Tensor, num_bins: torch.Tensor,
                      is_cat: torch.Tensor, feature_mask: torch.Tensor,
                      sum_grad: torch.Tensor, sum_hess: torch.Tensor,
                      num_data: torch.Tensor, *, lambda_l1: float = 0.0,
                      lambda_l2: float = 0.0, min_data_in_leaf: int = 20,
                      min_sum_hessian_in_leaf: float = 1e-3,
                      min_gain_to_split: float = 0.0):
    """[..., F, B] total gain per candidate threshold (-inf where
    invalid), plus the (GL, HL, CL) cumulatives."""
    F, B = hist.shape[-3], hist.shape[-1]
    l1, l2 = lambda_l1, lambda_l2
    g, h, c = hist[..., 0, :], hist[..., 1, :], hist[..., 2, :]
    sg = sum_grad[..., None, None]
    sh = sum_hess[..., None, None]
    nd = num_data[..., None, None]
    bin_idx = torch.arange(B, device=hist.device)[None, :]
    nb = num_bins.to(torch.int64)[..., None]
    cat = is_cat[..., None]

    # gradient and hessian sums accumulated in f64 on every device:
    # torch's CPU cumsum of f32 already adds in f64, its CUDA one in f32
    # in a tree, so the card's sums (and its near-tied gains) are the
    # CPU's.  Counts are whole numbers, exact in f32 in any order
    cum = torch.cumsum(hist[..., :2, :].to(torch.float64),
                       dim=-1).to(hist.dtype)
    GL = torch.where(cat, g, cum[..., 0, :])
    HL = torch.where(cat, h, cum[..., 1, :])
    CL = torch.where(cat, c, torch.cumsum(c, dim=-1))
    GR = sg - GL
    HR = sh - HL
    CR = nd - CL

    t_valid = torch.where(cat, bin_idx < nb, bin_idx < nb - 1)
    valid = (t_valid & feature_mask[..., None]
             & (CL >= min_data_in_leaf) & (CR >= min_data_in_leaf)
             & (HL >= min_sum_hessian_in_leaf)
             & (HR >= min_sum_hessian_in_leaf))

    gain_shift = leaf_split_gain(sg, sh, l1, l2)
    min_gain_shift = gain_shift + min_gain_to_split
    total = leaf_split_gain(GL, HL, l1, l2) + leaf_split_gain(GR, HR, l1, l2)
    total = torch.where(valid & (total > min_gain_shift), total,
                        torch.full_like(total, K_MIN_SCORE))
    return total, GL, HL, CL


def _best_split_plain(hist, num_bins, is_cat, feature_mask, sum_grad,
                      sum_hess, num_data, *, lambda_l1=0.0, lambda_l2=0.0,
                      min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3,
                      min_gain_to_split=0.0, can_split=None):
    F, B = hist.shape[-3], hist.shape[-1]
    l1, l2 = lambda_l1, lambda_l2
    total, GL, HL, CL = split_gain_matrix(
        hist, num_bins, is_cat, feature_mask, sum_grad, sum_hess, num_data,
        lambda_l1=l1, lambda_l2=l2, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
        min_gain_to_split=min_gain_to_split)
    gain_shift = leaf_split_gain(sum_grad, sum_hess, l1, l2)
    lead = total.shape[:-2]
    flat = total.reshape(lead + (F * B,))
    best = torch.argmax(flat, dim=-1, keepdim=True)
    bg = flat.gather(-1, best)[..., 0]
    glb = GL.reshape(lead + (F * B,)).gather(-1, best)[..., 0]
    hlb = HL.reshape(lead + (F * B,)).gather(-1, best)[..., 0]
    clb = CL.reshape(lead + (F * B,)).gather(-1, best)[..., 0]
    grb, hrb, crb = sum_grad - glb, sum_hess - hlb, num_data - clb
    best = best[..., 0]
    gain = torch.where(torch.isfinite(bg), bg - gain_shift,
                       torch.full_like(bg, K_MIN_SCORE))
    if can_split is not None:
        # the learners' can-split gate (serial_tree_learner.cpp
        # _can_split; the depth gate applies at leaf selection)
        can = ((num_data >= 2 * can_split[0])
               & (sum_hess >= 2 * can_split[1]))
        gain = torch.where(can & torch.isfinite(gain) & (gain > 0), gain,
                           torch.full_like(gain, K_MIN_SCORE))
    return torch.stack([
        gain, (best // B).to(torch.float32), (best % B).to(torch.float32),
        glb, hlb, clb, grb, hrb, crb,
        leaf_output(glb, hlb, l1, l2), leaf_output(grb, hrb, l1, l2)],
        dim=-1)


def _meta(x, dtype, k, F, name):
    """A per-feature metadata tensor as the kernel reads it, with its
    leaf stride: [F] (0) or one row a leaf (F)."""
    if x.dtype != dtype:
        x = x.to(dtype)
    x = x.contiguous()
    if x.numel() == F:
        return x, 0
    if x.numel() == k * F:
        return x, F
    raise ValueError(f"split search: {name} is neither [F] nor [k, F]")


# shared memory of a block's feature tile (csrc/split.cu kSmemBudget: two
# blocks an SM) and the features a tile holds at most (one scan thread a
# feature and channel of a 256-thread block)
SPLIT_SMEM_BUDGET = 96 * 1024
_SPLIT_TILE_FEATURES = 256 // 3


def split_tile(F: int, B: int) -> Tuple[int, int, int]:
    """(features, bins, tiles) of csrc/split.cu's feature tile: a bin tile
    of whole warps up to 256 bins (longer rows are scanned in turns); as
    many features of three padded rows as fit the budget, spread evenly
    over the tiles.  Each tile of a leaf is a block of its own."""
    bt = min(-(-B // 32) * 32, 256)
    most = min(SPLIT_SMEM_BUDGET // (12 * (bt + 1)), _SPLIT_TILE_FEATURES, F)
    ft = -(-F // -(-F // most))
    return ft, bt, -(-F // ft)


def _split_search_cuda(hists, sums, num_bins, is_cat, feature_mask, out,
                       dest, *, lambda_l1=0.0, lambda_l2=0.0,
                       min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3,
                       min_gain_to_split=0.0, can_split=None):
    """One launch of csrc/split.cu over one or two sides of k leaves.

    hists: one or two [k, F, 3, B] float32 histograms; sums: for each, a
    [k, 3] (grad, hess, count) table; out: float32 records with rows of
    11; dest: None (side s of leaf i to row s * k + i) or (sel, rows_a,
    rows_b) as split_children takes them."""
    h0 = hists[0]
    k, F, B = h0.shape[0], h0.shape[1], h0.shape[3]
    for h in hists:
        if h.dtype != torch.float32 or h.dim() != 4 or h.shape[2] != 3:
            raise TypeError("split kernel takes float32 [k, F, 3, B] "
                            "histograms")
        if h.shape != h0.shape:
            raise ValueError("split kernel: both sides take one shape")
    if out.dtype != torch.float32 or not out.is_contiguous() \
            or out.shape[-1] != RECORD_LEN:
        raise TypeError("split kernel writes contiguous float32 records")
    if any(s.shape != (k, 3) for s in sums):
        raise ValueError("split search takes one (grad, hess, count) a leaf")
    hs = [h.contiguous() for h in hists]
    ss = [s.to(torch.float32).contiguous() for s in sums]
    nb, nbs = _meta(num_bins, torch.int64, k, F, "num_bins")
    ic, ics = _meta(is_cat, torch.bool, k, F, "is_cat")
    fm, fms = _meta(feature_mask, torch.bool, k, F, "feature_mask")
    sel = ra = rb = None
    if dest is not None:
        sel, ra, rb = dest
        sel = sel.to(torch.bool).contiguous()
        ra = ra.to(torch.int64).contiguous()
        rb = rb.to(torch.int64).contiguous()
    ft, bt, tiles = split_tile(F, B)
    part = tickets = None
    if tiles > 1:
        part, tickets = kernels.combine_buffers(
            h0.device, len(hs) * k * tiles * 8, len(hs) * k)
    gate = can_split is not None
    kernels.call("split_search", hs[0].data_ptr(),
                 hs[1].data_ptr() if len(hs) > 1 else None,
                 ss[0].data_ptr(), ss[1].data_ptr() if len(ss) > 1 else None,
                 nb.data_ptr(), nbs, ic.data_ptr(), ics, fm.data_ptr(), fms,
                 k, F, B, ft, bt, float(lambda_l1), float(lambda_l2),
                 float(min_data_in_leaf), float(min_sum_hessian_in_leaf),
                 float(min_gain_to_split), int(gate),
                 float(2 * can_split[0]) if gate else 0.0,
                 float(2 * can_split[1]) if gate else 0.0,
                 kernels.ptr(sel), kernels.ptr(ra), kernels.ptr(rb),
                 out.data_ptr(), kernels.ptr(part), kernels.ptr(tickets))
    kernels.LAUNCHES["split_search"] += 1


def best_split(hist: torch.Tensor, num_bins: torch.Tensor,
               is_cat: torch.Tensor, feature_mask: torch.Tensor,
               sum_grad: torch.Tensor, sum_hess: torch.Tensor,
               num_data: torch.Tensor, *, lambda_l1: float = 0.0,
               lambda_l2: float = 0.0, min_data_in_leaf: int = 20,
               min_sum_hessian_in_leaf: float = 1e-3,
               min_gain_to_split: float = 0.0,
               can_split: Optional[Tuple[int, float]] = None
               ) -> torch.Tensor:
    """Best split of each leaf from its histogram hist [..., F, 3, B].
    Returns the packed records [..., 11] f32 (see RECORD_LEN).

    can_split=(min_data_in_leaf, min_sum_hessian_in_leaf) applies the
    learners' can-split gate: a leaf with fewer than twice either
    keeps -inf, and so does a gain that is not finite and > 0.  A CUDA
    tensor launches csrc/split.cu once; a CPU tensor takes the plain
    version."""
    kw = dict(lambda_l1=lambda_l1, lambda_l2=lambda_l2,
              min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
              min_gain_to_split=min_gain_to_split, can_split=can_split)
    if not hist.is_cuda:
        return _best_split_plain(hist, num_bins, is_cat, feature_mask,
                                 sum_grad, sum_hess, num_data, **kw)
    F, B = hist.shape[-3], hist.shape[-1]
    lead = tuple(hist.shape[:-3])
    k = math.prod(lead)
    out = torch.empty(lead + (RECORD_LEN,), dtype=torch.float32,
                      device=hist.device)
    if k == 0:
        return out
    sums = torch.stack([v.reshape(k).to(torch.float32)
                        for v in (sum_grad, sum_hess, num_data)], dim=-1)
    _split_search_cuda((hist.reshape(k, F, 3, B),), (sums,), num_bins,
                       is_cat, feature_mask, out, None, **kw)
    return out


def split_children(out: torch.Tensor, sel: torch.Tensor,
                   rows_a: torch.Tensor, rows_b: torch.Tensor,
                   hist_a: torch.Tensor, sums_a: torch.Tensor,
                   hist_b: torch.Tensor, sums_b: torch.Tensor,
                   num_bins: torch.Tensor, is_cat: torch.Tensor,
                   feature_mask: torch.Tensor, **kw) -> None:
    """The best splits of both children of k splits, written into the
    per-leaf record table `out` [L, 11].

    hist_a/hist_b [k, F, 3, B] and sums_a/sums_b [k, 3] (grad, hess,
    count) are the two children of each split (the rounds learner's
    smaller and larger); where sel[i] a's record goes to
    out[rows_a[i]] and b's to out[rows_b[i]], else the other way
    round.  kw as for best_split.  A CUDA tensor searches both sides in
    one launch of csrc/split.cu that writes the rows itself; a CPU
    tensor takes two best_split calls and two row writes."""
    k = hist_a.shape[0]
    if k == 0:
        return
    if not hist_a.is_cuda:
        rec_a = best_split(hist_a, num_bins, is_cat, feature_mask,
                           sums_a[:, 0], sums_a[:, 1], sums_a[:, 2], **kw)
        rec_b = best_split(hist_b, num_bins, is_cat, feature_mask,
                           sums_b[:, 0], sums_b[:, 1], sums_b[:, 2], **kw)
        write_children(out, sel, rows_a, rows_b, rec_a, rec_b)
        return
    _split_search_cuda((hist_a, hist_b), (sums_a, sums_b), num_bins, is_cat,
                       feature_mask, out, (sel, rows_a, rows_b), **kw)


def write_children(out, sel, rows_a, rows_b, rec_a, rec_b) -> None:
    """out[rows_a] and out[rows_b] take the records rec_a and rec_b,
    swapped where sel is false (split_children's destinations)."""
    out[rows_a] = torch.where(sel[:, None], rec_a, rec_b)
    out[rows_b] = torch.where(sel[:, None], rec_b, rec_a)


def identity_feat_table(num_bins) -> torch.Tensor:
    """[5, F] feature table of an unbundled store: every feature is its
    own column and unpacked, so bundle_predicate_params reduces to the
    plain (feature, threshold) predicate."""
    nb = torch.as_tensor(num_bins)
    F = nb.shape[0]
    z = torch.zeros(F, dtype=torch.float32, device=nb.device)
    return torch.stack([torch.arange(F, dtype=torch.float32,
                                     device=nb.device), z, z,
                        nb.to(torch.float32), z])


def bundle_predicate_params(feat_tbl, feat: torch.Tensor, thr: torch.Tensor,
                            is_cat: torch.Tensor):
    """Translate ORIGINAL-space splits (feature, threshold bin, is-cat)
    into STORE-space go-left parameters (col, T, lo, hi1, dl):

        in_range = lo <= store_bin <= hi1
        go_left  = in_range ? (is_cat ? store_bin == T : store_bin <= T)
                            : dl

    feat_tbl: [5, F] f32 rows (col, offset, default, nslots, packed) —
    Dataset.bundle_feat_table() or identity_feat_table() — or None for
    an unbundled store (the column is the feature, the threshold is
    unchanged, the window is [0, 2^30)).  feat/thr/is_cat are tensors of
    one shape, on feat_tbl's device; feature ids outside the table (the
    -inf records of leaves that never split) are clamped, and their
    parameters are never used.

    Slot packing keeps bin order with the default bin removed, so a
    numerical `orig_bin <= thr` is the slot interval [offset, offset +
    thr - (thr >= default)]; rows outside the feature's slots sit at its
    default bin, which goes left iff default <= thr (numerical) or
    default == thr (categorical).  A categorical split on the default
    bin takes T = offset - 1, which matches no slot, and dl sends the
    default rows left."""
    thr = thr.to(torch.int32)
    if feat_tbl is None:
        feat = feat.to(torch.int32)
        return (feat, thr, torch.zeros_like(feat),
                torch.full_like(feat, 1 << 30),
                torch.zeros_like(feat, dtype=torch.bool))
    fi = feat.to(torch.int64).clamp(0, feat_tbl.shape[1] - 1)
    r = feat_tbl[:, fi]
    col = r[0].to(torch.int32)
    off = r[1].to(torch.int32)
    d = r[2].to(torch.int32)
    ns = r[3].to(torch.int32)
    pk = r[4] > 0
    t_num = off + thr - (thr >= d).to(torch.int32)
    t_cat = torch.where(thr == d, off - 1,
                        off + thr - (thr > d).to(torch.int32))
    T = torch.where(pk, torch.where(is_cat, t_cat, t_num), thr)
    lo = torch.where(pk, off, torch.zeros_like(off))
    hi1 = torch.where(pk, off + ns - 1, torch.full_like(off, 1 << 30))
    dl = pk & torch.where(is_cat, thr == d, d <= thr)
    return col, T, lo, hi1, dl


def store_go_left(store_bin, T, lo, hi1, dl, is_cat):
    """The store-space predicate of bundle_predicate_params on a vector
    of store bins; the parameters are tensors, or Python scalars (one
    split, as the exact learner evaluates it)."""
    in_r = (store_bin >= lo) & (store_bin <= hi1)
    if isinstance(is_cat, torch.Tensor):
        gl = torch.where(is_cat, store_bin == T, store_bin <= T)
    else:
        gl = store_bin == T if is_cat else store_bin <= T
    if isinstance(dl, torch.Tensor):
        return torch.where(in_r, gl, dl)
    return (gl | ~in_r) if dl else (gl & in_r)


def unbundle_hist(hist: torch.Tensor, src: torch.Tensor, dmask: torch.Tensor,
                  totals: torch.Tensor) -> torch.Tensor:
    """Bundled histograms [..., C, 3, B] -> original-feature histograms
    [..., F, 3, B'].

    src/dmask come from Dataset.unbundle_tables: `src[f, b]` is a flat
    index into the [C*B] store histogram (C*B, one past the end, is a
    zero sentinel for out-of-range bins and the default slot), and
    `dmask` marks each packed feature's default bin, rebuilt as the
    leaf's totals minus the feature's other bins — exact under zero
    conflicts up to the f32 order of that sum.  totals [..., 3] are each
    leaf's (sum_grad, sum_hess, count)."""
    C, B = hist.shape[-3], hist.shape[-1]
    lead = hist.shape[:-3]
    flat = hist.transpose(-1, -2).reshape(lead + (C * B, 3))
    flat = torch.cat([flat, torch.zeros(lead + (1, 3), dtype=flat.dtype,
                                        device=flat.device)], dim=-2)
    F, Bo = src.shape
    g = flat[..., src.reshape(-1).long(), :].reshape(lead + (F, Bo, 3))
    g = g.transpose(-1, -2)                               # [..., F, 3, Bo]
    fill = totals[..., None, :, None] - g.sum(dim=-1, keepdim=True)
    return torch.where(dmask[:, None, :], fill, g)


def maybe_unbundle(hist: torch.Tensor, unb, totals) -> torch.Tensor:
    """unb is None (the store is the original layout) or (src, dmask)."""
    if unb is None:
        return hist
    return unbundle_hist(hist, unb[0], unb[1], totals)


def unbundle_hist_local(hist: torch.Tensor, src: torch.Tensor,
                        dmask: torch.Tensor, totals: torch.Tensor,
                        col_start: int):
    """Per-rank unbundle for the psum_scatter exchange: `hist`
    [..., Cs, 3, B] is a store-column SLICE holding global columns
    [col_start, col_start + Cs) of a reduce-scattered histogram;
    src/dmask are the GLOBAL tables of Dataset.unbundle_tables (flat
    indices into [C*B], sentinel C*B with C the padded column count, so
    the sentinel lies outside every slice's range).

    Returns ([..., F, 3, B'] histograms, owned [F] bool).  An original
    feature lives entirely in ONE store column, so it is exact on the
    rank owning that column and garbage elsewhere (its default-bin fill
    rebuilds from zero sums); the split search ANDs `owned` into its
    feature mask so only the owning rank's record for each feature
    survives the cross-rank combine."""
    Cs, B = hist.shape[-3], hist.shape[-1]
    src = src.long()
    lo = int(col_start) * B
    in_range = (src >= lo) & (src < lo + Cs * B)
    owned = in_range.any(dim=1)
    src_l = torch.where(in_range, src - lo, torch.full_like(src, Cs * B))
    return unbundle_hist(hist, src_l, dmask, totals), owned


def sharded_slice_search(h: torch.Tensor, sums: torch.Tensor, *, off: int,
                         nb_s, ic_s, fm_s, num_bins, is_cat, fmask, unb,
                         skw: dict) -> torch.Tensor:
    """Per-rank best splits of k leaves from their reduce-scattered
    store-column slices (the psum_scatter exchange of learner/rounds.py
    and learner/fused.py, shared so the two learners cannot diverge).

    h [k, Cs, 3, B] this rank's reduced column slices, sums [k, 3];
    `off` the rank's first global column.  Identity store (unb None):
    nb_s/ic_s/fm_s are the rank's metadata slices and each record's
    feature id gets `off` folded back in.  Bundled store: the slice is
    unbundled to the full original-feature layout with the features
    this rank does not own masked out of the search.  Returns packed
    [k, 11] records in ORIGINAL feature space; combine them across the
    ranks with `combine_sharded_records`."""
    if unb is None:
        rec = best_split(h, nb_s, ic_s, fm_s, sums[..., 0], sums[..., 1],
                         sums[..., 2], **skw)
        rec[..., 1] += float(off)
        return rec
    hF, owned = unbundle_hist_local(h, unb[0], unb[1], sums, off)
    return best_split(hF, num_bins, is_cat, fmask & owned, sums[..., 0],
                      sums[..., 1], sums[..., 2], **skw)


def combine_sharded_records(recs: torch.Tensor, mesh,
                            axis: str) -> torch.Tensor:
    """all_gather the ranks' packed records over `axis` and pick each
    leaf's winner: maximum gain, ties broken by the SMALLEST feature id
    (every feature is owned by exactly one rank, so this reproduces the
    full search's flat-argmax tie-break even where feature-to-rank
    ownership is not monotone in feature id, as under EFB).

    recs [..., 11] -> the same shape, the same bits on every rank of the
    axis (the gathered stack is replicated and the argmin over it
    deterministic), so it may gate replicated control flow."""
    allr = mesh.all_gather(recs, axis, kind="records")   # [nd, ..., 11]
    gains = allr[..., 0]
    mx = gains.max(dim=0, keepdim=True).values
    cand = torch.where(gains == mx, allr[..., 1],
                       torch.full_like(gains, math.inf))
    best = torch.argmin(cand, dim=0)                 # first minimum
    idx = best[None, ..., None].expand((1,) + tuple(recs.shape))
    return allr.gather(0, idx)[0]
