"""Vectorized best-split search over histograms.

Port of lightgbm_tpu/ops/split.py: `leaf_split_gain`, `leaf_output`,
`split_gain_matrix`, `best_split`, and the Exclusive Feature Bundling
helpers `identity_feat_table`, `bundle_predicate_params`,
`store_go_left`, `unbundle_hist` and `maybe_unbundle`, which translate
between original features (split search, trees) and bundled store
columns (histograms, partition).
Plain torch on any device; the f32 operation order follows JAX.

Every function takes leading batch dimensions on the histogram (the JAX
learner vmaps one leaf at a time): hist [..., F, 3, B] with per-leaf
sums [...].  Tie-break: the flat argmax over [F, B] picks the smallest
feature, then the smallest threshold (torch.argmax returns the first
maximum); invalid cells hold -inf, never NaN.
"""
from __future__ import annotations

import math

import torch

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
    nb = num_bins.to(torch.int64)[:, None]
    cat = is_cat[:, None]

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
    valid = (t_valid & feature_mask[:, None]
             & (CL >= min_data_in_leaf) & (CR >= min_data_in_leaf)
             & (HL >= min_sum_hessian_in_leaf)
             & (HR >= min_sum_hessian_in_leaf))

    gain_shift = leaf_split_gain(sg, sh, l1, l2)
    min_gain_shift = gain_shift + min_gain_to_split
    total = leaf_split_gain(GL, HL, l1, l2) + leaf_split_gain(GR, HR, l1, l2)
    total = torch.where(valid & (total > min_gain_shift), total,
                        torch.full_like(total, K_MIN_SCORE))
    return total, GL, HL, CL


def best_split(hist: torch.Tensor, num_bins: torch.Tensor,
               is_cat: torch.Tensor, feature_mask: torch.Tensor,
               sum_grad: torch.Tensor, sum_hess: torch.Tensor,
               num_data: torch.Tensor, *, lambda_l1: float = 0.0,
               lambda_l2: float = 0.0, min_data_in_leaf: int = 20,
               min_sum_hessian_in_leaf: float = 1e-3,
               min_gain_to_split: float = 0.0) -> torch.Tensor:
    """Best split of each leaf from its histogram hist [..., F, 3, B].
    Returns the packed records [..., 11] f32 (see RECORD_LEN)."""
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
    return torch.stack([
        gain, (best // B).to(torch.float32), (best % B).to(torch.float32),
        glb, hlb, clb, grb, hrb, crb,
        leaf_output(glb, hlb, l1, l2), leaf_output(grb, hrb, l1, l2)],
        dim=-1)


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
