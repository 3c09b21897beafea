"""Vectorized best-split search over histograms.

Port of lightgbm_tpu/ops/split.py (`leaf_split_gain`, `leaf_output`,
`split_gain_matrix`, `best_split`, and the no-bundle forms of
`bundle_predicate_params` and `maybe_unbundle`, which take no feature
table: the store's columns are the features).
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

    GL = torch.where(cat, g, torch.cumsum(g, dim=-1))
    HL = torch.where(cat, h, torch.cumsum(h, dim=-1))
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


def bundle_predicate_params(feat_tbl, feat: torch.Tensor, thr: torch.Tensor,
                            is_cat: torch.Tensor):
    """STORE-space go-left parameters (col, T, lo, hi1, dl) of an
    ORIGINAL-space split — no-bundle form: the column is the feature, the
    threshold is unchanged, and the in-range window is [0, 2^30)."""
    if feat_tbl is not None:
        raise NotImplementedError("bundled stores (EFB) are not ported yet "
                                  "(ROADMAP.md §A item 10)")
    feat = feat.to(torch.int32)
    return (feat, thr.to(torch.int32), torch.zeros_like(feat),
            torch.full_like(feat, 1 << 30), torch.zeros_like(feat,
                                                             dtype=torch.bool))


def maybe_unbundle(hist: torch.Tensor, unb, totals) -> torch.Tensor:
    """No-bundle form: the store already is the original layout."""
    if unb is not None:
        raise NotImplementedError("bundled stores (EFB) are not ported yet "
                                  "(ROADMAP.md §A item 10)")
    return hist
