"""Device-side evaluation metrics: the binary log loss, AUC and NDCG@k.

Port of lightgbm_tpu/ops/eval.py `pointwise_loss` (binary_logloss kind),
`auc` and `ndcg_at_k`.  The score stays on the device; each metric
returns a 0-d tensor, and the boosting loop fetches all of an
iteration's metrics in one transfer.
"""
from __future__ import annotations

from typing import Optional

import torch


def binary_logloss(score: torch.Tensor, label: torch.Tensor,
                   w: Optional[torch.Tensor], sum_w: float,
                   sigmoid: float) -> torch.Tensor:
    """Weighted mean binary log loss of raw scores [N] against labels."""
    prob = torch.sigmoid(sigmoid * score.to(torch.float32))
    prob = torch.clamp(prob, 1e-15, 1 - 1e-15)
    loss = -torch.where(label > 0, torch.log(prob), torch.log1p(-prob))
    if w is None:
        return torch.sum(loss) / sum_w
    return torch.sum(loss * w) / sum_w


def auc(score: torch.Tensor, label: torch.Tensor,
        w: Optional[torch.Tensor]) -> torch.Tensor:
    """Weighted tie-aware rank-sum AUC: sort once, fold tied blocks with a
    segment sum keyed by a block id derived from score changes."""
    s = score.to(torch.float32)
    n = s.shape[0]
    order = torch.argsort(s, stable=True)
    s_s = s[order]
    y_s = label[order] > 0
    w_s = torch.ones_like(s) if w is None else w[order]
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    wpos = torch.where(y_s, w_s, zero)
    wneg = torch.where(y_s, zero, w_s)
    new_block = torch.cat([torch.ones(1, dtype=torch.int64, device=s.device),
                           (s_s[1:] != s_s[:-1]).to(torch.int64)])
    block_id = torch.cumsum(new_block, 0) - 1
    bpos = torch.zeros(n, dtype=torch.float32,
                       device=s.device).index_add_(0, block_id, wpos)
    bneg = torch.zeros(n, dtype=torch.float32,
                       device=s.device).index_add_(0, block_id, wneg)
    below = torch.cumsum(bneg, 0) - bneg
    acc = torch.sum(bpos * (below + 0.5 * bneg))
    tot_pos = torch.sum(wpos)
    tot_neg = torch.sum(wneg)
    return torch.where((tot_pos > 0) & (tot_neg > 0),
                       acc / (tot_pos * tot_neg),
                       torch.ones((), dtype=torch.float32, device=s.device))


def _stable_lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Order sorting by `major`, ties by `minor`, remaining ties by row
    index (jnp.lexsort((minor, major)), a stable sort): two stable sorts.
    Adding 0.0 turns -0.0 into +0.0, so a radix sort on the float bits
    (CUDA) ties them as JAX's sort and the CPU's comparisons do."""
    o1 = torch.argsort(minor + 0.0, stable=True)
    o2 = torch.argsort(major[o1], stable=True)
    return o1[o2]


def ndcg_at_k(score: torch.Tensor, label_int: torch.Tensor,
              query_id: torch.Tensor, query_start_of_row: torch.Tensor,
              label_gain: torch.Tensor, discount_by_rank: torch.Tensor,
              query_weight: Optional[torch.Tensor], ks: tuple,
              num_queries: int) -> torch.Tensor:
    """NDCG@k for every k in `ks`, averaged over queries (weighted by
    query_weight when given).  One global sort of all rows keyed
    (query, -score) and segment sums per query, as in JAX; queries whose
    ideal DCG is 0 count as 1.  Returns [len(ks)] f32."""
    s = score.to(torch.float32)
    n = s.shape[0]
    dev = s.device
    gains = label_gain[label_int.long()]
    order = _stable_lexsort(-s, query_id)
    rank = torch.arange(n, dtype=torch.int32, device=dev) \
        - query_start_of_row[order]
    g_sorted = gains[order]
    qid_sorted = query_id[order].long()
    iorder = _stable_lexsort(-gains, query_id)
    ig_sorted = gains[iorder]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    disc = discount_by_rank[torch.clamp(rank, max=n - 1).long()]
    out = []
    for k in ks:
        within = rank < k
        dcg = torch.zeros(num_queries, dtype=torch.float32,
                          device=dev).index_add_(
            0, qid_sorted, torch.where(within, g_sorted * disc, zero))
        maxdcg = torch.zeros(num_queries, dtype=torch.float32,
                             device=dev).index_add_(
            0, qid_sorted, torch.where(within, ig_sorted * disc, zero))
        nd = torch.where(maxdcg > 0, dcg / torch.clamp(maxdcg, min=1e-30),
                         torch.ones((), dtype=torch.float32, device=dev))
        if query_weight is None:
            out.append(nd.mean())
        else:
            w = query_weight.to(torch.float32)
            out.append(torch.sum(nd * w) / torch.sum(w))
    return torch.stack(out)
