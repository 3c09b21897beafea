"""Device-side evaluation metrics: pointwise losses, AUC, multiclass
log loss and error, NDCG@k and MAP@k.

Port of lightgbm_tpu/ops/eval.py `pointwise_loss`, `auc`,
`multi_logloss`, `multi_error`, `ndcg_at_k` and `map_at_k`.  The score
stays on the device; each metric returns a 0-d tensor (or one per k),
and the boosting loop fetches all of an iteration's metrics in one
transfer.  The weight sum and the loss parameters come in as 0-d
tensors on the score's device, as JAX's device scalars do, so a
division by one is a true f32 division on the card too.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _wmean(loss: torch.Tensor, w: Optional[torch.Tensor],
           sum_w: torch.Tensor) -> torch.Tensor:
    if w is None:
        return torch.sum(loss) / sum_w
    return torch.sum(loss * w) / sum_w


def pointwise_loss(score: torch.Tensor, label: torch.Tensor,
                   w: Optional[torch.Tensor], sum_w: torch.Tensor, *,
                   kind: str, p1: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Weighted mean of an elementwise loss.  score/label [N] f32, w [N]
    or None, sum_w a 0-d f32 tensor.  `kind` selects the loss; p1 is its
    parameter (sigmoid / huber delta / fair c) as a 0-d f32 tensor."""
    s = score.to(torch.float32)
    y = label
    if kind == "l2":
        d = s - y
        loss = d * d
    elif kind == "l1":
        loss = torch.abs(s - y)
    elif kind == "huber":
        d = torch.abs(s - y)
        loss = torch.where(d <= p1, 0.5 * d * d, p1 * (d - 0.5 * p1))
    elif kind == "fair":
        x = torch.abs(s - y)
        loss = p1 * x - p1 * p1 * torch.log1p(x / p1)
    elif kind == "poisson":
        sv = torch.clamp(s, min=1e-10)
        loss = sv - y * torch.log(sv)
    elif kind == "binary_logloss":
        prob = torch.sigmoid(p1 * s)
        prob = torch.clamp(prob, 1e-15, 1 - 1e-15)
        loss = -torch.where(y > 0, torch.log(prob), torch.log1p(-prob))
    elif kind == "binary_error":
        loss = ((s > 0) != (y > 0)).to(torch.float32)
    else:
        raise ValueError(kind)
    return _wmean(loss, w, sum_w)


# jnp.log(1e-15) inside the jitted function: an f32 log of f32(1e-15)
_LOG_EPS = float(np.float32(math.log(float(np.float32(1e-15)))))


def multi_logloss(score: torch.Tensor, label_int: torch.Tensor,
                  w: Optional[torch.Tensor],
                  sum_w: torch.Tensor) -> torch.Tensor:
    """score [K, N], label_int [N] int64: mean -log softmax(score)[label],
    with log p clamped at log(1e-15)."""
    s = score.to(torch.float32)
    m = torch.amax(s, dim=0, keepdim=True)
    logp = s - m - torch.log(torch.sum(torch.exp(s - m), dim=0,
                                       keepdim=True))
    pl = torch.gather(logp, 0, label_int[None, :])[0]
    loss = -torch.clamp(pl, min=_LOG_EPS)
    return _wmean(loss, w, sum_w)


def multi_error(score: torch.Tensor, label_int: torch.Tensor,
                w: Optional[torch.Tensor],
                sum_w: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax class (the first on ties) is not the
    label."""
    pred = torch.argmax(score, dim=0)
    err = (pred != label_int).to(torch.float32)
    return _wmean(err, w, sum_w)


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


def _qw_mean(per_query: torch.Tensor,
             query_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Query-weighted average of a [Q] per-query vector; the plain mean
    without query weights."""
    if query_weight is None:
        return per_query.mean()
    w = query_weight.to(torch.float32)
    return torch.sum(per_query * w) / torch.sum(w)


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
        out.append(_qw_mean(nd, query_weight))
    return torch.stack(out)


def map_at_k(score: torch.Tensor, label_pos: torch.Tensor,
             query_id: torch.Tensor, query_start_of_row: torch.Tensor,
             query_weight: Optional[torch.Tensor], ks: tuple,
             num_queries: int) -> torch.Tensor:
    """MAP@k for every k in `ks` (AP@k = sum over the relevant rows among
    the top k of precision@rank, over the relevant rows among the top k;
    a query with none counts 0), averaged over queries (weighted by
    query_weight when given).  Hits within a query are a global cumsum
    less the query's first offset, as in JAX.  Returns [len(ks)] f32."""
    s = score.to(torch.float32)
    n = s.shape[0]
    dev = s.device
    rel = label_pos.to(torch.float32)
    order = _stable_lexsort(-s, query_id)
    rank = torch.arange(n, dtype=torch.int32, device=dev) \
        - query_start_of_row[order]
    rel_sorted = rel[order]
    qid_sorted = query_id[order].long()
    csum = torch.cumsum(rel_sorted, 0)
    offset = csum - rel_sorted
    first_offset = torch.full((num_queries,), float("inf"),
                              dtype=torch.float32, device=dev).scatter_reduce(
        0, qid_sorted, offset, reduce="amin")
    hits = offset - first_offset[qid_sorted] + rel_sorted
    prec = hits / (1.0 + rank.to(torch.float32))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = []
    for k in ks:
        within = rank < k
        ap_num = torch.zeros(num_queries, dtype=torch.float32,
                             device=dev).index_add_(
            0, qid_sorted, torch.where(within, prec * rel_sorted, zero))
        nrel = torch.zeros(num_queries, dtype=torch.float32,
                           device=dev).index_add_(
            0, qid_sorted, torch.where(within, rel_sorted, zero))
        ap = torch.where(nrel > 0, ap_num / torch.clamp(nrel, min=1.0), zero)
        out.append(_qw_mean(ap, query_weight))
    return torch.stack(out)
