"""Device-side evaluation metrics: pointwise losses, AUC, multiclass
log loss and error, NDCG@k and MAP@k.

Port of lightgbm_tpu/ops/eval.py `pointwise_loss`, `auc`,
`multi_logloss`, `multi_error`, `ndcg_at_k` and `map_at_k`.  The score
stays on the device; each metric returns a 0-d tensor (or one per k),
and the boosting loop fetches all of an iteration's metrics in one
transfer.  The weight sum and the loss parameters come in as 0-d
tensors on the score's device, as JAX's device scalars do, so a
division by one is a true f32 division on the card too.

Every sum is taken in an order fixed by the shapes, so a metric gives
the same bits on every run on the card (early stopping reads them):
JAX's segment sums become a segmented scan over the sorted rows (AUC's
tied-score blocks) and row sums of a [queries, k] layout of each
query's top k sorted rows (NDCG, MAP), never a float scatter-add, whose
atomics on CUDA add in a run-dependent order.  They add in another order
than JAX's, which moves a value by float rounding only.
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


def _scan(x: torch.Tensor, starts: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Inclusive prefix sums of x [n], restarting at every row where
    `starts` is True when given: log2(n) elementwise steps (Hillis and
    Steele), an order of additions fixed by n.  torch.cumsum of floats on
    CUDA may add in another order on every run."""
    n = x.shape[0]
    v, f = x, starts
    d = 1
    while d < n:
        add = v[d:] + v[:-d]
        if f is None:
            v = torch.cat([v[:d], add])
        else:
            v = torch.cat([v[:d], torch.where(f[d:], v[d:], add)])
            f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def auc(score: torch.Tensor, label: torch.Tensor,
        w: Optional[torch.Tensor]) -> torch.Tensor:
    """Weighted tie-aware rank-sum AUC: sort once, sum each block of tied
    scores (a run of the sorted rows) with a segmented scan, read at the
    block's last row, and the negatives below each block with a scan of
    those sums."""
    s = score.to(torch.float32)
    n = s.shape[0]
    order = torch.argsort(s, stable=True)
    s_s = s[order]
    y_s = label[order] > 0
    w_s = torch.ones_like(s) if w is None else w[order]
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    wpos = torch.where(y_s, w_s, zero)
    wneg = torch.where(y_s, zero, w_s)
    change = s_s[1:] != s_s[:-1]
    true = torch.ones(1, dtype=torch.bool, device=s.device)
    first = torch.cat([true, change])
    last = torch.cat([change, true])
    bpos = torch.where(last, _scan(wpos, first), zero)
    bneg = torch.where(last, _scan(wneg, first), zero)
    below = _scan(bneg) - bneg
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


def _top_rows(qid_sorted: torch.Tensor, query_id: torch.Tensor,
              query_start_of_row: torch.Tensor, num_queries: int,
              kmax: int):
    """The sorted positions of each query's first kmax rows, [Q, kmax]
    (clamped into range), and which of them are rows of that query.
    Queries are contiguous in row order, so after the sort by query query
    q's rows sit at its first row's index onwards, rank r at that index
    plus r."""
    n = qid_sorted.shape[0]
    dev = qid_sorted.device
    start = torch.full((num_queries,), n, dtype=torch.int64,
                       device=dev).scatter_reduce(
        0, query_id.long(), query_start_of_row.long(), reduce="amin")
    r = torch.arange(kmax, dtype=torch.int64, device=dev)
    q = torch.arange(num_queries, dtype=torch.int64, device=dev)
    pos = start[:, None] + r[None, :]
    valid = pos < n
    pos = torch.clamp(pos, max=n - 1)
    valid &= qid_sorted[pos] == q[:, None]
    return pos, valid, r


def ndcg_at_k(score: torch.Tensor, label_int: torch.Tensor,
              query_id: torch.Tensor, query_start_of_row: torch.Tensor,
              label_gain: torch.Tensor, discount_by_rank: torch.Tensor,
              query_weight: Optional[torch.Tensor], ks: tuple,
              num_queries: int, max_len: Optional[int] = None
              ) -> torch.Tensor:
    """NDCG@k for every k in `ks`, averaged over queries (weighted by
    query_weight when given).  One global sort of all rows keyed
    (query, -score) as in JAX; each query's DCG sums its first k sorted
    rows as one row of a [Q, max k] layout (`max_len`, the longest
    query, caps its width); queries whose ideal DCG is 0 count as 1.
    Returns [len(ks)] f32."""
    s = score.to(torch.float32)
    n = s.shape[0]
    dev = s.device
    gains = label_gain[label_int.long()]
    order = _stable_lexsort(-s, query_id)
    g_sorted = gains[order]
    qid_sorted = query_id[order].long()
    iorder = _stable_lexsort(-gains, query_id)
    ig_sorted = gains[iorder]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kmax = max(1, min(max(ks), n, max_len or n))
    pos, valid, r = _top_rows(qid_sorted, query_id, query_start_of_row,
                              num_queries, kmax)
    disc = discount_by_rank[r][None, :]
    g_top = g_sorted[pos] * disc
    ig_top = ig_sorted[pos] * disc
    out = []
    for k in ks:
        within = valid & (r < k)[None, :]
        dcg = torch.where(within, g_top, zero).sum(dim=1)
        maxdcg = torch.where(within, ig_top, zero).sum(dim=1)
        nd = torch.where(maxdcg > 0, dcg / torch.clamp(maxdcg, min=1e-30),
                         torch.ones((), dtype=torch.float32, device=dev))
        out.append(_qw_mean(nd, query_weight))
    return torch.stack(out)


def map_at_k(score: torch.Tensor, label_pos: torch.Tensor,
             query_id: torch.Tensor, query_start_of_row: torch.Tensor,
             query_weight: Optional[torch.Tensor], ks: tuple,
             num_queries: int, max_len: Optional[int] = None
             ) -> torch.Tensor:
    """MAP@k for every k in `ks` (AP@k = sum over the relevant rows among
    the top k of precision@rank, over the relevant rows among the top k;
    a query with none counts 0), averaged over queries (weighted by
    query_weight when given).  Hits within a query are a global running
    count less the query's first offset, as in JAX (integers, so exact
    in any order); the per-query sums run over the [Q, max k] layout of
    `ndcg_at_k`.  Returns [len(ks)] f32."""
    s = score.to(torch.float32)
    n = s.shape[0]
    dev = s.device
    order = _stable_lexsort(-s, query_id)
    rank = torch.arange(n, dtype=torch.int32, device=dev) \
        - query_start_of_row[order]
    rel_int = label_pos.to(torch.int64)[order]
    rel_sorted = rel_int.to(torch.float32)
    qid_sorted = query_id[order].long()
    csum = torch.cumsum(rel_int, 0)
    offset = (csum - rel_int).to(torch.float32)
    first_offset = torch.full((num_queries,), float("inf"),
                              dtype=torch.float32, device=dev).scatter_reduce(
        0, qid_sorted, offset, reduce="amin")
    hits = offset - first_offset[qid_sorted] + rel_sorted
    prec = hits / (1.0 + rank.to(torch.float32))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kmax = max(1, min(max(ks), n, max_len or n))
    pos, valid, r = _top_rows(qid_sorted, query_id, query_start_of_row,
                              num_queries, kmax)
    pr_top = (prec * rel_sorted)[pos]
    rel_top = rel_sorted[pos]
    out = []
    for k in ks:
        within = valid & (r < k)[None, :]
        ap_num = torch.where(within, pr_top, zero).sum(dim=1)
        nrel = torch.where(within, rel_top, zero).sum(dim=1)
        ap = torch.where(nrel > 0, ap_num / torch.clamp(nrel, min=1.0), zero)
        out.append(_qw_mean(ap, query_weight))
    return torch.stack(out)
