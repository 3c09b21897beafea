"""The sums the port takes in a fixed order, held against the JAX package
and against the accumulating versions they replace, on the CPU.

- The slot totals of a sparse pass (`histogram._slot_totals`, whose CUDA
  kernels sum in an order fixed by the inputs) against JAX's
  `_slot_totals`: int32 lanes bitwise, float32 within n * 2^-24 *
  sum|x| of each total (n f32 additions in any order lie within that of
  the exact sum, and XLA's scatter adds in row order on the CPU as the
  plain version does).
- AUC, NDCG@k and MAP@k (`ops/eval.py`: a segmented scan over tied
  blocks, row sums of a [queries, k] layout) against
  lightgbm_tpu/ops/eval.py within rtol 1e-6 (tests/test_torch_metrics.py's
  tolerance: float32 sums in another order), over long and short
  queries, k past every query, ties and weights; the scan itself within
  log2(n) * 2^-24 * sum|x| of the float64 prefix sums, and exact on
  integers.
- The lambdarank gradients, now written into each document's slot once,
  bitwise against the accumulating version (an add into zeroed slots)
  on synth_ctr and on the lambdarank test queries.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import eval as jeval
from lightgbm_tpu.ops import histogram as jh

from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.objectives import create_objective as t_objective
from lightgbm_tpu_torch.ops import eval as teval
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import sparse_streams as ss
from lightgbm_tpu_torch.synth import CTR_PARAMS, synth_ctr


@pytest.mark.parametrize("input_dtype", ["int8", "float32"])
@pytest.mark.parametrize("N,K", [(20_000, 31), (5_000, 1), (3_000, 300)])
def test_slot_totals_match_jax(input_dtype, N, K):
    rng = np.random.RandomState(K)
    lid = rng.randint(0, K + 4, N).astype(np.int32)
    m = (rng.rand(N) > 0.1).astype(np.float32)
    gh = np.stack([rng.randn(N) * m, rng.rand(N) * m, m]).astype(np.float32)
    sl = np.arange(K, dtype=np.int32)
    sl[2::5] = -1                                     # empty slots
    srow, vals, tot, _ = th._sparse_pass(torch.as_tensor(lid),
                                         torch.as_tensor(gh),
                                         torch.as_tensor(sl), input_dtype)
    assert torch.equal(tot, th._slot_totals(srow, vals, K))
    assert torch.equal(tot, ss.slot_totals_plain(srow, vals, K))
    ref = np.asarray(jh._slot_totals(jnp.asarray(srow.numpy()),
                                     jnp.asarray(vals.numpy()), K))
    assert tot.dtype == (torch.int32 if input_dtype == "int8"
                         else torch.float32)
    assert tot.shape == (K, 3) and ref.shape == (K, 3)
    if input_dtype == "int8":
        np.testing.assert_array_equal(tot.numpy(), ref)
    else:
        ta = ss.slot_totals_plain(srow, vals.abs(), K).double().numpy()
        bound = ta[:, 2:3] * 2.0 ** -24 * ta
        assert (np.abs(tot.double().numpy() - ref) <= bound).all()
    # rows of no slot (K) add nothing: an empty slot's totals are zero
    assert not tot[torch.as_tensor(sl < 0)].any()


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4097])
def test_scan_in_fixed_order(n):
    rng = np.random.RandomState(n)
    x = rng.randn(n).astype(np.float32)
    starts = rng.rand(n) < 0.1
    starts[0] = True
    got = teval._scan(torch.as_tensor(x)).double().numpy()
    ref = np.cumsum(x.astype(np.float64))
    tol = max(1, math.ceil(math.log2(max(n, 2)))) * 2.0 ** -24 \
        * np.cumsum(np.abs(x.astype(np.float64)))
    assert (np.abs(got - ref) <= tol).all()
    seg = teval._scan(torch.as_tensor(x),
                      torch.as_tensor(starts)).double().numpy()
    block = np.cumsum(starts) - 1
    for b in range(block[-1] + 1):
        idx = np.flatnonzero(block == b)
        r = np.cumsum(x[idx].astype(np.float64))
        t = max(1, math.ceil(math.log2(max(n, 2)))) * 2.0 ** -24 \
            * np.cumsum(np.abs(x[idx].astype(np.float64)))
        assert (np.abs(seg[idx] - r) <= t).all()
    # integer values are summed exactly
    xi = rng.randint(0, 3, n).astype(np.float32)
    np.testing.assert_array_equal(
        teval._scan(torch.as_tensor(xi)).numpy(), np.cumsum(xi))


def _queries(seed, n_q, lo, hi):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(lo, hi, n_q)
    n = int(sizes.sum())
    qb = np.concatenate([[0], np.cumsum(sizes)])
    qid = np.repeat(np.arange(n_q, dtype=np.int32), sizes)
    qstart = np.repeat(qb[:-1].astype(np.int32), sizes)
    return rng, sizes, n, qid, qstart


@pytest.mark.parametrize("ks", [(1, 2, 3, 4, 5), (1, 7, 200)])
@pytest.mark.parametrize("weighted", [False, True])
def test_rank_metrics_match_jax(ks, weighted):
    rng, sizes, n, qid, qstart = _queries(len(ks) + weighted, 300, 1, 90)
    label = rng.randint(0, 5, n).astype(np.int32)
    label[qid == 3] = 0                               # a query of no gain
    score = rng.randn(n).astype(np.float32)
    score[:400] = np.round(score[:400] * 2) / 2       # ties within queries
    gain = (2.0 ** np.arange(31) - 1).astype(np.float32)
    disc = (1.0 / np.log2(2.0 + np.arange(n))).astype(np.float32)
    qw = (rng.rand(sizes.size) + 0.5).astype(np.float32) if weighted \
        else None
    t = torch.as_tensor
    for max_len in (None, int(sizes.max())):
        got = teval.ndcg_at_k(t(score), t(label), t(qid), t(qstart), t(gain),
                              t(disc), None if qw is None else t(qw), ks,
                              sizes.size, max_len)
        ref = jeval.ndcg_at_k(jnp.asarray(score), jnp.asarray(label),
                              jnp.asarray(qid), jnp.asarray(qstart),
                              jnp.asarray(gain), jnp.asarray(disc),
                              None if qw is None else jnp.asarray(qw),
                              ks=ks, num_queries=sizes.size)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
        got = teval.map_at_k(t(score), t(label > 0), t(qid), t(qstart),
                             None if qw is None else t(qw), ks, sizes.size,
                             max_len)
        ref = jeval.map_at_k(jnp.asarray(score), jnp.asarray(label > 0),
                             jnp.asarray(qid), jnp.asarray(qstart),
                             None if qw is None else jnp.asarray(qw),
                             ks=ks, num_queries=sizes.size)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def _auc64(score, label, w):
    """The tie-aware rank-sum AUC in float64."""
    w = np.ones(score.size) if w is None else w.astype(np.float64)
    order = np.argsort(score, kind="stable")
    s, pos = score[order], label[order] > 0
    wpos, wneg = np.where(pos, w[order], 0.0), np.where(pos, 0.0, w[order])
    block = np.cumsum(np.concatenate([[True], s[1:] != s[:-1]])) - 1
    bpos = np.bincount(block, wpos)
    bneg = np.bincount(block, wneg)
    below = np.cumsum(bneg) - bneg
    return (bpos * (below + 0.5 * bneg)).sum() / (wpos.sum() * wneg.sum())


@pytest.mark.parametrize("ties", ["none", "many", "all"])
@pytest.mark.parametrize("weighted", [False, True])
def test_auc_matches_jax(ties, weighted):
    """Unweighted, every block and prefix sum is an exact integer on both
    sides: within rtol 1e-6 of JAX.  Weighted, the sums of n weights
    round: the port's (trees of log2(n) levels) within 4 log2(n) 2^-24
    of the float64 AUC, and within n 2^-23 of JAX's (whose scatter adds
    the n weights one after another)."""
    rng = np.random.RandomState(7)
    n = 20_000
    label = (rng.rand(n) < 0.3).astype(np.float32)
    score = rng.randn(n).astype(np.float32)
    if ties == "many":
        score = np.round(score * 3) / 3
    elif ties == "all":
        score[:] = 0.5
    w = (rng.rand(n) * 2).astype(np.float32) if weighted else None
    got = float(teval.auc(torch.as_tensor(score), torch.as_tensor(label),
                          None if w is None else torch.as_tensor(w)))
    ref = float(jeval.auc(jnp.asarray(score), jnp.asarray(label),
                          None if w is None else jnp.asarray(w)))
    exact = _auc64(score, label, w)
    if not weighted:
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        np.testing.assert_allclose(got, exact, rtol=1e-6)
    else:
        np.testing.assert_allclose(got, exact,
                                   rtol=4 * math.log2(n) * 2.0 ** -24)
        np.testing.assert_allclose(got, ref, rtol=n * 2.0 ** -23)


def _accumulating_lambdarank(obj, score):
    """The lambdarank gradients as the port computed them before they
    were written in place: the same pair sums, added into zeroed slots
    with index_add_."""
    sigmoid = float(obj.config.sigmoid)
    N = obj.num_data
    s1 = score[0]
    s_pad = torch.cat([s1, torch.zeros(1, dtype=s1.dtype)])
    g_flat = torch.zeros(N + 1, dtype=s1.dtype)
    h_flat = torch.zeros(N + 1, dtype=s1.dtype)
    neg_inf = torch.full((), -np.inf, dtype=s1.dtype)
    zero = torch.zeros((), dtype=s1.dtype)
    qc = obj._q_chunk
    for c0 in range(0, obj._doc_idx.shape[0], qc):
        didx = obj._doc_idx[c0:c0 + qc]
        msk = obj._mask[c0:c0 + qc]
        imd = obj._inv_max_dcg[c0:c0 + qc]
        sc = torch.where(msk, s_pad[didx], neg_inf)
        lb = obj._lab_pad[didx]
        order = torch.argsort(-sc + 0.0, dim=1, stable=True)
        sc_s = torch.gather(sc, 1, order)
        lb_s = torch.gather(lb, 1, order)
        msk_s = torch.gather(msk, 1, order)
        gain_s = obj._label_gain[torch.clamp(lb_s, 0, obj._n_gain - 1)]
        Dq = sc_s.shape[1]
        best = sc_s[:, 0]
        cnt = msk_s.sum(dim=1)
        worst = torch.gather(sc_s, 1, torch.clamp(cnt - 1, min=0)[:, None]
                             )[:, 0]
        ds = sc_s[:, :, None] - sc_s[:, None, :]
        valid = (msk_s[:, :, None] & msk_s[:, None, :]
                 & (lb_s[:, :, None] > lb_s[:, None, :]))
        dcg_gap = gain_s[:, :, None] - gain_s[:, None, :]
        disc = obj._discount[:Dq]
        paired_disc = torch.abs(disc[None, :, None] - disc[None, None, :])
        delta = dcg_gap * paired_disc * imd[:, None, None]
        norm = torch.where((best != worst)[:, None, None],
                           0.01 + torch.abs(ds), torch.ones((), dtype=s1.dtype))
        delta = delta / norm
        p_lambda = 2.0 / (1.0 + torch.exp(2.0 * sigmoid * ds))
        p_hess = p_lambda * (2.0 - p_lambda)
        p_lambda = torch.where(valid, -p_lambda * delta, zero)
        p_hess = torch.where(valid, p_hess * 2.0 * delta, zero)
        lam_s = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
        hes_s = p_hess.sum(dim=2) + p_hess.sum(dim=1)
        docs = torch.gather(didx, 1, order).reshape(-1)
        g_flat.index_add_(0, docs, lam_s.reshape(-1))
        h_flat.index_add_(0, docs, hes_s.reshape(-1))
    g, h = g_flat[:N], h_flat[:N]
    if obj.weights is not None:
        g = g * obj.weights
        h = h * obj.weights
    return g[None, :], h[None, :]


@pytest.mark.parametrize("data", ["ctr", "queries", "queries_weighted"])
def test_lambdarank_gradients_bitwise_the_accumulating_version(data):
    if data == "ctr":
        _, y, g = synth_ctr(3_000, 200, 0.05)
        sizes, lab, w = np.asarray(g), np.asarray(y, np.float32), None
        rng = np.random.RandomState(1)
        score = (rng.randn(1, y.size) * 0.3).astype(np.float32)
    else:
        rng = np.random.RandomState(0)
        sizes = rng.randint(1, 30, size=40)
        n = int(sizes.sum())
        lab = rng.randint(0, 4, size=n).astype(np.float32)
        w = rng.rand(n).astype(np.float32) if data.endswith("weighted") \
            else None
        score = (np.round(rng.randn(1, n) * 4) / 4).astype(np.float32)
        score[0, :10] = 0.0
    md = TMetadata(label=lab, weights=w)
    md.set_query_from_sizes(sizes)
    obj = t_objective(t_config(dict(CTR_PARAMS, device_type="cpu")))
    obj.init(md, lab.size, torch.device("cpu"))
    s = torch.as_tensor(score)
    g, h = obj.get_gradients(s)
    ga, ha = _accumulating_lambdarank(obj, s)
    assert g.dtype == ga.dtype and g.shape == ga.shape
    np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                  ga.numpy().view(np.uint32))
    np.testing.assert_array_equal(h.numpy().view(np.uint32),
                                  ha.numpy().view(np.uint32))
    assert g.abs().sum() > 0
