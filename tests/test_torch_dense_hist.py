"""The dense histogram kernels as redesigned for the H100 (K5 over byte
feeds with a live row count, K1 and K2 over the segment plan of the
gathered feed), held against the JAX package on the CPU.

Same seeded inputs through both packages.  The port's histograms take
their plain versions here (CPU tensors); the tiles of kernel K1's work
plan (`segment_plan`) must cover every live scratch position once, and
sums over the positions they name must equal JAX's.  The JAX side runs
its XLA functions and its Pallas kernels in interpret mode, as the JAX
package's own tests do.

Tolerances: the byte feeds and the row-major byte copy are integer data
and equal the int32 stores bitwise.  The work plan is held exactly.  K1
(int8 gradients, int32 sums) is bitwise equal to JAX's Pallas kernel.
K2's plain version over the gathered feed (float32 and bfloat16) is
bitwise equal to JAX's float Pallas kernel on dyadic gradients and within
n * 2^-23 * sum|x| per cell on real ones.
K5's float32 sums are added in another order than XLA's chunked one-hot
matmul: bitwise on dyadic values (every partial sum exact), and on real
ones within n * 2^-23 * sum|x| per cell (n float additions in any order
lie within n * 2^-24 * sum|x| of the exact sum, and both sides reorder)
plus 1e-4 (the bound of the JAX package's own interpret tests); the
count channel is exact in any order and held bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.learner.common import sentinel_bins_t as j_sentinel_bins_t
from lightgbm_tpu.ops import histogram as jh

from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Dataset as TDataset
from lightgbm_tpu_torch.learner.common import sentinel_bins_feed
from lightgbm_tpu_torch.learner.rounds import RoundsTreeLearner
from lightgbm_tpu_torch.learner.serial import SerialTreeLearner
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.synth import synth_higgs, synth_onehot


def _datasets(case):
    """JAX and port Datasets on the same data: the onehot store (7 bins
    a bundle column), or synth_higgs binned to at most 128, 256 or 300
    bins."""
    if case == "onehot":
        X, y = synth_onehot(3000)
        params = {}
    else:
        X, y = synth_higgs(3000, f=9)
        params = {"max_bin": {"bins128": 127, "bins256": 255,
                              "bins300": 299}[case]}
    p = dict(params, sparse_store="dense", verbose=-1)
    return (JDataset(X, y, j_config(p)),
            TDataset(X, y, t_config(dict(p, device_type="cpu"))))


@pytest.mark.parametrize("case,max_bins", [
    ("onehot", 7), ("bins128", 128), ("bins256", 256), ("bins300", 300)])
def test_exact_learner_byte_feed_bitwise_vs_jax(case, max_bins):
    """The exact learner's [N+1, C] feed of kernel K5 is the JAX
    learner's int32 store in uint8 (uint16 beyond 256 bins); the int32
    [C, N+1] store the partition reads is unchanged."""
    dj, dt = _datasets(case)
    assert dt.max_num_bin == dj.max_num_bin
    assert max_bins - 1 <= dt.max_num_bin <= max_bins
    ref = j_sentinel_bins_t(dj)
    feed = sentinel_bins_feed(dt)
    assert feed.dtype == (np.uint8 if max_bins <= 256 else np.uint16)
    np.testing.assert_array_equal(feed.astype(np.int32), ref)
    cfg = t_config({"device_type": "cpu", "tree_growth": "exact",
                    "verbose": -1})
    learner = SerialTreeLearner(dt, cfg)
    assert learner.bins_t.dtype == torch.from_numpy(feed).dtype
    np.testing.assert_array_equal(learner.bins_t.numpy().astype(np.int32),
                                  ref)
    assert learner.bins.dtype == torch.int32
    # row-contiguous: the partition reads one store column at a time
    assert learner.bins.is_contiguous()
    np.testing.assert_array_equal(learner.bins.numpy(), ref.T)
    assert learner.num_store_bins == dt.max_num_bin


@pytest.mark.parametrize("case", ["onehot", "bins128", "bins256",
                                  "bins300"])
def test_rounds_learner_byte_copy_bitwise(case):
    """The rounds learner's row-major byte copy holds the store's bins,
    built alike from the int32 store and from the int8 one (value -
    128); beyond 256 bins there is none and K1 reads the [F, N] store."""
    dj, dt = _datasets(case)
    cfg = t_config({"device_type": "cpu", "verbose": -1})
    learner = RoundsTreeLearner(dt, cfg)
    store = np.asarray(dj.bins).astype(np.int32)              # [F, N]
    F, N = store.shape
    if dt.max_num_bin > 256:
        assert learner.rows is None
        with pytest.raises(ValueError):
            th.row_major_bins(torch.as_tensor(store), dt.max_num_bin)
        return
    rows = learner.rows
    assert rows.rows.dtype == torch.uint8
    assert rows.rows.shape == (N, -(-F // 4) * 4)
    assert rows.num_bins == dt.max_num_bin
    np.testing.assert_array_equal(rows.rows[:, :F].numpy().T, store)
    assert not rows.rows[:, F:].any()
    int8_store = torch.as_tensor((store - 128).astype(np.int8))
    np.testing.assert_array_equal(
        th.row_major_bins(int8_store, dt.max_num_bin).rows.numpy(),
        rows.rows.numpy())


def _base(K, total, empty, seed):
    rng = np.random.RandomState(seed)
    w = rng.rand(K)
    w[list(empty)] = 0
    cnt = (rng.multinomial(total, w / w.sum()) if total
           else np.zeros(K, np.int64))
    return np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)


@pytest.mark.parametrize("K,capacity,total,empty,tile", [
    (1, 5_000, 5_000, (), 512),          # one slot over 10 tiles
    (1, 5_000, 1_200, (), 4_096),        # one tile, capacity > total
    (15, 6_000, 4_000, (0, 7, 14), 256),
    (84, 9_000, 8_500, (3, 40, 83), 128),
    (84, 1_280, 0, tuple(range(84)), 128),   # every slot empty
])
def test_segment_plan_covers_each_live_position_once(K, capacity, total,
                                                     empty, tile):
    base = _base(K, total, empty, K + total)
    n_blocks = -(-capacity // tile) + K
    slot, lo, hi = (x.numpy() for x in th.segment_plan(
        torch.as_tensor(base), tile, n_blocks))
    cover = np.zeros(capacity, np.int64)
    owner = np.full(capacity, -1, np.int64)
    tiles = np.zeros(K, np.int64)
    for k, a, b in zip(slot, lo, hi):
        if k < 0:
            assert a == b == 0
            continue
        assert base[k] <= a <= b <= base[k + 1] and b - a <= tile
        cover[a:b] += 1
        owner[a:b] = k
        tiles[k] += 1
    np.testing.assert_array_equal(cover[:total], 1)
    assert not cover[total:].any()
    cnt = np.diff(base)
    np.testing.assert_array_equal(owner[:total], np.repeat(np.arange(K),
                                                           cnt))
    # a slot takes ceil(cnt / tile) tiles, an empty one a single block
    # (it writes the slot's zeros); the grid bounds them all
    np.testing.assert_array_equal(tiles, np.maximum(1, -(-cnt // tile)))
    assert tiles.sum() <= n_blocks


def _gathered_case(N, F, K, counts, seed, int8_bins):
    rng = np.random.RandomState(seed)
    gb = rng.randint(0, 250, size=(F, N)).astype(np.int32)
    bins = (gb.astype(np.int16) - 128).astype(np.int8) if int8_bins else gb
    gh8 = np.zeros((8, N), np.float32)
    gh8[0] = rng.randn(N)
    gh8[1] = rng.rand(N)
    gh8[2] = rng.rand(N) < 0.9
    perm = rng.permutation(N).astype(np.int32)
    seg_cnt = np.asarray(counts, np.int32)
    seg_off = np.sort(rng.choice(N - seg_cnt.max(), K)).astype(np.int32)
    return bins, gh8, perm, seg_off, seg_cnt


@pytest.mark.parametrize("K,counts,capacity,int8_bins,byte_copy,tile", [
    (1, [1_500], 1_536, False, True, 64),
    (4, [500, 0, 900, 100], 1_536, True, True, 128),
    (4, [500, 0, 900, 100], 2_048, False, False, 96),
    (15, [60, 0, 130, 7, 0, 90, 200, 33, 1, 0, 50, 70, 80, 20, 40], 1_024,
     True, False, 32),
])
def test_gathered_int8_plan_bitwise_vs_pallas_interpret(
        K, counts, capacity, int8_bins, byte_copy, tile):
    """K1's plain version (hist_multileaf_gathered on the CPU) and the
    sums over the positions its work plan names (slots split into tiles
    of `tile` positions) against JAX's int8 Pallas kernel in interpret
    mode, from the store and from its byte copy."""
    bins, gh8, perm, so, sn = _gathered_case(3_000, 6, K, counts, K + tile,
                                             int8_bins)
    kw = dict(capacity=capacity, num_bins_padded=256, input_dtype="int8")
    tb, tg = torch.as_tensor(bins), torch.as_tensor(gh8)
    tp, tso, tsn = (torch.as_tensor(x) for x in (perm, so, sn))
    rows = th.row_major_bins(tb, 256) if byte_copy else None
    out = th.hist_multileaf_gathered(tb, tg, tp, tso, tsn, rows=rows,
                                     **kw).numpy()
    ref = np.asarray(jh.hist_multileaf_gathered(
        jnp.asarray(bins), jnp.asarray(gh8), jnp.asarray(perm),
        jnp.asarray(so), jnp.asarray(sn), backend="pallas", interpret=True,
        **kw))
    assert out.shape == (K, 6, 3, 256)
    np.testing.assert_array_equal(out, ref)
    # the same pass over the plan's (slot, position) pairs
    idx, slot, _, base = th._gather_segments(tp, tso, tsn, capacity)
    ghq, sg, sh = th._quantize_gh(tg[:3][:, idx.long()]
                                  * (slot >= 0).to(torch.float32))
    sk, lo, hi = th.segment_plan(base, tile, -(-capacity // tile) + K)
    kk = torch.repeat_interleave(sk, hi - lo)
    pp = torch.cat([torch.arange(a, b) for a, b in zip(lo.tolist(),
                                                       hi.tolist())])
    plan = th._dequantize(th._hist_pairs(tb, rows, idx, kk, pp, ghq, K, 256),
                          sg, sh)
    np.testing.assert_array_equal(plan.numpy(), ref)
    for k in np.flatnonzero(np.asarray(counts) == 0):
        assert not out[k].any()


@pytest.mark.parametrize("N,F,nb,B,cap,live,dyadic", [
    (5_000, 40, 7, 128, 8_192, 5_000, True),     # count below the cap
    (5_000, 40, 7, 128, 8_192, 4_100, False),
    (4_096, 28, 255, 256, 4_096, 4_096, False),  # cap == N, every row
    (4_096, 28, 255, 256, 4_096, 4_096, True),
    (6_000, 12, 300, 384, 4_096, 3_000, False),  # a uint16 feed
])
def test_histogram_from_indices_byte_feed_vs_jax(N, F, nb, B, cap, live,
                                                 dyadic):
    rng = np.random.RandomState(N + F + nb)
    bins_t = np.concatenate([rng.randint(0, nb, size=(N, F)),
                             np.zeros((1, F))]).astype(np.int32)
    g, h = rng.randn(N), rng.rand(N)
    if dyadic:
        g, h = np.round(g * 64) / 64, np.round(h * 64) / 256
    g = np.concatenate([g, [0.0]]).astype(np.float32)
    h = np.concatenate([h, [0.0]]).astype(np.float32)
    idx = np.full(cap, N, np.int32)
    idx[:live] = np.sort(rng.choice(N, live, replace=False))
    feed = bins_t.astype(np.uint8 if nb <= 256 else np.uint16)
    kw = dict(num_bins_padded=B, count=live, num_store_bins=nb)
    out = th.histogram_from_indices(
        torch.as_tensor(feed), torch.as_tensor(g), torch.as_tensor(h),
        torch.as_tensor(idx), **kw).numpy()
    ref = np.asarray(jh.histogram_from_indices(
        jnp.asarray(bins_t), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(idx), num_bins_padded=B))
    assert out.shape == (F, 3, B)
    assert not out[:, :, nb:].any()
    np.testing.assert_array_equal(out[:, 2], ref[:, 2])
    if dyadic:
        np.testing.assert_array_equal(out, ref)
    else:
        absum = th.histogram_from_indices(
            torch.as_tensor(feed), torch.as_tensor(np.abs(g)),
            torch.as_tensor(h), torch.as_tensor(idx), **kw).numpy()
        tol = 1e-4 + absum[:, 2:3] * 2.0 ** -23 * absum
        assert (np.abs(out - ref) <= tol).all()


def _dyadic(gh8, rng):
    """Gradients on a dyadic grid (multiples of 2^-6 and 2^-8), so that
    every partial sum of a cell is exact in float32 and in bfloat16."""
    gh8[0] = np.round(rng.randn(gh8.shape[1]) * 64) / 64
    gh8[1] = np.round(rng.rand(gh8.shape[1]) * 64) / 256
    return gh8


@pytest.mark.parametrize("input_dtype,feed,dyadic,counts,capacity", [
    ("float32", "rows32", True, [500, 0, 900, 100], 2_048),
    ("float32", "rows8", False, [500, 0, 900, 100], 2_048),
    ("float32", "cols32", False, [1_500], 1_536),
    ("float32", "cols8", True, [60, 0, 130, 7, 0, 90, 200, 33, 1, 0, 50],
     1_024),
    ("bfloat16", "rows32", False, [500, 0, 900, 100], 2_048),
    ("bfloat16", "cols8", True, [60, 0, 130, 7, 0, 90, 200, 33, 1, 0, 50],
     1_024),
])
def test_gathered_float_segments_vs_pallas_interpret(input_dtype, feed,
                                                     dyadic, counts,
                                                     capacity):
    """K2's plain route over the gathered feed (hist_multileaf_gathered
    on the CPU: `_segments_plain` over the slot runs' bounds, no slot
    ids) from the byte copy and from the int32 and int8 stores, against
    JAX's float Pallas kernel in interpret mode.  Empty slots stay zero;
    the scratch positions past the total add nothing.  Bitwise on dyadic
    gradients; on real ones every cell within n * 2^-23 * sum|x| of its n
    rows (n float additions in any order lie within n * 2^-24 * sum|x|
    of the exact sum, and both sides reorder)."""
    K = len(counts)
    rng = np.random.RandomState(K + capacity)
    bins, gh8, perm, so, sn = _gathered_case(3_000, 6, K, counts,
                                             K + capacity,
                                             feed.endswith("8"))
    if dyadic:
        gh8 = _dyadic(gh8, rng)
    kw = dict(capacity=capacity, num_bins_padded=256,
              input_dtype=input_dtype)
    tb, tg = torch.as_tensor(bins), torch.as_tensor(gh8)
    tp, tso, tsn = (torch.as_tensor(x) for x in (perm, so, sn))
    rows = th.row_major_bins(tb, 256) if feed.startswith("rows") else None
    out = th.hist_multileaf_gathered(tb, tg, tp, tso, tsn, rows=rows,
                                     **kw).numpy()
    ref = np.asarray(jh.hist_multileaf_gathered(
        jnp.asarray(bins), jnp.asarray(gh8), jnp.asarray(perm),
        jnp.asarray(so), jnp.asarray(sn), backend="pallas", interpret=True,
        **kw))
    assert out.shape == ref.shape == (K, 6, 3, 256)
    for k in np.flatnonzero(np.asarray(counts) == 0):
        assert not out[k].any()
    # the plain route over the bounds, as the kernel's wrapper takes it
    idx, _, valid, total, base = th._gather_rows(tp, tso, tsn, capacity)
    assert int(total) == sum(counts) and int(base[-1]) == sum(counts)
    ghg = tg[:3][:, idx.long()] * valid.to(torch.float32)
    bf16 = input_dtype == "bfloat16"
    seg = th.segment_counts(tb, rows, idx, ghg, base, 256, round_bf16=bf16)
    np.testing.assert_array_equal(seg.numpy(), out)
    if dyadic:
        np.testing.assert_array_equal(out, ref)
    else:
        absv = torch.stack([ghg[0].abs(), ghg[1].abs(),
                            torch.ones_like(ghg[2])])
        if bf16:
            absv = absv.to(torch.bfloat16).to(torch.float32)
        s = th._segments_plain(tb, rows, idx, absv, base, 256).numpy()
        tol = s[:, :, 2:3] * 2.0 ** -23 * s
        assert (np.abs(out - ref) <= tol).all()
        assert not np.array_equal(out, np.zeros_like(out))
