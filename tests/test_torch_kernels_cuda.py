"""Each CUDA kernel of lightgbm_tpu_torch against its plain PyTorch
version, on the card.

These tests need a CUDA device: they carry the `cuda` marker and skip
where none is visible (a CUDA kernel has no interpret mode).  The file
imports no JAX, so it runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: K1 (int8 histogram), K3 (lookup), K4 (partition) and K7
(int8 sparse histogram) are integer-exact or pure data movement and must
be bitwise equal.  K2 (float32 histogram) sums each cell in a fixed
order that differs from its plain version's: bitwise on dyadic values,
bitwise from run to run, and on real ones within n * 2^-23 * sum|x| per
cell (n f32 additions in any order lie within n * 2^-24 * sum|x| of the
exact sum, and both sides reorder), which is below the 1e-3 of the
masked-feed test for the ~15 rows of |x| <= 4 per cell there.  K8
(float32 sparse histogram) is held to the rigorous bound of reordered
float sums: n f32 additions in any order lie within n * 2^-24 * sum|x|
of the exact sum, and both the kernel and its plain version reorder, so
a stored cell agrees within n * 2^-23 * sum|x| of its own n entries; a
zero bin (slot total minus the column's stored sums, each reordered on
both sides) within n * 2^-22 * sum|x| of the slot's n rows.  With
dyadic gradients every partial sum is exact and K8 is bitwise.  K5
(gathered-row histogram) sums each cell in a fixed order that differs
from its plain version's, and so does K6 (M-row histogram, one owner
thread a cell); both are held to the same n * 2^-23 * sum|x| per cell,
bitwise on dyadic values (K5's count channel always bitwise), and both
bitwise from run to run.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import kernels
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import lookup as tl
from lightgbm_tpu_torch.ops import partition as tp
from lightgbm_tpu_torch.ops import sparse_streams as ss

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _hist_case(C, F, seed, int8_bins):
    rng = np.random.RandomState(seed)
    gb = rng.randint(0, 250, size=(F, C)).astype(np.int32)
    lid = rng.randint(0, 12, size=C).astype(np.int32)
    lid[rng.rand(C) < 0.05] = -2                      # pad rows
    gh = np.zeros((3, C), np.float32)
    gh[2] = rng.rand(C) < 0.9
    gh[0] = rng.randn(C) * gh[2]
    gh[1] = rng.rand(C) * gh[2]
    sl = np.array([3, 7, -1, 0, 11, -1, 5], np.int32)  # empty slots
    bins = (gb.astype(np.int16) - 128).astype(np.int8) if int8_bins else gb
    return [torch.as_tensor(x) for x in (bins, lid, gh, sl)]


@pytest.mark.parametrize("input_dtype,int8_bins", [
    ("int8", False), ("int8", True), ("float32", False),
    ("bfloat16", True)])
def test_hist_kernel_vs_plain(dev, input_dtype, int8_bins):
    args = _hist_case(100_003, 28, 31, int8_bins)
    ref = th.hist_multileaf_masked(*args, num_bins_padded=256,
                                   input_dtype=input_dtype)
    name = "hist_masked_int8" if input_dtype == "int8" else "hist_masked_f32"
    before = kernels.LAUNCHES[name]
    out = th.hist_multileaf_masked(*[a.to(dev) for a in args],
                                   num_bins_padded=256,
                                   input_dtype=input_dtype).cpu()
    assert kernels.LAUNCHES[name] == before + 1
    if input_dtype == "int8":
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
    else:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-3)


def test_hist_gathered_kernel_vs_plain(dev):
    rng = np.random.RandomState(8)
    N, F = 60_000, 28
    bins = torch.as_tensor(rng.randint(0, 250, size=(F, N)).astype(np.int32))
    gh = torch.as_tensor(rng.randn(3, N).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(N).astype(np.int64))
    so = torch.as_tensor(np.array([0, 9000, 20000, 50000], np.int64))
    sn = torch.as_tensor(np.array([8000, 0, 21000, 900], np.int64))
    kw = dict(capacity=30_080, num_bins_padded=256, input_dtype="int8")
    ref = th.hist_multileaf_gathered(bins, gh, perm, so, sn, **kw)
    out = th.hist_multileaf_gathered(bins.to(dev), gh.to(dev), perm.to(dev),
                                     so.to(dev), sn.to(dev), **kw).cpu()
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    # the float32 pass goes through K2 over the same slot bounds, from the
    # byte copy when given: within 1e-3 of the plain route (up to ~85
    # rows of |x| <= 4 a cell), twice the same bits
    kw["input_dtype"] = "float32"
    rows = th.row_major_bins(bins, 250)
    ref = th.hist_multileaf_gathered(bins, gh, perm, so, sn, rows=rows, **kw)
    rd = th.RowBins(rows.rows.to(dev), rows.num_bins)
    before = kernels.LAUNCHES["hist_masked_f32"]
    out = [th.hist_multileaf_gathered(
        bins.to(dev), gh.to(dev), perm.to(dev), so.to(dev), sn.to(dev),
        rows=rd, **kw).cpu() for _ in range(2)]
    assert kernels.LAUNCHES["hist_masked_f32"] == before + 2
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())
    np.testing.assert_allclose(out[0].numpy(), ref.numpy(), rtol=0,
                               atol=1e-3)


def _segment_case(seed, K, capacity, total, F=28, nb=255, empty=(1,)):
    """Bins [F, N], the row-major byte copy, a scratch of `capacity`
    positions whose first `total` fall in K slot runs (the `empty` slots
    hold none), row ids and quantized values (zero past the runs)."""
    rng = np.random.RandomState(seed)
    N = capacity + 1000
    gb = rng.randint(0, nb, size=(F, N)).astype(np.int32)
    w = rng.rand(K)
    w[[e for e in empty if e < K]] = 0
    cnt = rng.multinomial(total, w / w.sum())
    base = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    row_idx = rng.randint(0, N, size=capacity).astype(np.int32)
    vals = np.zeros((3, capacity), np.int32)
    vals[0, :total] = rng.randint(-127, 128, total)
    vals[1, :total] = rng.randint(0, 128, total)
    vals[2, :total] = 1
    return [torch.as_tensor(x) for x in (gb, base, row_idx, vals)]


@pytest.mark.parametrize("K,capacity,total,tile,feed,F,nb", [
    (84, 60_000, 57_000, None, "rows32", 28, 255),   # the learner's pass
    (15, 60_000, 40_000, 256, "rows8", 28, 255),     # slots over >16 blocks
    (1, 50_000, 50_000, 512, "cols32", 28, 255),     # one slot, 98 blocks
    (7, 30_000, 20_000, 256, "cols8", 28, 255),      # capacity > total
    (84, 60_000, 57_000, None, "rows32", 40, 7),     # the onehot store
    (15, 60_000, 40_000, 256, "rows8", 40, 7),
])
def test_hist_q_kernel_segments_vs_plain(dev, monkeypatch, K, capacity,
                                         total, tile, feed, F, nb):
    """K1 over the gathered feed's segment plan, bitwise equal to its
    plain version over the runs' bounds, to the masked-feed one over slot
    ids, and from run to run; small tiles split slots across blocks."""
    if tile is not None:
        monkeypatch.setattr(th, "K1_TILE_ROWS", tile)
    gb, base, row_idx, vals = _segment_case(K + capacity, K, capacity, total,
                                            F=F, nb=nb)
    bins = gb if feed.endswith("32") else (gb - 128).to(torch.int8)
    rows = th.row_major_bins(bins, nb) if feed.startswith("rows") else None
    ref = th._segments_plain(bins, rows, row_idx, vals, base, 256)
    slot = torch.full((capacity,), -2, dtype=torch.int32)
    cnt = (base[1:] - base[:-1]).numpy()
    slot[:total] = torch.as_tensor(np.repeat(np.arange(K), cnt).astype(
        np.int32))
    masked = th._hist_plain(bins, row_idx, slot, vals,
                            torch.arange(K, dtype=torch.int32), 256)
    np.testing.assert_array_equal(ref.numpy(), masked.numpy())
    rd = None if rows is None else th.RowBins(rows.rows.to(dev),
                                              rows.num_bins)
    before = kernels.LAUNCHES["hist_masked_int8"]
    out = [th.segment_counts(bins.to(dev), rd, row_idx.to(dev),
                             vals.to(dev), base.to(dev), 256).cpu()
           for _ in range(2)]
    assert kernels.LAUNCHES["hist_masked_int8"] == before + 2
    np.testing.assert_array_equal(out[0].numpy(), ref.numpy())
    np.testing.assert_array_equal(out[1].numpy(), ref.numpy())


def _float_vals(rng, n, total, dyadic):
    """[3, n] float32 (grad, hess, mask) with zeros past `total`: dyadic
    (every partial sum exact in float32 and bfloat16) or real."""
    g, h = rng.randn(total), rng.rand(total)
    if dyadic:
        g, h = np.round(g * 64) / 64, np.round(h * 64) / 256
    vals = np.zeros((3, n), np.float32)
    vals[0, :total], vals[1, :total] = g, h
    vals[2, :total] = rng.rand(total) < 0.9
    return torch.as_tensor(vals)


@pytest.mark.parametrize("feed,gathered,dyadic,bf16,tile,F,nb,B", [
    ("rows32", True, True, False, None, 28, 255, 256),   # a gathered pass
    ("rows8", True, False, False, 256, 28, 255, 256),    # slots split
    ("cols32", True, True, True, 256, 28, 255, 256),
    ("cols8", True, False, False, None, 28, 255, 256),
    ("rows32", False, True, False, None, 28, 255, 256),  # the root pass
    ("cols32", False, False, True, 256, 28, 255, 256),   # two-level combine
    ("rows8", False, False, False, 2048, 28, 255, 256),  # K > 1 masked
    ("rows32", True, True, False, 256, 40, 7, 128),      # the onehot store
    ("cols32", True, False, False, None, 9, 300, 384),   # past 256 bins
])
def test_hist_f_kernel_vs_plain(dev, monkeypatch, feed, gathered, dyadic,
                                bf16, tile, F, nb, B):
    """K2 over the gathered feed's segment plan and over the masked feed,
    from the byte copy and from both [F, N] stores, against its plain
    version: bitwise on dyadic values, else within n * 2^-23 * sum|x| per
    cell; two runs bitwise equal."""
    if tile is not None:
        monkeypatch.setattr(th, "K2_TILE_ROWS", tile)
    rng = np.random.RandomState(F + nb + tile if tile else F + nb)
    if gathered:
        K, capacity, total = 84 if nb == 255 else 15, 60_000, 57_000
        gb, base, row_idx, _ = _segment_case(K + capacity, K, capacity,
                                             total, F=F, nb=nb)
        vals = _float_vals(rng, capacity, total, dyadic)
        kw, lid, sl = dict(base=base), None, None
    else:
        K, C = (1, 200_003) if tile != 2048 else (6, 50_000)
        gb = torch.as_tensor(rng.randint(0, nb, size=(F, C)).astype(
            np.int32))
        row_idx, base = None, None
        lid = torch.as_tensor(rng.randint(-1, K + 2, size=C).astype(
            np.int32)) if K > 1 else torch.zeros(C, dtype=torch.int32)
        sl = torch.arange(K, dtype=torch.int32)
        if K > 1:
            sl[2] = -1                                   # an empty slot
        vals = _float_vals(rng, C, C, dyadic)
        kw = dict(lid=lid, sl=sl)
    bins = gb if feed.endswith("32") else (gb - 128).to(torch.int8)
    rows = th.row_major_bins(bins, nb) if feed.startswith("rows") else None

    def plain(v, round_bf16):
        if gathered:
            return th._segments_plain(bins, rows, row_idx, v, base, B,
                                      round_bf16)
        return th._hist_plain(bins, None, lid, v, sl, B, round_bf16,
                              rows=rows)
    ref = plain(vals, bf16)
    rd = None if rows is None else th.RowBins(rows.rows.to(dev),
                                              rows.num_bins)
    on = {k: v.to(dev) for k, v in kw.items()}
    args = (bins.to(dev), rd, None if row_idx is None else row_idx.to(dev),
            vals.to(dev), B)
    before = kernels.LAUNCHES["hist_masked_f32"]
    out = [th._hist_f_cuda(*args, round_bf16=bf16, **on).cpu()
           for _ in range(2)]
    assert kernels.LAUNCHES["hist_masked_f32"] == before + 2
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())
    if dyadic:
        np.testing.assert_array_equal(out[0].numpy(), ref.numpy())
        return
    absv = torch.stack([vals[0].abs(), vals[1].abs(),
                        torch.ones_like(vals[2])])
    s = plain(absv, bf16).double()
    tol = s[:, :, 2:3] * 2.0 ** -23 * s
    assert ((out[0].double() - ref.double()).abs() <= tol).all()


def test_combine_buffers_per_stream(dev):
    """Calls on one stream share the K1/K5 combine scratch and tickets;
    a call on another stream gets a pair of its own, tickets zeroed."""
    d = torch.empty(1, device=dev).device
    a = kernels.combine_buffers(d, 10, 10)
    assert kernels.combine_buffers(d, 10, 10) is a
    with torch.cuda.stream(torch.cuda.Stream()):
        b = kernels.combine_buffers(d, 10, 10)
    assert b[0].data_ptr() != a[0].data_ptr()
    assert b[1].data_ptr() != a[1].data_ptr()
    assert not b[1].any()


@pytest.mark.parametrize("K,C,tile,feed,F,nb", [
    (1, 200_003, None, "rows32", 28, 255),      # the root pass
    (1, 100_003, 1024, "cols32", 28, 255),      # 98 tiles, two levels
    (6, 50_000, 2048, "rows8", 28, 255),        # K > 1 keeps a leaf-id test
    (1, 200_003, None, "rows32", 40, 7),        # the onehot root pass
])
def test_hist_q_kernel_masked_vs_plain(dev, monkeypatch, K, C, tile, feed,
                                       F, nb):
    if tile is not None:
        monkeypatch.setattr(th, "K1_TILE_ROWS", tile)
    rng = np.random.RandomState(C + K)
    gb = torch.as_tensor(rng.randint(0, nb, size=(F, C)).astype(np.int32))
    bins = gb if feed.endswith("32") else (gb - 128).to(torch.int8)
    rows = th.row_major_bins(bins, nb) if feed.startswith("rows") else None
    lid = torch.as_tensor(rng.randint(-1, K + 2, size=C).astype(np.int32))
    sl = torch.arange(K, dtype=torch.int32)
    if K > 1:
        sl[2] = -1                                   # an empty slot
    vals = torch.as_tensor(np.stack([rng.randint(-127, 128, C),
                                     rng.randint(0, 128, C),
                                     rng.rand(C) < 0.9]).astype(np.int32))
    ref = th._hist_plain(bins, None, lid, vals, sl, 256)
    rd = None if rows is None else th.RowBins(rows.rows.to(dev),
                                              rows.num_bins)
    out = [th._hist_q_cuda(bins.to(dev), rd, None, vals.to(dev), 256,
                           lid=lid.to(dev), sl=sl.to(dev)).cpu()
           for _ in range(2)]
    np.testing.assert_array_equal(out[0].numpy(), ref.numpy())
    np.testing.assert_array_equal(out[1].numpy(), ref.numpy())


@pytest.mark.parametrize("n", [100_003, 1, 3])
@pytest.mark.parametrize("int8_bins", [False, True])
def test_partition_kernel_vs_plain(dev, int8_bins, n):
    """K4 over the int32 and int8 [F, N] stores, bitwise against its
    plain version and from run to run; leaf ids outside the table,
    non-splitting leaves, window rows and columns outside [0, F)
    included."""
    rng = np.random.RandomState(4)
    f, L = 28, 255
    gb = rng.randint(0, 250, size=(f, n)).astype(np.int32)
    bins = (gb.astype(np.int16) - 128).astype(np.int8) if int8_bins else gb
    lid = rng.randint(-1, L + 2, size=n).astype(np.int32)
    tbl = np.zeros((7, L + 1), np.float32)
    for leaf in range(0, L, 2):
        tbl[:, leaf] = (rng.randint(0, f + 1), rng.randint(0, 250),
                        rng.rand() < 0.3, rng.randint(1, L),
                        rng.randint(0, 9), rng.randint(200, 256),
                        rng.rand() < 0.5)
    args = [torch.as_tensor(x) for x in (bins, lid, tbl)]
    ref = tp.partition_rows(*args)
    before = kernels.LAUNCHES["partition_rows"]
    out = [tp.partition_rows(*[a.to(dev) for a in args]).cpu()
           for _ in range(2)]
    assert kernels.LAUNCHES["partition_rows"] == before + 2
    np.testing.assert_array_equal(out[0].numpy(), ref.numpy())
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("T,S", [(1, 255), (5, 254)])
def test_lookup_kernel_vs_plain(dev, T, S):
    rng = np.random.RandomState(T)
    t = torch.as_tensor(rng.randn(T, S).astype(np.float32))
    ids = torch.as_tensor(rng.randint(-2, S + 3, size=100_003).astype(
        np.int32))
    add = torch.as_tensor(rng.randn(T, 100_003).astype(np.float32))
    before = kernels.LAUNCHES["table_lookup"]
    out = tl.table_lookup(t.to(dev), ids.to(dev)).cpu()
    fused = tl.table_lookup(t.to(dev), ids.to(dev),
                            addend=add.to(dev)).cpu()
    assert kernels.LAUNCHES["table_lookup"] == before + 2
    np.testing.assert_array_equal(out.numpy(),
                                  tl.table_lookup(t, ids).numpy())
    np.testing.assert_array_equal(fused.numpy(),
                                  tl.table_lookup(t, ids,
                                                  addend=add).numpy())


def test_lookup_kernel_adds_into_score_row_in_place(dev):
    """K3 writing row k of a [K, N] score in place (the score add of a
    class tree): `out` is the addend's own row, the other rows stay."""
    rng = np.random.RandomState(5)
    K, S, N = 5, 255, 100_003
    t = torch.as_tensor(rng.randn(1, S).astype(np.float32))
    ids = torch.as_tensor(rng.randint(-2, S + 3, size=N).astype(np.int32))
    score = torch.as_tensor(rng.randn(K, N).astype(np.float32))
    want = score.clone()
    want[3] = tl.table_lookup(t, ids, addend=score[3:4])[0]
    got = score.to(dev)
    row = got[3:4]
    before = kernels.LAUNCHES["table_lookup"]
    res = tl.table_lookup(t.to(dev), ids.to(dev), addend=row, out=row)
    assert kernels.LAUNCHES["table_lookup"] == before + 1
    assert res.data_ptr() == row.data_ptr()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def _sparse_case(N, C, R, seed, dyadic, K=7, nbins=63):
    """Power-law ELL store with all-sentinel rows, a padded column
    (zero_bin -1, no entries), empty slots, unslotted leaves and real or
    dyadic gh; bins below `nbins`."""
    rng = np.random.RandomState(seed)
    cols = np.full((N, R), C, np.int32)
    bins = np.zeros((N, R), np.int32)
    cnt = rng.randint(0, R + 1, N)
    cnt[rng.rand(N) < 0.05] = 0                       # all-sentinel rows
    for i in np.flatnonzero(cnt):
        u = np.unique(np.minimum((C * rng.rand(cnt[i]) ** 3).astype(
            np.int64), C - 2))
        cols[i, :u.size] = u
        bins[i, :u.size] = rng.randint(0, nbins, u.size)
    zb = rng.randint(0, 3, C).astype(np.int32)
    zb[C - 1] = -1                                    # padded column
    lid = rng.randint(0, 9 if K == 7 else K + 3, N).astype(np.int32)
    m = (rng.rand(N) > 0.1).astype(np.float32)
    if dyadic:
        g = np.round(rng.randn(N) * 8) / 8
        h = np.round(rng.rand(N) * 16) / 32
    else:
        g, h = rng.randn(N), rng.rand(N)
    gh = np.stack([g * m, h * m, m]).astype(np.float32)
    sl = np.array([0, 3, -1, 8, 5, -1, 1], np.int32)  # empty slots
    if K != 7:
        sl = np.arange(K, dtype=np.int32)
        sl[1::6] = -1
    return [torch.as_tensor(x) for x in (cols, bins, zb, lid, gh, sl)]


@pytest.mark.parametrize("input_dtype,dyadic,K,B,budget,chunk", [
    ("int8", False, 7, 64, None, None),
    ("float32", False, 7, 64, None, None),
    ("float32", True, 7, 64, None, None),
    # slot tiles of 2 and columns of several chunks (the head columns
    # hold ~10k entries here)
    ("int8", False, 15, 128, 2 * 3 * 65 * 4, 1_500),
    ("float32", False, 15, 128, 2 * 3 * 65 * 4, 1_500),
    ("float32", True, 84, 256, 40 * 1024, 4_096),
])
def test_hist_sparse_kernel_vs_plain(dev, monkeypatch, input_dtype, dyadic,
                                     K, B, budget, chunk):
    if budget is not None:
        monkeypatch.setattr(ss, "SPARSE_SMEM_BUDGET", budget)
        monkeypatch.setattr(ss, "SPARSE_BLOCK_ENTRIES", chunk)
    C = 2_000
    cols, bins, zb, lid, gh, sl = _sparse_case(50_000, C, 64, 5, dyadic, K,
                                               255 if B == 256 else 63)
    kw = dict(num_columns_padded=C, num_bins_padded=B,
              input_dtype=input_dtype)
    ref = th.hist_sparse_xla(cols, bins, zb, lid, gh, sl, **kw)
    name = "hist_sparse_int8" if input_dtype == "int8" else \
        "hist_sparse_f32"
    st = ss.build_sparse_streams(cols.to(dev), bins.to(dev), C)
    plan = st.plan(ss.SPARSE_BLOCK_ENTRIES)
    if budget is not None:
        rows = 3 if input_dtype == "int8" else 4
        assert plan.n_long > 0 and ss.slot_tile(K, st.num_bins, budget,
                                                rows) < K
    before = kernels.LAUNCHES[name]
    out = th.hist_sparse_multileaf(
        (cols.to(dev), bins.to(dev), zb.to(dev), st), lid.to(dev),
        gh.to(dev), sl.to(dev), **kw).cpu()
    assert kernels.LAUNCHES[name] == before + 1
    assert not out[:, C - 1].any()                    # the padded column
    srow = th._slot_of_rows(lid, sl)
    absv = torch.stack([gh[0].abs(), gh[1].abs(), gh[2]])
    if input_dtype == "int8" or dyadic:
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
    else:
        tol = _reorder_bound(cols, bins, srow, absv, zb, K, C, B)
        assert ((out.double() - ref.double()).abs() <= tol).all()
    # the kernel against its plain version on the same pass inputs (one
    # tot tensor for both)
    srow, vals, tot, scale = th._sparse_pass(lid.to(dev), gh.to(dev),
                                             sl.to(dev), input_dtype)
    got = ss._hist_streams_cuda(st, zb.to(dev), srow, vals, tot, scale, K,
                                C, B).cpu()
    plain = ss.hist_streams_plain(st, zb.to(dev), srow, vals, tot, scale,
                                  K, C, B).cpu()
    if input_dtype == "int8" or dyadic:
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
    else:
        tol = _reorder_bound(cols, bins, srow.cpu(), absv, zb, K, C, B)
        assert ((got.double() - plain.double()).abs() <= tol).all()


def _reorder_bound(cols, bins, srow, absv, zb, K, C, B):
    """n * 2^-23 * sum|x| per stored cell (n of its entries); a zero bin
    (slot total minus the column's stored sums, each reordered on both
    sides) n * 2^-22 * sum|x| over the slot's n rows."""
    s = th._sparse_hist_plain(cols, bins, srow, absv, K, C, B).double()
    tol = s[:, :, 2:3, :] * 2.0 ** -23 * s
    tot = th._slot_totals(srow, absv, K).double()          # [K, 3]
    ok = (zb >= 0).nonzero()[:, 0]
    tol[:, ok, :, zb[ok].long()] += (tot[:, 2:3] * 2.0 ** -22 * tot)[None]
    return tol


def test_cuda_tensor_never_takes_the_plain_version(dev, monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the library
    call failing, the wrappers raise instead of falling back (K1, K2,
    K3, K5, K7/K8)."""
    def refuse(*a, **k):
        raise RuntimeError("launch refused")
    monkeypatch.setattr(kernels, "call", refuse)
    t = torch.zeros((1, 4), device=dev)
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="launch refused"):
        tl.table_lookup(t, ids)
    cols, bins, zb, lid, gh, sl = [x.to(dev) for x in _sparse_case(
        500, 40, 8, 3, False, 5)]
    for input_dtype in ("int8", "float32"):
        with pytest.raises(RuntimeError, match="launch refused"):
            th.hist_sparse_multileaf(
                (cols, bins, zb), lid, gh, sl, num_columns_padded=40,
                num_bins_padded=64, input_dtype=input_dtype)
    # K1 over the masked and the gathered feed, from the store and from
    # its byte copy; K5 over a byte feed with a live count
    gb, base, row_idx, vals = [x.to(dev) for x in _segment_case(
        1, 5, 2_000, 1_500)]
    rows = th.row_major_bins(gb, 255)
    for rd in (None, rows):
        with pytest.raises(RuntimeError, match="launch refused"):
            th.segment_counts(gb, rd, row_idx, vals, base, 256)
        with pytest.raises(RuntimeError, match="launch refused"):
            th.hist_multileaf_masked(
                gb, torch.zeros(2_000, dtype=torch.int32, device=dev),
                vals.float(), torch.zeros(1, dtype=torch.int32, device=dev),
                num_bins_padded=256, input_dtype="int8", rows=rd)
    # K2 over both feeds, from the store and from its byte copy
    fv = vals.float()
    for rd in (None, rows):
        for input_dtype in ("float32", "bfloat16"):
            with pytest.raises(RuntimeError, match="launch refused"):
                th.segment_counts(gb, rd, row_idx, fv, base, 256,
                                  round_bf16=input_dtype == "bfloat16")
            with pytest.raises(RuntimeError, match="launch refused"):
                th.hist_multileaf_masked(
                    gb, torch.zeros(2_000, dtype=torch.int32, device=dev),
                    fv, torch.zeros(1, dtype=torch.int32, device=dev),
                    num_bins_padded=256, input_dtype=input_dtype, rows=rd)
    bt, g, h, idx = [x.to(dev) for x in _gathered_case(
        1_000, 40, 7, 1_024, 900, 2, False, np.uint8)]
    with pytest.raises(RuntimeError, match="launch refused"):
        th.histogram_from_indices(bt, g, h, idx, num_bins_padded=128,
                                  count=900, num_store_bins=7)


def _gathered_case(N, F, nb, cap, live, seed, dyadic, dtype=np.int32):
    rng = np.random.RandomState(seed)
    bt = np.concatenate([rng.randint(0, nb, size=(N, F)),
                         np.zeros((1, F))]).astype(dtype)
    g, h = rng.randn(N), rng.rand(N)
    if dyadic:
        g, h = np.round(g * 64) / 64, np.round(h * 64) / 256
    g = np.concatenate([g, [0.0]]).astype(np.float32)
    h = np.concatenate([h, [0.0]]).astype(np.float32)
    idx = np.full(cap, N, np.int32)
    idx[:live] = np.sort(rng.choice(N, live, replace=False))
    return [torch.as_tensor(x) for x in (bt, g, h, idx)]


@pytest.mark.parametrize("N,F,nb,B,cap,live,dyadic,dtype,count,min_rows", [
    (100_003, 40, 7, 128, 131_072, 100_003, True, np.int32, None, None),
    (100_003, 40, 7, 128, 65_536, 60_000, False, np.int32, None, None),
    (100_003, 28, 255, 256, 131_072, 99_000, False, np.int32, None, None),
    (5_000, 300, 250, 256, 4_096, 3_000, False, np.int32, None, None),
    # the exact learner's byte feeds, with the live count
    (100_003, 40, 7, 128, 131_072, 100_003, True, np.uint8, 100_003, None),
    (100_003, 40, 7, 128, 65_536, 60_000, False, np.uint8, 60_000, None),
    (60_000, 28, 255, 256, 65_536, 60_000, True, np.uint8, 60_000, 256),
    (30_000, 12, 300, 384, 32_768, 20_000, False, np.uint16, 20_000, None),
    # 235 blocks a feature tile: the combine's two levels
    (60_000, 40, 7, 128, 65_536, 60_000, False, np.uint8, 60_000, 256),
])
def test_hist_from_indices_kernel_vs_plain(dev, monkeypatch, N, F, nb, B,
                                           cap, live, dyadic, dtype, count,
                                           min_rows):
    if min_rows is not None:
        monkeypatch.setattr(th, "K5_MIN_ROWS", min_rows)
    args = _gathered_case(N, F, nb, cap, live, N + F, dyadic, dtype)
    kw = dict(num_bins_padded=B, count=count,
              num_store_bins=nb if count is not None else None)
    ref = th.histogram_from_indices(*args, **kw)
    before = kernels.LAUNCHES["hist_gathered"]
    out = th.histogram_from_indices(*[a.to(dev) for a in args], **kw).cpu()
    again = th.histogram_from_indices(*[a.to(dev) for a in args], **kw).cpu()
    assert kernels.LAUNCHES["hist_gathered"] == before + 2
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    np.testing.assert_array_equal(out[:, 2].numpy(), ref[:, 2].numpy())
    if dyadic:
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
    else:
        bt, g, h, idx = args
        s = th.histogram_from_indices(bt, g.abs(), h, idx, **kw).double()
        tol = s[:, 2:3] * 2.0 ** -23 * s
        assert bool(((out.double() - ref.double()).abs() <= tol).all())


@pytest.mark.parametrize("input_dtype", ["float32", "bfloat16"])
def test_hist_pallas_kernel_vs_plain(dev, input_dtype):
    rng = np.random.RandomState(9)
    F, C = 11, 50_003
    gb = torch.as_tensor(rng.randint(0, 250, size=(F, C)).astype(np.int32))
    v8 = np.zeros((8, C), np.float32)
    v8[0] = np.round(rng.randn(C) * 64) / 64
    v8[1] = np.round(rng.rand(C) * 64) / 256
    v8[2] = rng.rand(C) < 0.8
    v8 = torch.as_tensor(v8)
    ref = th.hist_pallas(gb, v8, num_bins_padded=256,
                         input_dtype=input_dtype)
    out = th.hist_pallas(gb.to(dev), v8.to(dev), num_bins_padded=256,
                         input_dtype=input_dtype).cpu()
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("M,F,C,B,dyadic", [(128, 28, 200_003, 256, True),
                                            (24, 5, 30_001, 128, False),
                                            (128, 3, 20_000, 512, True),
                                            (7, 40, 50_000, 256, False),
                                            (130, 28, 100, 256, True),
                                            (33, 9, 4_099, 255, "bf16")])
def test_hist_multirow_kernel_vs_plain(dev, M, F, C, B, dyadic):
    """K6 against its plain version: bitwise on dyadic values, within
    n * 2^-23 * sum|x| a cell otherwise (and in bf16 mode, on the values
    rounded to bf16), the same bits from run to run.  The bins include
    B - 1 and values at or above B and below 0 (added nowhere); the
    shapes leave feature and value-row tiles part filled (F=40 over two
    feature tiles, M=7, 33 and 130 over row tiles), and C=100 is below
    one staged tile of positions."""
    rng = np.random.RandomState(M + F)
    gb = rng.randint(0, B, size=(F, C)).astype(np.int32)
    gb[rng.rand(F, C) < 0.02] = B - 1
    gb[rng.rand(F, C) < 0.01] = B
    gb[rng.rand(F, C) < 0.01] = B + 7
    gb[rng.rand(F, C) < 0.01] = -1
    gb = torch.as_tensor(gb)
    vals = rng.randn(M, C)
    if dyadic is True:
        vals = np.round(vals * 16) / 16
    vals = torch.as_tensor(vals.astype(np.float32))
    dt = "bfloat16" if dyadic == "bf16" else "float32"
    ref = th.hist_multileaf(gb, vals, num_bins_padded=B, input_dtype=dt)
    before = kernels.LAUNCHES["hist_multirow"]
    out = [th.hist_multileaf(gb.to(dev), vals.to(dev), num_bins_padded=B,
                             input_dtype=dt).cpu() for _ in range(2)]
    assert kernels.LAUNCHES["hist_multirow"] == before + 2
    assert torch.equal(out[0], out[1])
    if dyadic is True:
        np.testing.assert_array_equal(out[0].numpy(), ref.numpy())
    else:
        s = th.hist_multileaf(gb, vals.abs(), num_bins_padded=B,
                              input_dtype=dt).double()
        n = th.hist_multileaf(gb, torch.ones(1, C),
                              num_bins_padded=B).double()
        tol = n * 2.0 ** -23 * s
        assert bool(((out[0].double() - ref.double()).abs() <= tol).all())


def test_exact_learner_on_the_card_matches_the_cpu(dev):
    """One tree of the exact learner over a bundled store, card and CPU:
    dyadic gradients make every histogram exact, so the trees and leaf
    ids agree bitwise."""
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.dataset import Dataset
    from lightgbm_tpu_torch.learner.serial import SerialTreeLearner
    from lightgbm_tpu_torch.synth import synth_onehot
    X, y = synth_onehot(20_000)
    rng = np.random.RandomState(3)
    g = (np.round(rng.randn(20_000) * 16) / 16).astype(np.float32)
    h = (np.round(rng.rand(20_000) * 64) / 256).astype(np.float32)
    out = {}
    for d in ("cpu", "cuda"):
        cfg = config_from_params({"device_type": d, "num_leaves": 63,
                                  "min_sum_hessian_in_leaf": 1.0,
                                  "tree_growth": "exact"})
        ds = Dataset(X, y, cfg)
        assert ds.num_store_columns == 40
        tree, lid = SerialTreeLearner(ds, cfg).train(
            torch.as_tensor(g, device=d), torch.as_tensor(h, device=d))
        out[d] = (tree, lid.cpu().numpy())
    (tc, lc), (tg, lg) = out["cpu"], out["cuda"]
    n = tc.num_leaves
    assert tg.num_leaves == n
    np.testing.assert_array_equal(tg.split_feature[:n - 1],
                                  tc.split_feature[:n - 1])
    np.testing.assert_array_equal(tg.threshold_in_bin[:n - 1],
                                  tc.threshold_in_bin[:n - 1])
    np.testing.assert_array_equal(tg.leaf_value[:n], tc.leaf_value[:n])
    np.testing.assert_array_equal(lg, lc)
