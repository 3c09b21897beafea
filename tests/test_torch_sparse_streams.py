"""The column-sorted entry streams of the sparse store, and the plain
version of kernels K7/K8 over them, held against the JAX package on the
CPU.

Same seeded inputs (numpy) through both packages, on a skewed ELL store:
a head column longer than JAX's SPARSE_CHUNK, padded columns (zero_bin
-1, no entries), rows without entries, rows in no slot of the pass, rows
whose three values are zero, and empty slots.

- The streams are integers and are compared exactly: unwrapping JAX's
  `sparse_window_streams` windows (slot_col, e_row, e_flat % B, e_valid)
  gives, per column, the same (row, bin) sequence as the port's
  col_off / e_row / e_bin.
- `hist_streams_plain` against JAX's `hist_sparse_xla`: int8 bitwise
  (integer sums of the same quantized addends, one dequantizing scale);
  float32 to rtol 1e-5, atol 1e-5 (the zero bin is the slot total minus
  the column's stored sums, and torch and XLA add those sums in another
  order: a few ulps of the total, relative to the cell); with integer
  gradients every partial sum is exact and float32 is bitwise too.
- int8 against the TPU kernel itself, `hist_sparse_pallas` in interpret
  mode, bitwise.
- The kernel's work plan and slot tiles, with the block length and the
  shared-memory budget lowered through the module's constants: every
  entry in exactly one (column, chunk) work item, heaviest column first,
  every column at least once, and slot tiles within the budget covering
  every slot once.  (The kernel itself runs only on the card:
  tests/test_torch_kernels_cuda.py.)
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram as jh

from lightgbm_tpu_torch import kernels
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import sparse_streams as ss


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _skewed(N, C, R, nbins, K, seed, integer=False):
    """Power-law ELL store (column 0 in ~90% of rows), the last 3 columns
    padded, 5% of rows without entries; leaf ids with some leaves in no
    slot; gh8 with 10% all-zero rows; K slots, every sixth one empty."""
    rng = np.random.RandomState(seed)
    cols = np.full((N, R), C, np.int32)
    bins = np.zeros((N, R), np.int32)
    for i in range(N):
        if rng.rand() < 0.05:
            continue
        u = np.unique(np.minimum((C * rng.rand(R) ** 4.0).astype(np.int64),
                                 C - 4))
        if rng.rand() < 0.9:
            u = np.unique(np.concatenate([[0], u]))[:R]
        cols[i, :u.size] = u
        bins[i, :u.size] = rng.randint(0, nbins, u.size)
    zb = rng.randint(0, min(nbins, 4), C).astype(np.int32)
    zb[-3:] = -1
    lid = rng.randint(0, K + 3, N).astype(np.int32)
    gh8 = np.zeros((8, N), np.float32)
    gh8[2] = (rng.rand(N) > 0.1).astype(np.float32)
    if integer:
        gh8[0] = rng.randint(-8, 8, N) * gh8[2]
        gh8[1] = rng.randint(0, 4, N) * gh8[2]
    else:
        gh8[0] = rng.randn(N).astype(np.float32) * gh8[2]
        gh8[1] = np.abs(rng.randn(N)).astype(np.float32) * gh8[2]
    sl = np.arange(K, dtype=np.int32)
    sl[1::6] = -1
    return cols, bins, zb, lid, gh8, sl


@pytest.mark.parametrize("B,nbins", [(128, 64), (256, 256), (512, 300)])
def test_streams_match_jax_windows(B, nbins):
    N, C = 1500, 48
    cols, bins, *_ = _skewed(N, C, 16, nbins, 5, seed=B)
    er, ef, ev, sc = jh.sparse_window_streams(cols, bins, C,
                                              num_bins_padded=B)
    chunk = jh.SPARSE_CHUNK
    assert np.bincount(sc[sc < C], minlength=C).max() >= 2  # a long head
    st = ss.build_sparse_streams(_t(cols), _t(bins), C)
    assert st.e_bin.dtype == (torch.uint8 if nbins <= 256 else torch.uint16)
    assert st.num_bins == int(bins[cols < C].max()) + 1
    col_off = st.col_off.numpy()
    assert col_off[-1] == (cols < C).sum()
    # JAX's windows, unwrapped: slot s is the segment [(s % W) * chunk,
    # ...) of window s // W, its entries front-packed; a column's slots
    # are consecutive
    W = er.shape[1] // chunk
    for c in range(C):
        rows, bns = [], []
        for s in np.flatnonzero(sc == c):
            seg = slice((s % W) * chunk, (s % W + 1) * chunk)
            v = ev[s // W, seg] > 0
            rows.append(er[s // W, seg][v])
            bns.append(ef[s // W, seg][v] % B)
        rows = np.concatenate(rows) if rows else np.zeros(0, np.int32)
        bns = np.concatenate(bns) if bns else np.zeros(0, np.int32)
        lo, hi = col_off[c], col_off[c + 1]
        np.testing.assert_array_equal(st.e_row[lo:hi].numpy(), rows,
                                      err_msg=f"rows of column {c}")
        np.testing.assert_array_equal(st.e_bin[lo:hi].long().numpy(), bns,
                                      err_msg=f"bins of column {c}")
    cnt = np.diff(col_off)
    np.testing.assert_array_equal(st.order.numpy(),
                                  np.argsort(-cnt, kind="stable"))


@pytest.mark.parametrize("input_dtype,gh", [
    ("int8", "real"), ("float32", "real"), ("float32", "integer")])
@pytest.mark.parametrize("K,B", [(1, 128), (15, 128), (15, 256),
                                 (84, 256)])
def test_streams_plain_vs_jax_xla(K, B, input_dtype, gh):
    N, C = 1200, 40
    cols, bins, zb, lid, gh8, sl = _skewed(N, C, 12, B, K, seed=K + B,
                                           integer=gh == "integer")
    ref = np.asarray(jh.hist_sparse_xla(
        *[jnp.asarray(a) for a in (cols, bins, zb, lid, gh8, sl)],
        num_columns_padded=C, num_bins_padded=B, input_dtype=input_dtype))
    st = ss.build_sparse_streams(_t(cols), _t(bins), C)
    srow, vals, tot, scale = th._sparse_pass(_t(lid), _t(gh8[:3]), _t(sl),
                                             input_dtype)
    kernels.reset_launches()
    out = ss.hist_streams(st, _t(zb), srow, vals, tot, scale, K, C,
                          B).numpy()
    assert sum(kernels.LAUNCHES.values()) == 0       # a CPU tensor
    assert out.dtype == np.float32 and out.shape == (K, C, 3, B)
    assert not out[:, -3:].any()                     # padded columns
    assert not out[sl < 0].any()                     # empty slots
    if input_dtype == "int8" or gh == "integer":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # the pass through the store tuple with the streams attached (the
    # CPU takes the ELL formulation) agrees as well
    full = th.hist_sparse_multileaf(
        (_t(cols), _t(bins), _t(zb), st), _t(lid), _t(gh8[:3]), _t(sl),
        num_columns_padded=C, num_bins_padded=B,
        input_dtype=input_dtype).numpy()
    if input_dtype == "int8" or gh == "integer":
        np.testing.assert_array_equal(full, out)
    else:
        np.testing.assert_allclose(full, out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K", [1, 15, 84])
def test_streams_plain_int8_vs_pallas_interpret(K):
    N, C, B = 1000, 32, 128
    cols, bins, zb, lid, gh8, sl = _skewed(N, C, 8, 64, K, seed=3 * K)
    er, ef, ev, sc = jh.sparse_window_streams(cols, bins, C,
                                              num_bins_padded=B)
    assert np.bincount(sc[sc < C], minlength=C).max() >= 2
    ref = np.asarray(jh.hist_sparse_pallas(
        *[jnp.asarray(a) for a in (er, ef, ev, sc, zb, lid, gh8, sl)],
        num_columns_padded=C, num_bins_padded=B, input_dtype="int8",
        interpret=True))
    st = ss.build_sparse_streams(_t(cols), _t(bins), C)
    srow, vals, tot, scale = th._sparse_pass(_t(lid), _t(gh8[:3]), _t(sl),
                                             "int8")
    out = ss.hist_streams_plain(st, _t(zb), srow, vals, tot, scale, K, C, B)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("K,B", [(1, 128), (15, 128), (84, 256)])
def test_work_plan_and_slot_tiles(monkeypatch, K, B):
    N, C = 1500, 40
    cols, bins, *_ = _skewed(N, C, 12, B, K, seed=7)
    chunk = 200
    monkeypatch.setattr(ss, "SPARSE_BLOCK_ENTRIES", chunk)
    monkeypatch.setattr(ss, "SPARSE_SMEM_BUDGET", 4 * 3 * 257 * 4)
    st = ss.build_sparse_streams(_t(cols), _t(bins), C)
    plan = st.plan(ss.SPARSE_BLOCK_ENTRIES)
    col_off = st.col_off.numpy()
    cnt = np.diff(col_off)
    assert cnt.max() > 3 * chunk                     # a column in chunks
    w_col, w_chunk = plan.w_col.numpy(), plan.w_chunk.numpy()
    # heaviest column first; every column, empty ones too
    assert np.all(np.diff(cnt[w_col]) <= 0)
    assert set(w_col) == set(range(C))
    covered = np.zeros(col_off[-1], np.int64)
    for c, j in zip(w_col, w_chunk):
        lo = col_off[c] + j * chunk
        hi = min(lo + chunk, col_off[c + 1])
        assert lo < hi or (j == 0 and cnt[c] == 0)
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)        # each entry once
    # the chunked columns and their scratch parts
    nch = np.maximum(1, -(-cnt // chunk))
    c_long = plan.c_long.numpy()
    assert plan.n_long == (nch > 1).sum() == (c_long >= 0).sum()
    assert plan.n_parts == nch[nch > 1].sum()
    base = plan.long_base.numpy()
    for c in np.flatnonzero(nch > 1):
        li = c_long[c]
        assert base[li] == nch[nch > 1][:li].sum()
    # slot tiles: within the budget, every slot in exactly one tile
    nb = min(st.num_bins, B)
    for rows in (3, 6):             # grad, hess, count; twice as wide
        k_tile = ss.slot_tile(K, nb, ss.SPARSE_SMEM_BUDGET, rows)
        assert k_tile * rows * (nb | 1) * 4 <= max(ss.SPARSE_SMEM_BUDGET,
                                                   rows * (nb | 1) * 4)
        tiles = [range(k0, min(K, k0 + k_tile))
                 for k0 in range(0, K, k_tile)]
        assert sorted(k for t in tiles for k in t) == list(range(K))
        # tiles of equal size, the last one at most as large
        assert len(tiles[0]) - len(tiles[-1]) < len(tiles)
        if K == 84:
            assert len(tiles) > 1
        with pytest.raises(ValueError, match="bins"):
            ss.slot_tile(K, 20_000, ss.SPARSE_SMEM_BUDGET, rows)
