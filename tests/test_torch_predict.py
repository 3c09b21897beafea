"""The port's ensemble predictors (lightgbm_tpu_torch/ops/predict.py),
held against the JAX package's on the CPU.

- Random trees (tests/test_predict_kernel.py `_rand_tree`), built as JAX
  Trees and carried across with `convert.trees_from_numpy`: numerical
  and categorical splits, NaN rows, stumps, multiclass K=3 with an empty
  class, both layouts (perfect, soa), the raw, binned, sparse-binned,
  leaf and leaf-binned walks, and the grouped (stacked and segment)
  walks.
- Leaf indices are bitwise JAX's.  Sums are bitwise on dyadic leaf
  values, else within T * 2^-23 * sum|leaf| a row (the f32 reordering
  bound: XLA's CPU reduction order is not reproduced).
- Inside the port: walk and tensorized, perfect and soa, binned and raw,
  grouped and solo are bitwise equal on any leaf values (every tree sum
  is `_tree_sum`, fixed by the tree count alone).
- Trained models: `Booster.predict` (values, raw scores, pred_leaf) on
  the device path against the JAX package's device path, binary and
  multiclass on the ROADMAP §C probe data; the tensorized `add_trees`
  replay of a continued run against the walk replay, on the dense and
  the sparse store.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lj
from lightgbm_tpu.ops import predict as JP
from lightgbm_tpu.tree import (CATEGORICAL_DECISION, NUMERICAL_DECISION,
                               Tree as JTree)

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import (TREE_FIELDS,
                                        booster_from_model_string,
                                        trees_from_numpy)
from lightgbm_tpu_torch.ops import predict as TP

CPU = torch.device("cpu")


def _rand_tree(rng, F, leaves=31, maxdepth=6, cat_frac=0.0, dyadic=False,
               nbins=0):
    """tests/test_predict_kernel.py's fixture; with `nbins`, thresholds
    are also random bins below it (the binned walks)."""
    t = JTree(leaves)
    while t.num_leaves < leaves:
        cand = [l for l in range(t.num_leaves) if t.leaf_depth[l] < maxdepth]
        if not cand:
            break
        leaf = int(rng.choice(cand))
        f = int(rng.randint(F))
        if rng.rand() < cat_frac:
            bt, thr = CATEGORICAL_DECISION, float(rng.randint(4))
            tb = int(thr)
        else:
            bt, thr = NUMERICAL_DECISION, float(rng.rand())
            tb = int(rng.randint(nbins)) if nbins else int(thr)
        if dyadic:
            lv = float(rng.randint(-16, 16)) / 16.0
            rv = float(rng.randint(-16, 16)) / 16.0
        else:
            lv, rv = float(rng.randn() * 0.1), float(rng.randn() * 0.1)
        t.split(leaf, f, bt, tb, f, thr, lv, rv, 10, 10, 1.0)
    return t


def _stump(value):
    t = JTree(2)
    t.leaf_value[0] = value
    return t


def _port(tbc):
    """JAX trees by class -> the port's Trees by class."""
    def one(t):
        d = {n: getattr(t, n) for n in TREE_FIELDS}
        d.update(max_leaves=t.max_leaves, num_leaves=t.num_leaves,
                 shrinkage=t.shrinkage, has_categorical=t.has_categorical)
        return trees_from_numpy([d])[0]
    return [[one(t) for t in trees] for trees in tbc]


def _bound(tbc, K, X=None):
    """T * 2^-23 * sum|leaf| a row, per class (max |leaf| per tree)."""
    out = np.zeros(K)
    for k, trees in enumerate(tbc):
        s = sum(float(np.abs(t.leaf_value[:t.num_leaves]).max())
                for t in trees)
        out[k] = len(trees) * 2.0 ** -23 * s
    return out[:, None]


def _jax_any(tbc, X, layout="auto"):
    stack, meta = JP.build_ensemble(tbc, binned=False, layout=layout)
    out = JP.predict_ensemble_any(jax.device_put(stack), jnp.asarray(X),
                                  meta=meta)
    return np.asarray(out), stack


def _port_any(tbc, X, layout="auto"):
    stack, meta = TP.build_ensemble(_port(tbc), binned=False, layout=layout)
    out = TP.predict_ensemble_any(TP.to_device(stack, CPU),
                                  torch.as_tensor(X), meta=meta)
    return out.numpy(), stack


def _port_walk(tbc, X):
    stacks, depths = [], []
    for trees in _port(tbc):
        stacks.append(TP.to_device(TP.stack_trees(trees, binned=False), CPU)
                      if trees else None)
        depths.append(max(max((t.max_depth_grown for t in trees),
                              default=1), 1))
    return TP.ensemble_raw(stacks, torch.as_tensor(X),
                           depths=tuple(depths)).numpy()


def _jax_walk(tbc, X):
    stacks, depths = [], []
    for trees in tbc:
        if not trees:
            stacks.append(None)
            depths.append(1)
            continue
        stacks.append(jax.device_put(JP.stack_trees(trees, binned=False)))
        depths.append(max(max(t.max_depth_grown for t in trees), 1))
    return np.asarray(JP.ensemble_raw(stacks, jnp.asarray(X),
                                      depths=tuple(depths)))


CASES = {
    # name: (seed, F, trees by class, X maker)
    "numerical": dict(F=12, K=1, n=40),
    "categorical": dict(F=6, K=1, n=8, cat_frac=0.4),
    "deep": dict(F=9, K=1, n=7, leaves=40, maxdepth=30),
    "multiclass": dict(F=8, K=3, n=5),
}


def _case(name, dyadic):
    c = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name) + 10 * dyadic)
    F, K = c["F"], c["K"]
    tbc = [[_rand_tree(rng, F, leaves=c.get("leaves", 31),
                       maxdepth=c.get("maxdepth", 6),
                       cat_frac=c.get("cat_frac", 0.0), dyadic=dyadic)
            for _ in range(c["n"])] for _ in range(K)]
    if K == 3:
        tbc[1].insert(1, _stump(0.625))      # a stump mid-class
        tbc[2] = []                          # an untrained class
    if c.get("cat_frac"):
        X = np.floor(rng.rand(300, F) * 5).astype(np.float32)
    else:
        X = rng.rand(301, F).astype(np.float32)
    X[5, 3] = np.nan                          # NaN falls right
    X[7, :] = np.nan
    return tbc, X, K


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "real"])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("layout", ["auto", "soa"])
def test_raw_walks_match_jax(name, dyadic, layout):
    tbc, X, K = _case(name, dyadic)
    got, st = _port_any(tbc, X, layout)
    ref, jst = _jax_any(tbc, X, layout)
    # the layout choice is JAX's
    assert (isinstance(st, TP.PerfectEnsemble)
            == isinstance(jst, JP.PerfectEnsemble))
    assert got.shape == ref.shape == (K, X.shape[0])
    if dyadic:
        assert np.array_equal(got, ref)
    else:
        assert np.all(np.abs(got - ref) <= _bound(tbc, K))
    # the walk kernel: JAX's within the same bound, the port's tensorized
    # one bitwise on any values
    walk = _port_walk(tbc, X)
    assert np.array_equal(walk, got)
    jwalk = _jax_walk(tbc, X)
    if dyadic:
        assert np.array_equal(walk, jwalk)
    else:
        assert np.all(np.abs(walk - jwalk) <= _bound(tbc, K))
    if K == 3:
        assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("name", ["deep", "multiclass", "numerical"])
def test_perfect_and_soa_bitwise_in_port(name):
    """(Categorical ensembles have no perfect layout.)"""
    tbc, X, _ = _case(name, False)
    a, sa = _port_any(tbc, X, "perfect")
    b, sb = _port_any(tbc, X, "soa")
    assert isinstance(sa, TP.PerfectEnsemble)
    assert isinstance(sb, TP.EnsembleStack)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_leaf_indices_bitwise(name):
    tbc, X, _ = _case(name, False)
    # one tree a class, in model order, as the pred_leaf path builds it
    flat = [[t] for trees in tbc for t in trees]
    js, jm = JP.stack_ensemble(flat, binned=False)
    ref = np.asarray(JP.predict_ensemble_leaf(jax.device_put(js),
                                              jnp.asarray(X), meta=jm))
    ts, tm = TP.stack_ensemble(_port(flat), binned=False)
    got = TP.predict_ensemble_leaf(TP.to_device(ts, CPU),
                                   torch.as_tensor(X), meta=tm).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)
    # and the host walk's
    host = np.stack([t.predict_leaf_index(X.astype(np.float64))
                     for trees in _port(flat) for t in trees])
    assert np.array_equal(got, host)


def test_stack_fields_match_jax():
    """The SoA stack holds JAX's packed record, a field an array."""
    tbc, _, _ = _case("categorical", False)
    js, jm = JP.stack_ensemble(tbc, binned=False)
    ts, tm = TP.stack_ensemble(_port(tbc), binned=False)
    for lane, name in enumerate(("feature", "threshold", "decision",
                                 "left", "right")):
        assert np.array_equal(getattr(ts, name), js.nodes[..., lane]), name
    assert np.array_equal(ts.leaf_value, js.leaf_value)
    assert np.array_equal(ts.root, js.root)
    assert (tm.depth, tm.num_class, tm.any_cat) == tuple(jm)


def test_build_ensemble_layout_choice():
    rng = np.random.RandomState(5)
    shallow = [[_rand_tree(rng, 5, leaves=15, maxdepth=4)
                for _ in range(6)]]
    cat = [[_rand_tree(rng, 5, cat_frac=0.5) for _ in range(3)]]
    # past PERFECT_SLOT_BUDGET: T << depth slots
    deep = [[_rand_tree(rng, 5, leaves=30, maxdepth=30) for _ in range(2)]]
    for tbc in (shallow, cat, deep):
        _, jst = _jax_any(tbc, rng.rand(4, 5).astype(np.float32))
        st, _ = TP.build_ensemble(_port(tbc))
        assert type(st).__name__ == type(jst).__name__
    with pytest.raises(ValueError, match="numerical"):
        TP.build_ensemble(_port(cat), layout="perfect")
    with pytest.raises(ValueError, match="layout"):
        TP.build_ensemble(_port(shallow), layout="bogus")


def test_tree_sum_order_is_fixed_and_padding_free():
    rng = np.random.RandomState(1)
    v = torch.as_tensor(rng.randn(13, 7).astype(np.float32))
    s = TP._tree_sum(v)
    # adjacent pairs, level by level
    ref = v.clone()
    while ref.shape[0] > 1:
        if ref.shape[0] % 2:
            ref = torch.cat([ref, torch.full((1, 7), -0.0)])
        ref = ref[0::2] + ref[1::2]
    assert torch.equal(s, ref[0])
    # a tail of -0.0 changes no bit; a slice of a wider tensor, none
    pad = torch.cat([v, torch.full((19, 7), -0.0)])
    assert torch.equal(TP._tree_sum(pad), s)
    wide = torch.as_tensor(rng.randn(40, 7).astype(np.float32))
    wide[3:16] = v
    assert torch.equal(TP._tree_sum(wide[3:16]), s)
    assert torch.equal(TP._tree_sum(v[:, 2:5]), s[2:5])
    assert torch.equal(TP._tree_sum(v[:0]), torch.zeros(7))


# -- binned walks ---------------------------------------------------------

B = 16


def _binned_case(K, seed, cat_frac=0.0):
    rng = np.random.RandomState(seed)
    F = 7
    tbc = [[_rand_tree(rng, F, leaves=21, cat_frac=cat_frac, nbins=B)
            for _ in range(6)] for _ in range(K)]
    bins = rng.randint(0, B, size=(257, F)).astype(np.int32)
    return tbc, bins


def _sparse_of(bins_nc):
    """The ELL triple of a dense [N, C] bin matrix with zero bin 0."""
    N, C = bins_nc.shape
    nz = bins_nc != 0
    R = int(max(nz.sum(1).max(), 1))
    cols = np.full((N, R), C, np.int32)
    vals = np.zeros((N, R), np.int32)
    for i in range(N):
        c = np.nonzero(nz[i])[0]
        cols[i, :len(c)] = c
        vals[i, :len(c)] = bins_nc[i, c]
    return cols, vals, np.zeros(C, np.int32)


@pytest.mark.parametrize("K,cat", [(1, 0.0), (3, 0.0), (1, 0.3)],
                         ids=["k1", "k3", "categorical"])
def test_binned_walks_match_jax(K, cat):
    tbc, bins = _binned_case(K, 3 + K, cat)
    js, jm = JP.stack_ensemble(tbc, binned=True)
    js = jax.device_put(js)
    jb = jnp.asarray(np.vstack([bins, np.zeros((1, bins.shape[1]),
                                               np.int32)]))
    ref = np.asarray(JP.predict_ensemble_binned(js, jb, meta=jm))
    ref_leaf = np.asarray(JP.predict_ensemble_leaf_binned(js, jb, meta=jm))
    ts, tm = TP.stack_ensemble(_port(tbc), binned=True)
    ts = TP.to_device(ts, CPU)
    store = torch.as_tensor(np.ascontiguousarray(bins.T))    # [C, N]
    got = TP.predict_ensemble_binned(ts, store, meta=tm).numpy()
    leaf = TP.predict_ensemble_leaf_binned(ts, store, meta=tm).numpy()
    assert np.array_equal(leaf, ref_leaf)
    assert np.all(np.abs(got - ref) <= _bound(tbc, K))
    # the rounds learner's int8 byte store (value - 128) reads the same
    b8 = torch.as_tensor((bins.T - 128).astype(np.int8))
    assert np.array_equal(
        TP.predict_ensemble_binned(ts, b8, meta=tm).numpy(), got)
    # sparse: JAX's, and bitwise the port's dense
    cols, vals, zb = _sparse_of(bins)
    jsp = np.asarray(JP.predict_ensemble_binned_sparse(
        js, jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(zb),
        meta=jm))
    tsp = TP.predict_ensemble_binned_sparse(
        ts, torch.as_tensor(cols), torch.as_tensor(vals),
        torch.as_tensor(zb), meta=tm).numpy()
    assert np.array_equal(tsp, got)
    assert np.all(np.abs(tsp - jsp) <= _bound(tbc, K))
    assert np.array_equal(
        TP.predict_ensemble_leaf_binned(
            ts, tuple(torch.as_tensor(a) for a in (cols, vals, zb)),
            meta=tm).numpy(), ref_leaf)
    # the request-buffer form ([N, F] uint8) walks the same routes
    q = TP.predict_ensemble_quantized(
        ts, torch.as_tensor(bins.astype(np.uint8)), meta=tm).numpy()
    jq = np.asarray(JP.predict_ensemble_quantized(
        js, jnp.asarray(bins.astype(np.uint8)), meta=jm))
    assert np.array_equal(q, got)
    assert np.all(np.abs(q - jq) <= _bound(tbc, K))


def test_binned_perfect_equals_binned_soa():
    tbc, bins = _binned_case(1, 11)
    Xb = torch.as_tensor(bins.astype(np.uint8))
    out = []
    for layout in ("perfect", "soa"):
        st, meta = TP.build_ensemble(_port(tbc), binned=True, layout=layout)
        out.append(TP.predict_ensemble_quantized(TP.to_device(st, CPU), Xb,
                                                 meta=meta).numpy())
    assert np.array_equal(out[0], out[1])


def test_efb_remap_matches_jax():
    """The binned walk through an EFB feature table: a trained bundled
    model replayed onto its own store, port against JAX."""
    rng = np.random.RandomState(2)
    n = 1500
    X = np.zeros((n, 9))
    grp = rng.randint(0, 6, size=n)
    X[np.arange(n), grp] = 1.0                  # six exclusive one-hots
    X[:, 6:] = rng.randn(n, 3)
    y = (grp % 2 + X[:, 6] > 0.5) * 1.0
    p = {"objective": "binary", "num_leaves": 7, "enable_bundle": True,
         "verbose": -1, "min_data_in_leaf": 5}
    bj = lj.train(p, lj.Dataset(X, y, params=p), 4)
    ds = lt.Dataset(X, y, params=dict(p, device_type="cpu")).construct()
    inner = ds._inner
    assert inner.bundle_plan is not None
    trees = booster_from_model_string(bj.model_to_string(),
                                      device="cpu")._gbdt.models
    for t in trees:
        t.rebin_to_dataset(inner)
    st, meta = TP.stack_ensemble([trees], binned=True)
    ft = torch.as_tensor(inner.bundle_feat_table(), dtype=torch.float32)
    got = TP.predict_ensemble_binned(
        TP.to_device(st, CPU), torch.as_tensor(inner.bins.astype(np.int32)),
        ft, meta=meta).numpy()
    host = sum(t.predict_raw(X) for t in trees)
    np.testing.assert_allclose(got[0], host, rtol=0, atol=1e-5)


# -- grouped walks ----------------------------------------------------------

def _tenants(K, seed, dyadic=False):
    rng = np.random.RandomState(seed)
    F = 6
    sizes = [(5, 15, 4), (9, 31, 6), (3, 7, 3)]
    tenants = [[[_rand_tree(rng, F, leaves=lv, maxdepth=md, dyadic=dyadic)
                 for _ in range(n)] for _ in range(K)]
               for n, lv, md in sizes]
    if K == 3:
        tenants[2][0].append(_stump(-0.25))
    X = rng.rand(97, F).astype(np.float32)
    X[4, 2] = np.nan
    tids = rng.randint(0, len(tenants), size=97)
    return tenants, X, tids


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("binned", [False, True], ids=["raw", "binned"])
def test_grouped_bitwise_solo_and_jax(K, binned):
    tenants, X, tids = _tenants(K, 20 + K)
    ports = [_port(tbc) for tbc in tenants]
    if binned:
        # random trees whose thresholds are bins: request bins of X
        Xin = np.floor(X * B).astype(np.float32)
        Xin[np.isnan(Xin)] = B                      # the missing sentinel
        for tbc in ports:
            for trees in tbc:
                for t in trees:
                    k = t.num_leaves - 1
                    t.split_feature_inner[:k] = t.split_feature[:k]
                    t.threshold_in_bin[:k] = np.floor(
                        t.threshold[:k] * B).astype(np.int64)
        Xin = torch.as_tensor(Xin.astype(np.uint8))
    else:
        Xin = torch.as_tensor(X)
    gs, gm = TP.stack_ensemble_group(ports, binned=binned)
    gs = TP.to_device(gs, CPU)
    tt = torch.as_tensor(tids)
    if binned:
        stacked = TP.predict_ensemble_grouped_binned(gs, Xin, tt, meta=gm)
        seg = TP.predict_ensemble_grouped_segment_binned(gs, Xin, tt,
                                                         meta=gm)
    else:
        stacked = TP.predict_ensemble_grouped(gs, Xin, tt, meta=gm)
        seg = TP.predict_ensemble_grouped_segment(gs, Xin, tt, meta=gm)
    stacked, seg = stacked.numpy(), seg.numpy()
    assert np.array_equal(stacked, seg)
    for g, tbc in enumerate(ports):
        rows = np.nonzero(tids == g)[0]
        st, meta = TP.stack_ensemble(tbc, binned=binned)
        st = TP.to_device(st, CPU)
        sub = Xin[torch.as_tensor(rows)]
        solo = (TP.predict_ensemble_quantized(st, sub, meta=meta) if binned
                else TP.predict_ensemble(st, sub, meta=meta)).numpy()
        # bitwise per-tenant dispatch, real leaf values, another row count
        assert np.array_equal(stacked[:, rows], solo), g
    if not binned:
        js, jmeta = JP.stack_ensemble_group(tenants, binned=False)
        js = jax.device_put(js)
        ref = np.asarray(JP.predict_ensemble_grouped(
            js, jnp.asarray(X), jnp.asarray(tids), meta=jmeta))
        ref_seg = np.asarray(JP.predict_ensemble_grouped_segment(
            js, jnp.asarray(X), jnp.asarray(tids), meta=jmeta))
        bound = np.stack([_bound(tbc, K)[:, 0] for tbc in tenants])
        per_row = bound[tids].T
        assert np.all(np.abs(stacked - ref) <= per_row)
        assert np.all(np.abs(seg - ref_seg) <= per_row)


def test_grouped_dyadic_bitwise_jax():
    tenants, X, tids = _tenants(1, 31, dyadic=True)
    js, jm = JP.stack_ensemble_group(tenants, binned=False)
    ref = np.asarray(JP.predict_ensemble_grouped(
        jax.device_put(js), jnp.asarray(X), jnp.asarray(tids), meta=jm))
    ts, tm = TP.stack_ensemble_group([_port(t) for t in tenants])
    got = TP.predict_ensemble_grouped(TP.to_device(ts, CPU),
                                      torch.as_tensor(X),
                                      torch.as_tensor(tids), meta=tm)
    assert np.array_equal(got.numpy(), ref)
    assert tm.segments == jm.segments


def test_grouped_refuses_mixed_class_counts():
    a = _port([[_stump(1.0)]])
    b = _port([[_stump(1.0)], [_stump(2.0)]])
    with pytest.raises(ValueError, match="num_class"):
        TP.stack_ensemble_group([a, b])
    with pytest.raises(ValueError, match="at least one tree"):
        TP.stack_ensemble_group([a, [[]]])


def test_resolve_dials():
    assert TP.resolve_predict_kernel() == "tensorized"
    assert TP.resolve_predict_kernel("walk") == "walk"
    with pytest.raises(ValueError):
        TP.resolve_predict_kernel("bogus")
    assert TP.resolve_costack_kernel(device_type="cpu") == "segment"
    assert TP.resolve_costack_kernel(total_trees=10) == "stacked"
    assert TP.resolve_costack_kernel(total_trees=5000) == "segment"
    assert TP.resolve_costack_kernel(total_trees=10,
                                     segment_trees=8) == "segment"
    assert TP.resolve_costack_kernel("stacked", device_type="cpu") == \
        "stacked"


# -- trained models ---------------------------------------------------------

def _probe(multiclass):
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 5)
    if multiclass:
        y = np.digitize(X[:, 0] + 0.3 * rng.randn(2000), [-0.5, 0.5]) * 1.0
    else:
        y = (X[:, 0] + 0.3 * rng.randn(2000) > 0) * 1.0
    Xv = rng.randn(500, 5)
    Xv[3, 1] = np.nan
    p = {"objective": "multiclass" if multiclass else "binary",
         "num_leaves": 7, "verbose": -1}
    if multiclass:
        p["num_class"] = 3
    return X, y, Xv, p


@pytest.fixture
def device_predict(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "1")


@pytest.mark.parametrize("kernel", ["auto", "walk"])
@pytest.mark.parametrize("multiclass", [False, True],
                         ids=["binary", "multiclass"])
def test_booster_predict_device_path(device_predict, monkeypatch, multiclass,
                                     kernel):
    X, y, Xv, p = _probe(multiclass)
    p = dict(p, predict_kernel=kernel)
    bj = lj.train(p, lj.Dataset(X, y, params=p), 8)
    bt = lt.Booster(params=dict(p, device_type="cpu"),
                    model_str=bj.model_to_string())
    raw_j = bj.predict(Xv, raw_score=True)
    raw_t = bt.predict(Xv, raw_score=True)
    trees = bt._gbdt.models
    K = 3 if multiclass else 1
    bound = np.asarray([len(trees) * 2.0 ** -23 * sum(
        float(np.abs(t.leaf_value[:t.num_leaves]).max()) for t in trees)])
    assert raw_t.shape == raw_j.shape
    assert np.all(np.abs(raw_t - raw_j) <= bound)
    # f32 compares against the host f64 walk's
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "0")
    host = bt.predict(Xv, raw_score=True)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "1")
    np.testing.assert_allclose(raw_t, host, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=1e-5)
    leaf_t = bt.predict(Xv, pred_leaf=True)
    leaf_j = bj.predict(Xv, pred_leaf=True)
    assert leaf_t.shape == (len(Xv), len(trees))
    assert np.array_equal(leaf_t, leaf_j)
    assert K == (raw_t.shape[1] if raw_t.ndim == 2 else 1)


@pytest.mark.parametrize("change", ["rollback", "early_stopping",
                                    "load_model"])
def test_device_predict_follows_model_changes(monkeypatch, change):
    """The device path's cached stacks never outlive the trees they were
    built from: after trees are rolled back, trimmed by early stopping or
    replaced by a loaded model, and the tree count is back where it was,
    Booster.predict answers for the current trees (the host walk's)."""
    X, y, Xv, p = _probe(False)
    q = dict(p, device_type="cpu", early_stopping_round=2)
    bst = lt.Booster(params=q, train_set=lt.Dataset(X, y, params=q))
    g = bst._gbdt
    if change == "early_stopping":
        bst.update()
        bst.update()
        g.eval_and_check_early_stopping([("v", "auc", 1.0, True)])
    for _ in range(4 if change != "early_stopping" else 2):
        bst.update()
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "1")
    before = bst.predict(Xv, raw_score=True)
    n = bst.num_trees()
    if change == "rollback":
        bst.rollback_one_iter()
        bst.reset_parameter({"learning_rate": 0.5})
        bst.update()
    elif change == "early_stopping":
        # best at iteration 2: the last two trees go, two others grow
        assert g.eval_and_check_early_stopping([("v", "auc", 0.5, True)])
        bst.update()
        bst.update()
    else:
        q2 = dict(q, learning_rate=0.5)
        other = lt.train(q2, lt.Dataset(X, y, params=q2), 4)
        g.load_model_from_string(other.model_to_string())
    assert bst.num_trees() == n
    dev = bst.predict(Xv, raw_score=True)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "0")
    host = bst.predict(Xv, raw_score=True)
    assert np.abs(host - before).max() > 1e-3
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)


def test_device_predict_gate_and_chunks(monkeypatch):
    """The work gate, and a chunked run equal to a one-chunk run."""
    X, y, Xv, p = _probe(False)
    bt = lt.train(dict(p, device_type="cpu"),
                  lt.Dataset(X, y, params=dict(p, device_type="cpu")), 6)
    g = bt._gbdt
    assert not g._use_device_predict(100, 6)
    assert g._use_device_predict(400_000, 6)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "1")
    one = bt.predict(Xv, raw_score=True)
    monkeypatch.setattr(type(g), "_PREDICT_CHUNK", 64)
    assert np.array_equal(bt.predict(Xv, raw_score=True), one)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "0")
    assert not g._use_device_predict(10 ** 9, 6)


@pytest.mark.parametrize("store", ["dense", "csr"])
def test_tensorized_replay_of_continued_run(store):
    """A continued run (init_model) replays the loaded model onto the
    training and valid scores: tensorized against the walk."""
    rng = np.random.RandomState(4)
    X = rng.randn(1200, 6)
    X[rng.rand(*X.shape) < 0.6] = 0.0
    y = (X[:, 0] - X[:, 1] + 0.2 * rng.randn(1200) > 0) * 1.0
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "device_type": "cpu", "sparse_store": store, "min_data_in_leaf": 5}
    base = lt.train(p, lt.Dataset(X, y, params=p), 6)
    model = base.model_to_string()
    scores = {}
    for kernel in ("walk", "tensorized"):
        q = dict(p, predict_kernel=kernel)
        ds = lt.Dataset(X, y, params=q)
        vs = lt.Dataset(X[:300], y[:300], reference=ds, params=q)
        init = lt.Booster(params=q, model_str=model)
        bst = lt.Booster(params=q, train_set=ds)
        ds.construct(q)
        if store == "csr":
            assert ds._inner.sparse is not None
        bst._gbdt.models = init._gbdt.models
        bst._gbdt.reset_training_data(ds._inner)
        bst.add_valid(vs, "v")
        g = bst._gbdt
        scores[kernel] = (g.train_score.get(), g.valid_sets[0][2].get())
    for a, b in zip(scores["walk"], scores["tensorized"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    host = lt.Booster(params=p, model_str=model).predict(X,
                                                         raw_score=True)
    np.testing.assert_allclose(scores["tensorized"][0][0], host, rtol=0,
                               atol=1e-5)
