"""GOSS, DART, rollback and the rounds learner's training walk of the
port, held against the JAX package on the CPU.

- `prng` draws the bits of `jax.random` (threefry2x32, partitionable
  counters): keys, splits and uniforms bitwise.
- GOSS's selection (`_goss_select`) is bitwise JAX's, ties in |g*h|
  included: both keep the lower index first among equal values.
- GOSS and DART (uniform, weighted, xgboost mode) train the same trees as
  the JAX package on the rounds learner: structures equal, leaf values
  within rtol 1e-4 (the tolerance of tests/test_torch_slice.py: float32
  sums added in another order move a small leaf by up to ~1e-5
  relative).
- The rounds learner's store, walked over the training rows, puts every
  row in the leaf its leaf id names: the walked score add is bitwise the
  add by leaf id, over the int8 store, the int32 store past 256 bins,
  the sparse ELL store and an EFB-bundled store.
- rollback_one_iter takes the same trees off the training and valid
  scores as the JAX package's, within 1e-6.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lj
from lightgbm_tpu.boosting.goss import _goss_select as j_goss_select

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import prng
from lightgbm_tpu_torch.boosting.goss import _goss_select as t_goss_select
from lightgbm_tpu_torch.boosting.score_updater import (
    ScoreUpdater, traverse_tree_device)

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.5,
        "min_data_in_leaf": 5, "verbose": -1, "tree_growth": "rounds"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread (tests/test_torch_slice.py
    `one_torch_thread`: a worker thread's CPU exp can round differently)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def probe():
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 8)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(2000) > 0) * 1.0
    Xv = rng.randn(500, 8)
    yv = (Xv[:, 0] + 0.5 * Xv[:, 1] > 0) * 1.0
    return X, y, Xv, yv


def _train(pkg, params, X, y, rounds, valid=None):
    if pkg is lt:
        params = dict(params, device_type="cpu")
    ds = pkg.Dataset(X, y, params=params)
    vs = ([] if valid is None
          else [pkg.Dataset(valid[0], valid[1], reference=ds, params=params)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pkg.train(params, ds, rounds, valid_sets=vs or None,
                         verbose_eval=False)


def assert_same_trees(models_t, models_j, rtol=1e-4):
    assert len(models_t) == len(models_j)
    for i, (a, b) in enumerate(zip(models_t, models_j)):
        n = b.num_leaves
        assert a.num_leaves == n, f"tree {i}"
        for f in ("split_feature", "threshold", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, f)[:n - 1],
                                          getattr(b, f)[:n - 1],
                                          err_msg=f"tree {i} {f}")
        np.testing.assert_array_equal(a.leaf_count[:n], b.leaf_count[:n])
        np.testing.assert_allclose(a.leaf_value[:n], b.leaf_value[:n],
                                   rtol=rtol, atol=0, err_msg=f"tree {i}")


# -- prng -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 12345, -1])
def test_prng_matches_jax_random(seed):
    kj = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(kj).astype(np.int64),
                                  kt.numpy())
    sj = jax.random.split(kj)
    st = prng.split(kt)
    np.testing.assert_array_equal(np.asarray(sj).astype(np.int64),
                                  st.numpy())
    for n in (1, 7, 65_537):
        uj = np.asarray(jax.random.uniform(sj[1], (n,)))
        ut = prng.uniform(st[1], (n,)).numpy()
        assert ut.dtype == np.float32
        np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))
        bj = np.asarray(jax.random.bits(sj[0], (n,))).astype(np.int64)
        np.testing.assert_array_equal(bj, prng.random_bits(st[0],
                                                           (n,)).numpy())


# -- GOSS selection -------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3])
def test_goss_select_matches_jax_with_ties(K):
    """|g*h| takes few distinct values, so the top-k cut falls inside a
    run of ties; the bag, g and h are bitwise JAX's."""
    rng = np.random.RandomState(5)
    N, top_k, other_k, cap = 1000, 200, 100, 512
    g = rng.choice([-0.5, -0.25, 0.25, 0.5, 0.75], size=(K, N)).astype(
        np.float32)
    h = rng.choice([0.25, 0.5], size=(K, N)).astype(np.float32)
    key_j = jax.random.split(jax.random.PRNGKey(3))[1]
    key_t = prng.split(prng.PRNGKey(3))[1]
    bj, gj, hj = j_goss_select(jnp.asarray(g), jnp.asarray(h), key_j,
                               top_k=top_k, other_k=other_k, cap=cap)
    bt, gt, ht = t_goss_select(torch.as_tensor(g), torch.as_tensor(h),
                               key_t, top_k=top_k, other_k=other_k, cap=cap)
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    np.testing.assert_array_equal(np.asarray(gj).view(np.int32),
                                  gt.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(hj).view(np.int32),
                                  ht.numpy().view(np.int32))
    assert bt.dtype == torch.int32 and (bt[:top_k + other_k] < N).all()


# -- GOSS and DART training -------------------------------------------------

VARIANTS = {
    "goss": {"boosting": "goss"},
    "goss_int8": {"boosting": "goss", "histogram_dtype": "int8"},
    "dart_uniform": {"boosting": "dart", "uniform_drop": True,
                     "drop_rate": 0.5, "skip_drop": 0.0},
    "dart_weighted": {"boosting": "dart", "drop_rate": 0.5,
                      "skip_drop": 0.0},
    "dart_xgboost": {"boosting": "dart", "xgboost_dart_mode": True,
                     "drop_rate": 0.5, "skip_drop": 0.0},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_trees_match_jax(probe, name):
    """6 iterations at lr 0.5 (GOSS: 2 warm-up, 4 sampled; DART drops in
    most iterations).  No split differs at this shape, so no f32 gain
    tie needs a justification."""
    X, y, _, _ = probe
    params = dict(BASE, **VARIANTS[name])
    bj = _train(lj, params, X, y, 6)
    bt = _train(lt, params, X, y, 6)
    assert type(bt._gbdt).__name__ == type(bj._gbdt).__name__
    assert bt.model_to_string().split("\n", 1)[0] == name.split("_")[0]
    assert_same_trees(bt._gbdt.models, bj._gbdt.models)
    if name.startswith("dart"):
        np.testing.assert_allclose(bt._gbdt.tree_weight,
                                   bj._gbdt.tree_weight, rtol=1e-12)
        assert bt._gbdt.drop_rng.get_state()[2] == \
            bj._gbdt.drop_rng.get_state()[2]
    else:
        assert bt._gbdt.bag_cnt == bj._gbdt.bag_cnt == 2000 * 3 // 10
        # the last sampled iteration's bag
        np.testing.assert_array_equal(bt._gbdt.bag_idx.numpy(),
                                      np.asarray(bj._gbdt.bag_idx))
        np.testing.assert_array_equal(
            bt._gbdt._goss_key.numpy(),
            np.asarray(bj._gbdt._goss_key).astype(np.int64))


# -- the rounds learner's training walk -----------------------------------

def _walk_case(store):
    rng = np.random.RandomState(1)
    p = dict(BASE, device_type="cpu")
    if store == "int32":
        X = rng.randn(3000, 5)
        p["max_bin"] = 400
    elif store == "sparse":
        import scipy.sparse as sp
        X = sp.random(3000, 40, density=0.1, random_state=rng,
                      format="csr") * 5
        p["sparse_store"] = "csr"
    elif store == "bundled":
        groups = rng.randint(0, 6, size=(3000, 4))
        X = np.zeros((3000, 24))
        for j in range(4):
            X[np.arange(3000), j * 6 + groups[:, j]] = 1.0
        p["enable_bundle"] = True
    else:
        X = rng.randn(3000, 5)
    Xd = X.toarray() if store == "sparse" else X
    y = (Xd[:, 0] + Xd[:, 2] + 0.3 * rng.randn(3000) > 0.2) * 1.0
    return X, y, p


@pytest.mark.parametrize("store", ["int8", "int32", "sparse", "bundled"])
def test_rounds_training_walk_matches_leaf_ids(store):
    X, y, p = _walk_case(store)
    ds = lt.Dataset(X, y, params=p)
    bst = lt.Booster(params=p, train_set=ds)
    g = bst._gbdt
    learner = g.learner
    assert hasattr(learner, "train_device")
    src = learner.walk_bins
    if store == "int8":
        assert src.dtype == torch.int8
    elif store == "int32":
        assert src.dtype == torch.int32
    elif store == "sparse":
        assert isinstance(src, tuple) and len(src) == 3
    else:
        assert ds._inner.bundle_feat_table() is not None
    grad, hess = g.boosting_gradients()
    tree, leaf_id = learner.train(grad[0], hess[0], None)
    assert tree.num_leaves > 4
    tree.apply_shrinkage(0.5)
    by_id = ScoreUpdater(None, g.num_data, 1, g.device)
    by_id.add_tree_by_leaf_id(tree, leaf_id, 0)
    walked = ScoreUpdater(lambda: learner.walk_bins, g.num_data, 1,
                          g.device, feat_tbl=ds._inner.bundle_feat_table())
    walked.add_tree(tree, 0)
    d = tree.as_device_arrays(g.device)
    leaf = traverse_tree_device(
        learner.walk_bins, d["split_feature_inner"], d["threshold_in_bin"],
        d["decision_type"], d["left_child"], d["right_child"],
        tree.num_leaves, d["depth"], walked.feat_tbl)
    np.testing.assert_array_equal(leaf.numpy(), leaf_id.numpy())
    assert torch.equal(walked.score, by_id.score)


# -- rollback ---------------------------------------------------------------

def _dyadic_fobj(preds, dataset):
    """Gradients of a few dyadic values: the packages' f32 sums are then
    exact, so both grow bitwise the same trees, and what the rollback
    does is all that can differ."""
    lab = dataset.get_label()
    g = np.where(lab > 0, -0.5, 0.5) * np.where(np.abs(preds - 0.5) > 1,
                                                0.5, 1.0)
    return g, np.ones_like(preds)


@pytest.mark.parametrize("growth", ["exact", "rounds"])
def test_rollback_matches_jax(probe, growth):
    """5 iterations with a valid set, then two rollbacks: the training and
    valid scores of both packages agree within 1e-6 (the trees are the
    same, see `_dyadic_fobj`), and the port's training scores equal a
    fresh replay of the 3 iterations left within 1e-6 (the rollback adds
    the negated trees to the scores, the replay adds only the trees
    left)."""
    X, y, Xv, yv = probe
    params = dict(BASE, tree_growth=growth, objective="regression",
                  learning_rate=0.25)
    out = []
    for pkg in (lj, lt):
        p = dict(params, device_type="cpu") if pkg is lt else params
        ds = pkg.Dataset(X, y, params=p)
        vs = pkg.Dataset(Xv, yv, reference=ds, params=p)
        out.append(pkg.train(p, ds, 5, valid_sets=[vs], fobj=_dyadic_fobj,
                             verbose_eval=False))
    bj, bt = out
    for b in (bj, bt):
        b.rollback_one_iter()
        b.rollback_one_iter()
        assert b.current_iteration() == 3
    gj, gt = bj._gbdt, bt._gbdt
    assert_same_trees(gt.models, gj.models, rtol=0)
    np.testing.assert_allclose(gt.train_score.get(), gj.train_score.get(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(gt.valid_sets[0][2].get(),
                               gj.valid_sets[0][2].get(), rtol=0, atol=1e-6)
    fresh = ScoreUpdater(lambda: gt.learner.walk_bins, gt.num_data, 1,
                         gt.device)
    fresh.add_trees(gt.models, 1)
    np.testing.assert_allclose(gt.train_score.get(), fresh.get(), rtol=0,
                               atol=1e-6)
    tens = ScoreUpdater(lambda: gt.learner.walk_bins, gt.num_data, 1,
                        gt.device)
    tens.add_trees(gt.models, 1, "tensorized")
    np.testing.assert_allclose(tens.get(), fresh.get(), rtol=0, atol=1e-6)
