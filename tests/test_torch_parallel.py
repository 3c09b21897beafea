"""The port's multi-GPU learners on the CPU: gloo worlds of W rank
processes (tests/torch_worlds.py) against the JAX package's mesh
learners on the 8 virtual CPU devices of tests/conftest.py at the same
W (`make_mesh(lt, W)`), and against the port's own one-rank learners.

The data is tests/test_parallel.py's shape: 1,201 rows x 5 from a seeded
RandomState, 15 leaves; its voting problem, 1,500 rows x 30, for PV-Tree
with top_k 3-5, where the 2*top_k voted features are a real subset and
the trees are not the data-parallel ones; a one-hot problem of
tests/test_bundle.py's for the EFB-bundled store; a small synth_ctr csr store (1,200 x 128 at
density 0.04, max_bin 63 as CTR_PARAMS) for the sparse store's per-rank
feeds.  Gradients at a zero score are dyadic (+-1 and a
hessian of 0.5, every f32 sum exact in any order); the non-dyadic ones
come from a seeded random score.

Tolerance, as the JAX package's tests state it: structure equal (split
features, thresholds, children, every row's leaf id), leaf values within
rtol 1e-4 and atol 1e-6.  int8 histograms: the port's ranks quantize
with the scales shared over the world and exchange int32 sums, so a
W-rank int8 tree is bitwise the one-rank tree, dyadic or not.  The JAX
mesh learners quantize each shard with its own local scales; on the
dyadic problem every shard holds both labels, so its scales are the
global ones and the two packages are compared within the tolerance
there.

Every world runs several checks (one process start a rank per world),
under BENCH_SANITIZE=1, so each tree's DivergenceSanitizer check runs
too."""
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu import profiling as j_profiling
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.dataset import Dataset as JDS
from lightgbm_tpu.learner.fused import FusedTreeLearner as JFused
from lightgbm_tpu.learner.rounds import RoundsTreeLearner as JRounds
from lightgbm_tpu.sharded.mesh import make_mesh as j_make_mesh

from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.dataset import Dataset as TDS
from lightgbm_tpu_torch.learner.fused import FusedTreeLearner as TFused
from lightgbm_tpu_torch.learner.rounds import RoundsTreeLearner as TRounds

from torch_worlds import run_world

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbose": -1}
N_BAG = 500


def _small():
    rng = np.random.RandomState(7)
    X = rng.randn(1201, 5)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.randn(1201) > 0
         ).astype(np.float64)
    return X, y


def _wide():
    """tests/test_parallel.py's voting problem: 1,500 x 30."""
    rng = np.random.RandomState(7)
    X = rng.randn(1500, 30)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * X[:, 3]
         + 0.1 * rng.randn(1500) > 0).astype(np.float64)
    return X, y


def _one_hot(n=1200, groups=20, card=6, seed=1, noise=0.3):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card))
    for g in range(groups):
        X[np.arange(n), g * card + codes[:, g]] = 1.0
    w = rng.randn(groups * card)
    y = (X @ w + noise * rng.randn(n) > 0).astype(float)
    return X, y


def _ctr():
    """A small synth_ctr csr store (power-law columns; binary labels)."""
    from lightgbm_tpu_torch.synth import synth_ctr
    X, y, _ = synth_ctr(1_200, 128, 0.04)
    return X.tocsc(), (y > 0).astype(np.float64)


def _dataset(pkg_ds, X, y, cfg):
    """A package's Dataset: from the csc columns for the sparse store."""
    if hasattr(X, "tocsc"):
        return pkg_ds.from_csc(X, y, cfg)
    return pkg_ds(X, y, config=cfg)


def _grads(y, dyadic: bool):
    if dyadic:
        return ((0.5 - y) * 2).astype(np.float32), \
            np.full(len(y), 0.5, np.float32)
    s = np.random.RandomState(3).randn(len(y)) * 0.7
    p = 1 / (1 + np.exp(-s))
    return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)


def _bag(n):
    idx = np.sort(np.random.RandomState(0).choice(n, N_BAG, replace=False))
    padded = np.full(512, n, np.int32)
    padded[:N_BAG] = idx
    return padded


SPARSE = dict(sparse_store="csr", max_bin=63, min_data_in_leaf=5)
# name -> (world, data, dyadic, bagged, params)
TREES = {
    "rounds_psum": (2, "small", True, False,
                    dict(tree_learner="data", hist_exchange="psum")),
    "rounds_scatter_gathered": (
        2, "small", False, False,
        dict(tree_learner="data", hist_exchange="psum_scatter",
             hist_rows="gathered")),
    "rounds_psum_nd": (2, "small", False, False,
                       dict(tree_learner="data", hist_exchange="psum")),
    "rounds_int8_psum": (2, "small", True, False,
                         dict(tree_learner="data", hist_exchange="psum",
                              histogram_dtype="int8")),
    "rounds_int8_scatter_nd": (2, "small", False, False,
                               dict(tree_learner="data",
                                    hist_exchange="psum_scatter",
                                    histogram_dtype="int8")),
    "rounds_int8_scatter": (2, "small", True, False,
                            dict(tree_learner="data",
                                 hist_exchange="psum_scatter",
                                 histogram_dtype="int8",
                                 hist_rows="gathered")),
    "rounds_bundled_scatter": (2, "onehot", True, False,
                               dict(tree_learner="data",
                                    hist_exchange="psum_scatter",
                                    enable_bundle=True, min_data_in_leaf=5)),
    "fused_data": (2, "small", False, False,
                   dict(tree_learner="data", tree_growth="exact")),
    "fused_data_scatter": (2, "small", True, False,
                           dict(tree_learner="data", tree_growth="exact",
                                hist_exchange="psum_scatter")),
    "fused_feature": (2, "small", False, False,
                      dict(tree_learner="feature")),
    "fused_voting": (2, "small", True, False,
                     dict(tree_learner="voting", top_k=5)),
    "fused_voting_scatter": (2, "small", True, False,
                             dict(tree_learner="voting", top_k=5,
                                  hist_exchange="psum_scatter")),
    "fused_bundled_data": (2, "onehot", True, False,
                           dict(tree_learner="data", tree_growth="exact",
                                enable_bundle=True, min_data_in_leaf=5)),
    "fused_bag3": (3, "small", True, True,
                   dict(tree_learner="data", tree_growth="exact")),
    "rounds_bag3": (3, "small", False, True,
                    dict(tree_learner="data", hist_exchange="psum_scatter")),
    "fused_feature3": (3, "small", False, False,
                       dict(tree_learner="feature")),
    "data2d_psum": (4, "small", False, False,
                    dict(tree_learner="data2d", hist_exchange="psum")),
    "data2d_scatter": (4, "small", True, False,
                       dict(tree_learner="data2d",
                            hist_exchange="psum_scatter")),
    "data2d_int8_scatter": (4, "small", False, True,
                            dict(tree_learner="data2d",
                                 hist_exchange="psum_scatter",
                                 histogram_dtype="int8")),
    "data2d_fused": (4, "small", False, False,
                     dict(tree_learner="data2d", tree_growth="exact")),
    # the sparse store: each rank's row block of the ELL store (rounds),
    # its window of the entries (fused)
    "sparse_rounds_scatter_int8": (
        2, "ctr", True, False,
        dict(tree_learner="data", hist_exchange="psum_scatter",
             histogram_dtype="int8", **SPARSE)),
    "sparse_fused_feature": (2, "ctr", False, False,
                             dict(tree_learner="feature", **SPARSE)),
    "sparse_fused_voting_scatter": (
        2, "ctr", True, False,
        dict(tree_learner="voting", top_k=1000,
             hist_exchange="psum_scatter", **SPARSE)),
    "sparse_data2d": (4, "ctr", False, True,
                      dict(tree_learner="data2d", hist_exchange="psum",
                           **SPARSE)),
    # PV-Tree over a real subset: 2*top_k of 30 features voted a search
    # (under psum_scatter W=3 and W=4 pad the subset with repeats)
    "fused_data_wide": (2, "wide", True, False,
                        dict(tree_learner="data", tree_growth="exact")),
    "voting_subset": (2, "wide", True, False,
                      dict(tree_learner="voting", top_k=5)),
    "voting_subset_nd": (2, "wide", False, False,
                         dict(tree_learner="voting", top_k=5)),
    "voting_subset_scatter": (2, "wide", False, False,
                              dict(tree_learner="voting", top_k=5,
                                   hist_exchange="psum_scatter")),
    "voting_subset3_scatter": (3, "wide", True, True,
                               dict(tree_learner="voting", top_k=4,
                                    hist_exchange="psum_scatter")),
    "voting_subset4_scatter": (4, "wide", False, False,
                               dict(tree_learner="voting", top_k=3,
                                    hist_exchange="psum_scatter")),
}
# the voting trees that vote a real subset: no one-rank learner grows them
SUBSET = sorted(n for n in TREES if n.startswith("voting_subset"))
F_WIDE = 30
# name -> (world, params, iterations, data): lt.train on every rank
TRAINS = {
    "train_rounds_int8": (2, dict(tree_learner="data", histogram_dtype="int8",
                                  hist_exchange="psum_scatter",
                                  bagging_fraction=0.7, bagging_freq=1), 4,
                          "small"),
    "train_voting": (2, dict(tree_learner="voting", top_k=3), 3, "small"),
    "train_voting_subset": (2, dict(tree_learner="voting", top_k=5,
                                    hist_exchange="psum_scatter"), 3,
                            "wide"),
    "train_feature3": (3, dict(tree_learner="feature",
                               feature_fraction=0.8), 3, "small"),
    "train_data2d": (4, dict(tree_learner="data2d", hist_rows="gathered"), 3,
                     "small"),
}

_BODY = """
import json
import numpy as np
import torch
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import profiling
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.dataset import Dataset
from lightgbm_tpu_torch.learner.fused import create_tree_learner
spec = json.load(open(OUT + "/spec.json"))
data = np.load(OUT + "/data.npz")
for name, (w, key, dyadic, bagged, params) in spec["trees"].items():
    if w != WORLD:
        continue
    p = dict(spec["base"], device_type="cpu", **params)
    cfg = config_from_params(p)
    if key == "ctr":
        import scipy.sparse as spm
        ds = Dataset.from_csc(spm.load_npz(OUT + "/X_ctr.npz"),
                              data["y_" + key], cfg)
        assert ds.sparse is not None
    else:
        ds = Dataset(data["X_" + key], data["y_" + key], config=cfg)
    learner = create_tree_learner(ds, cfg)
    g = torch.as_tensor(data[("g_" if dyadic else "gn_") + key])
    h = torch.as_tensor(data[("h_" if dyadic else "hn_") + key])
    bag = torch.as_tensor(data["bag_" + key]) if bagged else None
    c0 = profiling.counters("tree/")
    tree, lid = learner.train(g, h, bag)
    c1 = profiling.counters("tree/")
    xb = [c1.get(k, 0.0) - c0.get(k, 0.0)
          for k in (profiling.HIST_EXCHANGE_BYTES,
                    profiling.SPLIT_RECORDS_BYTES)]
    n = tree.num_leaves
    np.savez(f"{OUT}/{name}_r{RANK}.npz", n=n,
             sf=tree.split_feature_inner[:n - 1],
             th=tree.threshold_in_bin[:n - 1],
             lc=tree.left_child[:n - 1], rc=tree.right_child[:n - 1],
             lv=tree.leaf_value[:n], cnt=tree.leaf_count[:n],
             ic=tree.internal_count[:n - 1], lid=lid.numpy(),
             kind=type(learner).__name__,
             shape=np.asarray(learner.mesh.shape),
             hx=getattr(learner, "hist_exchange", ""),
             hist_bytes=xb[0], record_bytes=xb[1],
             B=getattr(learner, "B", 0))
for name, (w, params, iters, key) in spec["trains"].items():
    if w != WORLD:
        continue
    p = dict(spec["base"], device_type="cpu", **params)
    bst = lt.train(p, lt.Dataset(data["X_" + key], data["y_" + key],
                                 params=p), iters)
    open(f"{OUT}/{name}_r{RANK}.txt", "w").write(bst.model_to_string())
json.dump({"checks": profiling.counter_value("sanitize/divergence_checks"),
           "divergences": profiling.counter_value("sanitize/divergences")},
          open(f"{OUT}/sanitize_r{RANK}.json", "w"))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    import scipy.sparse as spm
    out = {}
    data = {}
    for key, (X, y) in (("small", _small()), ("wide", _wide()),
                        ("onehot", _one_hot()), ("ctr", _ctr())):
        if key == "ctr":
            data["Xs_ctr"] = X
        else:
            data["X_" + key] = X
        data["y_" + key] = y
        data["g_" + key], data["h_" + key] = _grads(y, True)
        data["gn_" + key], data["hn_" + key] = _grads(y, False)
        data["bag_" + key] = _bag(len(y))
    for w in (2, 3, 4):
        d = tmp / f"world{w}_out"
        d.mkdir()
        np.savez(d / "data.npz", **{k: v for k, v in data.items()
                                    if k != "Xs_ctr"})
        spm.save_npz(d / "X_ctr.npz", data["Xs_ctr"])
        (d / "spec.json").write_text(json.dumps(
            {"base": BASE, "trees": TREES, "trains": TRAINS}))
        out[w] = d
    # the three worlds run side by side
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(run_world, tmp, w, _BODY, name=f"world{w}",
                              timeout=300, env={"BENCH_SANITIZE": "1"})
                  for w in out]:
            f.result()
    return out, data


def _result(worlds, name, rank=0):
    out, _ = worlds
    w = TREES[name][0]
    return dict(np.load(out[w] / f"{name}_r{rank}.npz"))


def _inputs(worlds, name):
    _, data = worlds
    _, key, dyadic, bagged, params = TREES[name]
    X = data["Xs_ctr"] if key == "ctr" else data["X_" + key]
    y = data["y_" + key]
    g = data[("g_" if dyadic else "gn_") + key]
    h = data[("h_" if dyadic else "hn_") + key]
    bag = data["bag_" + key] if bagged else None
    return X, y, g, h, bag, dict(BASE, **params)


def _arrays(tree, lid):
    n = tree.num_leaves
    return dict(n=n, sf=tree.split_feature_inner[:n - 1],
                th=tree.threshold_in_bin[:n - 1],
                lc=tree.left_child[:n - 1], rc=tree.right_child[:n - 1],
                lv=tree.leaf_value[:n], cnt=tree.leaf_count[:n],
                ic=tree.internal_count[:n - 1], lid=np.asarray(lid))


def _same_tree(got, want, exact=False):
    assert int(got["n"]) == int(want["n"]) > 1
    for k in ("sf", "th", "lc", "rc", "cnt", "ic", "lid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if exact:
        np.testing.assert_array_equal(got["lv"], want["lv"])
    else:
        np.testing.assert_allclose(got["lv"], want["lv"], rtol=1e-4,
                                   atol=1e-6)


def _port_one_rank(worlds, name):
    X, y, g, h, bag, p = _inputs(worlds, name)
    cfg = t_config(dict(p, device_type="cpu"))
    ds = _dataset(TDS, X, y, cfg)
    fused = p.get("tree_learner") in ("feature", "voting") or \
        p.get("tree_growth") == "exact"
    learner = (TFused if fused else TRounds)(ds, cfg)
    tree, lid = learner.train(torch.as_tensor(g), torch.as_tensor(h),
                              None if bag is None else torch.as_tensor(bag))
    return _arrays(tree, lid.numpy())


def _jax_mesh(worlds, name):
    X, y, g, h, bag, p = _inputs(worlds, name)
    w = TREES[name][0]
    cfg = j_config(p)
    ds = _dataset(JDS, X, y, cfg)
    mesh = j_make_mesh(p["tree_learner"], w)
    fused = p.get("tree_learner") in ("feature", "voting") or \
        p.get("tree_growth") == "exact"
    learner = (JFused if fused else JRounds)(ds, cfg, mesh)
    args = (jnp.asarray(g), jnp.asarray(h))
    if bag is not None:
        args += (jnp.asarray(bag), N_BAG)
    tree, lid = learner.train(*args)
    # the JAX learners' deferred counters live on this mesh's devices;
    # drain them before a mesh of another size adds to them
    j_profiling.counters()
    return _arrays(tree, np.asarray(lid))


@pytest.mark.parametrize("name", sorted(TREES))
def test_every_rank_grows_the_same_tree(worlds, name):
    """The tree and every row's leaf id are replicated state: bitwise the
    same on every rank, and the learner is the mesh learner JAX's
    factory routes to, on the mesh JAX's make_mesh shapes."""
    w, _, _, _, params = TREES[name]
    r0 = _result(worlds, name, 0)
    jm = j_make_mesh(params["tree_learner"], w)
    assert tuple(r0["shape"]) == tuple(jm.devices.shape)
    fused = params.get("tree_learner") in ("feature", "voting") or \
        params.get("tree_growth") == "exact"
    assert str(r0["kind"]) == ("FusedTreeLearner" if fused
                               else "RoundsTreeLearner")
    for r in range(1, w):
        _same_tree(_result(worlds, name, r), r0, exact=True)


@pytest.mark.parametrize("name", sorted(set(TREES) - set(SUBSET)))
def test_mesh_tree_equals_the_one_rank_tree(worlds, name):
    """Data-, feature-, voting- (top_k covering every feature) and 2-D
    parallel trees equal the port's one-rank learner's; int8 ones over
    the dense store bitwise (integer sums, scales shared by the world;
    over the sparse store the kernel finishes each rank's histogram in
    float32 before the exchange)."""
    p = TREES[name][4]
    exact = (p.get("histogram_dtype") == "int8"
             and p.get("sparse_store") != "csr")
    _same_tree(_result(worlds, name), _port_one_rank(worlds, name),
               exact=exact)


@pytest.mark.parametrize("name", [
    "rounds_psum", "rounds_scatter_gathered", "rounds_psum_nd",
    "rounds_int8_psum", "rounds_int8_scatter", "rounds_bundled_scatter",
    "fused_data", "fused_data_scatter", "fused_feature", "fused_voting",
    "fused_voting_scatter", "fused_bundled_data", "fused_bag3",
    "rounds_bag3", "fused_feature3", "data2d_psum", "data2d_scatter",
    "data2d_fused", "sparse_rounds_scatter_int8", "sparse_fused_feature",
    "sparse_fused_voting_scatter", "sparse_data2d", "fused_data_wide"]
    + SUBSET)
def test_mesh_tree_equals_jax_mesh_learner(worlds, name):
    """The port's W-rank tree against JAX's RoundsTreeLearner(mesh) /
    FusedTreeLearner(mesh) on make_mesh(tree_learner, W)."""
    _same_tree(_result(worlds, name), _jax_mesh(worlds, name))


def test_padded_rows_never_enter_the_bag(worlds):
    """W=3 pads 1,201 rows to 1,203: the bag's sentinel index and the
    padding rows stay out of every histogram, so the root counts the
    bag (tests/test_parallel.py:86-103)."""
    for name in ("fused_bag3", "rounds_bag3"):
        r = _result(worlds, name)
        assert int(r["ic"][0]) == N_BAG, name


def test_voting_with_top_k_covering_every_feature_is_data_parallel(worlds):
    """tests/test_parallel.py:106-135: top_k >= F exchanges every
    feature's histogram, so PV-Tree is data-parallel exactly."""
    X, y, g, h, _, _ = _inputs(worlds, "fused_voting")
    v = _result(worlds, "fused_voting")
    vs = _result(worlds, "fused_voting_scatter")
    cfg = t_config(dict(BASE, device_type="cpu", tree_growth="exact"))
    t, lid = TFused(TDS(X, y, config=cfg), cfg).train(
        torch.as_tensor(g), torch.as_tensor(h))
    _same_tree(v, _arrays(t, lid.numpy()))
    _same_tree(vs, v)


def _splits(r):
    n = int(r["n"])
    return sorted(zip(r["sf"][:n - 1].tolist(), r["th"][:n - 1].tolist()))


def test_voting_subset_stays_close_to_data_parallel(worlds):
    """tests/test_parallel.py:130-139: with top_k 5 of 30 features
    PV-Tree grows a full tree that shares at least half its splits with
    the data-parallel one."""
    v = _result(worlds, "voting_subset")
    d = _result(worlds, "fused_data_wide")
    assert int(v["n"]) == int(d["n"])
    shared = len(set(_splits(v)) & set(_splits(d)))
    assert shared >= (int(d["n"]) - 1) // 2


@pytest.mark.parametrize("name", SUBSET)
def test_voting_exchanges_only_the_voted_features(worlds, name):
    """The bytes a rank's histogram collectives moved in one tree, as
    the mesh counts them: the root's column 0, then for each of the
    1 + 2*(L-1) leaf searches the 2*top_k voted features' histograms
    (under psum_scatter the rank's slice of the subset padded to a
    multiple of W), never all 30; and under psum_scatter one gathered
    [W, 11] record a search."""
    w, _, _, _, p = TREES[name]
    r = _result(worlds, name)
    B, L = int(r["B"]), BASE["num_leaves"]
    searches = 1 + 2 * (L - 1)
    k2 = min(2 * p["top_k"], F_WIDE)
    assert k2 < F_WIDE
    if p.get("hist_exchange") == "psum_scatter":
        per = -(-k2 // w)
        records = 4 * 11 * w * searches
    else:
        per, records = k2, 0
    assert float(r["hist_bytes"]) == 4 * 3 * B * (1 + per * searches)
    assert float(r["record_bytes"]) == records


@pytest.mark.parametrize("name", sorted(TRAINS))
def test_every_rank_writes_the_same_model_string(worlds, name):
    """lt.train inside a gloo world trains on the mesh, the boosting
    loop replicated: every rank's model string is the same."""
    out, _ = worlds
    w = TRAINS[name][0]
    texts = [(out[w] / f"{name}_r{r}.txt").read_text() for r in range(w)]
    assert texts[0].count("Tree=") == TRAINS[name][2]
    for t in texts[1:]:
        assert t == texts[0]


def test_int8_model_string_is_the_one_rank_model_string(worlds):
    """Bagged int8 training, psum_scatter: the W-rank model string is
    bitwise the one-rank run's (quantization scales shared by the world,
    int32 sums exchanged)."""
    import lightgbm_tpu_torch as lt
    out, data = worlds
    _, params, iters, _ = TRAINS["train_rounds_int8"]
    p = dict(BASE, device_type="cpu", **params)
    one = lt.train(dict(p, tree_learner="serial"),
                   lt.Dataset(data["X_small"], data["y_small"], params=p),
                   iters).model_to_string()
    got = (out[2] / "train_rounds_int8_r0.txt").read_text()
    strip = [ln for ln in got.splitlines() if not ln.startswith("[")]
    want = [ln for ln in one.splitlines() if not ln.startswith("[")]
    assert strip == want


def test_divergence_sanitizer_checked_every_tree(worlds):
    """Under BENCH_SANITIZE every rank compared its digests of every
    tree with the world's and found no divergence."""
    out, _ = worlds
    for w in (2, 3, 4):
        for r in range(w):
            st = json.loads((out[w] / f"sanitize_r{r}.json").read_text())
            assert st["checks"] > 0 and st["divergences"] == 0, (w, r, st)
