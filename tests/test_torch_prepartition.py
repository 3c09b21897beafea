"""Pre-partitioned multi-process training (`is_pre_partition=true`): each
rank keeps only its rows of the file, the bin mappers come from every
rank's sample, and the boosting loop runs over the local rows.

One JAX world of 2 processes (`lightgbm_tpu.distributed.init_distributed`,
one virtual CPU device a process, so its data axis is 2 like the port's)
and one gloo world of 2 ranks of the port (tests/torch_worlds.py) load
the same files and train the same workloads; a module fixture runs both
worlds side by side, once.  The port's world first trains through the
CLI (`python -m lightgbm_tpu_torch` with a machine list), which brings
the world up, then runs the Python route in it.  The port's one-rank
runs load the whole file in this process.

Data: 3,001 rows x 6 (`RandomState(9)`, so the blocks are 1,501 and
1,500 rows) written with `np.savetxt`, a copy with a `.weight` side file
and one with a 3-class `.init` file, a 801-row valid file and a copy with a
`.query` file.  `bin_construct_sample_cnt` (200,000) covers every row, so
the gathered sample is the whole file and the mappers are the one-rank
mappers.  Workloads: 15 leaves, 3 iterations.

Tolerances: int8 histograms are integer sums with scales shared over the
world, so an int8 model is bitwise the port's one-rank model on the full
file.  Float32 models and the JAX package's models: every tree's
structure equal, float lines within rtol 1e-4, atol 1e-6
(`diagnostics.worlds.compare_models`)."""
import json
import os
import socket
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_worlds import ROOT, run_world

from lightgbm_tpu_torch.diagnostics.worlds import FLOAT_LINES, \
    compare_models, run_world as run_argvs

N, F, NV = 3001, 6, 801
ITERS = 3
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "verbose": -1, "num_machines": 2, "pre_partition": True}
# name -> (file key, extra params, reference load or None)
LOADS = {
    "train": ("train", {}, None),
    "valid": ("valid", {}, "train"),
    "weighted": ("weighted", {}, None),
    "init": ("init", {}, None),
    "sketch_tight": ("train", {"bin_find": "sketch", "sketch_eps": 1e-5},
                     None),
    "sketch_loose": ("train", {"bin_find": "sketch", "sketch_eps": 0.05},
                     None),
}
# name -> (extra params, exact against the one-rank model)
TRAINS = {
    "rounds_int8_psum": (dict(tree_learner="data", tree_growth="rounds",
                              histogram_dtype="int8", hist_exchange="psum"),
                         True),
    "rounds_int8_scatter": (dict(tree_learner="data", tree_growth="rounds",
                                 histogram_dtype="int8",
                                 hist_exchange="psum_scatter"), True),
    "rounds_float32": (dict(tree_learner="data", tree_growth="rounds",
                            histogram_dtype="float32",
                            hist_exchange="psum"), False),
    "fused_data": (dict(tree_learner="data", tree_growth="exact",
                        histogram_dtype="float32"), False),
    "fused_voting": (dict(tree_learner="voting", top_k=2,
                          histogram_dtype="float32"), None),
    # the bag is drawn over the local rows: no one-rank counterpart
    "bagged_int8": (dict(tree_learner="data", tree_growth="rounds",
                         histogram_dtype="int8", bagging_fraction=0.8,
                         bagging_freq=1), None),
}
# learners a pre-partitioned world refuses, or trains as data-parallel
REFUSALS = {"feature": dict(tree_learner="feature"),
            "data2d": dict(tree_learner="data2d", tree_growth="rounds")}

# the body both worlds run: load, refuse, train, through each package's
# `load(path, params, reference)` and `train(params, iterations)`
_COMMON = """
spec = json.load(open(os.path.join(OUT, "spec.json")))
loaded = {}
for name, (key, extra, ref) in spec["loads"].items():
    p = dict(spec["base"], **extra)
    ds = load(spec["files"][key], p, loaded.get(ref))
    loaded[name] = ds
    md = ds.metadata
    np.savez(os.path.join(OUT, f"{name}_r{RANK}.npz"),
             bins=np.asarray(ds.bins), label=np.asarray(md.label),
             weights=(np.zeros(0) if md.weights is None
                      else np.asarray(md.weights)),
             init=(np.zeros(0) if md.init_score is None
                   else np.asarray(md.init_score)),
             infos=np.asarray(ds.feature_infos()),
             bounds=np.concatenate([np.asarray(m.bin_upper_bound, "f8")
                                    for m in ds.mappers]),
             nbins=np.asarray([m.num_bin for m in ds.mappers]),
             num_data=ds.num_data)
res = {}
try:
    load(spec["files"]["query"], dict(spec["base"]), None)
    res["query"] = "loaded"
except Exception as e:
    res["query"] = [type(e).__name__, str(e)]
for name, extra in spec["refusals"].items():
    try:
        train(dict(spec["base"], **extra), 1)
        res[name] = "trained"
    except Exception as e:
        res[name] = [type(e).__name__, str(e)]
json.dump(res, open(os.path.join(OUT, f"refusals_r{RANK}.json"), "w"))
for name, (extra, _) in spec["trains"].items():
    s = train(dict(spec["base"], **extra), spec["iters"])
    open(os.path.join(OUT, f"{name}_r{RANK}.txt"), "w").write(s)
"""

_JAX_WORKER = """\
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join({root!r}, ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
sys.path.insert(0, {root!r})
import numpy as np
import lightgbm_tpu as lgb
from lightgbm_tpu.config import config_from_params
from lightgbm_tpu.dataset import Dataset
from lightgbm_tpu.distributed import init_distributed
RANK, OUT = int(sys.argv[1]), sys.argv[2]
os.environ["LIGHTGBM_TPU_MACHINE_RANK"] = str(RANK)
assert init_distributed(num_machines=2, local_listen_port=int(sys.argv[3]))
assert jax.process_index() == RANK and len(jax.devices()) == 2


def load(path, params, reference):
    return Dataset.from_file(path, config_from_params(params), reference)


def train(params, iters):
    ds = lgb.Dataset(spec["files"]["train"], params=params).construct(params)
    bst = lgb.Booster(params, ds)
    for _ in range(iters):
        bst.update()
    return bst._gbdt.save_model_to_string()
{common}
print("JAX_DONE", RANK, flush=True)
"""

_PORT_BODY = """
import json, os
import numpy as np
os.environ["LIGHTGBM_TPU_MACHINE_RANK"] = str(RANK)
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import application
from lightgbm_tpu_torch.config import config_from_params
from lightgbm_tpu_torch.dataset import Dataset
spec = json.load(open(os.path.join(OUT, "spec.json")))
# the CLI brings the world up from the machine list
cli = dict(spec["base"], **spec["trains"]["rounds_int8_psum"][0])
argv = [f"{k}={v}" for k, v in cli.items()] + [
    "task=train", "device_type=cpu", f"data={spec['files']['train']}",
    f"num_iterations={spec['iters']}",
    f"machine_list_file={os.path.join(OUT, 'mlist.txt')}",
    f"output_model={os.path.join(OUT, f'cli_r{RANK}.txt')}",
    "is_save_binary_file=true"]
assert application.main(argv) == 0
json.dump(os.path.exists(spec["files"]["train"] + ".bin"),
          open(os.path.join(OUT, f"cli_bin_r{RANK}.json"), "w"))
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"


def load(path, params, reference):
    return Dataset.from_file(path, config_from_params(
        dict(params, device_type="cpu")), reference)


def train(params, iters):
    p = dict(params, device_type="cpu")
    bst = lt.train(p, lt.Dataset(spec["files"]["train"], params=p), iters)
    return bst.model_to_string()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_files(d):
    rng = np.random.RandomState(9)
    X = rng.randn(N + NV, F)
    X[:, 5] = np.round(X[:, 5] * 2)          # a few distinct values
    y = ((X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(N + NV))
         > 0).astype(np.float64)
    files = {k: str(d / f"{k}.tsv") for k in ("train", "valid", "weighted",
                                              "init", "query")}
    for k in ("train", "weighted", "init", "query"):
        np.savetxt(files[k], np.column_stack([y[:N], X[:N]]),
                   delimiter="\t", fmt="%.8g")
    np.savetxt(files["valid"], np.column_stack([y[N:], X[N:]]),
               delimiter="\t", fmt="%.8g")
    np.savetxt(files["weighted"] + ".weight",
               np.random.RandomState(3).rand(N) + 0.5, fmt="%.8g")
    np.savetxt(files["init"] + ".init",
               np.random.RandomState(4).randn(3 * N) * 0.1, fmt="%.8g")
    np.savetxt(files["query"] + ".query", [1000, 1000, 1001], fmt="%d")
    return files


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prepartition")
    files = _write_files(tmp)
    spec = {"base": BASE, "loads": LOADS, "trains": TRAINS,
            "refusals": REFUSALS, "files": files, "iters": ITERS}
    jax_out = tmp / "jax_out"
    port_out = tmp / "port_out"
    for d in (jax_out, port_out):
        d.mkdir()
        (d / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    (port_out / "mlist.txt").write_text(
        f"127.0.0.1 {port}\n127.0.0.1 {port}\n")
    script = tmp / "jax_worker.py"
    script.write_text(_JAX_WORKER.format(root=ROOT, common=_COMMON))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    jport = _free_port()
    argvs = [[sys.executable, str(script), str(r), str(jax_out), str(jport)]
             for r in range(2)]
    with ThreadPoolExecutor(2) as pool:
        fj = pool.submit(run_argvs, argvs, timeout=400, env=env,
                         log_dir=str(tmp), name="jax")
        fp = pool.submit(run_world, tmp, 2, _PORT_BODY + _COMMON,
                         name="port", timeout=400, init=False)
        fj.result()
        fp.result()
    return files, jax_out, port_out


def _load(out, name, rank):
    return dict(np.load(out / f"{name}_r{rank}.npz"))


def _text(out, name, rank):
    return (out / f"{name}_r{rank}.txt").read_text()


def _one_rank(files, params, monkeypatch):
    """The port's one-rank run on the full file (no world: the whole
    file loads), on the synchronous path that a pre-partitioned world
    takes.  Exact growth runs the one-device fused builder, as on the
    card (on the CPU it would be the serial learner)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import fused
    if params.get("tree_growth") == "exact":
        monkeypatch.setattr(fused, "resolve_tree_learner",
                            lambda *a, **k: "fused")
    p = dict(params, device_type="cpu")
    bst = lt.Booster(p, lt.Dataset(files["train"], params=p))
    bst._gbdt._can_pipeline = lambda: False
    for _ in range(ITERS):
        bst.update()
    return bst.model_to_string()


def _full_load(files, name):
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.dataset import Dataset
    key, extra, ref = LOADS[name]
    cfg = config_from_params(dict(BASE, device_type="cpu", **extra))
    reference = _full_load(files, ref) if ref else None
    return Dataset.from_file(files[key], cfg, reference)


def _block(rank):
    per = (N + 1) // 2
    return slice(rank * per, min((rank + 1) * per, N))


@pytest.mark.parametrize("name", ["train", "weighted", "init",
                                  "sketch_tight"])
@pytest.mark.parametrize("rank", [0, 1])
def test_rank_block_is_the_jax_rank_block(worlds, name, rank):
    """Each rank holds local_row_slice(N)'s rows: its bins, labels,
    weights and per-class init scores are bitwise the JAX rank's, and
    its mappers are JAX's."""
    _, jax_out, port_out = worlds
    got, want = _load(port_out, name, rank), _load(jax_out, name, rank)
    sl = _block(rank)
    assert int(got["num_data"]) == sl.stop - sl.start
    for k in ("bins", "label", "weights", "init", "infos", "bounds",
              "nbins"):
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["train", "weighted", "init",
                                  "sketch_tight"])
def test_rank_blocks_are_blocks_of_the_full_load(worlds, name):
    """The ranks' blocks tile the one-rank full load of the same file,
    bins, labels, weights and each class's init scores; the mappers are
    the full load's on both ranks."""
    files, _, port_out = worlds
    full = _full_load(files, name)
    init = (None if full.metadata.init_score is None
            else full.metadata.init_score.reshape(-1, N))
    for rank in (0, 1):
        got, sl = _load(port_out, name, rank), _block(rank)
        assert np.array_equal(got["bins"], full.bins[:, sl])
        assert np.array_equal(got["label"], full.metadata.label[sl])
        if name == "weighted":
            assert np.array_equal(got["weights"], full.metadata.weights[sl])
        if init is not None:
            assert np.array_equal(got["init"], init[:, sl].reshape(-1))
        assert list(got["infos"]) == full.feature_infos()
        assert np.array_equal(got["bounds"], np.concatenate(
            [np.asarray(m.bin_upper_bound, "f8") for m in full.mappers]))


def test_loose_sketch_mappers_are_the_same_on_every_rank(worlds):
    """bin_find=sketch at sketch_eps=0.05 compacts the summaries: the
    merged mappers are still the same on both ranks (one merge of the
    same stack), and JAX's."""
    _, jax_out, port_out = worlds
    r0, r1 = (_load(port_out, "sketch_loose", r) for r in (0, 1))
    want = _load(jax_out, "sketch_loose", 0)
    for k in ("infos", "bounds", "nbins"):
        assert np.array_equal(r0[k], r1[k]), k
        assert np.array_equal(r0[k], want[k]), k


def test_valid_set_is_sliced_and_binned_with_training_mappers(worlds):
    """A valid file with reference= keeps the rank's block of its rows,
    binned with the training set's mappers, as in JAX."""
    files, jax_out, port_out = worlds
    full = _full_load(files, "valid")
    per = (NV + 1) // 2
    for rank in (0, 1):
        got = _load(port_out, "valid", rank)
        sl = slice(rank * per, min((rank + 1) * per, NV))
        assert np.array_equal(got["bins"], full.bins[:, sl])
        assert np.array_equal(got["bins"], _load(jax_out, "valid",
                                                 rank)["bins"])
        assert list(got["infos"]) == list(_load(port_out, "train",
                                                rank)["infos"])


def test_valid_set_of_another_width_is_refused(worlds, monkeypatch):
    """A valid set whose width differs from the training set's raises
    the JAX loader's ValueError (the world's rank is stubbed: the check
    precedes every collective)."""
    from lightgbm_tpu_torch import distributed
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.dataset import Dataset
    files, _, _ = worlds
    train = _full_load(files, "train")
    train.num_total_features += 1
    monkeypatch.setattr(distributed, "world", lambda: (0, 2))
    with pytest.raises(ValueError, match="different #features"):
        Dataset.from_file(files["valid"], config_from_params(
            dict(BASE, device_type="cpu")), train)


@pytest.mark.parametrize("name", sorted(TRAINS))
def test_every_rank_writes_the_same_model_string(worlds, name):
    _, _, port_out = worlds
    m0, m1 = (_text(port_out, name, r) for r in (0, 1))
    assert m0.count("Tree=") == ITERS
    assert m0 == m1


@pytest.mark.parametrize("name", sorted(n for n, (_, ex) in TRAINS.items()
                                        if ex is not None))
def test_model_is_the_one_rank_model(worlds, name, monkeypatch):
    """int8: bitwise the one-rank model on the full file; float32 within
    the tolerance.  Bagging draws over the local rows, so the bagged
    model is held against JAX's only (below)."""
    files, _, port_out = worlds
    extra, exact = TRAINS[name]
    want = _one_rank(files, dict(BASE, **extra), monkeypatch)
    verdict = compare_models(want, _text(port_out, name, 0), exact)
    assert verdict in (("bitwise",) if exact
                       else ("bitwise", "within tolerance")), verdict


def _first_tree(model: str) -> str:
    return model[:model.index("Tree=1")]


def _structure(model: str) -> list:
    return [ln for ln in model.splitlines()
            if ln.split("=", 1)[0] not in FLOAT_LINES]


@pytest.mark.parametrize("name", sorted(TRAINS))
def test_model_equals_the_jax_pre_partitioned_model(worlds, name):
    """Structure equal to the JAX two-process model, float lines within
    rtol 1e-4.  The bagged int8 model: every structural line equal, and
    the first tree within the tolerance.  The JAX learner quantizes each
    rank's rows with that rank's own scales, the port with the world's
    (so its int8 models are the one-rank models, above); under a bag the
    ranks' scales part, and one leaf value of the second tree is 2.9e-4
    off (ROADMAP.md §C entry 10)."""
    _, jax_out, port_out = worlds
    want, got = _text(jax_out, name, 0), _text(port_out, name, 0)
    assert _text(jax_out, name, 1) == want
    if name == "bagged_int8":
        assert _structure(got) == _structure(want)
        want, got = _first_tree(want), _first_tree(got)
    verdict = compare_models(want, got, False)
    assert verdict in ("bitwise", "within tolerance"), verdict


def test_cli_trains_the_python_route_model(worlds):
    """python -m lightgbm_tpu_torch task=train with a machine list and
    pre_partition=true writes the Python route's model on both ranks."""
    _, _, port_out = worlds
    want = _text(port_out, "rounds_int8_psum", 0)
    for r in (0, 1):
        assert _text(port_out, "cli", r) == want


def test_cli_saves_no_binary_cache_of_a_block(worlds):
    """is_save_binary_file in a pre-partitioned world: a rank's block
    would pass for the whole file, so no `.bin` cache is written."""
    _, _, port_out = worlds
    for r in (0, 1):
        assert json.loads((port_out / f"cli_bin_r{r}.json").read_text()) \
            is False


def test_query_data_and_feature_sharding_refused_as_in_jax(worlds):
    """Query data raises NotImplementedError in both packages;
    tree_learner=feature is refused by both; data2d on two ranks is the
    (2, 1) mesh, data-parallel, in both."""
    _, jax_out, port_out = worlds
    for r in (0, 1):
        got = json.loads((port_out / f"refusals_r{r}.json").read_text())
        want = json.loads((jax_out / f"refusals_r{r}.json").read_text())
        assert got["query"] == want["query"]
        assert got["query"][0] == "NotImplementedError"
        assert want["feature"] != "trained"
        assert got["feature"] == [
            "NotImplementedError", "multi-host feature-parallel training "
            "is not supported; use tree_learner=data"]
        assert got["data2d"] == want["data2d"] == "trained"


@pytest.mark.parametrize("n", [3001, 7, 1, 0])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_local_row_slice_tiles_the_rows(monkeypatch, n, size):
    """Contiguous ceil(n / W) blocks in rank order, the last ones
    shorter or empty, the whole range without a world."""
    from lightgbm_tpu_torch import distributed
    per = (n + size - 1) // size
    got = []
    for rank in range(size):
        monkeypatch.setattr(distributed, "world", lambda: (rank, size))
        sl = distributed.local_row_slice(n)
        assert sl == slice(min(rank * per, n), min((rank + 1) * per, n))
        got += list(range(n))[sl]
    assert got == list(range(n))


@pytest.mark.parametrize("mode,n,size,want", [
    ("auto", 200_002, 2, "allgather"), ("auto", 200_003, 2, "sketch"),
    ("auto", 10, 1, "allgather"), ("sketch", 10, 2, "sketch"),
    ("allgather", 10**7, 4, "allgather")])
def test_resolve_bin_find_is_the_jax_resolution(mode, n, size, want):
    from lightgbm_tpu.config import config_from_params as jcfg
    from lightgbm_tpu.distributed import resolve_bin_find as jresolve
    from lightgbm_tpu_torch.config import config_from_params as tcfg
    from lightgbm_tpu_torch.distributed import resolve_bin_find
    got = resolve_bin_find(tcfg({"bin_find": mode}), n, size)
    assert got == want == jresolve(jcfg({"bin_find": mode}), n, size)


@pytest.mark.parametrize("bin_find", ["allgather", "sketch"])
def test_one_process_mappers_are_the_jax_mappers(bin_find):
    """With no world the distributed mapper search is the search over
    the local sample, bitwise JAX's, and returns that sample (allgather)
    or the bounded plan sample (sketch)."""
    from lightgbm_tpu.config import config_from_params as jcfg
    from lightgbm_tpu.distributed import find_bin_mappers_distributed as jf
    from lightgbm_tpu_torch.config import config_from_params as tcfg
    from lightgbm_tpu_torch.distributed import find_bin_mappers_distributed
    rng = np.random.RandomState(3)
    sample = rng.randn(500, 4)
    sample[:, 3] = np.round(sample[:, 3])
    p = {"bin_find": bin_find, "sketch_eps": 1e-5}
    got, gs = find_bin_mappers_distributed(sample, tcfg(p),
                                           return_sample=True)
    want, ws = jf(sample, jcfg(p), return_sample=True)
    assert np.array_equal(gs, ws) and np.array_equal(gs, sample)
    for g, w in zip(got, want):
        assert g.num_bin == w.num_bin and g.is_trivial == w.is_trivial
        assert np.array_equal(np.asarray(g.bin_upper_bound),
                              np.asarray(w.bin_upper_bound))


@pytest.mark.parametrize("shape,size,exc", [
    ((2, 2), 4, NotImplementedError), ((1, 2), 2, NotImplementedError),
    ((1, 1), 2, ValueError)])
def test_rank_rows_refuses_what_jax_refuses(monkeypatch, shape, size, exc):
    """A feature axis raises JAX's NotImplementedError word for word; a
    data axis the world does not divide raises its ValueError.  Both
    before any collective."""
    from lightgbm_tpu_torch import distributed
    from lightgbm_tpu_torch.sharded.mesh import Mesh, RankRows
    monkeypatch.setattr(distributed, "world", lambda: (0, size))
    mesh = Mesh(shape, 0, "gloo", {"data": None, "feature": None})
    msg = ("multi-host feature-parallel training is not supported; use "
           "tree_learner=data" if exc is NotImplementedError
           else r"data axis \(1\) must be divisible by the process count")
    with pytest.raises(exc, match=msg):
        RankRows(mesh, 10)


def test_rank_rows_pads_to_the_longest_rank(monkeypatch):
    """per_proc is the longest rank's count; a short rank's tensors are
    zero-padded to it."""
    import torch
    from lightgbm_tpu_torch import distributed
    from lightgbm_tpu_torch.sharded.mesh import Mesh, RankRows
    monkeypatch.setattr(distributed, "world", lambda: (1, 2))
    monkeypatch.setattr(distributed, "_gathered_sizes",
                        lambda n: np.array([1501, n], np.int64))
    rr = RankRows(Mesh((2, 1), 1, "gloo", {"data": None, "feature": None}),
                  1500)
    assert (rr.per_proc, rr.n_global) == (1501, 3001)
    x = torch.arange(1500, dtype=torch.float32)
    padded = rr.pad_local(x)
    assert padded.shape == (1501,) and float(padded[-1]) == 0.0
    assert torch.equal(padded[:1500], x)
