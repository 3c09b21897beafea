"""The port's mesh layer and distributed helpers against the JAX
package's: lightgbm_tpu_torch.sharded.mesh and .distributed's pure
helpers, the split search over one rank's column slice
(ops/split.unbundle_hist_local, sharded_slice_search,
combine_sharded_records) against JAX's on the 8 virtual CPU devices of
tests/conftest.py, and make_mesh's shapes for every tree_learner.
Nothing here starts a process group (the worlds of several ranks are
tests/test_torch_parallel.py and tests/test_torch_distributed.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from lightgbm_tpu import distributed as jdist
from lightgbm_tpu.config import config_from_params as j_config
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.sharded import mesh as jmesh

from lightgbm_tpu_torch import distributed as tdist
from lightgbm_tpu_torch.config import config_from_params as t_config
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.sharded import mesh as tmesh


@pytest.mark.parametrize("n_cols,ndev,align", [
    (1, 1, 1), (7, 2, 1), (28, 3, 1), (28, 4, 32), (33, 2, 32), (40, 3, 1),
    (64, 8, 32), (5, 6, 1)])
def test_pad_cols_to_ndev_matches_jax(n_cols, ndev, align):
    assert tmesh.pad_cols_to_ndev(n_cols, ndev, align) == \
        jmesh.pad_cols_to_ndev(n_cols, ndev, align)


def test_pad_and_scatter_guards_raise_like_jax():
    for fn in (tmesh.pad_cols_to_ndev, jmesh.pad_cols_to_ndev):
        with pytest.raises(ValueError):
            fn(8, 0)
        with pytest.raises(ValueError):
            fn(8, 2, 0)
    for fn in (tmesh.check_scatter_divisible, jmesh.check_scatter_divisible):
        fn("cols", 8, 4)
        fn("cols", 7, 1)
        with pytest.raises(ValueError, match="pad_cols_to_ndev"):
            fn("cols", 7, 2)


@pytest.mark.parametrize("dd,df", [(1, 1), (4, 1), (1, 2), (4, 2), (2, 2)])
def test_row_shard_axes_matches_jax(dd, df):
    assert tmesh.row_shard_axes(dd, df) == jmesh.row_shard_axes(dd, df)


@pytest.mark.parametrize("params,ndev,payload", [
    ({}, 1, 1e9), ({}, 8, 64 * 1024), ({}, 8, 4.0 * 84 * 28 * 3 * 256),
    ({}, 2, float(1 << 20)), ({}, 2, float((1 << 20) - 1)),
    ({"hist_exchange": "psum"}, 8, 1e9),
    ({"hist_exchange": "psum_scatter"}, 8, 1.0),
    ({"hist_exchange": "psum_scatter"}, 1, 1.0),
    ({"hist_exchange_min_bytes": 0}, 2, 1.0),
    ({"hist_exchange_min_bytes": 4096}, 2, 4095.0),
    ({"histogram_reduce": "psum"}, 4, 1e9)])
def test_resolve_hist_exchange_matches_jax(params, ndev, payload):
    p = dict(params, verbose=-1)
    got = tmesh.resolve_hist_exchange(t_config(p), ndev=ndev,
                                      payload_bytes=payload)
    want = jmesh.resolve_hist_exchange(j_config(p), ndev=ndev,
                                       payload_bytes=payload)
    assert got == want


def test_hist_exchange_threshold_env_matches_jax(monkeypatch):
    for raw in ("", "123", "-5", "bogus"):
        monkeypatch.setenv("LGBT_HIST_EXCHANGE_MIN_BYTES", raw)
        assert tmesh._hist_exchange_threshold(None) == \
            jmesh._hist_exchange_threshold(None)
        cfg = {"verbose": -1}
        assert tmesh._hist_exchange_threshold(t_config(cfg)) == \
            jmesh._hist_exchange_threshold(j_config(cfg))


@pytest.mark.parametrize("lt", ["data", "voting", "feature", "data2d"])
@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_mesh_shapes_match_jax_make_mesh(lt, w):
    """The port's mesh over a W-rank world has the shape of JAX's
    make_mesh over W devices.  One rank is no mesh (JAX's make_mesh
    reads num_machines=1 as "every visible device", so W = 1 has no JAX
    counterpart here)."""
    if w == 1:
        assert tmesh.mesh_shape(lt, 1) == (1, 1)
        return
    jm = jmesh.make_mesh(lt, w)
    assert tmesh.mesh_shape(lt, w) == tuple(jm.devices.shape)
    assert tuple(jm.axis_names) == tmesh.Mesh.axis_names


def test_make_mesh_without_a_world_is_none():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for lt in ("data", "voting", "feature", "data2d"):
        assert tmesh.make_mesh(lt, 4) is None
    assert tmesh.mesh_axes(None) == {} == jmesh.mesh_axes(None)


def test_mesh_object_coordinates_and_identity_collectives():
    """A (2, 3) mesh's rank coordinates are row-major, the order in
    which a JAX row axis sharded over both axes lays its blocks out;
    a collective over an axis of size 1 is the identity."""
    m = tmesh.Mesh((2, 3), 4, "gloo", {"data": None, "feature": None})
    assert m.coords == (1, 1) and m.world == 6
    assert (m.size("data"), m.size("feature")) == (2, 3)
    assert tmesh.mesh_axes(m) == {"data": 2, "feature": 3}
    m1 = tmesh.Mesh((1, 1), 0, "gloo", {"data": None, "feature": None})
    x = torch.arange(6.0)
    assert m1.psum(x) is x and m1.pmax(x, "data") is x
    assert m1.psum_scatter(x, "data", 0) is x
    assert torch.equal(m1.all_gather(x), x[None])


@pytest.mark.parametrize("n,nsh", [(1201, 3), (1201, 1), (10, 4), (8, 2)])
def test_row_blocks_tile_the_padded_rows(n, nsh):
    """Blocks tile Np = nsh * ceil(n / nsh) rows in rank order, the JAX
    learners' padded layout, with the padding at the end."""
    x = torch.arange(n, dtype=torch.float32) + 1
    parts = []
    for b in range(nsh):
        r0, r1, loc = tmesh.row_block(n, nsh, b)
        assert loc == -(-n // nsh)
        parts.append(tmesh.take_rows(x, r0, r1, loc))
    full = torch.cat(parts)
    assert full.shape[0] == nsh * (-(-n // nsh))
    assert torch.equal(full[:n], x) and not full[n:].any()


def test_parse_machine_list_matches_jax(tmp_path):
    f = tmp_path / "mlist.txt"
    f.write_text("10.0.0.1 12400\n# comment\n10.0.0.2 12400 rank=5\n\n"
                 "10.0.0.3,12401\n")
    assert tdist.parse_machine_list(str(f)) == \
        jdist.parse_machine_list(str(f)) == [
            ("10.0.0.1", 12400, None), ("10.0.0.2", 12400, 5),
            ("10.0.0.3", 12401, None)]
    bad = tmp_path / "bad.txt"
    bad.write_text("10.0.0.1\n")
    for fn in (tdist.parse_machine_list, jdist.parse_machine_list):
        with pytest.raises(ValueError):
            fn(str(bad))


def test_resolve_rank_matches_jax(monkeypatch):
    machines = [("10.9.9.1", 1, None), ("10.9.9.2", 1, None)]
    monkeypatch.setenv("LIGHTGBM_TPU_MACHINE_RANK", "1")
    assert tdist.resolve_rank(machines) == jdist.resolve_rank(machines) == 1
    monkeypatch.delenv("LIGHTGBM_TPU_MACHINE_RANK")
    for ms in ([("10.9.9.1", 1, None), ("127.0.0.1", 1, None)],
               [("127.0.0.1", 1, 3), ("10.9.9.1", 1, None)]):
        assert tdist.resolve_rank(ms) == jdist.resolve_rank(ms)
    for ms in (machines, [("127.0.0.1", 1, None), ("127.0.0.1", 2, None)]):
        for fn in (tdist.resolve_rank, jdist.resolve_rank):
            with pytest.raises(ValueError):
                fn(ms)


def test_allgather_f64_single_process_is_bitwise():
    a = np.array([[1.0 / 3, np.nextafter(1.0, 2.0)], [-0.0, 1e-310]])
    got = tdist.allgather_f64(a)
    assert got.shape == (1, 2, 2)
    assert got.view(np.int64).tobytes() == a.view(np.int64).tobytes()
    assert np.array_equal(got.view(np.int64),
                          jdist.allgather_f64(a).view(np.int64))


def test_init_distributed_single_process_starts_nothing(monkeypatch):
    import torch.distributed as dist
    for k in ("WORLD_SIZE", "RANK", "LIGHTGBM_TPU_MACHINE_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_distributed(1) is False
    with pytest.warns(UserWarning, match="single-host test mode"):
        assert tdist.init_distributed(2, device_type="cpu") is False
    assert not dist.is_initialized()
    assert tdist.world() == (0, 1)
    assert tdist.default_backend("cuda") == "nccl"
    assert tdist.default_backend("cpu") == "gloo"


# ---- the split search over one rank's column slice -------------------------

def _hists(rng, k, C, B, nb):
    h = np.zeros((k, C, 3, B), np.float32)
    for c in range(C):
        m = int(nb[c])
        h[:, c, 0, :m] = rng.randn(k, m)
        h[:, c, 1, :m] = rng.rand(k, m) + 0.5
        h[:, c, 2, :m] = rng.randint(5, 40, (k, m))
    return h


class _StackMesh:
    """all_gather of a fixed per-rank stack: the combine's input."""

    def __init__(self, stack):
        self.stack = stack

    def all_gather(self, t, axes=None, *, kind="other"):
        return self.stack


def _jax_combine(stack):
    m = jax.sharding.Mesh(np.asarray(jax.devices()[:stack.shape[0]]),
                          ("data",))
    f = jmesh.compat_shard_map(
        lambda r: jsplit.combine_sharded_records(r[0], "data")[None],
        mesh=m, in_specs=P("data"), out_specs=P("data"))
    return np.asarray(jax.jit(f)(jnp.asarray(stack)))[0]


@pytest.mark.parametrize("nd", [2, 3, 4])
def test_combine_sharded_records_matches_jax(nd):
    """Max gain, ties to the smallest feature id, -inf rows and
    non-monotone feature ownership (EFB) included."""
    rng = np.random.RandomState(nd)
    k = 6
    stack = rng.rand(nd, k, 11).astype(np.float32)
    stack[:, :, 1] = rng.permutation(nd * k).reshape(nd, k)
    stack[:, 0, 0] = 2.0                       # a tie on every rank
    stack[:, 1, 0] = -np.inf                   # nothing splits
    stack[nd - 1, 2, 0] = 5.0                  # the last rank wins
    got = tsplit.combine_sharded_records(torch.as_tensor(stack[0]),
                                         _StackMesh(torch.as_tensor(stack)),
                                         "data")
    assert np.array_equal(got.numpy(), _jax_combine(stack))
    assert got[0, 1] == stack[:, 0, 1].min()


def test_unbundle_hist_local_matches_jax():
    """A rank's slice of a bundled histogram unbundles to the features
    it owns exactly as JAX's does, with the same ownership mask."""
    from lightgbm_tpu.dataset import Dataset as JDS
    from lightgbm_tpu_torch.dataset import Dataset as TDS
    rng = np.random.RandomState(1)
    n, groups, levels = 1200, 6, 5
    lab = rng.randint(0, levels, (n, groups))
    X = np.zeros((n, groups * levels))
    for g in range(groups):
        X[np.arange(n), g * levels + lab[:, g]] = 1.0
    X = np.hstack([X, rng.randn(n, 2)])
    y = (rng.rand(n) > 0.5).astype(np.float64)
    p = {"verbose": -1, "enable_bundle": True, "device_type": "cpu"}
    tds = TDS(X, y, config=t_config(p))
    jds = JDS(X, y, config=j_config({k: v for k, v in p.items()
                                     if k != "device_type"}))
    C = tds.num_store_columns
    assert tds.bundle_plan is not None and C < X.shape[1]
    nd = 2
    Cp = tmesh.pad_cols_to_ndev(C, nd)
    B = 128
    src, dmask = tds.unbundle_tables(B, Cp)
    jsrc, jdmask = jds.unbundle_tables(B, Cp)
    assert np.array_equal(src, jsrc) and np.array_equal(dmask, jdmask)
    nb = np.concatenate([np.full(C, 6), np.ones(Cp - C, int)])
    h = _hists(rng, 1, Cp, B, nb)[0]
    tot = np.array([h[0, 0].sum(), h[0, 1].sum(), h[0, 2].sum()],
                   np.float32)
    for r in range(nd):
        cs = Cp // nd
        hs = h[r * cs:(r + 1) * cs]
        got, own = tsplit.unbundle_hist_local(
            torch.as_tensor(hs), torch.as_tensor(src),
            torch.as_tensor(dmask), torch.as_tensor(tot), r * cs)
        want, jown = jsplit.unbundle_hist_local(
            jnp.asarray(hs), jnp.asarray(src), jnp.asarray(dmask),
            jnp.asarray(tot), r * cs)
        assert np.array_equal(own.numpy(), np.asarray(jown))
        np.testing.assert_allclose(got.numpy()[own.numpy()],
                                   np.asarray(want)[np.asarray(jown)],
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("nd", [2, 4])
def test_sharded_slice_search_matches_jax_full_search(nd):
    """Each rank's slice search then the combine is the full search:
    the port's against JAX's sharded_slice_search + combine, and both
    against the full best_split."""
    rng = np.random.RandomState(5 + nd)
    k, C, B = 3, 8, 128
    nb = rng.randint(3, 30, C)
    nb[3] = 1
    h = _hists(rng, k, C, B, nb)
    sums = np.stack([h[:, 0, 0].sum(-1), h[:, 0, 1].sum(-1),
                     h[:, 0, 2].sum(-1)], -1).astype(np.float32)
    ic = np.zeros(C, bool)
    ic[5] = True
    fm = np.ones(C, bool)
    fm[6] = False
    skw = dict(lambda_l1=0.0, lambda_l2=1.0, min_data_in_leaf=5,
               min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    cs = C // nd
    recs = []
    for r in range(nd):
        s = slice(r * cs, (r + 1) * cs)
        recs.append(tsplit.sharded_slice_search(
            torch.as_tensor(h[:, s]), torch.as_tensor(sums), off=r * cs,
            nb_s=torch.as_tensor(nb[s]), ic_s=torch.as_tensor(ic[s]),
            fm_s=torch.as_tensor(fm[s]), num_bins=None, is_cat=None,
            fmask=None, unb=None, skw=skw))
        for j in range(k):
            want = jsplit.sharded_slice_search(
                jnp.asarray(h[j, s]), jnp.asarray(sums[j]), off=r * cs,
                nb_s=jnp.asarray(nb[s]), ic_s=jnp.asarray(ic[s]),
                fm_s=jnp.asarray(fm[s]), num_bins=None, is_cat=None,
                fmask=None, unb=None, skw=skw)
            np.testing.assert_allclose(recs[-1][j].numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
    stack = torch.stack(recs)
    got = tsplit.combine_sharded_records(stack[0], _StackMesh(stack), "data")
    full = tsplit.best_split(torch.as_tensor(h), torch.as_tensor(nb),
                             torch.as_tensor(ic), torch.as_tensor(fm),
                             torch.as_tensor(sums[:, 0]),
                             torch.as_tensor(sums[:, 1]),
                             torch.as_tensor(sums[:, 2]), **skw)
    assert torch.equal(got[:, 1:3], full[:, 1:3])
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-6)
    assert np.array_equal(got.numpy(), _jax_combine(stack.numpy()))


def test_batched_metadata_search_equals_per_leaf():
    """best_split with per-leaf feature metadata [k, n] (the voting
    learner's voted subsets) equals one search a leaf."""
    rng = np.random.RandomState(9)
    k, n, B = 3, 4, 128
    nb = rng.randint(3, 20, (k, n))
    h = np.stack([_hists(rng, 1, n, B, nb[j])[0] for j in range(k)])
    sums = np.stack([h[:, 0, 0].sum(-1), h[:, 0, 1].sum(-1),
                     h[:, 0, 2].sum(-1)], -1).astype(np.float32)
    ic = rng.rand(k, n) < 0.3
    fm = rng.rand(k, n) < 0.8
    skw = dict(lambda_l2=1.0, min_data_in_leaf=5)
    got = tsplit.best_split(
        torch.as_tensor(h), torch.as_tensor(nb), torch.as_tensor(ic),
        torch.as_tensor(fm), torch.as_tensor(sums[:, 0]),
        torch.as_tensor(sums[:, 1]), torch.as_tensor(sums[:, 2]), **skw)
    for j in range(k):
        one = tsplit.best_split(
            torch.as_tensor(h[j]), torch.as_tensor(nb[j]),
            torch.as_tensor(ic[j]), torch.as_tensor(fm[j]),
            torch.as_tensor(sums[j, 0]), torch.as_tensor(sums[j, 1]),
            torch.as_tensor(sums[j, 2]), **skw)
        assert torch.equal(got[j], one)
