"""The port's data-file readers (lightgbm_tpu_torch/dataset.py,
lightgbm_tpu_torch/native.py) against the JAX package's.

Every file is written here, from a seed, under tmp_path.  Parsing and
binning are exact, so every comparison is bitwise: the parsed (X, y,
names) of CSV, TSV, LibSVM, header and comment files; the port's native
parser against its NumPy parser; side files; every in-file column
selector; `Dataset.from_file` mappers, store and metadata, one-shot and
two-round (the sample smaller than the file and spread over several
chunks, so the reservoir's replacement phase runs); binary files written
by one package and read by the other, and the `.bin` cache's mtime rule;
the error types of an empty file and of LibSVM under two-round loading.

The last test writes values with `%.17g`.  The port reads them correctly
rounded on every path (one-shot, two-round, and task=predict's chunked
reader), bitwise as JAX's one-shot `parse_text_file`.  JAX's two-round
loader reads them through pandas' default float converter, which is not
correctly rounded, so its values, and with them its bin mappers, differ
there (ROADMAP.md §C entry 8); at `%.9g` both agree, which the other
two-round tests use.
"""
import os
import time

import numpy as np
import pytest

from lightgbm_tpu import dataset as JDS
from lightgbm_tpu.config import config_from_params as jcfg

from lightgbm_tpu_torch import dataset as TDS, native
from lightgbm_tpu_torch.application import _iter_predict_chunks
from lightgbm_tpu_torch.config import config_from_params as tcfg


def _rows(n=3000, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[:, 2] = np.round(X[:, 2] * 2)          # a few distinct values
    X[rng.rand(n) < 0.05, 3] = 0.0
    y = (X[:, 0] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _write(path, X, y, fmt="csv", header=None, digits=9, comments=False):
    """The label first, then the features; `fmt` csv | tsv | space |
    libsvm."""
    sep = {"csv": ",", "tsv": "\t", "space": " "}.get(fmt)
    with open(path, "w") as f:
        if header is not None:
            f.write((sep or " ").join(header) + "\n")
        for i in range(len(y)):
            if comments and i % 500 == 7:
                f.write("# a comment line\n")
            if fmt == "libsvm":
                toks = [f"{y[i]:.{digits}g}"] + [
                    f"{j}:{v:.{digits}g}" for j, v in enumerate(X[i])
                    if v != 0.0]
                f.write(" ".join(toks) + "\n")
            else:
                f.write(sep.join(f"{v:.{digits}g}"
                                 for v in [y[i], *X[i]]) + "\n")
    return str(path)


def _cfgs(**p):
    p = dict(p, verbose=-1)
    return jcfg(p), tcfg(dict(p, device_type="cpu"))


def _assert_same_dataset(dj, dt):
    assert dt.num_data == dj.num_data
    assert dt.num_total_features == dj.num_total_features
    assert list(dt.used_features) == list(dj.used_features)
    assert list(dt.feature_names) == list(dj.feature_names)
    for mt, mj in zip(dt.mappers, dj.mappers):
        assert (mt.bin_type, mt.num_bin, mt.default_bin, mt.is_trivial) == \
            (mj.bin_type, mj.num_bin, mj.default_bin, mj.is_trivial)
        assert (mt.min_val, mt.max_val) == (mj.min_val, mj.max_val)
        assert np.array_equal(np.asarray(mt.bin_upper_bound),
                              np.asarray(mj.bin_upper_bound))
        assert list(mt.bin_2_categorical) == list(mj.bin_2_categorical)
    assert np.array_equal(dt.bins, np.asarray(dj.bins)[:, :dt.num_data])
    mt, mj = dt.metadata, dj.metadata
    assert np.array_equal(mt.label, np.asarray(mj.label))
    for a, b in ((mt.weights, mj.weights),
                 (mt.query_boundaries, mj.query_boundaries),
                 (mt.init_score, mj.init_score)):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b))


FORMATS = [
    # (format, header, comments, label_idx)
    ("csv", False, False, 0),
    ("tsv", False, False, 0),
    ("space", False, False, 0),
    ("libsvm", False, False, 0),
    ("csv", True, False, 0),
    ("csv", True, True, 0),
    ("tsv", True, True, 0),
    ("libsvm", True, False, 0),
    ("csv", False, False, 3),
]


@pytest.mark.parametrize("fmt,header,comments,label_idx", FORMATS)
def test_parse_text_file_matches_jax(tmp_path, fmt, header, comments,
                                     label_idx):
    X, y = _rows(400)
    names = ["label"] + [f"f{j}" for j in range(X.shape[1])]
    path = _write(tmp_path / "d.txt", X, y, fmt,
                  header=names if header else None, comments=comments)
    Xt, yt, nt = TDS.parse_text_file(path, header, label_idx)
    Xj, yj, nj = JDS.parse_text_file(path, header, label_idx)
    assert np.array_equal(Xt, Xj) and np.array_equal(yt, yj)
    assert nt == nj
    if header:
        assert nt == names


@pytest.mark.parametrize("fmt", ["csv", "tsv", "space", "libsvm"])
@pytest.mark.parametrize("digits", [9, 17])
def test_native_parser_matches_numpy_parser(tmp_path, fmt, digits):
    X, y = _rows(500, seed=digits)
    path = _write(tmp_path / "d.txt", X, y, fmt, digits=digits)
    before = dict(native.PARSES)
    Xn, yn, _ = TDS.parse_text_file(path)
    assert native.PARSES["native"] == before["native"] + 1
    Xp, yp, _ = TDS.parse_text_file_numpy(path)
    assert np.array_equal(Xn, Xp) and np.array_equal(yn, yp)


def test_side_files(tmp_path):
    X, y = _rows(300)
    path = _write(tmp_path / "d.csv", X, y)
    rng = np.random.RandomState(1)
    np.savetxt(path + ".weight", rng.rand(300) + 0.5, fmt="%.9g")
    np.savetxt(path + ".init", rng.randn(300), fmt="%.17g")
    np.savetxt(path + ".query", [100, 50, 150], fmt="%d")
    mt = TDS.Metadata.load_side_files(path, 300)
    mj = JDS.Metadata.load_side_files(path, 300)
    for name in ("weights", "init_score", "query_boundaries"):
        a, b = getattr(mt, name), getattr(mj, name)
        assert a is not None and a.dtype == b.dtype
        assert np.array_equal(a, b)
    jc, tc = _cfgs(objective="lambdarank", max_bin=63)
    _assert_same_dataset(JDS.Dataset.from_file(path, jc),
                         TDS.Dataset.from_file(path, tc))


SELECTORS = [
    {"label_column": "2"},
    {"weight_column": "3"},
    {"group_column": "1", "objective": "lambdarank"},
    {"ignore_column": "4,5"},
    {"ignore_column": "name:f3,f4", "has_header": True},
    {"weight_column": "name:f5", "has_header": True},
    {"categorical_column": "3"},
    {"categorical_column": "name:f2", "has_header": True},
    {"label_column": "1", "weight_column": "6", "ignore_column": "2"},
]


@pytest.mark.parametrize("sel", SELECTORS,
                         ids=lambda s: ",".join(f"{k}={v}"
                                                for k, v in s.items()))
@pytest.mark.parametrize("two_round", [False, True])
def test_column_selectors_match_jax(tmp_path, sel, two_round):
    X, y = _rows(1200)
    X[:, 0] = np.repeat(np.arange(12), 100)          # contiguous query ids
    X[:, 4] = np.abs(X[:, 4]) + 0.1                  # positive weights
    X[:, 1] = np.round(np.abs(X[:, 1]) * 3) % 5      # a categorical
    header = ["label"] + [f"f{j}" for j in range(X.shape[1])]
    path = _write(tmp_path / "d.csv", X, y,
                  header=header if sel.get("has_header") else None)
    p = dict(sel, max_bin=63, min_data_in_leaf=5,
             use_two_round_loading=two_round,
             bin_construct_sample_cnt=500, stream_chunk_rows=256)
    jc, tc = _cfgs(**p)
    _assert_same_dataset(JDS.Dataset.from_file(path, jc),
                         TDS.Dataset.from_file(path, tc))


@pytest.mark.parametrize("fmt,header", [("csv", False), ("tsv", True),
                                        ("space", False)])
def test_from_file_matches_jax(tmp_path, fmt, header):
    X, y = _rows(2000)
    path = _write(tmp_path / "d.txt", X, y, fmt,
                  header=(["label"] + [f"c{j}" for j in range(6)]
                          if header else None))
    jc, tc = _cfgs(max_bin=255, has_header=header)
    dj = JDS.Dataset.from_file(path, jc)
    dt = TDS.Dataset.from_file(path, tc)
    _assert_same_dataset(dj, dt)
    assert dt.source == path
    # a valid set from a file takes the training set's mappers
    vpath = _write(tmp_path / "v.txt", *_rows(300, seed=4), fmt,
                   header=(["label"] + [f"c{j}" for j in range(6)]
                           if header else None))
    _assert_same_dataset(JDS.Dataset.from_file(vpath, jc, reference=dj),
                         TDS.Dataset.from_file(vpath, tc, reference=dt))


@pytest.mark.parametrize("fmt,header,chunk", [("csv", False, 256),
                                              ("tsv", True, 256),
                                              ("csv", False, 1000),
                                              ("space", False, 7)])
def test_two_round_matches_jax(tmp_path, fmt, header, chunk):
    """3,000 rows, a 500-row sample and chunks smaller than the file: the
    reservoir fills in the first chunk(s) and replaces in the others, one
    rand and one randint draw a chunk, as pd.read_csv(chunksize=) cuts
    the file."""
    X, y = _rows(3000)
    path = _write(tmp_path / "d.txt", X, y, fmt,
                  header=(["label"] + [f"c{j}" for j in range(6)]
                          if header else None))
    jc, tc = _cfgs(max_bin=63, has_header=header, use_two_round_loading=True,
                   bin_construct_sample_cnt=500, stream_chunk_rows=chunk)
    dt = TDS.Dataset.from_file(path, tc)
    _assert_same_dataset(JDS.Dataset.from_file(path, jc), dt)
    # chunks of exactly stream_chunk_rows rows, comments holding none
    sizes = [len(a) for a in TDS.iter_text_chunks(path, TDS.probe_text_file(
        path, header)[0], header, chunk)]
    assert sum(sizes) == 3000 and set(sizes[:-1]) <= {chunk}


def test_binary_files_cross_load(tmp_path):
    """A .bin written by either package loads in the other; the cache
    beside a text file is taken only while it is at least as new."""
    X, y = _rows(1500)
    path = _write(tmp_path / "d.csv", X, y)
    np.savetxt(path + ".weight", np.linspace(0.5, 1.5, 1500), fmt="%.9g")
    jc, tc = _cfgs(max_bin=63)
    dj = JDS.Dataset.from_file(path, jc)
    dt = TDS.Dataset.from_file(path, tc)
    dj.save_binary(str(tmp_path / "j.bin"))
    dt.save_binary(str(tmp_path / "t.bin"))
    _assert_same_dataset(dj, TDS.Dataset.from_file(str(tmp_path / "j.bin"),
                                                   tc))
    _assert_same_dataset(JDS.Dataset.from_file(str(tmp_path / "t.bin"), jc),
                         dt)
    assert TDS.Dataset._is_binary_file(str(tmp_path / "j.bin"))
    assert not TDS.Dataset._is_binary_file(path)

    # the cache rule: <path>.bin is loaded while it is not older than the
    # text file (a cache of other rows shows which one was read)
    other = TDS.Dataset.from_file(
        _write(tmp_path / "o.csv", *_rows(700, seed=9)), tc)
    other.save_binary(path + ".bin")
    assert TDS.Dataset.from_file(path, tc).num_data == 700
    assert JDS.Dataset.from_file(path, jc).num_data == 700
    old = time.time() - 100
    os.utime(path + ".bin", (old, old))
    assert TDS.Dataset.from_file(path, tc).num_data == 1500
    assert JDS.Dataset.from_file(path, jc).num_data == 1500
    _, no_cache = _cfgs(max_bin=63, enable_load_from_binary_file=False)
    os.utime(path + ".bin", None)
    assert TDS.Dataset.from_file(path, no_cache).num_data == 1500
    # a valid cache binned with other mappers is refused
    _, tc15 = _cfgs(max_bin=15)
    small = TDS.Dataset.from_file(str(tmp_path / "o.csv"), tc15)
    small.config = tc
    small.save_binary(str(tmp_path / "v.bin"))
    with pytest.raises(ValueError, match="binned differently"):
        TDS.Dataset.from_file(str(tmp_path / "v.bin"), tc, reference=dt)


@pytest.mark.parametrize("two_round,header", [(False, True), (True, False),
                                               (True, True)])
def test_empty_file_error_types(tmp_path, two_round, header):
    """An empty file raises ValueError in both packages (JAX's two-round
    loader raises pandas' EmptyDataError, a ValueError)."""
    path = tmp_path / "empty.csv"
    path.write_text("")
    jc, tc = _cfgs(use_two_round_loading=two_round, has_header=header)
    with pytest.raises(ValueError):
        JDS.Dataset.from_file(str(path), jc)
    with pytest.raises(ValueError, match="empty data file"):
        TDS.Dataset.from_file(str(path), tc)


def test_empty_file_without_header_raises(tmp_path):
    """Without a header the JAX package's native parse of an empty file
    returns zero rows; the port raises as its other paths do."""
    path = tmp_path / "empty.csv"
    path.write_text("")
    assert JDS.parse_text_file(str(path))[0].shape[0] == 0
    with pytest.raises(ValueError, match="empty data file"):
        TDS.parse_text_file(str(path))


def test_two_round_libsvm_error_type(tmp_path):
    path = _write(tmp_path / "d.svm", *_rows(50), "libsvm")
    jc, tc = _cfgs(use_two_round_loading=True)
    with pytest.raises(ValueError, match="csv/tsv only"):
        JDS.Dataset.from_file(path, jc)
    with pytest.raises(ValueError, match="csv/tsv only"):
        TDS.Dataset.from_file(path, tc)


def test_pre_partition_without_a_world_loads_every_row(tmp_path):
    """is_pre_partition with num_machines > 1 but no world of ranks
    loads the whole file, as the JAX loader does in one process."""
    path = _write(tmp_path / "d.csv", *_rows(500))
    jc, tc = _cfgs(num_machines=2, is_pre_partition=True)
    dt = TDS.Dataset.from_file(path, tc)
    assert dt.num_data == 500 and dt.rank_rows is None
    _assert_same_dataset(JDS.Dataset.from_file(path, jc), dt)


def test_seventeen_digit_values_read_correctly_rounded(tmp_path):
    """ROADMAP.md §C entry 8.  Values written with %.17g: the port's
    one-shot parse (native and NumPy), its two-round loader and
    task=predict's chunked reader hold JAX's one-shot parse_text_file
    bitwise.  JAX's two-round loader parses through pandas.read_csv,
    whose default float converter ("high", not "round_trip") is not
    correctly rounded: its values differ from np.loadtxt's by a few ulp,
    so its bin mappers differ from its own one-shot load's, while the
    port's two-round mappers are the one-shot's."""
    X, y = _rows(3000, seed=11)
    path = _write(tmp_path / "d.csv", X, y, digits=17)
    Xj, yj, _ = JDS.parse_text_file(path)
    for Xt, yt, _ in (TDS.parse_text_file(path),
                      TDS.parse_text_file_numpy(path)):
        assert np.array_equal(Xt, Xj) and np.array_equal(yt, yj)
    chunks = list(_iter_predict_chunks(path, False, 0, 256))
    assert len(chunks) == 12
    assert np.array_equal(np.concatenate(chunks), Xj)
    # the sample holds every row, so a two-round load bins the same
    # values as a one-shot load
    p = dict(max_bin=255, bin_construct_sample_cnt=3000,
             stream_chunk_rows=256)
    jc1, tc1 = _cfgs(**p)
    jc2, tc2 = _cfgs(**p, use_two_round_loading=True)
    one_shot = JDS.Dataset.from_file(path, jc1)
    _assert_same_dataset(one_shot, TDS.Dataset.from_file(path, tc1))
    _assert_same_dataset(one_shot, TDS.Dataset.from_file(path, tc2))
    jax_two_round = JDS.Dataset.from_file(path, jc2)
    assert any(not np.array_equal(a.bin_upper_bound, b.bin_upper_bound)
               for a, b in zip(jax_two_round.mappers, one_shot.mappers))
    import pandas as pd
    Xpd = pd.read_csv(path, header=None, dtype=np.float64).to_numpy()[:, 1:]
    assert (Xpd != Xj).sum() > 0
