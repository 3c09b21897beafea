"""Each CUDA kernel of lightgbm_tpu_torch against its plain PyTorch
version, on the card.

These tests need a CUDA device: they carry the `cuda` marker and skip
where none is visible (a CUDA kernel has no interpret mode).  The file
imports no JAX, so it runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: K1 (int8 histogram), K3 (lookup) and K4 (partition) are
integer-exact or pure data movement and must be bitwise equal.  K2
(float32 histogram) adds each cell's values with float atomics in a
run-dependent order: n f32 additions reorder within n * 2^-24 * sum|x|,
below 1e-3 for the ~15 rows of |x| <= 4 per cell here.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import kernels
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import lookup as tl
from lightgbm_tpu_torch.ops import partition as tp

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


@pytest.mark.parametrize("int8_bins", [False, True])
def test_partition_kernel_vs_plain(dev, int8_bins):
    rng = np.random.RandomState(4)
    n, f, L = 100_003, 28, 255
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
    out = tp.partition_rows(*[a.to(dev) for a in args]).cpu()
    assert kernels.LAUNCHES["partition_rows"] == before + 1
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


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


def test_cuda_tensor_never_takes_the_plain_version(dev, monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the library
    call failing, the wrapper raises instead of falling back."""
    def refuse(*a, **k):
        raise RuntimeError("launch refused")
    monkeypatch.setattr(kernels, "call", refuse)
    t = torch.zeros((1, 4), device=dev)
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="launch refused"):
        tl.table_lookup(t, ids)
