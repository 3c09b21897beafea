"""The mesh layer of the multi-GPU learners: every mesh, axis and
collective decision in one module.

Port of lightgbm_tpu/sharded/mesh.py onto `torch.distributed`.

Process model.  The JAX mesh learners are single-controller SPMD: one
process, a `shard_map` body per device, and `psum`, `psum_scatter` and
`all_gather` between the bodies.  Here the mesh is the
`torch.distributed` world: one process (rank) per card, and the
`shard_map` body is the rank's own program.

- `make_mesh(tree_learner)` returns a `Mesh` over the initialised world
  (None when there is none, or it has one rank: the learners then run
  on one device, as the JAX factory does when it sees one device).  Its
  axes are ("data", "feature"), its shape (W, 1) for data and voting,
  (1, W) for feature and the balanced factorization for data2d; rank r
  sits at (r // df, r % df), the row-major order in which a JAX row
  axis sharded over both mesh axes lays its blocks out.
- How ranks start: `python -m torch.distributed.run` (its environment
  variables), or `distributed.init_distributed` from `num_machines` and
  a machine list.  Either way the backend is chosen explicitly: NCCL
  when every rank has its own card, gloo when the tensors are on the
  CPU or several ranks share one card (NCCL refuses two ranks on one
  device).  Each rank makes `torch.cuda.set_device(local_rank)` its
  current device, so `device_type="cuda"` means the rank's own card.
- Where the rows live, in one of two modes.  Replicated (a Dataset of
  all N rows on every rank): the boosting loop runs replicated over all
  N rows on each card (scores, gradients, bagging and metrics from the
  same seeds, so every rank holds the same bits); the tree learner
  uploads only the rank's row block of the store (rows padded to
  Np = nsh * ceil(N / nsh), padding rows masked out, as the JAX
  learners pad), grows the tree with the collectives below, and returns
  every row's leaf id through one `all_gather` at the end of the tree.
  Pre-partitioned (the loader kept only the rank's rows,
  `Dataset.rank_rows`; the JAX package's multi-process worlds): the
  boosting loop runs over the local rows only (local scores, gradients,
  bag and metrics; boost-from-average from the world's label sum), the
  rank's rows are its block (`RankRows`: padded to the longest rank's
  count), and the learner returns the local leaf ids, with no gather.

Collectives (`Mesh.psum`, `pmax`, `psum_scatter`, `all_gather`) map
`lax.psum` to `all_reduce`, `lax.psum_scatter` to
`reduce_scatter_tensor` over the scattered axis, and `lax.all_gather`
to `all_gather_into_tensor`.  Under NCCL every collective takes the
device tensor as it is.  Under gloo a CUDA tensor is staged through
host memory (copied to the CPU, reduced there, copied back inside
`explicit_transfer`): gloo's CUDA support does not cover every
collective (no reduce-scatter and no all-gather of CUDA tensors), so
the gloo path stages them all, and takes `all_reduce` plus a slice for
the reduce-scatter and the list form of `all_gather`, which every
gloo build has.  Nothing is staged under NCCL.

Axis convention (the JAX module's): rows shard over every axis with
size > 1; under the psum_scatter exchange the histogram's store-column
axis is scattered over ONE of them: the data axis on a 1-D mesh, the
feature axis on a 2-D (data x feature) mesh, where the exchange
becomes "reduce-scatter over feature, then psum over data"
(docs/Distributed-Data.md).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch

from ..config import Config

AXES = ("data", "feature")


class Mesh:
    """A (data, feature) mesh over the `torch.distributed` world.

    `shape` is (dd, df) with dd * df == world size; `coords` is this
    rank's (data, feature) position; `groups` maps "data" and
    "feature" to the process group of the ranks that share this rank's
    other coordinate (None: the whole world; an axis of size 1 has no
    group).  Made by `make_mesh`; every rank builds its groups in the
    same order, as `torch.distributed.new_group` requires.

    `collective_bytes` and `collective_calls` count the payload this
    rank's collectives moved (the reduced tensor of a psum or pmax, the
    kept slice of a psum_scatter, the gathered tensor of an
    all_gather); `kind_bytes` splits the bytes by the `kind` each call
    names: "hist" for the histogram exchange, "records" for the
    gathered best-split records, "other" for the rest (votes, row
    sides, leaf ids)."""

    axis_names = AXES

    def __init__(self, shape: Tuple[int, int], rank: int, backend: str,
                 groups: Dict[str, object]):
        self.shape = (int(shape[0]), int(shape[1]))
        self.world = self.shape[0] * self.shape[1]
        self.rank = int(rank)
        self.coords = (self.rank // self.shape[1], self.rank % self.shape[1])
        self.backend = backend
        self.groups = groups
        # gloo stages CUDA tensors through host memory (module docstring)
        self.staged = backend == "gloo"
        self.collective_bytes = 0
        self.collective_calls = 0
        self.kind_bytes: Dict[str, int] = {}

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"backend={self.backend!r})")

    # -- axes -------------------------------------------------------------
    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def _live(self, axes) -> Tuple[str, ...]:
        if axes is None:
            axes = AXES
        elif isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in axes if self.size(a) > 1)

    def _group(self, live: Tuple[str, ...]):
        """The process group spanning `live` (the world when it spans
        both axes or the only axis of size > 1)."""
        if len(live) == 2 or self.size(live[0]) == self.world:
            return None
        return self.groups[live[0]]

    def group_size(self, axes) -> int:
        live = self._live(axes)
        return int(math.prod(self.size(a) for a in live)) if live else 1

    # -- host staging -------------------------------------------------------
    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        if self.staged and t.is_cuda:
            from ..diagnostics.sanitize import explicit_transfer
            with explicit_transfer():
                return t.cpu()
        return t.contiguous()

    def _unstage(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if h.device != like.device:
            from ..diagnostics.sanitize import explicit_transfer
            with explicit_transfer():
                return h.to(like.device)
        return h

    def _count(self, t: torch.Tensor, kind: str) -> None:
        n = t.numel() * t.element_size()
        self.collective_bytes += n
        self.collective_calls += 1
        self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) + n

    # -- collectives --------------------------------------------------------
    def _reduce(self, t: torch.Tensor, axes, op, kind) -> torch.Tensor:
        import torch.distributed as dist
        live = self._live(axes)
        if not live:
            return t
        h = self._stage(t)
        if h is t:
            h = t.clone()
        dist.all_reduce(h, op=op, group=self._group(live))
        self._count(h, kind)
        return self._unstage(h, t)

    def psum(self, t: torch.Tensor, axes=None, *,
             kind: str = "other") -> torch.Tensor:
        """`lax.psum(t, axes)`: the sum over the ranks of `axes` (both
        axes when None), the same bits on every one of them."""
        import torch.distributed as dist
        return self._reduce(t, axes, dist.ReduceOp.SUM, kind)

    def pmax(self, t: torch.Tensor, axes=None, *,
             kind: str = "other") -> torch.Tensor:
        """`lax.pmax(t, axes)`."""
        import torch.distributed as dist
        return self._reduce(t, axes, dist.ReduceOp.MAX, kind)

    def psum_scatter(self, t: torch.Tensor, axis: str, dim: int, *,
                     kind: str = "other") -> torch.Tensor:
        """`lax.psum_scatter(t, axis, scatter_dimension=dim, tiled=True)`:
        the sum over the ranks of `axis`, of which this rank keeps the
        `index(axis)`-th of `size(axis)` equal slices along `dim`."""
        import torch.distributed as dist
        n = self.size(axis)
        if n <= 1:
            return t
        check_scatter_divisible(f"dimension {dim}", t.shape[dim], n)
        k = t.shape[dim] // n
        i = self.index(axis)
        group = self._group((axis,))
        if self.staged:
            h = self._stage(t)
            if h is t:
                h = t.clone()
            dist.all_reduce(h, group=group)
            out = self._unstage(h.narrow(dim, i * k, k).contiguous(), t)
        else:
            src = t.movedim(dim, 0).contiguous()
            out = torch.empty((k,) + tuple(src.shape[1:]), dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, src, group=group)
            out = out.movedim(0, dim).contiguous()
        self._count(out, kind)
        return out

    def all_gather(self, t: torch.Tensor, axes=None, *,
                   kind: str = "other") -> torch.Tensor:
        """`lax.all_gather(t, axes)`: [n, *t.shape], stacked in the
        ranks' order along `axes` (both axes when None)."""
        import torch.distributed as dist
        live = self._live(axes)
        if not live:
            return t[None]
        n = self.group_size(live)
        group = self._group(live)
        h = self._stage(t)
        if self.staged:
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=group)
            out = torch.stack(parts)
        else:
            out = torch.empty((n,) + tuple(h.shape), dtype=h.dtype,
                              device=h.device)
            dist.all_gather_into_tensor(out, h, group=group)
        self._count(out, kind)
        return self._unstage(out, t)

    def record_tree_exchange(self, before: Dict[str, int]) -> None:
        """Add the "hist" and "records" bytes since `before` (a copy of
        `kind_bytes` taken when the tree started) to the profiling
        registry's tree/hist_exchange_bytes and tree/split_records_bytes."""
        from .. import profiling
        for kind, name in (("hist", profiling.HIST_EXCHANGE_BYTES),
                           ("records", profiling.SPLIT_RECORDS_BYTES)):
            profiling.count(name, self.kind_bytes.get(kind, 0)
                            - before.get(kind, 0))

    def collective_device(self) -> torch.device:
        """Where a host-side value travels for a collective: the current
        card under NCCL, the CPU under gloo."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")


class HistExchange:
    """The histogram exchange of a data-parallel learner: reduces one
    rank's local histogram pass [..., C, 3, B] across the ranks of the
    row axes, by a full psum, or under psum_scatter by a reduce-scatter
    of the column axis over `scatter_axis` (the feature axis on a 2-D
    mesh, then a psum of the kept slice over the data axis).

    The histogram ops call it on their accumulated sums (the int32 ones
    before the dequantize) and `amax` on the int8 scales' maxima, both
    counted as the mesh's "hist" bytes.  `shards` is the row-shard
    count."""

    def __init__(self, mesh: Mesh, scatter: bool):
        self.mesh = mesh
        self.row_axes = row_shard_axes(*mesh.shape)
        self.shards = mesh.world
        self.scatter_axis = (("feature" if mesh.shape[1] > 1 else "data")
                             if scatter else None)

    @property
    def slices(self) -> int:
        """How many column slices the exchange cuts (1 under psum)."""
        return self.mesh.size(self.scatter_axis) if self.scatter_axis else 1

    @property
    def slice_index(self) -> int:
        """Which column slice this rank keeps (0 under psum)."""
        return self.mesh.index(self.scatter_axis) if self.scatter_axis \
            else 0

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.pmax(t, self.row_axes, kind="hist")

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        if self.scatter_axis is None:
            return self.mesh.psum(h, self.row_axes, kind="hist")
        out = self.mesh.psum_scatter(h, self.scatter_axis, h.ndim - 3,
                                     kind="hist")
        if self.scatter_axis == "feature" and self.mesh.shape[0] > 1:
            out = self.mesh.psum(out, "data", kind="hist")
        return out


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (empty when mesh is None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.axis_names, mesh.shape))


def row_shard_axes(dd: int, df: int) -> Optional[Tuple[str, ...]]:
    """The mesh axes a learner's row dimension shards over: every axis
    with more than one device.  None on a single-device mesh."""
    axes = tuple(name for name, size in (("data", dd), ("feature", df))
                 if size > 1)
    return axes or None


def pad_cols_to_ndev(n_cols: int, ndev: int, align: int = 1) -> int:
    """Smallest column count >= `n_cols` that tiles the mesh axis the
    psum_scatter histogram exchange scatters over: a multiple of
    lcm(ndev, align) (`align` carries a store layout constraint, e.g.
    the int8 store's 32-column group; pass ndev = data*feature for a
    2-D mesh, where the per-feature-shard slice must itself tile the
    data axis).  Raises a clear ValueError on degenerate mesh sizes."""
    if ndev < 1 or align < 1:
        raise ValueError(
            f"pad_cols_to_ndev: mesh axis size ({ndev}) and alignment "
            f"({align}) must be >= 1; a zero-sized mesh axis cannot be "
            "tiled by any column padding")
    unit = math.lcm(int(ndev), int(align))
    return unit * int(math.ceil(max(int(n_cols), 1) / unit))


def check_scatter_divisible(axis: str, size: int, ndev: int) -> None:
    """Guard in front of a psum_scatter: raise a ValueError naming the
    axis, its size and the mesh axis size when the scattered axis
    cannot tile the mesh (the learners pad their stores with
    pad_cols_to_ndev, so only direct callers can trip it)."""
    if ndev > 1 and size % ndev:
        raise ValueError(
            f"psum_scatter needs the scattered axis '{axis}' (size "
            f"{size}) to be a multiple of the mesh axis size "
            f"({ndev}); pad the store columns with "
            f"sharded.mesh.pad_cols_to_ndev "
            f"({pad_cols_to_ndev(size, ndev)} would tile)")


def check_tree_divergence(mesh, name: str, packed, leaf_count) -> None:
    """BENCH_SANITIZE divergence gate shared by every mesh learner
    (diagnostics/sanitize.py): the tree a build returned is replicated
    state, so every rank must hold the bitwise-identical copy.  Digests
    the packed tree vector (the one read the tree makes) and the leaf
    counts, the JAX gate's two fingerprints.  No-op (one environment
    read) unless the sanitizer is enabled, or without a mesh."""
    from ..diagnostics import sanitize
    if mesh is None or not sanitize.sanitize_enabled():
        return
    sanitize.maybe_check_divergence(mesh, name, {"packed_tree": packed,
                                                 "leaf_count": leaf_count})


# `hist_exchange=auto` switches to psum_scatter only when the per-pass
# histogram payload is at least this many bytes: below it the full psum
# is cheaper than reduce-scatter + the per-leaf record allgather
# (mirroring the reference's allgather-vs-Recursive-Halving switch on
# small payloads).  The Config key `hist_exchange_min_bytes` pins it
# per run, and LGBT_HIST_EXCHANGE_MIN_BYTES overrides it when the key
# is unset.
HIST_EXCHANGE_MIN_SCATTER_BYTES = 1 << 20


def _hist_exchange_threshold(cfg: Optional[Config] = None) -> int:
    cfg_v = int(getattr(cfg, "hist_exchange_min_bytes", -1)) \
        if cfg is not None else -1
    if cfg_v >= 0:
        return cfg_v
    raw = os.environ.get("LGBT_HIST_EXCHANGE_MIN_BYTES", "")
    if not raw:
        return HIST_EXCHANGE_MIN_SCATTER_BYTES
    try:
        return max(0, int(raw))
    except ValueError:
        from .. import log
        log.warning(f"ignoring malformed LGBT_HIST_EXCHANGE_MIN_BYTES="
                    f"{raw!r}")
        return HIST_EXCHANGE_MIN_SCATTER_BYTES


def resolve_hist_exchange(cfg: Config, *, ndev: int,
                          payload_bytes: float) -> str:
    """Resolve `hist_exchange` to the collective a data-parallel learner
    runs per histogram pass.  `payload_bytes` is the full reduced
    histogram size of one pass (K * F * 3 * B * 4); with a single device
    there is no exchange and the answer is always "psum" (a no-op).
    `ndev` is the total device count of the mesh's row axes."""
    if ndev <= 1:
        return "psum"
    mode = getattr(cfg, "hist_exchange", "auto")
    if mode == "auto":
        return ("psum_scatter"
                if payload_bytes >= _hist_exchange_threshold(cfg)
                else "psum")
    return mode


def mesh_shape(tree_learner: str, n: int) -> Tuple[int, int]:
    """(data, feature) shape of an n-rank mesh for a learner type: data
    and voting shard rows, feature shards the split search, and data2d
    takes the balanced 2-D factorization (the largest factor of n up to
    its square root on the feature axis)."""
    if tree_learner in ("data", "voting"):
        return (n, 1)
    if tree_learner == "feature":
        return (1, n)
    df = 1
    for f in range(int(math.isqrt(n)), 0, -1):
        if n % f == 0:
            df = f
            break
    return (n // df, df)


def make_mesh(tree_learner: str, num_machines: int = 0) -> Optional[Mesh]:
    """Mesh for a distributed learner type over the initialised
    `torch.distributed` world (reference tree_learner types,
    config.h:233).  The mesh always spans every rank of the world
    (`num_machines` counts hosts in the reference, as in the JAX
    package's multi-process worlds); None without a world of more than
    one rank.  On a 2-D mesh every rank makes every axis group, in the
    same order."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    if n <= 1:
        return None
    dd, df = mesh_shape(tree_learner, n)
    rank = dist.get_rank()
    groups: Dict[str, object] = {"data": None, "feature": None}
    if dd > 1 and df > 1:
        for f in range(df):
            g = dist.new_group([d * df + f for d in range(dd)])
            if rank % df == f:
                groups["data"] = g
        for d in range(dd):
            g = dist.new_group([d * df + f for f in range(df)])
            if rank // df == d:
                groups["feature"] = g
    return Mesh((dd, df), rank, dist.get_backend(), groups)


class RankRows:
    """The row layout of a pre-partitioned world (the JAX package's
    `MultiHostRows`, one rank a card): each rank holds one contiguous
    block of the rows (`distributed.local_row_slice`), and every block
    is padded to the same length, `per_proc`, the longest rank's count,
    so the padded rows carry zero masks and the histograms tile the
    same way on every rank.  The JAX class assembles global arrays from
    the processes' blocks; here a rank's tensors are its block, so that
    is `pad_local` and a cut back to `n_local`.

    The rows shard over the data axis only: a mesh with a feature axis
    (tree_learner=feature, data2d on a 2-D mesh) is refused, as in the
    JAX package, and so is a data axis the world does not divide."""

    def __init__(self, mesh: Mesh, n_local: int):
        from ..distributed import _gathered_sizes, world
        dd, df = mesh.shape
        if df > 1:
            raise NotImplementedError(
                "multi-host feature-parallel training is not supported; "
                "use tree_learner=data")
        self.world = world()[1]
        if dd % self.world:
            raise ValueError(
                f"data axis ({dd}) must be divisible by the process count "
                f"({self.world}) for multi-host training")
        self.counts = _gathered_sizes(int(n_local))
        self.n_local = int(n_local)
        self.per_proc = max(int(self.counts.max()), 1)
        self.n_global = int(self.counts.sum())

    def pad_local(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """`x` ([..., n_local] along `dim`) zero-padded to per_proc."""
        return take_rows(x, 0, self.n_local, self.per_proc, dim)


def row_block(n: int, nsh: int, block: int) -> Tuple[int, int, int]:
    """(start, stop, local rows) of row block `block` of an n-row axis
    padded to nsh * ceil(n / nsh): the rows [start, stop) are real, the
    block holds `local` rows with the padding at its end."""
    local = int(math.ceil(n / max(nsh, 1)))
    start = min(block * local, n)
    return start, min(start + local, n), local


def take_rows(x: torch.Tensor, start: int, stop: int, local: int,
              dim: int = -1) -> torch.Tensor:
    """Rows [start, stop) of `x` along `dim`, zero-padded to `local`."""
    part = x.narrow(dim, start, stop - start)
    pad = local - (stop - start)
    if pad == 0:
        return part
    shape = list(part.shape)
    shape[dim] = pad
    return torch.cat([part, torch.zeros(shape, dtype=x.dtype,
                                        device=x.device)], dim=dim)
