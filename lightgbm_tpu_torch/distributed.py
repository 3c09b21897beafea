"""Multi-process bootstrap on `torch.distributed`.

Port of lightgbm_tpu/distributed.py.  The reference brings up a TCP/MPI
network from `num_machines` + `machine_list_file` (+ `local_listen_port`)
at training start (application.cpp:185-197, linkers_socket.cpp:73-110:
"ip port" lines, an optional `rank=<n>` override, rank otherwise by list
order).  Here that is `torch.distributed.init_process_group` at the
address of the machine of rank 0, after which `sharded.mesh.make_mesh`
spans every rank of the world (one rank a card).

Launch recipes:

    # one host, N cards: torchrun sets RANK / WORLD_SIZE / LOCAL_RANK
    python -m torch.distributed.run --nproc-per-node N \\
        -m lightgbm_tpu_torch config=train.conf tree_learner=data

    # one process a machine, from a machine list (rank by local address,
    # by a `rank=<n>` suffix, or by LIGHTGBM_TPU_MACHINE_RANK)
    python -m lightgbm_tpu_torch config=train.conf num_machines=2 \\
        machine_list_file=mlist.txt tree_learner=data

The backend is chosen explicitly and printed, never switched silently:
NCCL when the ranks run on CUDA cards (each its own), gloo for the CPU
(`device_type=cpu`) or when the caller passes `backend="gloo"`, as it
must when several ranks share one card.  Importing this module starts
no process group.

Two ways to feed a world from one file.  With `is_pre_partition=false`
every rank reads the whole file, and the boosting loop runs replicated
over all N rows (the tree learner uploads the rank's row block).  With
`is_pre_partition=true` and a world of more than one rank, each rank
keeps only its contiguous block of the file's rows (`local_row_slice`),
binned with mappers every rank derives identically from the samples of
all ranks (`find_bin_mappers_distributed`: the gathered sample, or the
merged quantile sketches of `bin_find=sketch`), and the boosting loop
runs over the local rows only (sharded/mesh.py `RankRows`).  A world of
one rank, or none, loads the whole file either way.
"""
from __future__ import annotations

import datetime
import os
import socket
import warnings
from typing import List, Optional, Tuple

import numpy as np

# seconds a collective may wait for its peers before the rank fails
DEFAULT_TIMEOUT_S = 600.0


def parse_machine_list(path: str) -> List[Tuple[str, int, Optional[int]]]:
    """`ip port [rank=<n>]` per line (linkers_socket.cpp:73-110)."""
    out: List[Tuple[str, int, Optional[int]]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rank = None
            toks = []
            for t in line.replace(",", " ").split():
                if t.startswith("rank="):
                    rank = int(t[5:])
                else:
                    toks.append(t)
            if len(toks) < 2:
                raise ValueError(
                    f"machine_list line needs 'ip port': {line!r}")
            out.append((toks[0], int(toks[1]), rank))
    return out


def _local_addresses() -> List[str]:
    addrs = {"127.0.0.1", "localhost"}
    try:
        hostname = socket.gethostname()
        addrs.add(hostname)
        for info in socket.getaddrinfo(hostname, None):
            addrs.add(info[4][0])
    except OSError:
        pass
    return list(addrs)


def resolve_rank(machines: List[Tuple[str, int, Optional[int]]]) -> int:
    """This process's rank: the environment override, then explicit
    rank= entries, then a local-address match (the reference matches
    the local ip against the list the same way,
    linkers_socket.cpp:84-103)."""
    env = os.environ.get("LIGHTGBM_TPU_MACHINE_RANK")
    if env is not None:
        return int(env)
    local = set(_local_addresses())
    matches = [(i, rank) for i, (ip, _port, rank) in enumerate(machines)
               if ip in local]
    if len(matches) > 1:
        # the same host listed more than once: the address alone cannot
        # tell the processes apart
        raise ValueError(
            "machine_list has multiple local entries; set "
            "LIGHTGBM_TPU_MACHINE_RANK per process to disambiguate")
    if matches:
        i, rank = matches[0]
        return rank if rank is not None else i
    raise ValueError(
        "cannot determine this machine's rank: none of the machine_list "
        "addresses are local; set LIGHTGBM_TPU_MACHINE_RANK")


def default_backend(device_type: str) -> str:
    """NCCL for ranks on CUDA cards, gloo on the CPU."""
    return "nccl" if device_type.startswith("cuda") else "gloo"


def _bind_device(backend: str, local_rank: int) -> str:
    """Make the rank's card the current CUDA device (so every
    `torch.device("cuda")` of the port means it) and name it.  Under
    NCCL each rank needs a card of its own; under gloo ranks may share
    one (rank i takes card i mod the card count)."""
    import torch
    if not torch.cuda.is_available():
        if backend == "nccl":
            raise RuntimeError("backend nccl needs a CUDA device per rank; "
                               "none is visible")
        return "cpu"
    n = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= n:
        raise RuntimeError(
            f"backend nccl needs a card per rank: local rank {local_rank} "
            f"of a host with {n} card(s); several ranks on one card take "
            "backend gloo")
    torch.cuda.set_device(local_rank % n)
    return f"cuda:{local_rank % n}"


def init_process_group(backend: str, rank: int, world_size: int,
                       init_method: str, local_rank: Optional[int] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """`torch.distributed.init_process_group` with an explicit backend,
    the rank bound to its card first.  Returns the rank's device name
    and logs the backend and the device."""
    import torch.distributed as dist
    from . import log
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    dev = _bind_device(backend, rank if local_rank is None else local_rank)
    kw = {}
    if backend == "nccl":
        # NCCL binds the communicator to the rank's card up front
        import torch
        kw["device_id"] = torch.device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    log.info(f"distributed: rank {rank} of {world_size}, backend "
             f"{backend}, device {dev}")
    return dev


def init_distributed(num_machines: int, machine_list_file: str = "",
                     local_listen_port: int = 12400, *,
                     backend: Optional[str] = None,
                     device_type: str = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up the `torch.distributed` world.  Returns True when a
    world of more than one rank is (or already was) initialised, False
    for one process.

    A torchrun environment (WORLD_SIZE and RANK set) initialises from it
    (`env://`).  Otherwise the reference config maps as in the JAX
    package: `num_machines` processes, the coordinator is the machine of
    rank 0 in the list, and `local_listen_port` the port on 127.0.0.1
    when no list is given (one host, several processes, with
    LIGHTGBM_TPU_MACHINE_RANK naming each).  `backend` None picks
    `default_backend(device_type)`."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    backend = backend or default_backend(device_type)
    env_world = os.environ.get("WORLD_SIZE")
    if env_world is not None and os.environ.get("RANK") is not None:
        world = int(env_world)
        if world <= 1:
            return False
        init_process_group(backend, int(os.environ["RANK"]), world,
                           "env://", int(os.environ.get("LOCAL_RANK", 0)),
                           timeout_s)
        return True
    if num_machines <= 1:
        return False
    if machine_list_file:
        machines = parse_machine_list(machine_list_file)
        if len(machines) != num_machines:
            raise ValueError(
                f"machine_list_file has {len(machines)} entries, "
                f"num_machines={num_machines}")
        rank = resolve_rank(machines)
        # EFFECTIVE ranks: rank= overrides can move a rank (rank 0, the
        # coordinator, included) away from its list line
        eff = [m[2] if m[2] is not None else i
               for i, m in enumerate(machines)]
        coord_machine = machines[eff.index(0)] if 0 in eff else machines[0]
        coord = f"{coord_machine[0]}:{coord_machine[1]}"
        # the ranks of one host take its cards in rank order
        host = machines[eff.index(rank)][0] if rank in eff else ""
        local_rank = sum(1 for m, e in zip(machines, eff)
                         if m[0] == host and e < rank)
    else:
        rank_env = os.environ.get("LIGHTGBM_TPU_MACHINE_RANK")
        if rank_env is None:
            warnings.warn(
                "num_machines>1 without machine_list_file or "
                "LIGHTGBM_TPU_MACHINE_RANK: assuming single-host test "
                "mode, skipping torch.distributed")
            return False
        rank = int(rank_env)
        coord = f"127.0.0.1:{local_listen_port}"
        local_rank = rank
    init_process_group(backend, rank, num_machines, f"tcp://{coord}",
                       local_rank, timeout_s)
    return True


def maybe_init_from_config(cfg) -> bool:
    """Application entry (application.cpp:185-197 Network::Init analog)."""
    return init_distributed(int(getattr(cfg, "num_machines", 0) or 0),
                            getattr(cfg, "machine_list_file", ""),
                            int(getattr(cfg, "local_listen_port", 12400)),
                            device_type=getattr(cfg, "device_type", "cuda"))


def world() -> Tuple[int, int]:
    """(rank, world size) of the initialised world, (0, 1) without."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_words(words: np.ndarray) -> np.ndarray:
    """[world, *words.shape] of an int64 array, bit for bit, through
    the world's backend (on the current card under NCCL)."""
    import torch
    import torch.distributed as dist
    rank, size = world()
    if size == 1:
        return words[None].copy()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(np.ascontiguousarray(words), device=dev)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def allgather_f64(arr) -> np.ndarray:
    """Allgather a float64 array BIT-EXACTLY across the ranks: the words
    travel as int64, which no collective rounds.  Returns
    [world, *arr.shape] float64 (world 1 included)."""
    a = np.ascontiguousarray(np.asarray(arr, np.float64))
    out = _allgather_words(a.view(np.int64))
    return np.ascontiguousarray(out).reshape((-1,) + a.shape).view(
        np.float64)


# ---------------------------------------------------------------------------
# Pre-partitioned ingestion: each rank's row block and the global bin
# mappers (the reference's dataset_loader.cpp:554-659 row assignment and
# :733-833 distributed bin finding)
# ---------------------------------------------------------------------------

def local_row_slice(n: int) -> slice:
    """This rank's contiguous row block of an n-row dataset: blocks of
    ceil(n / W) rows in rank order (the last ones shorter, or empty when
    n < W); the whole range without a world."""
    rank, size = world()
    per = (n + size - 1) // size
    return slice(min(rank * per, n), min((rank + 1) * per, n))


def resolve_bin_find(cfg, n_sample_global: int, world: int = 1) -> str:
    """The path distributed bin finding runs for the `bin_find` knob:
    "allgather" (every rank derives the mappers from the identical
    gathered global sample, exact) or "sketch" (the ranks' mergeable
    quantile summaries, sharded/sketch.py, so no rank holds the global
    sample).  "auto" stays exact while the combined sample fits the
    bin-construction budget; the loader takes `budget // world + 1`
    rows a rank, so the `+ world` slack keeps its sample exact."""
    mode = getattr(cfg, "bin_find", "auto")
    if mode == "auto":
        budget = int(cfg.bin_construct_sample_cnt) + max(int(world), 1)
        return "sketch" if n_sample_global > budget else "allgather"
    return mode


def _gathered_sizes(n_local: int) -> np.ndarray:
    """[world] int64: every rank's `n_local`, in rank order."""
    return _allgather_words(np.array([n_local], np.int64)).reshape(-1)


def _allgather_rows(local_rows, smax: int, sizes) -> np.ndarray:
    """Every rank's [rows, F] float64 block concatenated in rank order:
    each padded to `smax` rows for the collective and cut back to its
    true size (`sizes`), so no sentinel value is needed."""
    local_rows = np.asarray(local_rows, np.float64)
    padded = np.zeros((smax, local_rows.shape[1]), np.float64)
    padded[: len(local_rows)] = local_rows
    gathered = allgather_f64(padded)                      # [W, smax, F]
    return np.concatenate([gathered[w, : int(sizes[w])]
                           for w in range(gathered.shape[0])])


def find_bin_mappers_sketch(local_sample, cfg, categorical=(),
                            return_sample=False):
    """Global BinMappers by merging every rank's quantile sketches: each
    rank summarizes its sample (sharded/sketch.py), one allgather_f64
    carries the fixed-width packed summaries bit for bit, and every rank
    merges the identical stack in rank order, so the mappers are the
    same everywhere.  Exact while `sketch_eps` holds every distinct
    value.

    return_sample=True also returns the bundle planner's sample, the
    same on every rank: at most BUNDLE_PLAN_SAMPLE_CNT / world rows of
    each rank's sample, gathered; never the global sample."""
    from .sharded.sketch import SketchSet, sketch_columns
    _, size = world()
    ss = sketch_columns(local_sample, cfg, categorical=categorical)
    if size > 1:
        stack = allgather_f64(ss.pack())        # [W, F + 1, 2 * cap + 4]
        ss = SketchSet.merge_packed(stack, categorical=categorical)
    mappers = ss.mappers_from_config(cfg)
    if not return_sample:
        return mappers
    from .dataset import BUNDLE_PLAN_SAMPLE_CNT
    cap = max(BUNDLE_PLAN_SAMPLE_CNT // max(size, 1), 1)
    plan_local = np.ascontiguousarray(
        np.asarray(local_sample, np.float64)[:cap])
    if size > 1:
        sizes = _gathered_sizes(len(plan_local))
        plan_sample = _allgather_rows(plan_local, int(sizes.max()), sizes)
    else:
        plan_sample = plan_local
    return mappers, plan_sample


def find_bin_mappers_distributed(local_sample, cfg, categorical=(),
                                 return_sample=False):
    """Global BinMappers from every rank's local sample, the same on
    every rank, by the path `resolve_bin_find` picks: "allgather" (the
    samples gathered in rank order, resampled to
    `bin_construct_sample_cnt` rows with RandomState(data_random_seed)
    when longer, then find_bin_mappers) or "sketch"
    (`find_bin_mappers_sketch`).

    return_sample=True also returns a sample that is the same on every
    rank, for the bundle planner: the global sample on the allgather
    path, the bounded plan sample on the sketch path."""
    from .binning import find_bin_mappers
    _, size = world()
    if size > 1:
        sizes = _gathered_sizes(len(local_sample))
        n_global = int(sizes.sum())
    else:
        sizes = np.array([len(local_sample)], np.int64)
        n_global = len(local_sample)
    if resolve_bin_find(cfg, n_global, size) == "sketch":
        return find_bin_mappers_sketch(local_sample, cfg,
                                       categorical=categorical,
                                       return_sample=return_sample)
    if size == 1:
        m = find_bin_mappers(
            local_sample, cfg.max_bin, cfg.min_data_in_bin,
            cfg.min_data_in_leaf, categorical=categorical,
            sample_cnt=len(local_sample), seed=cfg.data_random_seed)
        return (m, local_sample) if return_sample else m
    flat = _allgather_rows(local_sample, int(sizes.max()), sizes)
    cap = int(cfg.bin_construct_sample_cnt)
    if len(flat) > cap:
        idx = np.random.RandomState(cfg.data_random_seed).choice(
            len(flat), cap, replace=False)
        flat = flat[np.sort(idx)]
    m = find_bin_mappers(
        flat, cfg.max_bin, cfg.min_data_in_bin, cfg.min_data_in_leaf,
        categorical=categorical, sample_cnt=len(flat),
        seed=cfg.data_random_seed)
    return (m, flat) if return_sample else m
