"""Build, load and count the hand-written CUDA kernels of csrc/.

Each source in csrc/ compiles with nvcc for sm_90a into its own shared
library with a plain C interface, loaded through ctypes.  The build runs
at first use — every missing library at once, one nvcc process per
source, all started together — into build/kernels/ at the root of the
checkout.  A library's file name carries a hash of its source and of the
headers of csrc/, so an edited source builds anew.  Nothing here runs at
import time: the CPU tests import every module of the package and never
build.

Every kernel wrapper counts its launches in `LAUNCHES` (one per launch,
nowhere else), so a run can show that a path really went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# entry name -> (source name, C function, argtypes, the stream last);
# every function returns the cudaError_t of its launch (0 = success)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    "hist_q": ("histogram", "lgbt_hist_q",
               [_P, _I, _L, _I, _I, _I, _I, _P, _P, _L, _P, _L, _P, _P, _I,
                _I, _I, _P, _P, _P, _L, _L, _L, _P, _P]),
    "hist_f": ("histogram", "lgbt_hist_f",
               [_P, _I, _L, _I, _I, _I, _I, _I, _P, _P, _I, _L, _P, _L, _P,
                _P, _I, _I, _I, _P, _P, _P, _L, _L, _L, _P, _P]),
    "lookup": ("lookup", "lgbt_table_lookup",
               [_P, _I, _I, _P, _L, _P, _P, _P]),
    "partition": ("partition", "lgbt_partition_rows",
                  [_P, _I, _P, _I, _I, _L, _P, _P, _P]),
    "hist_sparse": ("hist_sparse", "lgbt_hist_sparse",
                    [_P, _P, _P, _I, _P, _P, _I, _L, _P, _P, _P, _P, _L,
                     _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                     _P]),
    "slot_totals": ("hist_sparse", "lgbt_slot_totals",
                    [_P, _P, _L, _I, _I, _L, _P, _P, _P]),
    "hist_gathered": ("hist_gathered", "lgbt_hist_gathered",
                      [_P, _I, _L, _L, _I, _I, _I, _P, _L, _L, _I, _P, _P,
                       _P, _L, _I, _I, _I, _P, _P, _P, _P, _P]),
    "hist_multirow": ("hist_gathered", "lgbt_hist_multirow",
                      [_P, _I, _L, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I,
                       _P, _P, _P, _P, _P]),
    "split_search": ("split", "lgbt_split_search",
                     [_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                      _I, _F, _F, _F, _F, _F, _I, _F, _F, _P, _P, _P, _P, _P,
                      _P, _P]),
}
# the sources of csrc/, one library each
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

# launches per kernel, keyed by the names chip_smoke.py reports
LAUNCHES: Dict[str, int] = {"hist_masked_int8": 0, "hist_masked_f32": 0,
                            "table_lookup": 0, "partition_rows": 0,
                            "hist_sparse_int8": 0, "hist_sparse_f32": 0,
                            "hist_gathered": 0, "hist_multirow": 0,
                            "slot_totals": 0, "split_search": 0}

_libs: Dict[str, ctypes.CDLL] = {}

# ("build" | "load", source) per nvcc build and per library load, in
# order: the port's compile events, which diagnostics/sanitize.py's
# HotPathSanitizer counts (a build or load after warm-up is a retrace)
BUILD_EVENTS: List[Tuple[str, str]] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc" if cand else None
        if p is not None and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _lib_path(name: str) -> Path:
    # the hash covers the headers too: a source includes csrc/*.cuh
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library among `names`, one nvcc each, all
    in parallel.  Returns {name: seconds} for the libraries built now
    (empty when all were built already); raises with the compiler's
    output when one fails.  The build holds an exclusive lock on
    build/kernels/.lock, so the ranks of a cold multi-process run that
    reach their first kernel together build each library once: the
    others wait, then find it built."""
    names = list(names)
    if all(_lib_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    import fcntl
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_locked(
                [n for n in names if not _lib_path(n).exists()])
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_locked(todo: List[str]) -> Dict[str, float]:
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took, errors = {}, []
    for n, (p, tmp, out) in procs.items():
        log_text, _ = p.communicate()
        took[n] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu:\n{log_text}")
            continue
        os.replace(tmp, out)
        (BUILD_DIR / f"{out.stem}.log").write_text(log_text)
        BUILD_EVENTS.append(("build", n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>.cu, built on first use, with
    the argument types of its entry points set."""
    lib = _libs.get(source)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_lib_path(source)))
        for src, fn_name, argtypes in SIGNATURES.values():
            if src == source:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[source] = lib
        BUILD_EVENTS.append(("load", source))
    return lib


# entry name -> its loaded C function
_fns: Dict[str, Callable[..., int]] = {}


def _current_stream() -> int:
    """The current CUDA stream of the current device, as an int.  The
    raw getter of PyTorch's CUDA build (the one Triton's launcher calls)
    skips building a Stream object, a few microseconds a launch."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch._C._cuda_getDevice())
    return torch.cuda.current_stream().cuda_stream


def call(name: str, *args) -> None:
    """Run the entry point `name` of SIGNATURES on the current CUDA
    stream and raise if the launch was refused."""
    fn = _fns.get(name)
    if fn is None:
        source, fn_name, _ = SIGNATURES[name]
        fn = _fns[name] = getattr(library(source), fn_name)
    err = fn(*args, _current_stream())
    if err != 0:
        raise RuntimeError(f"CUDA kernel {SIGNATURES[name][1]} failed to "
                           f"launch: cudaError {err}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# scratch (partial tiles) and int32 ticket counters of the kernels that
# combine partial tiles through tickets (csrc/tile_combine.cuh): one pair
# a (device, stream), each grown to the largest request.  Kernels on one
# stream run one after another, so its calls share the pair; a call on
# another stream gets its own.  Tickets are zero when handed out and left
# zero by the kernel.  Fresh scratch of a varying size each call made the
# caching allocator call cudaMalloc every iteration.
_combine: Dict[Tuple[torch.device, int],
               Tuple[torch.Tensor, torch.Tensor]] = {}
# pairs handed out while a CUDA graph was being captured: the graph keeps
# their addresses, so they stay allocated when a larger request replaces
# them
_captured: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def combine_buffers(device: torch.device, n_scratch: int, n_tickets: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scratch, tickets) for a call on the current stream of `device`:
    at least `n_scratch` int32 words of scratch (contents undefined) and
    `n_tickets` zeroed int32 ticket counters."""
    key = (device, _current_stream())
    buf = _combine.get(key)
    if (buf is None or buf[0].numel() < n_scratch
            or buf[1].numel() < n_tickets):
        sc, tk = buf if buf is not None else (None, None)
        if sc is None or sc.numel() < n_scratch:
            sc = torch.empty(max(n_scratch, 1 << 20), dtype=torch.int32,
                             device=device)
        if tk is None or tk.numel() < n_tickets:
            tk = torch.zeros(max(n_tickets, 1024,
                                 0 if tk is None else 2 * tk.numel()),
                             dtype=torch.int32, device=device)
        buf = _combine[key] = (sc, tk)
    if torch.cuda.is_current_stream_capturing():
        _captured[id(buf)] = buf
    return buf


_sms: Dict[torch.device, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n
