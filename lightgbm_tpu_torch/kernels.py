"""Build, load and count the hand-written CUDA kernels of csrc/.

Each source in csrc/ compiles with nvcc for sm_90a into its own shared
library with a plain C interface, loaded through ctypes.  The build runs
at first use — every missing library at once, one nvcc process per
source, all started together — into build/kernels/ at the root of the
checkout.  A library's file name carries a hash of its source, so an
edited source builds anew.  Nothing here runs at import time: the CPU
tests import every module of the package and never build.

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
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# entry name -> (source name, C function, argtypes); every function
# returns the cudaError_t of its launch (0 = success)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "histogram": ("histogram", "lgbt_hist_multileaf",
                  [_P, _I, _L, _I, _P, _P, _P, _I, _L, _P, _I, _I, _I, _P,
                   _P]),
    "lookup": ("lookup", "lgbt_table_lookup",
               [_P, _I, _I, _P, _L, _P, _P, _P]),
    "partition": ("partition", "lgbt_partition_rows",
                  [_P, _I, _P, _I, _I, _L, _P, _P, _P]),
    "hist_sparse": ("hist_sparse", "lgbt_hist_sparse",
                    [_P, _P, _P, _I, _P, _P, _I, _L, _P, _P, _P, _P, _L,
                     _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                     _P]),
    "hist_gathered": ("hist_gathered", "lgbt_hist_gathered",
                      [_P, _L, _L, _I, _P, _L, _P, _P, _P, _L, _I, _I, _P,
                       _P]),
    "hist_multirow": ("hist_gathered", "lgbt_hist_multirow",
                      [_P, _I, _L, _P, _I, _I, _I, _P, _P]),
}
# the sources of csrc/, one library each
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

# launches per kernel, keyed by the names chip_smoke.py reports
LAUNCHES: Dict[str, int] = {"hist_masked_int8": 0, "hist_masked_f32": 0,
                            "table_lookup": 0, "partition_rows": 0,
                            "hist_sparse_int8": 0, "hist_sparse_f32": 0,
                            "hist_gathered": 0, "hist_multirow": 0}

_libs: Dict[str, ctypes.CDLL] = {}


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
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library among `names`, one nvcc each, all
    in parallel.  Returns {name: seconds} for the libraries built now
    (empty when all were built already); raises with the compiler's
    output when one fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
    return lib


def call(name: str, *args) -> None:
    """Run the entry point `name` of SIGNATURES on the current CUDA
    stream and raise if the launch was refused."""
    source, fn_name, _ = SIGNATURES[name]
    fn = getattr(library(source), fn_name)
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: "
                           f"cudaError {err}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
