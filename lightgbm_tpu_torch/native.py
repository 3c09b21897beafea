"""The native host libraries, built with g++ at first use and loaded with
ctypes.

- `liblgbt_native_torch` — the text loader (`src/native/loader.cpp`: CSV,
  TSV and LibSVM in one `std::from_chars`/`strtod` pass, correctly
  rounded) and the dependency-free C inference ABI
  (`src/native/c_api.cpp`: a model file and `LGBM_BoosterPredictForMat`
  with no Python).  `dataset.parse_text_file` takes the loader for files
  without a header.  Without g++ it is not built, and parsing takes the
  NumPy parser (the same values) after one log line.  The same library
  holds the bulk binner (`lgbt_bin_numerical`, `bin_numerical_native`):
  quantize.py bins the numerical columns of a uint8 store, and of a
  serving request, through it, and through NumPy where it is not built.
- `liblgbt_train_torch` — the training `LGBM_*` C ABI
  (`csrc/native/c_api_train.cpp`), which embeds CPython and delegates to
  `lightgbm_tpu_torch.capi`; built against the running interpreter's
  headers (`sysconfig`).  Its own name lets it load beside the JAX
  package's `liblgbt_train.so` in one process.

Both build into build/native/ at the root of the checkout, under a file
name that carries a hash of their sources (and of the interpreter's
flags, for the training ABI), through a temporary file moved into place,
so that concurrent processes never load a half-written library.  These
are host libraries: no device kernel is among them, and the nvcc build
of kernels.py never sees them.  Nothing builds at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import log

PACKAGE_DIR = Path(__file__).resolve().parent
ROOT = PACKAGE_DIR.parent
BUILD_DIR = ROOT / "build" / "native"
LOADER_SOURCES = (ROOT / "src" / "native" / "loader.cpp",
                  ROOT / "src" / "native" / "c_api.cpp")
TRAIN_SOURCE = PACKAGE_DIR / "csrc" / "native" / "c_api_train.cpp"

# text files parsed, by parser ("native" or "numpy"), counted by
# dataset.parse_text_file
PARSES: Dict[str, int] = {"native": 0, "numpy": 0}
# columns binned by quantize.py's row binning and serving quantizer, by
# binner ("native": bin_numerical_native, "numpy": the NumPy searches)
BINNED: Dict[str, int] = {"native": 0, "numpy": 0}

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def compiler() -> Optional[str]:
    return shutil.which("g++")


def _hashed_path(stem: str, sources, flags: List[str]) -> Path:
    h = hashlib.sha1()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:12]}.so"


def _build(out: Path, sources, flags: List[str]) -> Path:
    """Compile `sources` into the shared library `out` unless it exists;
    raises with the compiler's output when it fails."""
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("g++ not found: the native libraries build with "
                           "a C++17 g++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ([cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp)]
           + [str(s) for s in sources] + flags)
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def loader_path() -> Path:
    """The built `liblgbt_native_torch` (loader + inference ABI)."""
    return _build(_hashed_path("liblgbt_native_torch", LOADER_SOURCES, []),
                  LOADER_SOURCES, [])


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded loader library, built on first use; None (after one log
    line) where no C++ compiler is installed."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if compiler() is None:
        log.info("no C++ compiler found: text files are parsed by the "
                 "NumPy parser")
        return None
    lib = ctypes.CDLL(str(loader_path()))
    lib.lgbt_parse_text.restype = ctypes.c_void_p
    lib.lgbt_parse_text.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int64]
    lib.lgbt_matrix_rows.restype = ctypes.c_int64
    lib.lgbt_matrix_rows.argtypes = [ctypes.c_void_p]
    lib.lgbt_matrix_cols.restype = ctypes.c_int64
    lib.lgbt_matrix_cols.argtypes = [ctypes.c_void_p]
    lib.lgbt_matrix_copy.restype = None
    lib.lgbt_matrix_copy.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.lgbt_free_matrix.restype = None
    lib.lgbt_free_matrix.argtypes = [ctypes.c_void_p]
    lib.lgbt_bin_numerical.restype = None
    lib.lgbt_bin_numerical.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    _LIB = lib
    return _LIB


def parse_text_native(path: str, has_header: bool, label_idx: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(X, y) through the native parser, or None where it is not built;
    raises ValueError on a file it cannot parse."""
    lib = get_lib()
    if lib is None:
        return None
    err = ctypes.create_string_buffer(512)
    h = lib.lgbt_parse_text(path.encode(), int(has_header), int(label_idx),
                            err, 512)
    if not h:
        raise ValueError(err.value.decode() or f"failed to parse {path}")
    try:
        n = lib.lgbt_matrix_rows(h)
        f = lib.lgbt_matrix_cols(h)
        X = np.empty((n, f), np.float64)
        y = np.empty(n, np.float64)
        lib.lgbt_matrix_copy(h, X, y)
        return X, y
    finally:
        lib.lgbt_free_matrix(h)


def bin_numerical_native(X: np.ndarray, cols: List[int],
                         uppers_list: List[np.ndarray]
                         ) -> Optional[np.ndarray]:
    """Column-major [len(cols), n] uint8 bins of the numerical columns
    `cols` of X [n, stride] against their bin upper bounds: the first
    bound >= the value (searchsorted side='left'; a value above every
    bound takes the last bin), NaN binned as 0.0.  None where the library
    is not built or a feature has more than 256 bins."""
    lib = get_lib()
    if lib is None or any(len(u) > 256 for u in uppers_list):
        return None
    X = np.ascontiguousarray(X, np.float64)
    n, stride = X.shape
    cols_a = np.asarray(cols, np.int32)
    offsets = np.zeros(len(uppers_list) + 1, np.int64)
    offsets[1:] = np.cumsum([len(u) for u in uppers_list])
    uppers = (np.concatenate(uppers_list).astype(np.float64)
              if len(uppers_list) else np.zeros(0, np.float64))
    out = np.empty((len(cols), n), np.uint8)
    lib.lgbt_bin_numerical(X, n, stride, cols_a, len(cols), uppers, offsets,
                           out)
    return out


def python_flags() -> List[str]:
    """Compile and link flags of the running interpreter (its headers,
    and its libpython where it has a shared one; a static interpreter
    exports the symbols the loaded library resolves against)."""
    v = sysconfig.get_config_var
    flags = ["-I" + sysconfig.get_path("include")]
    if v("Py_ENABLE_SHARED"):
        flags += ["-L" + (v("LIBDIR") or ""), "-lpython" + v("LDVERSION")]
    return flags


def train_lib_path() -> Path:
    """The built `liblgbt_train_torch` (the training C ABI)."""
    flags = python_flags()
    return _build(_hashed_path("liblgbt_train_torch", [TRAIN_SOURCE], flags),
                  [TRAIN_SOURCE], flags)


def train_lib() -> ctypes.CDLL:
    """The training C ABI, built on first use and loaded into this
    process (whose interpreter it then shares)."""
    lib = ctypes.CDLL(str(train_lib_path()))
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    return lib
