"""Build and load the port's hand-written CUDA kernels.

The sources are ``multiverso_tpu_torch/csrc/*.cu`` (sharing the device
helpers of ``csrc/*.cuh``), each with a plain C
interface (pointers, sizes and a ``cudaStream_t``; every entry point
returns its ``cudaError_t``). At first use each source is compiled by
its own ``nvcc`` process — all started together — for ``sm_90a``, and
the objects are linked into one shared library under
``multiverso_tpu_torch/_build/``, named by a hash of the sources and
flags so an edited source rebuilds. The library is loaded with
``ctypes``. Nothing here runs at import time: a host without ``nvcc``
imports the package and uses the kernels' plain versions on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# Held around the first build: several threads (the rank threads of a
# LocalCluster, each zoo's server actor) may reach their first kernel
# at once, and one build must serve them all.
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_log: List[str] = []
build_seconds: Optional[float] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry point -> argument types (pointers and the stream as c_void_p;
#: ctypes would otherwise pass a Python int as a 32-bit int).
SIGNATURES = {
    "mv_row_gather": [_P, _I64, _I64, _P, _I64, _P, _I, _P],
    "mv_row_scatter_add": [_P, _I64, _I64, _P, _I64, _P, _I, _F, _P],
    "mv_row_gather_bounded": [_P, _I64, _I64, _P, _I64, _P, _I, _I64, _I64,
                              _P],
    "mv_row_scatter_add_bounded": [_P, _I64, _I64, _P, _I64, _P, _I, _F,
                                   _I64, _I64, _P],
    "mv_mesh_allreduce": [_P, _I, _I64, _I, _I, _P, _P],
    "mv_segment_merge": [_P, _P, _I, _P, _P, _I64, _I, _P, _P],
    "mv_segment_split": [_P, _I64, _I, _P, _P, _I, _P, ctypes.c_uint32, _P,
                         _P],
    "mv_subsample_compact": [_P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P],
    "mv_banded_sgns_grad": [_P, _P, _P, _I, _I, _I, _I, _I, _F,
                            _P, _P, _P, _P, _P, _P, _P, _P],
    "mv_banded_cbow_grad": [_P, _P, _P, _I, _I, _I, _I, _I, _F,
                            _P, _P, _P, _P, _P, _P, _P, _P],
    "mv_banded_hs_sg_grad": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                             _P, _P, _P, _P, _P, _P, _P, _P],
    "mv_hs_cbow_grad": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                        _P, _P, _P, _P, _P, _P, _P, _P],
    "mv_pair_offset_grad": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P,
                            _P, _P, _P],
    "mv_pairlist_ns_grad": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                            _F, _I, _P, _P, _P, _P, _P, _P, _P],
    "mv_pairlist_hs_grad": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _F,
                            _I, _P, _P, _P, _P, _P, _P, _P],
    "mv_sparse_lr_forward": [_P, _P, _P, _I64, _I, _P, _P, _I, _I, _P, _P,
                             _I, _I, _F, _F, _F, _F, _P, _P, _P, _P, _P],
    "mv_sparse_lr_apply": [_P, _P, _P, _I, _P, _P, _P, _P, _I64, _I, _P, _P,
                           _P, _I, _P, _I, _F, _I, _F, _F, _F, _F, _F, _P,
                           _P, _P, _P, _P, _P],
    "mv_row_rule_apply": [_I, _P, _I64, _I64, _P, _I, _I, _P, _P, _I64, _P,
                          _I64, _I, _F, _F, _F, _F, _P],
    "mv_rows_apply_gather": [_I, _P, _I64, _I64, _P, _I, _I, _P, _P, _P,
                             _I64, _P, _I64, _I, _F, _F, _F, _F, _P, _I64,
                             _P, _I, _P],
}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "multiverso_tpu_torch/csrc on a host with the CUDA "
                       "toolkit")


def _digest(extra: List[str]) -> str:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS + extra:
        h.update(flag.encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Tuple[Path, List[str]]:
    """Compile (if needed) and return (library path, compiler output).
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) to a fresh build."""
    extra = ["-Xptxas", "-v"] if verbose else []
    so = BUILD_DIR / f"libmvkernels-{_digest(extra)}.so"
    if so.exists():
        return so, []
    nvcc = nvcc_path()
    work = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    objs = []
    for src in sources():
        obj = work / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log: List[str] = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== nvcc {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp_so = work / so.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link (rc {link.returncode})\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    os.replace(tmp_so, so)
    shutil.rmtree(work, ignore_errors=True)
    return so, log


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path, log = build(verbose)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mv_banded_sgns_smem.argtypes = [_I, _I, _I, _I]
            lib.mv_banded_sgns_smem.restype = ctypes.c_size_t
            lib.mv_error_string.argtypes = [_I]
            lib.mv_error_string.restype = ctypes.c_char_p
            _build_log[:] = log
            build_seconds = time.perf_counter() - t0
            _lib = lib
        return _lib


def build_log() -> List[str]:
    """Compiler output of the build that produced the loaded library
    (empty when it was already built)."""
    return list(_build_log)


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned an error."""
    if rc != 0:
        text = _lib.mv_error_string(rc).decode() if _lib is not None \
            else "?"
        raise RuntimeError(f"{what}: CUDA error {rc} ({text})")
