"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` (one per entry of ``SOURCES``) has a plain C
interface and is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` inside the package (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds), then loaded with ``ctypes``.  ``KERNELS`` names the
kernels whose launches are counted: one source may hold several
(``flow_nc_qside.cu`` holds K7a and K7b; ``ssd_chunk.cu`` K10a with and
without carry-ins, counted apart; ``paged_gather.cu`` K8a and K8b).
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("flow_fused", "flow_fused_bwd", "flow_decode", "flow_decode_q",
           "flow_nc_fused", "flow_nc_qside", "flow_chunk", "flow_chunk_bwd",
           "boundary_gather", "ssd_chunk", "ssd_chunk_bwd", "paged_gather")
KERNELS = ("flow_fused", "flow_fused_bwd", "flow_decode", "flow_decode_q",
           "flow_nc_fused", "flow_nc_qside", "flow_nc_qside_bwd", "flow_chunk",
           "flow_chunk_dkv", "boundary_gather", "ssd_chunk", "ssd_chunk_hins",
           "ssd_chunk_bwd", "paged_gather", "paged_gather_quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: what the kernels take: phi kinds, activation dtypes and head dims
PHI_CODES = {"sigmoid": 0, "elu1": 1, "relu": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
#: the small-head route of the non-causal kernels (K6, K7a, K7b; the vision
#: and time-series encoders' heads, on the CUDA cores): rows of one block
#: at each D, one row a thread (``Small<D>::THREADS`` in
#: ``csrc/flow_nc_common.cuh``)
NC_SMALL_THREADS = {6: 256, 8: 256, 12: 256, 16: 256, 24: 256, 48: 128}
#: the non-causal kernels' head dims: ``HEAD_DIMS`` on the tensor cores and
#: the small-head route's
NC_HEAD_DIMS = tuple(sorted((*HEAD_DIMS, *NC_SMALL_THREADS)))

#: launches per kernel: each wrapper adds one where it launches its kernel
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_FUNCS: dict[str, ctypes._CFuncPtr] = {}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing.

    All ``nvcc`` processes start together and are waited on together.
    Returns the compiler's output (``-Xptxas -v`` register and shared
    memory report) per source built; raises if any build fails.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def function(name: str, symbol: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of the library built from source
    ``name`` (built on first use), returning ``restype`` (by default an
    ``int`` cudaError_t)."""
    key = f"{name}:{symbol}"
    fn = _FUNCS.get(key)
    if fn is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fn.error_string = err
        _FUNCS[key] = fn
    return fn


def refuse_autograd(*xs: torch.Tensor, why: str, instead: str):
    """Raise where autograd would record a kernel call whose output has no
    autograd graph: grad mode on and an input that requires grad.  Inside
    an ``autograd.Function`` grad mode is off.  ``instead`` names the
    differentiable route."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(f"{why}; differentiate through {instead}")


def check(fn, err: int, what: str):
    """Raise if a launch returned a non-zero cudaError_t."""
    if err:
        msg = fn.error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed: cudaError {err} ({msg})")
