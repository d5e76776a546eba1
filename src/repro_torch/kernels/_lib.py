"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` (one per entry of ``SOURCES``) has a plain C
interface and is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` inside the package (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds), then loaded with ``ctypes``.  ``KERNELS`` names the
kernels whose launches are counted: one source may hold several
(``flow_nc_qside.cu`` holds K7a and K7b; ``ssd_chunk.cu`` K10a with and
without carry-ins, counted apart; ``paged_gather.cu`` K8a and K8b), and one
kernel may span two sources (K2: ``flow_fused_bwd.cu`` at D <= 128,
``flow_fused_bwd_wide.cu`` at the wide pairs, one ``flow_fused_bwd``
count; K5a and K5b likewise over ``flow_chunk.cu`` / ``flow_chunk_wide.cu``
and ``flow_chunk_bwd.cu`` / ``flow_chunk_bwd_wide.cu``).
Nothing here runs at import.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("flow_fused", "flow_fused_bwd", "flow_fused_bwd_wide",
           "flow_decode", "flow_decode_q",
           "flow_nc_fused", "flow_nc_qside", "flow_chunk", "flow_chunk_wide",
           "flow_chunk_bwd", "flow_chunk_bwd_wide", "boundary_gather",
           "ssd_chunk", "ssd_chunk_bwd", "paged_gather")
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
#: head dims the causal kernels of forward and training (K1, K2, K5a, K5b)
#: take by zero-padding to a wider instantiation, and that width: the
#: Table 7 harness's D = 24 runs the D = 32 one (K1 and K2 told the real
#: width, so that phi is 0 on the padded lanes; K5a and K5b given
#: operands that phi was applied to before the padding)
PADDED_HEAD_DIMS = {24: 32}
#: the (D, Dv) pairs beyond ``HEAD_DIMS``' D == Dv that K1 (flow_fused),
#: K2 (flow_fused_bwd), K3 (flow_decode) and K4 (flow_decode_q) take:
#: DeepSeek-V2's MLA heads (q and k 192 wide, v 128), Nemotron-4-340B's
#: 192-wide ones and RecurrentGemma's 256-wide ones
WIDE_PAIRS = ((192, 128), (192, 192), (256, 256))
#: the (D, Dv) pairs of K1 to K4: ``HEAD_DIMS`` square, then ``WIDE_PAIRS``
FUSED_PAIRS = tuple((d, d) for d in HEAD_DIMS) + WIDE_PAIRS
#: the (D, Dv) pairs of K5a (flow_chunk) and K5b (flow_chunk_dkv): every
#: product of ``HEAD_DIMS`` (``flow_chunk.cu``, ``flow_chunk_bwd.cu``),
#: then ``WIDE_PAIRS`` with (128, 192), K5a's dq call at the MLA heads
#: (``FlowChunkDot`` swaps k and v), in ``flow_chunk_wide.cu`` and
#: ``flow_chunk_bwd_wide.cu``.  ``pair_ok`` in ``csrc/flow_chunk_common.cuh``
#: mirrors it (the card tests hold the two equal); a D of
#: ``PADDED_HEAD_DIMS`` is taken at its stored width
CHUNK_PAIRS = tuple((d, dv) for d in HEAD_DIMS for dv in HEAD_DIMS) + (
    (192, 128), (128, 192), (192, 192), (256, 256))
#: the opt-in shared memory of one block on the H100 (bytes): what K1's and
#: K2's super-chunks are sized against on the card
H100_SMEM_PER_BLOCK = 232_448
#: the small-head route of the non-causal kernels (K6, K7a, K7b; the vision
#: and time-series encoders' heads, on the CUDA cores): rows of one block
#: at each D, one row a thread (``Small<D>::THREADS`` in
#: ``csrc/flow_nc_common.cuh``)
NC_SMALL_THREADS = {6: 256, 8: 256, 12: 256, 16: 256, 24: 256, 48: 128}
#: the non-causal kernels' head dims: ``HEAD_DIMS`` on the tensor cores and
#: the small-head route's
NC_HEAD_DIMS = tuple(sorted((*HEAD_DIMS, *NC_SMALL_THREADS)))


def stored_width(d: int) -> int:
    """The width a head dim of ``d`` is stored at for the causal kernels:
    ``PADDED_HEAD_DIMS``' width, else ``d`` itself."""
    return PADDED_HEAD_DIMS.get(d, d)


def pad_lanes(x: torch.Tensor) -> torch.Tensor:
    """``x`` zero-padded along its last axis to ``stored_width``; a width
    stored as it is comes back unchanged."""
    d = x.shape[-1]
    return torch.nn.functional.pad(x, (0, stored_width(d) - d)) \
        if stored_width(d) != d else x


def _flow_smem_floats(d: int, t: int, g: int) -> int:
    """Shared floats of the flows' block (``flow_smem_floats_at`` in
    ``csrc/flow_fused_common.cuh``)."""
    return (g + 5) * t * d + 2 * g * t + 4 * t + 2 * 1024 + 4 * d + 4


def k2_group_fits(d: int, g: int, limit: int = H100_SMEM_PER_BLOCK) -> bool:
    """Whether K2 takes a group of ``g`` at head width ``d`` within
    ``limit`` bytes of shared memory a block: its pull-back (the flows plus
    (G + 1) T D + 3 G T + 4 T + 4 D + 4 floats, ``pull_smem_floats`` in
    ``csrc/flow_fused_bwd.cuh``) at a super-chunk of 4 or 2 scan segments
    (and of one at D = 192, 256), and the flows at one of 8, 4 or 2 no
    shorter.  A mirror of the C entry's count (``flow_fused_bwd_tile``,
    which the card tests hold it to): 9 at D = 32, 10 at 64 and 128, 23 at
    192, 21 at 256 on the H100."""
    w = stored_width(d)
    segs = 1024 // w
    tiles = (4 * segs, 2 * segs) + ((segs,) if w > 128 else ())
    pull = next((t for t in tiles if 4 * (
        _flow_smem_floats(w, t, g) + (g + 1) * t * w + 3 * g * t + 4 * t
        + 4 * w + 4) <= limit), 0)
    flows = next((t for t in (8 * segs, 4 * segs, 2 * segs)
                  if 4 * _flow_smem_floats(w, t, g) <= limit), 0)
    return pull > 0 and flows >= pull


def kernel_chunk(n: int, chunk: int, d: int, dv: int) -> int:
    """The chunk N is padded to for the causal kernels (K1 and K2, K5a and
    K5b): ``chunk`` capped at N, or where the caller has none (``chunk <=
    0``: ``flowformer_dt``) the kernels' own -- 64 positions, 32 where a
    stored width is 128 or more (``chunk_of`` in
    ``csrc/flow_fused_common.cuh`` and ``csrc/flow_chunk_common.cuh``) --
    never a chunk of 1."""
    if chunk <= 0:
        return 32 if max(stored_width(d), stored_width(dv)) >= 128 else 64
    return max(1, min(chunk, n))


#: launches per kernel: each wrapper adds one where it launches its kernel
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
#: launches of K5a and K5b by the (D, Dv) they ran at, keyed
#: ``"<kernel>_<D>x<Dv>"``: each wrapper adds one beside its LAUNCHES count
PAIR_LAUNCHES: collections.Counter = collections.Counter()

_FUNCS: dict[str, ctypes._CFuncPtr] = {}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PAIR_LAUNCHES.clear()


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
    memory report) per source built, after a first line "built in <s> s"
    (that source's wall time); raises if any build fails.
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
    t0, done = time.perf_counter(), {}

    def wait(name, proc):  # the output, and when this source finished
        done[name] = (proc.communicate()[0], time.perf_counter() - t0)

    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (proc, _, _) in jobs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        text, secs = done[name]
        logs[name] = f"built in {secs:.1f} s\n{text}"
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
