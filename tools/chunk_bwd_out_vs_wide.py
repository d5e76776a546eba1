#!/usr/bin/env python3
"""K5b's two output kernels at the narrow pairs, on the same chunk states:
``chunk_bwd_out`` (what ``csrc/flow_chunk_bwd.cu`` launches at D and Dv in
{32, 64, 128}) against ``chunk_bwd_wide`` (what the wide pairs launch: 64
output columns a block, by grid y), both from ``csrc/flow_chunk_bwd.cuh``.

    python3 tools/chunk_bwd_out_vs_wide.py        # one GPU

It builds one library of its own that includes the header, runs K5b's
state and pass kernels once per shape (``launch``), then launches either
output kernel on that workspace.  For each shape it prints whether the two
give bitwise the same dk and dv, and each one's median device ms
(``chip_smoke.time_ms``: 20 CUDA-event runs, L2 flushed).  The shapes are
phase 9's K5b layer (128 rows, G = 1, N = 512) at D = Dv = 64 and 128, and
the same at G = 4.  ``chunk_bwd_wide`` needs D and Dv multiples of its 64
-column tile, so the pairs with 32 have no such comparison.  Imports torch
and the port only.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import chunk_operands, time_ms  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402

SOURCE = r"""
#include "flow_chunk_bwd.cuh"

template <int D>
cudaError_t out_kernel(int wide, const float* q, const float* k, const float* v,
                       const float* g, const float* work, float* dk, float* dv, int bh,
                       int grp, int n, cudaStream_t st) {
  constexpr int C = chunk_of<D, D>();
  const int nc = (n + C - 1) / C;
  cudaError_t err;
  if (wide) {
    using WT = WideTiles<D, D>;
    if ((err = allow_smem(chunk_bwd_wide<D, D>, WT::FLOATS)) != cudaSuccess) return err;
    chunk_bwd_wide<D, D><<<dim3(bh * nc, WT::NDV + WT::NDK), kThreads,
                           WT::FLOATS * sizeof(float), st>>>(q, k, v, g, work, dk, dv, bh,
                                                             grp, n);
  } else {
    constexpr int fo = BwdTiles<D, D>::FLOATS;
    if ((err = allow_smem(chunk_bwd_out<D, D>, fo)) != cudaSuccess) return err;
    chunk_bwd_out<D, D><<<bh * nc, kOutThreads, fo * sizeof(float), st>>>(q, k, v, g, work,
                                                                          dk, dv, bh, grp, n);
  }
  return cudaGetLastError();
}

// the whole K5b call (state, pass, chunk_bwd_out) at D = Dv = d
extern "C" int k5b_full(const void* q, const void* k, const void* v, const void* g, void* dk,
                        void* dv, void* work, int bh, int grp, int n, int d, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return (int)launch<64, 64>(f(q), f(k), f(v), f(g), (float*)dk, (float*)dv, (float*)work,
                               bh, grp, n, st);
  if (d == 128)
    return (int)launch<128, 128>(f(q), f(k), f(v), f(g), (float*)dk, (float*)dv,
                                 (float*)work, bh, grp, n, st);
  return (int)cudaErrorInvalidValue;
}

// one output kernel on a workspace k5b_full filled
extern "C" int k5b_out(int wide, const void* q, const void* k, const void* v, const void* g,
                       const void* work, void* dk, void* dv, int bh, int grp, int n, int d,
                       void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return (int)out_kernel<64>(wide, f(q), f(k), f(v), f(g), f(work), (float*)dk,
                               (float*)dv, bh, grp, n, st);
  if (d == 128)
    return (int)out_kernel<128>(wide, f(q), f(k), f(v), f(g), f(work), (float*)dk,
                                (float*)dv, bh, grp, n, st);
  return (int)cudaErrorInvalidValue;
}
"""

#: (rows, G, N, D): phase 9's K5b layer at two widths, and at G = 4
SHAPES = ((128, 1, 512, 64), (128, 1, 512, 128), (128, 4, 512, 64),
          (128, 4, 512, 128))


def build(tmp: Path) -> ctypes.CDLL:
    src, lib = tmp / "k5b_out_vs_wide.cu", tmp / "libk5b_out_vs_wide.so"
    src.write_text(SOURCE)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC_DIR),
                    "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="k5b_out_vs_wide_") as tmp:
        lib = build(Path(tmp))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k5b_full.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.k5b_out.argtypes = [i] + [p] * 7 + [i] * 4 + [p]
        rows = []
        for bh, grp, n, d in SHAPES:
            q, k, v, g = chunk_operands(bh, grp, n, d, d, 34)
            size = _lib.function("flow_chunk_bwd", "flow_chunk_dkv_workspace",
                                 [i] * 5, ctypes.c_longlong)(bh, grp, n, d, d)
            work = torch.empty(max(size, 4), device="cuda")
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            stream = torch.cuda.current_stream().cuda_stream
            ptr = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
            if lib.k5b_full(*ptr(q, k, v, g, dk, dv, work), bh, grp, n, d,
                            stream):
                raise RuntimeError("k5b_full failed")
            outs = {}
            for wide in (0, 1):
                a, b = torch.full_like(k, float("nan")), torch.full_like(
                    v, float("nan"))

                def run(wide=wide, a=a, b=b):
                    if lib.k5b_out(wide, *ptr(q, k, v, g, work, a, b), bh,
                                   grp, n, d, stream):
                        raise RuntimeError("k5b_out failed")

                run()
                outs[wide] = (a, b, time_ms(run))
            row = {"rows": bh, "G": grp, "N": n, "D": d, "Dv": d,
                   "full_call_equals_out": torch.equal(outs[0][0], dk)
                   and torch.equal(outs[0][1], dv),
                   "wide_bitwise_equal": torch.equal(outs[0][0], outs[1][0])
                   and torch.equal(outs[0][1], outs[1][1]),
                   "wide_max_abs_diff": max(
                       float((outs[0][j] - outs[1][j]).abs().max())
                       for j in (0, 1)),
                   "chunk_bwd_out_ms": outs[0][2],
                   "chunk_bwd_wide_ms": outs[1][2]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
