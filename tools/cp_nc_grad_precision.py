#!/usr/bin/env python3
"""How far the gradients of sum(out^2) through the non-causal flow
attention lie from a true-fp64 run at the LRA shape, per path.

    PYTHONPATH=src python3 tools/cp_nc_grad_precision.py              # one GPU
    PYTHONPATH=src python3 tools/cp_nc_grad_precision.py --device cpu --batch 2 --n 512

q, k and v are unit normal, (``--batch``, 4 heads, ``--n``, 64), from
``--seed``.  It prints the gradients' max |grad| and, for dq, dk and dv,
max |grad - grad_fp64| / max |grad_fp64| of:

* ``nc``: the plain ``nc`` backend (autograd through
  ``pipeline.nc_forward``) in fp32;
* ``cp_nc 4-way``, ``cp_nc 8-way``: the context-parallel glue on a ``seq``
  mesh of the device (``attention/cp.py``), fp32;
* ``share of cons_src > 1``: of every source's conserved outgoing flow,
  which the attention clamps to [-1, 1] (it sits at 1, where the clamp
  kinks, so roundings on either side switch single entries of dk).

The fp64 reference is the plain path with every tensor in fp64:
``pipeline.nc_forward`` casts with ``Tensor.float()``, which this script
makes keep fp64 tensors in fp64 for that one run.  Imports torch and the
port only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import attention  # noqa: E402
from repro_torch.attention import ExecutionPlan, FlowConfig, ShardSpec  # noqa: E402
from repro_torch.attention.pipeline import nc_forward  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402

from nc_grad_precision import fp64_kept  # noqa: E402


def grads(fn, qkv, dtype):
    leaves = [x.to(dtype).clone().requires_grad_(True) for x in qkv]
    out = fn(*leaves)
    return [g.double() for g in torch.autograd.grad(
        (out.double() ** 2).sum(), leaves)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=369)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    qkv = [torch.randn(args.batch, 4, args.n, 64, generator=gen, device=dev)
           for _ in range(3)]
    cfg = FlowConfig()
    paths = {"nc": attention.resolve(ExecutionPlan(
        flow=dataclasses.replace(cfg, backend="nc"))).forward}
    for ways in (4, 8):
        mesh = make_mesh((ways,), ("seq",), devices=[dev])
        paths[f"cp_nc {ways}-way"] = attention.resolve(ExecutionPlan(
            flow=cfg, shard=ShardSpec(axis="seq", mesh=mesh))).forward
    got = {name: grads(fn, qkv, torch.float32) for name, fn in paths.items()}
    with fp64_kept():
        ref = grads(lambda q, k, v: nc_forward(q, k, v, cfg), qkv,
                    torch.float64)
    pq, pk = torch.sigmoid(qkv[0]), torch.sigmoid(qkv[1])
    sink_in = 1.0 / torch.einsum("bhnd,bhd->bhn", pq + cfg.eps,
                                 pk.sum(2) + cfg.eps)
    qi_sum = (pq * sink_in[..., None]).sum(2)
    cons_src = torch.einsum("bhmd,bhd->bhm", pk + cfg.eps, qi_sum + cfg.eps)
    out = {"max_grad_fp64": {n: float(g.abs().max())
                             for n, g in zip(("dq", "dk", "dv"), ref)},
           "share of cons_src > 1": float((cons_src > 1).float().mean()),
           "of_max": {name: {n: float((a - b).abs().max() / b.abs().max())
                             for n, a, b in zip(("dq", "dk", "dv"), gs, ref)}
                      for name, gs in got.items()}}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
