#!/usr/bin/env python3
"""How far the first training step's attention gradients of the vision
encoder lie from a true-fp64 run, per path.

    PYTHONPATH=src python3 tools/nc_grad_precision.py              # one GPU
    PYTHONPATH=src python3 tools/nc_grad_precision.py --device cpu --size 64 --batch 2

The model is ``chip_smoke.py`` phase 21b's: ``flowformer_vision`` at full
width with one block a stage (16 heads of 6, 12, 24 and 48), random
weights from ``--seed`` + 2, the first ``--batch`` training images of
``launch.classify.vision_data(4 * batch, batch)`` at ``--size``.  It
prints, for each stage's wq and wk, max |grad - grad_fp64| / max
|grad_fp64| of:

* ``kernels``: the ``auto`` path (on a GPU K6 forward, K7b backward through
  ``FlowNCFused``; on the CPU the same glue on the kernels' plain versions,
  ``cuda_nc`` pinned);
* ``kernels, fp32 kv``: the same with ``nc_key_side``'s kv summed in fp32
  (``_KvSum`` replaced by a plain fp32 einsum);
* ``plain``: ``backend="plain"`` (autograd through ``pipeline.nc_forward``).

The fp64 reference is the plain path with every tensor in fp64: the model
and the attention cast their inputs with ``Tensor.float()``, which this
script makes keep fp64 tensors in fp64 for that one run.  Imports torch,
numpy and the port only.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.attention import backends, vjp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.classify import vision_data  # noqa: E402
from repro_torch.layers.attention import executor_of, plan_of  # noqa: E402
from repro_torch.models import vision  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402


@contextlib.contextmanager
def fp64_kept():
    """``Tensor.float()`` leaves fp64 tensors in fp64 inside the block."""
    real = torch.Tensor.float

    def keep(self, *a, **kw):
        return self if self.dtype == torch.float64 else real(self, *a, **kw)

    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = real


@contextlib.contextmanager
def fp32_kv():
    """``nc_key_side``'s kv summed in fp32 (no ``_KvSum``)."""
    real = vjp._KvSum

    class Fp32:
        @staticmethod
        def apply(pk, v_hat):
            return torch.einsum("bmd,bme->bde", pk, v_hat)

    vjp._KvSum = Fp32
    try:
        yield
    finally:
        vjp._KvSum = real


def first_step_grads(cfg, params, batch, backend, dtype):
    """Each stage's wq and wk gradient of one step's loss."""
    c = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend=backend))
    leaves = tree_map(lambda x: x.detach().to(dtype).requires_grad_(True),
                      params)
    bt = {"images": batch["images"].to(dtype), "labels": batch["labels"]}
    plan = executor_of(c, plan_of(c, causal=False, needs_grad=True),
                       causal=False)
    loss, _ = vision.loss_fn(leaves, bt, c, dtype=dtype, plan=plan)
    loss.backward()
    return {f"stage {i + 1} {w}":
            st["blocks"][0]["attn"][w]["w"].grad.double()
            for i, st in enumerate(leaves["stages"]) for w in ("wq", "wk")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cpu":  # the kernel glue on its plain versions
        backends._check_nc_dims = lambda shapes, platform: None
    cfg = dataclasses.replace(get_config("flowformer_vision"),
                              stage_layers=(1, 1, 1, 1))
    params = vision.init(cfg, torch.Generator().manual_seed(args.seed + 2),
                         device=args.device)
    data, _ = vision_data(4 * args.batch, args.batch, size=args.size,
                          n_classes=cfg.n_classes, seed=args.seed + 2)
    batch = {k: torch.from_numpy(v[:args.batch]).to(args.device)
             for k, v in data.items()}
    kernels = "cuda_nc" if args.device == "cpu" else "auto"
    with fp64_kept():
        ref = first_step_grads(cfg, params, batch, "plain", torch.float64)
    runs = {"kernels": first_step_grads(cfg, params, batch, kernels,
                                        torch.float32),
            "plain": first_step_grads(cfg, params, batch, "plain",
                                      torch.float32)}
    with fp32_kv():
        runs["kernels, fp32 kv"] = first_step_grads(cfg, params, batch,
                                                    kernels, torch.float32)
    name = "cpu"
    if args.device == "cuda":  # the card's name and power limit
        name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.splitlines()[0]
    print(json.dumps({"device": name, "size": args.size, "batch": args.batch,
                      "max |grad - fp64| / max |fp64|": {
                          path: {k: float((g[k] - ref[k]).abs().max()
                                          / ref[k].abs().max())
                                 for k in ref}
                          for path, g in runs.items()}}, indent=1))


if __name__ == "__main__":
    main()
