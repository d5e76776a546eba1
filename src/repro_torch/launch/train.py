"""Train the LM: the counterpart of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch flowformer-lm --steps 200 \\
        --batch 16 --seq 512 --ckpt-dir runs/lm --ckpt-every 50
    python -m repro_torch.launch.train --arch mamba2_1p3b --steps 5 \\
        --batch 4 --seq 4096
    python -m repro_torch.launch.train --arch deepseek-v2-lite-16b \\
        --layers 2 --steps 5 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch recurrentgemma-9b \\
        --layers 3 --optimizer adafactor --steps 5 --batch 4 --seq 512

Random weights from ``--seed`` (or given ``params``), batches from
``data.loader.lm_loader(seed)``, AdamW on fp32 master parameters with a
warmup-cosine schedule, bf16 compute, over ``mesh`` (default a (1, 1)
("data", "model") mesh on ``device``) through ``launch.steps.
build_train_step``: a (2, 1) mesh runs two data-parallel positions in
turn on the same card and averages their gradients
(``training.train_state.shard_train_step``).  The attention backend is resolved
once, for gradients: on a GPU every attention forward runs kernel K1 and
every attention backward kernel K2; in the paper-faithful causal mode
(``attention.strict_causal=False``) and without competition, every
forward runs K5a and every backward K5a (dq) and K5b (dk, dv).  The
wide-head archs train on K1 and K2 at their widths: DeepSeek-V2-Lite's
MLA heads (192, 128), Nemotron-4-340B's (192, 192) at G = 12 and
RecurrentGemma-9B's flow heads (256, 256) at G = 16; ``--layers`` cuts
the depth at full width.
``--attn`` sets ``attention.kind``: ``linear`` runs its causal dot on K5a
and K5b likewise, ``softmax`` is plain PyTorch.  An SSD stack
(``mamba2_1p3b``) has no attention: every SSD forward and its remat
recompute run K10a with carry-ins, every backward K10b.

Crash-restart: with ``--ckpt-dir`` the state (parameters, optimizer,
step) is saved every ``--ckpt-every`` steps by an async writer and once
more at the end, and rerunning the same command resumes from the last
committed checkpoint, the loader replaying from the next batch
(``checkpoint/manager.py``).  The state stays as ZeRO-1 pieces over the
mesh from step to step; a checkpoint holds its leaves whole, in the
reference's stacked layout, so a run restores onto another mesh; the
state ``train`` returns is gathered whole, in the port's layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.loader import lm_loader
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (RunPlan, build_train_step,
                                      check_flow_trainable)
from repro_torch.layers.attention import plan_of
from repro_torch.models import lm
from repro_torch.runtime.elastic import StepMonitor
from repro_torch.training.train_state import gather_state
from repro_torch.utils import resolve_device, tree_leaves, tree_map


def build_train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
                seed: int = 0, peak_lr: float = 3e-4, device="cuda",
                dtype=torch.bfloat16, params: dict | None = None,
                mesh=None, optimizer: str | None = None):
    """``train``'s step function and fresh ``TrainState`` for a run of
    ``steps`` steps of ``batch`` x ``seq`` tokens (the warmup-cosine
    schedule spans ``steps``) over ``mesh`` (default (1, 1) on
    ``device``): the template that a restore fills, as
    ``runtime.elastic.ElasticTrainer``'s ``build`` returns it.  The step
    is ``build_train_step``'s on every mesh, and it takes and returns the
    placed state (ZeRO-1 pieces; ``training.train_state.gather_state(
    state, cfg)`` gives it whole).  ``optimizer`` ("adamw" or "adafactor")
    replaces ``RunPlan.choose``'s (AdamW)."""
    dev = resolve_device(device)
    mesh = mesh or make_mesh((1, 1), ("data", "model"), devices=[dev])
    dev = mesh.devices.flat[0]
    shape = ShapeSpec("custom", seq, batch, "train")
    plan = RunPlan.choose(cfg, shape, mesh)
    if optimizer is not None:
        plan = dataclasses.replace(plan, optimizer=optimizer)
    overrides = {"total_steps": steps, "warmup": max(5, steps // 10),
                 "peak_lr": peak_lr, "fused_value_grad": True,
                 "compute_dtype": dtype}
    xplan = plan_of(cfg, needs_grad=True)
    be = check_flow_trainable(cfg, shape, dev.type, xplan)
    if params is None:
        params = lm.init(cfg, torch.Generator().manual_seed(seed), device=dev)
    params = tree_map(lambda x: x.detach().to(dev, torch.float32), params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params:,} params on {mesh}, "
          f"{str(dtype)[6:]} compute, microbatch={plan.microbatch}, "
          f"params {plan.param_mode}, {plan.optimizer}")
    kinds = sorted({cfg.block_kind(i) for i in range(cfg.n_layers)})
    if be is not None:
        route = be.name
    elif "attn" in kinds:
        route = f"{cfg.attention.kind} branch (no flow backend)"
    else:
        route = f"no attention backend (mixers: {', '.join(kinds)})"
    print(f"[train] attention {xplan.describe()} -> {route}")

    step, init_state, _, _ = build_train_step(cfg, shape, mesh, plan,
                                              overrides)
    return step, init_state(params)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str | None = None, ckpt_every: int = 50, mesh=None,
          seed: int = 0, peak_lr: float = 3e-4, device="cuda",
          dtype=torch.bfloat16, params: dict | None = None,
          log_every: int = 10, optimizer: str | None = None) -> dict:
    """Train up to step ``steps`` with batches of ``batch`` x ``seq``
    tokens, resuming from the latest checkpoint under ``ckpt_dir`` if it
    holds one.

    ``mesh`` (a ``distribution.mesh.Mesh``; default (1, 1) ("data",
    "model") on ``device``) is the mesh the step runs over, its batches
    moved to the mesh's first device.  ``params`` (fp32, any device)
    replaces the random init from ``seed``; ``optimizer`` ("adamw", the
    default, or "adafactor") is ``build_train``'s.
    The state stays placed across the steps and is checkpointed placed.
    Returns {"history": the losses of the steps run here, "final_loss",
    "wall_s", "step_s": their wall seconds, "state": the final TrainState
    (whole, the port's layout),
    "start_step", "ckpt": {"restore_s", "async_save_s": the seconds each
    async save held the loop, "save_s": the last, synchronous save's}}.
    """
    dev = resolve_device(device)
    mesh = mesh or make_mesh((1, 1), ("data", "model"), devices=[dev])
    dev = mesh.devices.flat[0]
    step_fn, state = build_train(cfg, steps=steps, batch=batch, seq=seq,
                                 seed=seed, peak_lr=peak_lr, device=dev,
                                 dtype=dtype, params=params, mesh=mesh,
                                 optimizer=optimizer)
    start_step, mgr = 0, None
    ckpt = {"restore_s": None, "async_save_s": [], "save_s": None}
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        t0 = time.perf_counter()
        restored = mgr.restore_latest(state)
        if restored is not None:
            start_step, state, _ = restored
            ckpt["restore_s"] = time.perf_counter() - t0
            print(f"[train] resumed from step {start_step}")
    loader = lm_loader(seed, batch=batch, seq=seq, vocab=cfg.vocab_size,
                       start_step=start_step)
    monitor = StepMonitor()
    history, step_s = [], []
    t_start = time.perf_counter()
    for step in range(start_step, steps):
        batch_np = next(loader)
        monitor.start()
        state, metrics = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                         for k, v in batch_np.items()})
        loss_value = float(metrics["loss"])  # waits for the step
        step_s.append(monitor.stop(step))
        history.append(loss_value)
        if step % log_every == 0 or step == steps - 1:
            print(f"  step {step:5d} loss={loss_value:.4f} "
                  f"ppl={float(metrics['ppl']):.2f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"{step_s[-1] * 1000:.0f}ms")
        if mgr and (step + 1) % ckpt_every == 0:
            t0 = time.perf_counter()
            mgr.save(step + 1, state, extra=loader.state(), async_=True)
            ckpt["async_save_s"].append(time.perf_counter() - t0)
    if mgr:
        t0 = time.perf_counter()
        mgr.save(steps, state, extra=loader.state())
        mgr.wait()
        ckpt["save_s"] = time.perf_counter() - t0
    return {"history": history, "final_loss": history[-1] if history else None,
            "wall_s": time.perf_counter() - t_start, "step_s": step_s,
            "state": gather_state(state, cfg), "start_step": start_step,
            "ckpt": ckpt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Train the LM (random weights, synthetic zipf_text "
        "batches) on a (1, 1) mesh, resuming from --ckpt-dir's last "
        "checkpoint.")
    ap.add_argument("--arch", default="flowformer-lm")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--attn", default=None, help="override attention kind")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--optimizer", default=None,
                    choices=["adamw", "adafactor"],
                    help="default adamw; adafactor keeps factored moments "
                    "(RecurrentGemma-9B at full width: AdamW's update holds "
                    "the old and the new state at once)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, kind=args.attn))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                device=args.device, optimizer=args.optimizer)
    last = out["final_loss"]
    print(f"[train] done at step {out['state'].step}: final_loss="
          + ("none (nothing left to run)" if last is None else f"{last:.4f}")
          + f" ({out['wall_s']:.1f}s)")
    return out


if __name__ == "__main__":
    main()
