"""Serving entry point: continuous batching with constant-memory states.

The counterpart of ``repro/launch/serve.py`` on one GPU::

    python -m repro_torch.launch.serve --arch flowformer-lm --smoke \\
        --requests 16 --max-new 32
    python -m repro_torch.launch.serve --arch mamba2_1p3b

(an SSD stack: packed admission gathers each row's conv history with the
K9 kernel; prefill and decode run the plain chunked scan and recurrence).

int8 FlowState pools (int8 payloads with fp32 per-(slot, head) scales;
every decode step on the flow_decode_q kernel, K4)::

    python -m repro_torch.launch.serve --state-dtype int8

The softmax Transformer baseline (``--attn softmax``, the same weights'
shapes), its KV caches paged into a shared pool (every decode step
gathers each slot's pages with K8a, or with K8b from int8 pools)::

    python -m repro_torch.launch.serve --attn softmax --paged \
        [--page-size 64] [--num-pages 0] [--state-dtype int8]

Speculative decoding: each window drafts k tokens a slot (``--draft
self``: the target's own greedy decode steps; ``tiny``: a smoke-sized
flowformer_lm drafter) and one fused verify commits the accepted prefix
plus a bonus token::

    python -m repro_torch.launch.serve --draft self --speculate-k 4

Random weights from seed 0, random prompts from ``numpy`` seed 0.  The
paths not ported yet are refused by name: the local, linear and MLA
attention branches (``--attn local|linear``) and fleet serving
(``--fleet``, which the reference also refuses with ``--speculate-k``).
``--paged`` on a stack with no softmax layer serves unpaged, as in the
reference.  A mixer that cannot meet the serving plan (an SSD stack with
int8 pools, whose mixer is not ``quant_capable`` here) exits with the
mixer's reason.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.layers.attention import plan_of
from repro_torch.layers.mixer import MixerResolutionError
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, PagedSpec, Request
from repro_torch.serving.quant import STATE_DTYPES, pool_bytes

#: options of the reference CLI whose paths are not ported yet, with what
#: each needs
_NOT_PORTED = {
    "attn": "the local, linear and MLA attention branches",
    "fleet": "fleet serving",
}


def _refuse_unported(args):
    if args.fleet and args.speculate_k:
        raise SystemExit("--fleet serves plain decode only (speculative "
                         "windows stay a single-engine feature)")
    given = {"attn": args.attn not in (None, "flow", "softmax"),
             "fleet": args.fleet is not None}
    for opt, on in given.items():
        if on:
            raise SystemExit(f"--{opt.replace('_', '-')} is not ported yet: "
                             f"it needs {_NOT_PORTED[opt]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Serve random requests through the Engine on one GPU "
        "(random weights from seed 0).")
    ap.add_argument("--arch", default="flowformer-lm")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn", default=None,
                    help="attention kind: flow (the configuration's) or "
                    "softmax; local and linear are not ported yet")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy); "
                    "sampling is one batched draw per step either way")
    ap.add_argument("--paged", action="store_true",
                    help="serve softmax KV caches from the paged pool "
                    "instead of dense max_len caches")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="paged pool size (0 = dense-equivalent worst case)")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                    help="serving activation dtype")
    ap.add_argument("--state-dtype", default=None, choices=list(STATE_DTYPES),
                    help="state-pool storage dtype, independent of the "
                    "activation dtype; int8 stores quantized pools (int8 "
                    "payload + fp32 per-(slot, head) scales) decoded by the "
                    "flow_decode_q kernel; fp8 is TPU-only and refused here")
    ap.add_argument("--draft", default=None, choices=["self", "tiny"],
                    help="speculative decoding draft source: 'self' "
                    "(self-speculation from the target's own states) or "
                    "'tiny' (a smoke-sized flowformer_lm drafter)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="drafted tokens per verify window (0 = plain "
                    "decode; implies --draft self when unset)")
    ap.add_argument("--fleet", default=None, metavar="prefill:N,decode:M",
                    help="fleet serving (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    _refuse_unported(args)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, kind=args.attn))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device=args.device)
    paged = (PagedSpec(page_size=args.page_size, num_pages=args.num_pages)
             if args.paged else None)
    # one ExecutionPlan for the whole serving lifetime: packed admission,
    # the paged-cache option and the state-pool dtype ride it instead of
    # per-call kwargs; the Engine adds the speculative window
    plan = plan_of(cfg, packed=True, paged=paged,
                   state_dtype=args.state_dtype)
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[args.dtype]
    max_len = args.prompt_len + args.max_new + 8
    try:
        engine = Engine(params, cfg, slots=args.slots, max_len=max_len,
                        plan=plan, dtype=dtype, draft=args.draft,
                        speculate_k=args.speculate_k, device=args.device)
    except MixerResolutionError as err:
        raise SystemExit(f"[serve] {err}") from None
    worker = engine.worker
    mixers = sorted({cfg.block_kind(i) for i in range(cfg.n_layers)})
    print(f"[serve] mixers: {', '.join(mixers)}; attention plan: "
          f"{worker.plan.describe()}")
    print(f"[serve] dtypes: activations={args.dtype} "
          f"state_pools={args.state_dtype or args.dtype}")
    n_bytes = pool_bytes(worker.caches)
    print(f"[serve] state pools: {n_bytes} bytes for {args.slots} slots x "
          f"{cfg.n_layers} layers ({n_bytes / args.slots:.0f} bytes per slot)")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        r = Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len
                                        ).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
        reqs.append(r)
        engine.submit(r)

    t0 = time.perf_counter()
    steps = 0
    while any(not r.done for r in reqs):
        if engine.step() == 0 and not engine.queue:
            break
        steps += 1
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in reqs)
    print(f"[serve] {args.requests} requests, {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s, {steps} steps)")
    if engine.draft is not None:
        print(f"[serve] speculative: k={engine.speculate_k}, "
              f"~{total_tokens / max(steps, 1):.2f} tokens committed per "
              f"step ({type(engine.draft).__name__}, {worker.verify_windows} "
              "verify windows)")
    alloc = worker.allocator
    if alloc is not None:
        print(f"[serve] paged KV: page_size={alloc.page_size} "
              f"pool={alloc.num_pages} pages, {alloc.free_pages} free after "
              "drain")
    print(f"[serve] sample generation: {reqs[0].generated[:16]}")
    return {"requests": reqs, "steps": steps, "seconds": dt,
            "pool_bytes": n_bytes, "plan": worker.plan, "allocator": alloc,
            "draft": engine.draft}


if __name__ == "__main__":
    main()
