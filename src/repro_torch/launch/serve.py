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

The linear-attention baseline (``--attn linear``: elu + 1 features, an
O(d^2) state a slot; each admission's causal numerator on K5a, decode in
plain einsums, int8 pools dequantized and requantized around the fp32
update)::

    python -m repro_torch.launch.serve --attn linear [--state-dtype int8]

The MoE, MLA and M-RoPE archs (K1 and K3 at D = 192 beside Dv = 128 for
DeepSeek-V2-Lite's MLA heads, at G = 8, D = 128 for Qwen2-VL's M-RoPE
heads)::

    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m

The RecurrentGemma hybrid stack (rglru, rglru, local): in flow mode, the
configuration's own, the local slots run causal flow attention (K1 and K3
at D = Dv = 256, G = 16) and admission packs (K9 gathers each rglru
layer's conv histories); with ``--attn softmax`` (or ``local``) they are
sliding-window rings and admission runs one prefill a request::

    python -m repro_torch.launch.serve --arch recurrentgemma-9b
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --attn softmax

``--attn local`` on a plain stack serves every attention layer from a
window ring.  int8 pools serve the SSD and RG-LRU mixers (dequantized,
advanced in fp32, requantized each step), and the flow heads at every
width K3 takes, D = 192 and 256 included, on K4::

    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --state-dtype int8

Disaggregated fleet serving (``serving/fleet.py``): a prefill group runs
packed admission (K1) and hands each request's state to the least-loaded
decode worker as a byte-accounted bundle; the decode group steps its
pools (K3, or K4 from int8 pools).  The groups take every CUDA device,
disjoint when there are enough, shared on one card::

    python -m repro_torch.launch.serve --fleet prefill:1,decode:2

``--fleet`` serves plain decode only and, as in the reference, refuses
``--speculate-k``.

Random weights from seed 0, random prompts from ``numpy`` seed 0.  The
path not ported yet is refused by name: MLA's softmax branch (``--attn
softmax`` on an MLA arch, whose decode is the absorbed form over a
compressed latent cache).
``--paged`` on a stack with no softmax layer serves unpaged, as in the
reference.  A mixer that cannot meet the serving plan (a local ring with
int8 pools or a speculative window) exits with the mixer's reason.
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
from repro_torch.serving.fleet import FleetEngine
from repro_torch.serving.quant import STATE_DTYPES, pool_bytes

#: options of the reference CLI whose paths are not ported yet, with what
#: each needs
_NOT_PORTED = {
    "attn": "an attention kind of the port's attention branches (flow, "
            "softmax, linear, local); MLA is an arch's own attention "
            "(--arch deepseek-v2-lite-16b), not a kind",
}


#: the attention kinds ``--attn`` takes
_KINDS = ("flow", "softmax", "linear", "local")


def _parse_fleet(spec: str) -> tuple[int, int]:
    """``prefill:N,decode:M`` -> (N, M), with loud errors; a group left out
    keeps its default (1 prefill, 2 decode workers)."""
    sizes = {"prefill": 1, "decode": 2}
    for part in spec.split(","):
        name, _, num = part.partition(":")
        if name not in sizes or not num.isdigit() or int(num) < 1:
            raise SystemExit(
                f"--fleet expects 'prefill:N,decode:M' (got {spec!r}): "
                "fleet serving needs at least one worker in each group")
        sizes[name] = int(num)
    return sizes["prefill"], sizes["decode"]


def _refuse_unported(args):
    if args.fleet and args.speculate_k:
        raise SystemExit("--fleet serves plain decode only (speculative "
                         "windows stay a single-engine feature)")
    given = {"attn": args.attn not in (None, *_KINDS)}
    for opt, on in given.items():
        if on:
            raise SystemExit(f"--{opt.replace('_', '-')} is not ported yet: "
                             f"it needs {_NOT_PORTED[opt]}")


def _refuse_unported_arch(cfg, args):
    """Exit naming what an arch's plan would need that is not ported: MLA
    with softmax (its absorbed decode over an ``MLACache``)."""
    if cfg.mla is not None and cfg.attention.kind != "flow":
        raise SystemExit(f"--attn {cfg.attention.kind} on an MLA arch is not "
                         "ported yet: it needs MLA's absorbed decode over a "
                         "compressed latent cache (MLACache)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Serve random requests through the Engine on one GPU "
        "(random weights from seed 0).")
    ap.add_argument("--arch", default="flowformer-lm")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn", default=None,
                    help="attention kind: flow (the configuration's), "
                    "softmax, linear or local (sliding-window rings); on a "
                    "hybrid stack softmax and local make its local slots "
                    "window rings")
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
                    help="serve through FleetEngine: disaggregated "
                    "prefill/decode worker groups with StateBundle hand-off "
                    "over the CUDA devices (with --device cpu, on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    _refuse_unported(args)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, kind=args.attn))
    _refuse_unported_arch(cfg, args)
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
        if args.fleet:
            n_pre, n_dec = _parse_fleet(args.fleet)
            # the default takes every CUDA device; another names the one
            devices = None if args.device == "cuda" else [args.device]
            engine = FleetEngine(params, cfg, prefill=n_pre, decode=n_dec,
                                 slots=args.slots, max_len=max_len,
                                 plan=plan, dtype=dtype, paged=paged,
                                 state_dtype=args.state_dtype,
                                 devices=devices)
            worker = engine.workers[0]
            n_devs = len({*engine.prefill_devices, *engine.decode_devices})
            print(f"[serve] fleet: {n_pre} prefill + {n_dec} decode workers, "
                  f"{n_devs} devices (decode group: "
                  f"{[str(d) for d in engine.decode_devices]})")
        else:
            engine = Engine(params, cfg, slots=args.slots, max_len=max_len,
                            plan=plan, dtype=dtype, draft=args.draft,
                            speculate_k=args.speculate_k, device=args.device)
            worker = engine.worker
    except MixerResolutionError as err:
        raise SystemExit(f"[serve] {err}") from None
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
    draft = getattr(engine, "draft", None)
    if args.fleet:
        kb_moved = engine.bytes_migrated / 1024.0
        kb_req = np.mean(list(engine.kb_by_uid.values()) or [0.0])
        print(f"[serve] fleet: loads={engine.loads()}, "
              f"{engine.migrations} migrations ({kb_moved:.1f} KiB moved), "
              f"{engine.recoveries} recoveries, "
              f"~{kb_req:.1f} KiB of state moved per request")
    elif draft is not None:
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
            "draft": draft, "fleet": engine if args.fleet else None}


if __name__ == "__main__":
    main()
