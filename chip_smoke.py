#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Flowformer on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card, ``nvcc`` (under
``$CUDA_HOME``, on ``PATH`` or in ``/usr/local/cuda``) and nothing else:
it imports ``repro_torch`` from ``src/`` and never JAX.  Phases, in order;
any failure raises, so the exit code is non-zero:

  1. the card: ``nvidia-smi`` name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  3. K1 ``flow_fused`` against its plain version at the packed-prefill
     shapes of the serving path (16 rows x 8 kv heads, N = 512, D = 64,
     bf16 and fp32), plus a G = 2, N = 200, chunk-64 case;
  4. K3 ``flow_decode`` against its plain version: 16 (the serving pool)
     and 64 slots x 8 kv heads, 32 steps from a non-zero state, updated
     in place;
  5. the Engine serving the full-width flowformer_lm (random weights from a
     seed) in bf16: 48 requests through 16 slots; every K1/K3 launch is
     counted and must equal 6 x admission rounds / 6 x decode steps;
     then ``torch.profiler`` reads the device time of a decode step by
     kernel, and its share of the step's wall time;
  6. the same Engine in fp32, once on the kernels and once on the plain
     PyTorch path: the greedy tokens must be identical;
  7. per kernel, its time with CUDA events beside its plain version's and
     its bound, as one ``{"kernels": [...]}`` line;
  8. the last line: ``{"ok": true, "device": {...}}``.

Tolerances (|kernel - plain| <= atol + rtol * |plain|, elementwise):
fp32 outputs and every fp32 state piece rtol 1e-4, atol 1e-4 -- both sides
sum the same fp32 terms in another order, no TF32 anywhere; bf16 outputs
rtol 1e-2, atol 1e-2 -- both compute in fp32 from the same bf16 inputs and
round once to bf16, whose spacing is 2^-7 relative.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"

# H100 SXM published peaks (dense): HBM bytes/s, fp32 FLOP/s off the tensor
# cores -- both kernels compute in fp32 FMA on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
STATE_TOL = (1e-4, 1e-4)
STATE_FIELDS = ("q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s")


def setup():
    """Refuse to run without a card or outside a checkout; import the port."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}")
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card() -> str:
    """Phase 1: the card's name and power limit, as nvidia-smi says them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    line = res.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def build_kernels() -> float:
    """Phase 2: compile every kernel (one nvcc per source, all at once)."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"[build] {name}: {len(usage)} kernel variants; "
              + (usage[0] if usage else "cached"), flush=True)
    print(f"[build] {secs:.1f} s", flush=True)
    return secs


def max_err(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    """Max |got - want|; raises where it exceeds atol + rtol * |want|."""
    rtol, atol = tol
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    excess = diff - (atol + rtol * want.abs())
    if excess.max() > 0:
        i = int(excess.argmax())
        raise AssertionError(
            f"{name}: |diff| {diff.flatten()[i]:.3e} at flat index {i} "
            f"exceeds atol {atol} + rtol {rtol} * |{want.flatten()[i]:.4e}|")
    return float(diff.max())


def ragged_lens(rng, rows: int, lo: int, hi: int) -> np.ndarray:
    return rng.integers(lo, hi + 1, rows).astype(np.int32)


def k1_inputs(dtype, rows=16, hkv=8, g=1, n=512, d=64, seed=SEED):
    """q (BH,G,N,D), k, v (BH,N,D) and lens (BH,) on the card; each row's
    length is drawn like the Engine's prompts (16..384)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    bh = rows * hkv
    mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
    lens = np.repeat(ragged_lens(np.random.default_rng(seed), rows, 16, 384),
                     hkv)
    return (mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, d),
            torch.tensor(lens, device=DEVICE))


def check_flow_fused() -> dict:
    """Phase 3: K1 against its plain version; returns the main-path
    (bf16) output's max |error|."""
    from repro_torch.attention.fused import fused_causal_forward
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_fused import (flow_fused_call,
                                                flow_fused_forward,
                                                flow_fused_ref)

    errs = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, lens = k1_inputs(dtype)
            out, sums = flow_fused_call(q, k, v, lens, chunk=128)
            ref_out, ref_sums = flow_fused_ref(q, k, v, lens, chunk=128)
            torch.cuda.synchronize()
            tag = f"flow_fused {str(dtype)[6:]} BH=128 N=512"
            errs[dtype] = max_err(f"{tag} out", out, ref_out, TOL[dtype])
            worst = max(max_err(f"{tag} {name}", a, b, STATE_TOL)
                        for name, a, b in zip(STATE_FIELDS, sums, ref_sums))
            print(f"[K1] {tag}: out {errs[dtype]:.3e}, state {worst:.3e}",
                  flush=True)
        # G = 2, N = 200 padded to chunk 64, through the (B, Hq, N, D) wrapper
        b, hkv, g, n, d = 4, 8, 2, 200, 64
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
        q = torch.randn((b, hkv * g, n, d), generator=gen, device=DEVICE)
        k = torch.randn((b, hkv, n, d), generator=gen, device=DEVICE)
        v = torch.randn((b, hkv, n, d), generator=gen, device=DEVICE)
        lengths = torch.tensor([200, 1, 77, 129], dtype=torch.int32,
                               device=DEVICE)
        cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=64)
        out, st = flow_fused_forward(q, k, v, cfg, return_state=True,
                                     lengths=lengths)
        ref_out, ref_st = fused_causal_forward(q, k, v, cfg, return_state=True,
                                               lengths=lengths)
        torch.cuda.synchronize()
        tag = "flow_fused fp32 G=2 N=200 chunk=64"
        e = max_err(f"{tag} out", out, ref_out, TOL[torch.float32])
        if not torch.equal(st.t, ref_st.t):
            raise AssertionError(f"{tag}: t {st.t} != {ref_st.t}")
        worst = max(max_err(f"{tag} {name}", getattr(st, name),
                            getattr(ref_st, name), STATE_TOL)
                    for name in STATE_FIELDS)
        print(f"[K1] {tag}: out {e:.3e}, state {worst:.3e}", flush=True)
    return {"max_abs_err": errs[torch.bfloat16]}


def decode_pool(slots, hkv, d, seed):
    """A non-zero FlowState pool: counts 16..384, sums of that magnitude."""
    from repro_torch.attention.recurrent import FlowState

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t = torch.tensor(ragged_lens(np.random.default_rng(seed), slots, 16, 384),
                     device=DEVICE)
    tf = t.float()[:, None, None]
    u = lambda *s: torch.rand(s, generator=gen, device=DEVICE)  # noqa: E731
    return FlowState(
        t=t, q_sum=u(slots, hkv, d) * tf, k_sum=u(slots, hkv, d) * tf,
        ko_sum=u(slots, hkv, d) * tf, qi_sum=u(slots, hkv, d) * tf,
        z=u(slots, hkv) * tf[:, :, 0] + 1.0,
        s=torch.randn((slots, hkv, d, d), generator=gen, device=DEVICE))


def decode_token(gen, slots, hkv, g, d, dtype):
    mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
    return mk(slots, hkv * g, 1, d), mk(slots, hkv, 1, d), mk(slots, hkv, 1, d)


def check_flow_decode() -> dict:
    """Phase 4: K3 against its plain version over 32 steps, on the serving
    run's 16-slot pool and on 64 slots; returns the bf16 output's max
    |error|."""
    from repro_torch.attention.recurrent import FlowState, decode_step
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import flow_decode_step

    hkv, g, d, steps = 8, 1, 64, 32
    cfg = FlowConfig(causal=True, strict_causal=True)
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    with torch.inference_mode():
        for slots, dtype in ((16, torch.bfloat16), (16, torch.float32),
                             (64, torch.bfloat16), (64, torch.float32)):
            pool = decode_pool(slots, hkv, d, SEED + 2)
            plain = FlowState(*(x.clone() for x in pool))
            ptrs = [x.data_ptr() for x in pool]
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
            tag = f"flow_decode {str(dtype)[6:]} {slots} slots"
            err = 0.0
            for step in range(steps):
                q, k, v = decode_token(gen, slots, hkv, g, d, dtype)
                same, out = flow_decode_step(pool, q, k, v, cfg)
                plain, ref = decode_step(plain, q, k, v, cfg)
                torch.cuda.synchronize()
                if any(a is not b for a, b in zip(same, pool)):
                    raise AssertionError(f"{tag}: decode_step returned new "
                                         "tensors, not the pool")
                err = max(err, max_err(f"{tag} out step {step}", out, ref,
                                       TOL[dtype]))
            if [x.data_ptr() for x in pool] != ptrs:
                raise AssertionError(f"{tag}: the pool moved")
            if not torch.equal(pool.t, plain.t):
                raise AssertionError(f"{tag}: t differs")
            worst = max(max_err(f"{tag} {name} after {steps} steps",
                                getattr(pool, name), getattr(plain, name),
                                STATE_TOL) for name in STATE_FIELDS)
            errs[dtype] = max(errs[dtype], err)
            print(f"[K3] {tag} x {steps} steps: out {err:.3e}, state "
                  f"{worst:.3e}, pool updated in place", flush=True)
    return {"max_abs_err": errs[torch.bfloat16]}


def requests(rng, n, vocab, lens, budgets):
    from repro_torch.serving.engine import Request

    return [Request(uid=i, prompt=rng.integers(
        0, vocab, int(rng.integers(lens[0], lens[1] + 1))).astype(np.int32),
        max_new_tokens=int(rng.integers(budgets[0], budgets[1] + 1)))
        for i in range(n)]


def serve_full_width(params, cfg) -> dict:
    """Phase 5: the bf16 Engine at full width; launch counts and rates."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.engine import Engine

    engine = Engine(params, cfg, slots=16, max_len=512, seed=SEED,
                    device=DEVICE)
    reqs = requests(np.random.default_rng(SEED + 4), 48, cfg.vocab_size,
                    (16, 384), (32, 64))
    for r in reqs:
        engine.submit(r)
    worker, spent = engine.worker, {"prefill": 0.0, "step": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            res = fn(*a, **kw)  # ends in a device-to-host copy: synchronized
            spent[key] += time.perf_counter() - t0
            return res
        return run

    worker.prefill = timed(worker.prefill, "prefill")
    worker.step = timed(worker.step, "step")
    torch.cuda.synchronize()
    reset_launches()
    done = engine.run()
    launches = dict(LAUNCHES)
    n_layers = cfg.n_layers
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests retired")
    for r in done:
        if not r.done or len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(r.generated)} of "
                                 f"{r.max_new_tokens} tokens")
        if not all(0 <= tok < cfg.vocab_size for tok in r.generated):
            raise AssertionError(f"request {r.uid}: token out of range")
    rounds, steps = worker.admission_rounds, worker.decode_steps
    if launches["flow_fused"] != n_layers * rounds:
        raise AssertionError(f"flow_fused launched {launches['flow_fused']}"
                             f" times, want {n_layers} x {rounds} rounds")
    if launches["flow_decode"] != n_layers * steps:
        raise AssertionError(f"flow_decode launched {launches['flow_decode']}"
                             f" times, want {n_layers} x {steps} steps")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    stats = {
        "requests": len(reqs), "admission_rounds": rounds,
        "decode_steps": steps, "prompt_tokens": prompt_tokens,
        "decode_tokens": decode_tokens,
        "prefill_s": spent["prefill"], "decode_s": spent["step"],
        "prefill_tok_per_s": prompt_tokens / spent["prefill"],
        "decode_tok_per_s": decode_tokens / spent["step"],
        "launches": launches,
    }
    print("[engine bf16] " + json.dumps(stats), flush=True)
    return stats


def profile_decode(params, cfg, step_ms: float) -> dict:
    """Phase 5b: where a decode step's time goes, from ``torch.profiler``
    over a window of full-pool decode steps: device time by kernel, the
    kernels launched, and host time by operator.  Every step decodes all
    16 slots, live or not, so its device work is that of phase 5, whose
    unprofiled mean step time gives the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Engine

    engine = Engine(params, cfg, slots=16, max_len=512, seed=SEED,
                    device=DEVICE)
    for r in requests(np.random.default_rng(SEED + 8), 16, cfg.vocab_size,
                      (128, 128), (12, 12)):
        engine.submit(r)
    engine.step()  # the admission round stays outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps = 0
        while engine.step():
            steps += 1
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in dev) / 1e3 / steps
    top_dev = sorted(dev, key=dev_us, reverse=True)[:6]
    top_host = sorted(host, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
    stats = {
        "steps": steps, "device_ms_per_step": busy,
        "kernels_per_step": sum(e.count for e in dev) / steps,
        "step_ms_unprofiled": step_ms, "device_busy_share": busy / step_ms,
        "device_ms_per_step_by_kernel": {
            e.key[:80]: dev_us(e) / 1e3 / steps for e in top_dev},
        "host_ms_per_step_by_op_profiled": {
            e.key[:80]: e.self_cpu_time_total / 1e3 / steps
            for e in top_host}}
    print("[profile decode] " + json.dumps(stats), flush=True)
    return stats


def serve_fp32_both_paths(params, cfg):
    """Phase 6: fp32 greedy tokens, kernels vs the plain PyTorch path."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    runs, cfgs = {}, {}
    for backend in ("auto", "plain"):
        cfgs[backend] = c = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, backend=backend))
        engine = Engine(params, c, slots=8, max_len=256, seed=SEED,
                        dtype=torch.float32, device=DEVICE)
        for r in requests(np.random.default_rng(SEED + 5), 12,
                          cfg.vocab_size, (16, 128), (16, 16)):
            engine.submit(r)
        reset_launches()
        runs[backend] = {r.uid: r for r in engine.run()}
        counts = sorted(LAUNCHES.values())
        if (backend == "auto" and counts[0] == 0) or (
                backend == "plain" and counts[-1] > 0):
            raise AssertionError(f"backend={backend}: launches {LAUNCHES}")
    for uid, r in runs["plain"].items():
        got = runs["auto"][uid].generated
        if got == r.generated:
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, r.generated)) if a != b)
        prefix = np.concatenate([r.prompt, np.asarray(r.generated[:j],
                                                      np.int32)])
        with torch.inference_mode():
            logits, _ = lm.forward(lm.for_serving(params, DEVICE,
                                                  torch.float32),
                                   torch.tensor(prefix[None], device=DEVICE),
                                   cfgs["plain"], dtype=torch.float32)
        top = torch.topk(logits[0, -1], 2).values
        print(f"[fp32] request {uid} diverges at generated token {j}: "
              f"kernels {got[j]}, plain {r.generated[j]}, plain top-2 margin "
              f"{float(top[0] - top[1]):.3e}", flush=True)
        raise AssertionError(f"fp32 greedy tokens differ for request {uid}")
    n_tok = sum(len(r.generated) for r in runs["plain"].values())
    print(f"[fp32] kernels and plain path agree on all {n_tok} greedy "
          f"tokens of {len(runs['plain'])} requests", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device ms of one run of ``fn``, by CUDA events around each run.

    The L2 cache is flushed before each run (the serving loop reaches each
    kernel's operands after ~50 MB of weights).  Each run is enqueued
    behind a device-side sleep longer than the host takes to enqueue it,
    so its launches run back to back and the wrappers' host time does not
    show in the device time.  One run at a time: a plain version's hundreds
    of launches stay inside the driver's launch queue.  A run whose enqueue
    outlasted its sleep is repeated with a sleep twice as long.
    """
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    t0 = time.perf_counter()
    for _ in range(warmup):
        flush.zero_()
        fn()
    torch.cuda.synchronize()
    # a bound on the host time of one run, in cycles of a clock of <= 2 GHz
    cycles = int(2 * (time.perf_counter() - t0) / warmup * 2e9)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    times = []
    while len(times) < reps:
        asleep, awake, start, stop = ev(), ev(), ev(), ev()
        flush.zero_()
        asleep.record()
        torch.cuda._sleep(cycles)
        awake.record()
        t0 = time.perf_counter()
        start.record()
        fn()
        stop.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if enqueue_ms < asleep.elapsed_time(awake):
            times.append(start.elapsed_time(stop))
        elif cycles > 60 * 2e9:
            raise RuntimeError(f"enqueueing one run took {enqueue_ms:.1f} ms")
        else:
            cycles *= 2
    return statistics.median(times)


def flow_ops_per_position(g: int, d: int, dv: int) -> int:
    """fp32 operations of one position of one (row, kv head) in the O(d^2)
    recurrent form: 2(G+1) D Dv for q_in @ S and S += k (v e)^T, and
    7 (G+1) D for the four flow sums and four flow dot products."""
    return 2 * (g + 1) * d * dv + 7 * (g + 1) * d


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_kernels(launches: dict, errs: dict) -> list:
    """Phase 7: time each kernel and its plain version at the serving
    path's shapes (bf16 activations, 16 slots x 8 kv heads, D = 64)."""
    from repro_torch.attention.recurrent import decode_step
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import flow_decode_call
    from repro_torch.kernels.flow_fused import flow_fused_call, flow_fused_ref

    rows = []
    with torch.inference_mode():
        # K1: one packed admission of 16 prompts padded to N = 512
        q, k, v, lens = k1_inputs(torch.bfloat16)
        bh, g, n, d = q.shape
        valid = int(lens.sum())
        st_bytes = bh * (4 * d + 1 + d * d) * 4
        b_k1 = (valid * (g * d + 2 * d) * 2 + bh * g * n * d * 2 + st_bytes
                + bh * 4)
        bound_ms, by = bound(b_k1, valid * flow_ops_per_position(g, d, d))
        rows.append({
            "name": "flow_fused", "route": "cuda",
            "source": "src/repro_torch/csrc/flow_fused.cu",
            "replaces": "src/repro/kernels/flow_fused/flow_fused.py:207",
            "launches": launches["flow_fused"],
            "max_abs_err": errs["flow_fused"],
            "ms": time_ms(lambda: flow_fused_call(q, k, v, lens, chunk=128)),
            "plain_ms": time_ms(lambda: flow_fused_ref(q, k, v, lens,
                                                       chunk=128)),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
        # K3: one decode step of the 16-slot pool, one layer
        slots, hkv = 16, 8
        pool = decode_pool(slots, hkv, d, SEED + 6)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        tq, tk, tv = decode_token(gen, slots, hkv, 1, d, torch.bfloat16)
        bh = slots * hkv
        flat = [x.view((bh,) + x.shape[2:]) for x in
                (pool.k_sum, pool.q_sum, pool.ko_sum, pool.qi_sum, pool.z,
                 pool.s)]
        args = (pool.t, tq.reshape(bh, 1, d), tk.reshape(bh, d),
                tv.reshape(bh, d), *flat)
        cfg = FlowConfig(causal=True, strict_causal=True)
        b_k3 = 2 * bh * (4 * d + 1 + d * d) * 4 + bh * 4 * d * 2 + slots * 4
        bound_ms, by = bound(b_k3, bh * flow_ops_per_position(1, d, d))
        rows.append({
            "name": "flow_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flow_decode.cu",
            "replaces": "src/repro/kernels/flow_decode/flow_decode.py:137",
            "launches": launches["flow_decode"],
            "max_abs_err": errs["flow_decode"],
            "ms": time_ms(lambda: flow_decode_call(*args, hkv=hkv)),
            "plain_ms": time_ms(lambda: decode_step(pool, tq, tk, tv, cfg)),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
    return rows


def main() -> int:
    setup()
    smi = card()
    build_kernels()
    errs = {"flow_fused": check_flow_fused()["max_abs_err"],
            "flow_decode": check_flow_decode()["max_abs_err"]}

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    stats = serve_full_width(params, cfg)
    profile_decode(params, cfg, 1e3 * stats["decode_s"] / stats["decode_steps"])
    serve_fp32_both_paths(params, cfg)
    rows = time_kernels(stats["launches"], errs)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
