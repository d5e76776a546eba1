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
  3b. K2 ``flow_fused_bwd`` against its plain version (autograd through
     K1's) at the training shape (16 rows x 8 kv heads, G = 1, N = 512,
     D = 64, chunk 128, bf16 and fp32) and at G = 2, N = 200 padded to 256
     (chunk 64) with random cotangents on all six state outputs, for each
     phi;
  3c. K6 ``flow_nc_fused``, K7a ``flow_nc_qside`` and K7b
     ``flow_nc_qside_bwd`` against their plain versions at the LRA training
     shape (32 rows x 4 heads, N = M = 4096, D = 64, bf16 and fp32; K6 with
     competition on and off, K7b with random cotangents), and at G = 2,
     N = 200, M = 136 (through the grouping wrapper, with gradients); K6
     also at G = 2 (NQ = 400, M = 136), at counts its 16-block clusters do
     not divide (NQ = 4,001, M = 3,999), at NQ = M = 1 (blocks that own no
     rows) and at logits of +-30 (sigmoid saturated), bf16 and fp32, and
     two calls at the LRA shape bitwise equal; K7a and K7b also at D = 32
     and 128 (16 rows, N = 1,000, M = 700), and K7b at every shape also
     against its own decomposition (``flow_nc_qside_bwd_parallel`` at the
     card's rows per block, its fp32 outputs also within
     ``K7B_TWIN_RTOL``) with two calls bitwise equal; K6, K7a and K7b
     also on their small-head route, bf16 and fp32, 4 images x 16
     heads at the vision encoder's stages (D = 6, 12, 24, 48 over N = M =
     3,136, 784, 196, 49; the reference bench's D = 8 and 16 over 3,136
     and 784) and at D = 24 with NQ = 400, M = 136: each against its plain
     version and its twin (K6's cluster split, K7b's blocks), two calls of
     each bitwise equal;
  3d. K5a ``flow_chunk`` and K5b ``flow_chunk_dkv`` against their plain
     versions at the paper-causal training shape (16 rows x 8 kv heads,
     G = 1, N = 512, D = 64, fp32; operands as the causal pipeline makes
     them), K5a also on the swapped operands of the backward's dq, and at
     G = 2, N = 200 padded to the chunk, D = 32 and 128, through the glue
     and autograd (``FlowChunkDot``) against autograd of the plain cumsum
     dot; K5a and K5b also against their own decompositions
     (``flow_chunk_parallel``, ``flow_chunk_dkv_parallel``) at the training
     shape, with two calls of each there bitwise equal, and K5b at G = 2,
     N = 200, D = 32 and 128 too;
  3e. K10a ``ssd_chunk`` (with and without carry-ins) and K10b
     ``ssd_chunk_bwd`` against their plain versions at the mamba2_1p3b
     training shape (B = 4 x H = 64 rows, N = 4,096, P = 64, S = 128,
     chunk 128, fp32; B and C shared by the heads: K10a reads them through
     a stride-0 (B, H, N, S) view, ``SSDChunkDot`` takes the (B, N, S)
     rows) and at ``ssd_scan``'s chunk rule's N = 96 (chunk 96) and
     N = 200 (chunk 8), and at strong decay (dta = -50, N = 512): K10a's y
     and carry-ins against the plain chunked scan, K10b through
     ``SSDChunkDot`` against autograd through it (db and dc summed over
     the heads), random cotangents; K9
     ``boundary_gather`` at the admission shape (16 rows, Lb 512, W 4,096
     and 128, bf16 and fp32, lengths including 0, 1, 2, 3 and 512), and
     ``boundary_gather_many`` on one layer's three streams (W 4,096, 128
     and 128) and on unaligned widths (W 3, 5 and 6: the 2- and 4-byte
     paths), exact;
  3f. K8a ``paged_gather`` and K8b ``paged_gather_quant`` against their
     plain versions at the serving shape (the dense-equivalent pool of
     128 pages x 8 kv heads x 64 positions, D = Dv = 64; 16 slots x 8
     pages) and at Hkv 2, page 8, D 16, Dv 32, with pools and outputs in
     bf16 and fp32 (K8b: int8 payloads, fp32 scales); tables shuffled,
     partly mapped, with a row of sentinels (a dead slot); also at page 5,
     D 24, Dv 40 (runs the copy engine does not take: scales of 20 bytes,
     widths not a multiple of 16); two K8b calls bitwise equal;
  4. K3 ``flow_decode`` against its plain version: 16 (the serving pool)
     and 64 slots x 8 kv heads, 32 steps from a non-zero state, updated
     in place; at every step also against ``flow_decode_split`` (the
     kernel's own order) from a copy of the kernel's pre-step pool; and
     two K3 steps from clones of one pool (16 slots, bf16) bitwise equal
     in out and in every state tensor;
  4b. K4 ``flow_decode_q`` against its plain version on an int8 pool (phase
     4's pool, quantized): 16 and 64 slots x 8 kv heads, D = 64, bf16 and
     fp32 tokens, 32 steps; at every step the plain version starts from a
     copy of the kernel's pre-step pool (teacher-forced), and the pool is
     updated in place; the largest payload gap (in LSB) of a free-running
     plain pool after 32 steps is printed, not gated; and two K4 steps
     from clones of one pool (16 slots, bf16) bitwise equal in out,
     payloads, scales and z;
  5. the Engine serving the full-width flowformer_lm (random weights from a
     seed) in bf16: 48 requests through 16 slots; every K1/K3 launch is
     counted and must equal 6 x admission rounds / 6 x decode steps;
     then ``torch.profiler`` reads the device time of a decode step by
     kernel, and its share of the step's wall time;
  5c. phase 5 with ``state_dtype="int8"``: the same 48 requests, bf16, 16
     slots, every pool an int8 ``QuantizedPool``; K1 = 6 x admission
     rounds, K4 = 6 x decode steps, K3 never; decode and prefill tokens/s
     and the fp32 and int8 pools' bytes; then ``torch.profiler`` over
     decode steps as in 5b;
  6. the same Engine in fp32, once on the kernels and once on the plain
     PyTorch path: the greedy tokens must be identical;
  6b. the int8 Engine in fp32 at full width, 12 requests as in phase 6, on
     the kernels; before every decode step the plain path
     (``backend="plain"``) takes the same step from a copy of the same
     pool with the same tokens and positions: the logits, every layer's
     new pool, and each greedy token where the plain step's top-2 margin
     exceeds twice the logits' tolerance must agree.  Free-running
     kernel-vs-plain token agreement is printed, not gated: one-LSB
     payload flips compound over steps and can part near-ties;
  17. the Engine serving the softmax baseline of the full-width
     flowformer_lm (``attention.kind="softmax"``, made as the reference's
     ``--attn softmax`` makes it, phase 5's weights) in bf16 from a paged
     pool of 64 pages of 64 (half the dense-equivalent 128, so admission
     waits), phase 5's traffic: exactly 6 K8a launches per decode step
     and nothing else; decode and prefill tokens/s, the admission passes
     the pool held back, ``pool_bytes`` beside the dense pools', and every
     page free after the drain; then ``torch.profiler`` over decode steps
     as in 5b, with the gather kernel's device ms per step;
  17b. phase 17 from int8 pools: exactly 6 K8b per decode step, no K8a;
  18. the paged Engine in fp32 at full width, phase 6's 12 requests: on
     the kernels and on the plain path (the layer's gathers bound with
     ``interpret=True``), from fp32 and from int8 pools of 24 pages, the
     greedy tokens must be identical; then paged (the dense-equivalent
     pool, so both runs take the same steps) against the dense Engine,
     step by step: logits within rtol 1e-4 and atol 1e-4 x max |logit|,
     and equal greedy tokens wherever the dense run's top-2 margin clears
     twice that;
  19. speculative serving: phase 5's Engine (its weights and 48 requests,
     bf16, 16 slots) with ``draft="self"`` and ``speculate_k=4``; each
     window is one propose (4 greedy decode steps from a copy of the flow
     pools) and one fused verify (``lm.verify``, plain PyTorch on the
     card, then the accepted prefix, the bonus token and the rollback):
     every window commits at least one token a live slot, and exactly
     6 K1 launches per admission round and 6 x 4 K3 per window run, and
     nothing else; windows, committed tokens a window, propose and verify
     ms a window, decode tokens/s;
  19b. phase 19 from int8 pools: K4 in every propose step (6 x 4 a
     window), no K3; verify dequantizes the pool once and the rollback
     quantizes the gathered boundary once (``QuantTraj``);
  19c. phase 19 with ``draft="tiny"`` (``ModelDraft``, a smoke-sized
     flowformer_lm drafter with its own pool): K1 on both pools' admission
     rounds, K3 on the drafter's 5 steps a window only;
  20. fp32 greedy equality on the card, phase 6's 12 requests through the
     speculative Engine against the plain Engine, token for token: flow
     with the self draft (k = 4) and with the tiny draft (k = 2), int8 flow
     with the self draft against the plain fp32 Engine, the paged softmax
     Engine (K8a in propose and in verify's sequential decode; the
     dense-equivalent pool) and the full-width mamba2_1p3b (K9 at
     admission; its verify stacks 5 whole SSD states a slot, ~4 GB at 8
     slots) with its conv histories bound to fp32, as phase 14 (with the
     configuration's bf16 histories the runs are compared and printed,
     not gated); the speculative runs' launches are printed.  The int8
     case is held teacher-forced (``speculative_int8_against_fp32``):
     int8 pools round where fp32 ones do not;
  7. training at full width (``launch/train.py::train``, bf16, 5 steps
     of 16 x 512 tokens from ``lm_loader(seed=0)``, random weights from a
     seed): finite losses, and exactly 2 x 6 K1 (forward and remat
     recompute) and 6 K2 launches per step and nothing else; then
     ``torch.profiler`` over two steps: device time by kernel and busy
     share;
  7c. training the paper-faithful causal variant (``attention.
     strict_causal=False``, made with ``dataclasses.replace`` as
     ``benchmarks/common.py::with_kind`` does) at full width, as phase 7:
     finite losses, and exactly 3 x 6 K5a (forward, remat recompute and
     the backward's dq) and 6 K5b launches per step and nothing else; then
     ``torch.profiler`` over two steps;
  8. the same trainer in fp32 at full width and 2 layers, once on the
     kernels and once on the plain PyTorch path, 3 steps: the losses
     agree, and every wq/wk/wv gradient of the first step is non-zero
     and agrees with the plain path's;
  8b. phase 8 for the paper-causal variant (the plain path: the
     ``chunked`` scan), and for 1 step without competition
     (``use_competition=False``);
  10. the LRA classifier at full width (``launch/classify.py::
     train_eval_classifier``, flowformer_lra, bf16, 5 steps of 32 x 4096
     ListOps tokens, random weights from a seed), then its evaluation over
     64 held-out examples: finite losses, and exactly 4 K6 and 4 K7b
     launches per step (the backward runs no K7a) and 4 K6 per eval batch
     and nothing else; then
     ``torch.profiler`` over two steps: device time by kernel and busy
     share;
  11. the same classifier in fp32 at full width and 2 layers, once on the
     kernels and once on the plain PyTorch path, 3 steps: the losses
     agree, and every wq/wk/wv gradient of the first step is non-zero and
     agrees with the plain path's;
  21. the vision encoder at full width and depth (``flowformer_vision``:
     19 layers in stages of 3, 3, 10 and 3, channels 96-768, 16 heads of
     6, 12, 24 and 48, 1,000 classes; ``launch/classify.py``'s vision
     task) in bf16, 5 steps of 64 images of 224 x 224 x 3 (3,136 tokens
     in stage 1; 64 is one card's cut of the paper's ImageNet batch),
     random weights from a seed, then 64 held-out images: finite losses,
     exactly 19 K6 and 19 K7b launches a step and 19 K6 an evaluation
     batch, and nothing else; step ms, images/s, the phase's peak memory;
     then ``torch.profiler`` over two steps: device time by kernel and
     busy share;
  21b. the same model in fp32 at full width with one block a stage, 3
     steps of 16 images of 224 x 224, on the kernels and on the plain path
     (``backend="plain"``): losses and the first step's wq/wk/wv gradients
     agree within phase 11's bounds, and those gradients are non-zero;
  22. the time-series encoder at full width (``flowformer_timeseries``: 2
     layers, d 512, 8 heads of 64) in bf16, 5 steps of 32 series of 512
     steps x 8 dims (the reference's full Table 6 run), then 64 held-out
     series: finite losses, exactly 2 K6 and 2 K7b a step; step ms and
     tokens/s; then the reference harness's override (96 wide, 4 heads of
     24), 3 steps, the same counts on the small-head route;
  13. the Engine serving the full-width mamba2_1p3b (48 layers of SSD,
     random weights from a seed) in bf16, phase 5's traffic: exactly 1 K9
     launch per layer and admission round (``boundary_gather_many`` of the
     x, B and C streams) and nothing else; decode and
     prefill tokens/s; ``pool_bytes`` = 16 x 101,916,672; then
     ``torch.profiler`` over decode steps as in 5b;
  14. the same Engine in fp32, 12 requests of mixed lengths, against a
     per-request greedy oracle on the card (unpacked ``lm.prefill``, whose
     conv history is ``_causal_conv``'s tail, then ``lm.decode``),
     teacher-forced, twice: with fp32 conv histories in both paths
     (``layers.ssd.CONV_DTYPE`` bound) the greedy tokens must be identical
     and every logit within rtol 1e-4, atol 1e-4 x max |logit| of the
     oracle's; with the configuration's bf16 histories the logits of the
     t-th token within rtol and atol (1e-4 + 1.5e-3 t) x max |logit|, and
     the tokens where the oracle's margin clears that (see
     ``serve_ssd_fp32_against_oracle``);
  15. training the full-width mamba2_1p3b (bf16, 5 steps of 4 x 4,096:
     the sequence length of the reference's ``train_4k`` shape, its
     global batch of 256 cut to 4 for one card): finite losses, exactly
     2 x 48 K10a with carry-ins (the forward and its remat recompute:
     ``torch.utils.checkpoint`` reruns each block's forward in the
     backward) and 48 K10b per step and nothing else; one no-grad
     evaluation forward: exactly 48 K10a without carry-ins; the peak
     memory of this phase (training and evaluation); then
     ``torch.profiler`` over two steps;
  16. the same trainer in fp32 at full width and 2 layers, 3 steps of 4 x
     4,096, on the kernels and on the plain path (``ssd_scan`` bound with
     ``interpret=True`` in ``layers.ssd``, restored after): the losses
     agree, and every in_x/in_b/in_c/in_dt/a_log/dt_bias gradient of the
     first step is non-zero and agrees with the plain path's;
  9. (after 16) per kernel, its time with CUDA events beside its plain
     version's and its bound, as one ``{"kernels": [...]}`` line
     (``launches`` is the count over the main-path runs of phases 5 and 7
     for K1-K3, of phase 5c for K4 (K1's count includes 5c's), of phase
     10, 21 and 22 for K6, K7a (none), K7b, of phase 7c for K5a, K5b, of phases 17 and 17b
     for K8a and K8b, of phase 13 for K9 and of phase 15 for K10a and
     K10b, each plus the speculative runs of phases 19, 19b, 19c and 20:
     K1, K3, K4, K8a and K9), K1's time and bound at the training shape (in its row),
     the device time of each CUDA kernel of one K1 call (serving and
     training shape) and one K2 call (``k12_breakdown``: the ``flow_fwd_``
     and ``flow_bwd_`` kernels) with their registers and spill bytes from
     the build, K3 and K4 at 16 and 1,024 slots x 8 kv heads (their
     registers, spills and CTAs per SM beside, and K3's launch floor),
     K5a's and K5b's CUDA kernels at the training shape
     (``chunk_breakdown``: the ``chunk_fwd_`` and ``chunk_bwd_`` kernels;
     K5b's in its row, ``k5b_breakdown``), K8a and K8b at one layer's gather of phase
     17's step with every slot's 8 pages mapped (their library yardstick
     ``torch.index_select`` of the pools by the flattened table, without
     the relayout; K8b's launch floor beside), K9 at one admission's
     x stream (16 x 512 x 4,096 bf16; its library yardstick the padded
     ``torch.take_along_dim``) and at one layer's three streams in one
     launch, against three one-stream launches, three padded
     ``take_along_dim``s and an empty kernel of the same build (the card's
     launch floor), K6's phases by ablation (``k6_breakdown``: variant
     builds that stop before phases B, C and D) and at 8-block clusters,
     K6's and K7b's bounds where their products run in 3xTF32
     (``tensor_core_bound_ms``, beside the fp32 ``bound_ms``), K6, K7a and
     K7b also at the vision encoder's first and last stage (64 images x 16
     heads, bf16: D = 6 over 3,136 tokens, D = 48 over 49; keys
     ``vision_stage1``, ``vision_stage4``, each with its bound and its
     plain version's time),
     K10a and K10b at one layer of phase 15
     (their plain versions' ~500-1,000 launches overflow the launch queue,
     so those are timed as one replay of a CUDA graph, ``graph_ms``);
  12. the last line: ``{"ok": true, "device": {...}}``.

Tolerances (|kernel - plain| <= atol + rtol * |plain|, elementwise):
fp32 outputs and every fp32 state piece rtol 1e-4, atol 1e-4 -- both sides
sum the same fp32 terms in another order, no TF32 on either side but in
the products of K5a, K5b, K6 and K7b, which run in 3xTF32 (each operand
split into a tf32 head and rest, three tensor-core products; K6's, K7a's
and K7b's small-head route runs its products in fp32 FMA) and are held
to the same tolerances; one plain TF32 product fails K5a's, K5b's and
K7b's, and K7b's fp32 outputs are also held to its twin within
``K7B_TWIN_RTOL`` x max |twin| (6e-6), which catches a sum left to drift
in the tensor cores' accumulators that TOL lets through; bf16 outputs
rtol 1e-2, atol 1e-2 -- both compute in fp32 from the same bf16 inputs and
round once to bf16, whose spacing is 2^-7 relative.  K2's gradients are
held to the same two tolerances, as are K6's, K7a's and K7b's outputs
and cotangents (K7b's key-side cotangents are fp32 in both dtypes, summed
from the same rounded inputs); these are also held to rtol x max |plain|,
since at the LRA shape they are ~1e-3, below atol.  K5a and K5b, fp32:
|kernel - plain| <= atol + rtol * |plain| + rtol * max |plain| with rtol
and atol 1e-4 -- the causal dot sums N D terms as large as its largest
outputs, so an output that cancels (the dq of a unit cotangent) keeps an
error of the terms' size, whatever the order.  fp32 training, kernels vs
plain (the LM, both causal variants, and the classifier): losses rtol
1e-4, and each attention weight's
gradient within 1e-4 of that leaf's max |grad| -- the same fp32 sums in
another order, carried through the residual stream and three Adam steps.
K4 (and phase 6b's pools): outputs as K3's, z rtol 1e-5 and atol 1e-5, t
exact, scales rtol 1e-5, payloads within one LSB with at most a share of
1e-3 of the entries differing -- the amax is exact but the values are
summed in another order, so a value within ~1e-5 of a half-integer may
round the other way (a few in 1e5), while rounding by truncation differs
in about half of the entries and a stale scale in far more.  Phase 6b's
logits: rtol 1e-4 and atol 1e-4 x max |logit| -- within one step ``out``
uses the fp32 S before requantization, so only fp32 order differs.  K10a
and K10b, fp32: |kernel - plain| <= atol + rtol |plain| + rtol max |plain|
with rtol and atol 1e-4 -- a chunk sums C S products (and K10b's dcum
C^2 of them) as large as the outputs, in another order.  K9: exact (a
gather).  Phase 16: losses rtol 1e-4 and each listed gradient within
1e-4 of that leaf's max |grad|, as phase 8.  K8a and K8b: exact (a
copy, and one fp32 product rounded once); phase 18's kernel and plain
paths: identical tokens (the gathers are exact); paged against dense:
logits as phase 6b's (the same products over the same gathered length,
max_len 256 = 4 pages).  Phase 14 with bf16 conv
histories: the t-th token's logits within (1e-4 + 1.5e-3 t) x max |logit|
-- a history element rounded to the neighbouring bf16 value (the two
paths sum it at other GEMM shapes) moves the state, and the gap grew by
~4.5e-4 of max |logit| per token on an H100.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import math
import re
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
# cores (every kernel's arithmetic but K6's products), TF32 FLOP/s on them.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12  # tensor cores, dense

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# K7b's fp32 outputs against its twin, which sums in the same order:
# |kernel - twin| <= this x max |twin|.  Sound builds read at most 3.8e-6;
# one whose per-block sums ran on in the tensor cores' accumulators read
# 1.1e-5 to 1.3e-5, and passed TOL (PERF.md, PR 23)
K7B_TWIN_RTOL = 6e-6
STATE_TOL = (1e-4, 1e-4)
STATE_FIELDS = ("q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s")
STATE_FLAT = ("k_sum", "q_sum", "ko_sum", "qi_sum", "z", "s")  # flow_decode's


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


#: registers and spills of the redesigned kernels' variants, per source,
#: from the build (printed again beside phase 9's breakdowns)
PTXAS: dict[str, dict] = {}


#: K6's ablation variant (``k6_ablation_source``), started with the build
K6_ABLATION: dict = {}
#: the run-time ``use_comp`` values at which that variant stops before
#: phases B, C and D
K6_STOPS = {"B": -2, "C": -3, "D": -4}


def build_kernels() -> float:
    """Phase 2: compile every kernel (one nvcc per source, all at once),
    with K6's ablation variant alongside."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    K6_ABLATION.update(start_k6_ablation_build())
    logs = build()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"[build] {name}: {len(usage)} kernel variants; "
              + (usage[0] if usage else "cached"), flush=True)
        if name.startswith(("ssd_chunk", "flow_fused", "flow_nc",
                            "flow_chunk", "flow_decode", "paged_gather")):
            PTXAS[name] = ptxas_usage(log)
            print(f"[build] {name}: " + json.dumps(PTXAS[name]), flush=True)
    print(f"[build] {secs:.1f} s", flush=True)
    for name in ("flow_decode", "flow_decode_q"):
        print(f"[build] {name} CTAs per SM (registers and shared memory): "
              + json.dumps(decode_occupancy(name)), flush=True)
    return secs


def decode_occupancy(name: str) -> dict:
    """CTAs of K3 (``name`` flow_decode) or K4 (flow_decode_q) an SM holds
    at once, per (dtype, D) at G = 1, from the library's
    ``<name>_occupancy`` (the CUDA occupancy calculator on the built
    kernel)."""
    from repro_torch.kernels import _lib

    fn = _lib.function(name, f"{name}_occupancy", [ctypes.c_int] * 3)
    return {f"{dt}<{d}>": fn(d, code, 1) for dt, code in (("f32", 0),
                                                          ("bf16", 1))
            for d in (32, 64, 128)}


def ptxas_usage(log: str) -> dict:
    """Registers, spill bytes and static shared memory per kernel variant
    from nvcc's ``-Xptxas -v`` report, keyed by name<template args> (bf16
    for an ``__nv_bfloat16`` argument, f32 for ``float``)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            sym = m.group(1)
            k = re.search(r"\d+((?:ssd|flow)_(?:fwd|bwd)_[a-z0-9]+|"
                          r"chunk_(?:fwd|bwd)_[a-z]+|flow_decode(?:_q)?_kernel|"
                          r"flow_nc_(?:fused|qside|qside_bwd)_kernel(?:_small)?|"
                          r"paged_gather"
                          r"(?:_quant(?:_page)?)?_kernel)(I\w*?E(?=v))?", sym)
            targs = (k.group(2) or "") if k else ""
            args = (["bf16"] if "bfloat16" in targs
                    else ["f32"] if targs.startswith("If") else [])
            args += re.findall(r"L[ib](\d+)E", targs)
            name = (k.group(1) + (f"<{','.join(args)}>" if args else "")
                    if k else sym)
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def k6_ablation_source(src: str) -> str:
    """K6's source with an exit before each of its phases B, C and D, taken
    when the kernel's ``use_comp`` is -2, -3 or -4: a run-time value, so
    nothing before an exit is optimized away, and timing the variant at
    each value (and at 1, the whole kernel) splits a call by phase.  A
    cluster kernel first waits for its staged copies and meets the
    cluster's other blocks, so no block leaves while another reads its
    shared memory."""
    sync = ("cp_async_wait<0>(); cluster.sync(); "
            if "this_cluster()" in src else "")

    def exit_before(m):
        return (f"{m.group(1)}if (use_comp == {K6_STOPS[m.group(2)]}) "
                f"{{ {sync}return; }}\n{m.group(0)}")

    out, n = re.subn(r"^( *)// ---- phase ([BCD])\b.*$", exit_before, src,
                     flags=re.M)
    if n != 3:
        raise RuntimeError(f"K6's source has {n} of the 3 phase markers")
    return out


def start_k6_ablation_build(source=None) -> dict:
    """Start nvcc on ``k6_ablation_source`` of ``source`` (by default the
    checkout's ``csrc/flow_nc_fused.cu``) into the build directory; returns
    what ``k6_breakdown`` needs."""
    from repro_torch.kernels import _lib

    path = Path(source or _lib.CSRC_DIR / "flow_nc_fused.cu")
    text = k6_ablation_source(path.read_text())
    out_dir = _lib.BUILD_DIR / "k6_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(text.encode()).hexdigest()[:16]
    cu, so = out_dir / f"k6_{tag}.cu", out_dir / f"libk6_{tag}.so"
    cu.write_text(text)
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC_DIR), "-o",
           str(so), str(cu)]
    head = re.search(r"int flow_nc_fused_fwd\((.*?)\)", text, re.S)
    return {"proc": subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
            "so": so, "source": str(path),
            "takes_cb": bool(head and "int cb" in head.group(1))}


def k6_breakdown(q, k, v, ablation=None, cb=None) -> dict:
    """Device ms of one K6 call on (q, k, v) by phase, from the ablation
    variant (``start_k6_ablation_build``) timed by ``time_ms`` at each stop:
    the loads and phase A (stop before B), B, C (with kv's cluster
    reduction) and D as differences of the cumulative times; ``cb`` blocks
    per cluster (by default the wrapper's)."""
    from repro_torch.kernels._lib import DTYPE_CODES
    from repro_torch.kernels.flow_nc.ops import CLUSTER_BLOCKS

    build = ablation or K6_ABLATION
    if "log" not in build:
        build["log"], _ = build["proc"].communicate()
    if build["proc"].returncode:
        raise RuntimeError("K6's ablation variant did not build:\n"
                           + build["log"])
    lib = ctypes.CDLL(str(build["so"]))
    fn = lib.flow_nc_fused_fwd
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p_] * 4 + [i_] * (8 if build["takes_cb"] else 7) + [f_, p_]
    bh, nq, d = q.shape
    out = torch.empty_like(q)
    cb = (cb or CLUSTER_BLOCKS,) if build["takes_cb"] else ()

    def run(code):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                 nq, k.shape[1], d, d, DTYPE_CODES[q.dtype], *cb, code, 1e-6,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K6 ablation variant: cudaError {err}")

    cum = {f"to_{ph}": time_ms(lambda c=code: run(c))
           for ph, code in K6_STOPS.items()}
    cum["full"] = time_ms(lambda: run(1))
    return {"source": build["source"], "loads_and_A": cum["to_B"],
            "B": cum["to_C"] - cum["to_B"], "C": cum["to_D"] - cum["to_C"],
            "D": cum["full"] - cum["to_D"], "cumulative_ms": cum}


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


def max_err_scaled(name: str, got: torch.Tensor, want: torch.Tensor,
                   tol) -> float:
    """``max_err``, and also |got - want| <= rtol * max |want| everywhere:
    at the LRA shape the non-causal outputs and cotangents are ~1e-3, so
    atol alone would not see an error of their own size."""
    err = max_err(name, got, want, tol)
    scale = float(want.float().abs().max())
    if not err <= tol[0] * scale:
        raise AssertionError(f"{name}: |diff| {err:.3e} exceeds rtol {tol[0]}"
                             f" * max |want| {scale:.3e}")
    return err


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


def k2_case(dtype, bh, g, n, d, chunk, n_valid, phi, seed, state_cot):
    """Inputs of one K2 check: q, k, v, g_out on the card, K1's totals,
    and the six state cotangents (random, or zeros as in training)."""
    from repro_torch.kernels.flow_fused import flow_fused_call

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
    q, k, v, g_out = mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, d), mk(bh, g, n, d)
    lens = torch.full((bh,), n_valid, dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        _, totals = flow_fused_call(q, k, v, lens, chunk=chunk, phi=phi)
    g_sums = [torch.randn(x.shape, generator=gen, device=DEVICE) if state_cot
              else torch.zeros_like(x) for x in totals]
    return (q, k, v, lens, totals, g_out, g_sums), dict(chunk=chunk, phi=phi)


def check_flow_fused_bwd() -> dict:
    """Phase 3b: K2 against its plain version (autograd through K1's);
    returns the main-path (bf16) gradients' max |error|."""
    from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,
                                                flow_fused_bwd_ref)

    cases = [(dtype, (16 * 8, 1, 512, 64, 128, 512, "sigmoid", False))
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(torch.float32, (4 * 8, 2, 256, 64, 64, 200, phi, True))
              for phi in ("sigmoid", "elu1", "relu")]
    errs = {}
    for i, (dtype, (bh, g, n, d, chunk, n_valid, phi, cot)) in enumerate(cases):
        args, kw = k2_case(dtype, bh, g, n, d, chunk, n_valid, phi,
                           SEED + 10 + i, cot)
        with torch.no_grad():
            got = flow_fused_bwd_call(*args, **kw)
        want = flow_fused_bwd_ref(*args[:4], *args[5:], **kw)
        torch.cuda.synchronize()
        tag = (f"flow_fused_bwd {str(dtype)[6:]} BH={bh} G={g} N={n} "
               f"valid={n_valid} {phi}")
        err = max(max_err(f"{tag} {name}", a, b, TOL[dtype])
                  for name, a, b in zip(("dq", "dk", "dv"), got, want))
        for name, a in zip(("dq", "dk", "dv"), got):
            if a[..., n_valid:, :].any():
                raise AssertionError(f"{tag} {name}: non-zero past n_valid")
        errs[dtype] = max(errs.get(dtype, 0.0), err)
        print(f"[K2] {tag}: grads {err:.3e}", flush=True)
    return {"max_abs_err": errs[torch.bfloat16]}


def twin_close(name: str, got: torch.Tensor, want: torch.Tensor,
               rtol: float) -> float:
    """|got - want| / max |want|; raises where it exceeds ``rtol``."""
    scale = float(want.float().abs().max())
    rel = float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)
    if not rel <= rtol:
        raise AssertionError(f"{name}: |diff| / max |want| {rel:.3e} exceeds "
                             f"{rtol}")
    return rel


def dot_close(name: str, got: torch.Tensor, want: torch.Tensor,
              tol=TOL[torch.float32]) -> float:
    """Max |got - want|; raises where it exceeds atol + rtol * |want| +
    rtol * max |want| (the causal dot's tolerance, see the docstring)."""
    rtol, atol = tol
    scale = float(want.abs().max())
    return max_err(name, got, want, (rtol, atol + rtol * scale))


def chunk_operands(bh, g, n, d, dv, seed):
    """The causal dot's operands as ``pipeline.causal_forward`` makes them
    (sigmoid phi): q_in = phi(q) * pos / I (BH, G, N, D), phi(k) (BH, N,
    D), v (BH, N, Dv) and a unit cotangent (BH, G, N, Dv); fp32."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE)  # noqa: E731
    pq, pk = torch.sigmoid(mk(bh, g, n, d)), torch.sigmoid(mk(bh, n, d))
    pos = torch.arange(1, n + 1, device=DEVICE, dtype=torch.float32)
    inflow = torch.einsum("bgnd,bnd->bgn", pq, torch.cumsum(pk, 1))
    q = (pq * (pos / inflow)[..., None]).contiguous()
    return q, pk.contiguous(), mk(bh, n, dv), mk(bh, g, n, dv)


def check_flow_chunk() -> dict:
    """Phase 3d: K5a and K5b against their plain versions; returns each
    one's max |error| at the paper-causal training shape."""
    from repro_torch.attention._cuda import chunked_causal_dot_cuda
    from repro_torch.attention.dots import causal_dot_grouped
    from repro_torch.kernels.flow_chunk import (flow_chunk_call,
                                                flow_chunk_dkv_call,
                                                flow_chunk_dkv_parallel,
                                                flow_chunk_dkv_ref,
                                                flow_chunk_parallel,
                                                flow_chunk_ref)

    with torch.no_grad():
        q, k, v, g = chunk_operands(16 * 8, 1, 512, 64, 64, SEED + 50)
        tag = "fp32 BH=128 G=1 N=512 D=64"
        out = flow_chunk_call(q, k, v)
        e5a = dot_close(f"flow_chunk {tag} out", out, flow_chunk_ref(q, k, v))
        epar = dot_close(f"flow_chunk {tag} out vs flow_chunk_parallel", out,
                         flow_chunk_parallel(q, k, v, 64))
        if not torch.equal(flow_chunk_call(q, k, v), out):
            raise AssertionError(f"flow_chunk {tag}: two calls differ")
        edq = dot_close(f"flow_chunk {tag} dq (g, v, k)",
                        flow_chunk_call(g, v, k), flow_chunk_ref(g, v, k))
        dkv = flow_chunk_dkv_call(q, k, v, g)
        e5b = max(dot_close(f"flow_chunk_dkv {tag} {name}", a, b)
                  for name, a, b in zip(("dk", "dv"), dkv,
                                        flow_chunk_dkv_ref(q, k, v, g)))
        print(f"[K5] {tag}: bound of |K5a - plain|, |K5b dk - plain|, "
              "|K5b dv - plain|: 1e-4 + 1e-4 |plain| + 1e-4 x " + json.dumps(
                  [float(x.abs().max()) for x in (flow_chunk_ref(q, k, v),
                                                  *flow_chunk_dkv_ref(q, k, v,
                                                                      g))]),
              flush=True)
        epar_b = max(dot_close(f"flow_chunk_dkv {tag} {name} vs "
                               "flow_chunk_dkv_parallel", a, b)
                     for name, a, b in zip(("dk", "dv"), dkv,
                                           flow_chunk_dkv_parallel(q, k, v, g,
                                                                   64)))
        if not all(map(torch.equal, flow_chunk_dkv_call(q, k, v, g), dkv)):
            raise AssertionError(f"flow_chunk_dkv {tag}: two calls differ")
        torch.cuda.synchronize()
    print(f"[K5] {tag}: K5a {e5a:.3e} (vs its chunk decomposition "
          f"{epar:.3e}; two calls bitwise equal), K5a dq {edq:.3e}, K5b "
          f"{e5b:.3e} (vs its chunk decomposition {epar_b:.3e}; two calls "
          "bitwise equal)", flush=True)
    b, hkv, grp, n = 4, 8, 2, 200
    for d in (32, 128):
        q, k, v, g = chunk_operands(b * hkv, grp, n, d, d, SEED + 51 + d)
        with torch.no_grad():  # K5b on the flat operands, N = 200 unpadded
            epar_b = max(dot_close(f"flow_chunk_dkv fp32 G=2 N=200 D={d} "
                                   "vs flow_chunk_dkv_parallel", a, b_)
                         for a, b_ in zip(flow_chunk_dkv_call(q, k, v, g),
                                          flow_chunk_dkv_parallel(
                                              q, k, v, g, 64 if d < 128
                                              else 32)))
        q, g = q.reshape(b, hkv, grp, n, d), g.reshape(b, hkv, grp, n, d)
        k, v = k.reshape(b, hkv, n, d), v.reshape(b, hkv, n, d)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = chunked_causal_dot_cuda(*leaves, chunk=128)  # N padded to 256
        want = causal_dot_grouped(*plain, chunk_size=0, use_kernel=False)
        tag = f"fp32 G=2 N=200 D={d}"
        e = dot_close(f"flow_chunk {tag} out", out.detach(), want.detach())
        eg = max(dot_close(f"FlowChunkDot {tag} d{name}", a, b_)
                 for name, a, b_ in zip("qkv", torch.autograd.grad(
                     out, leaves, g), torch.autograd.grad(want, plain, g)))
        torch.cuda.synchronize()
        print(f"[K5] {tag}: out {e:.3e}, grads through FlowChunkDot "
              f"{eg:.3e}, K5b vs its chunk decomposition {epar_b:.3e}",
              flush=True)
    return {"flow_chunk": e5a, "flow_chunk_dkv": e5b}


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


def flat_pool(pool):
    """A FlowState pool's state tensors as views in flow_decode's flat
    layout (k, q, ko, qi sums, z, s)."""
    bh = pool.s.shape[0] * pool.s.shape[1]
    return [x.view((bh,) + x.shape[2:]) for x in
            (pool.k_sum, pool.q_sum, pool.ko_sum, pool.qi_sum, pool.z,
             pool.s)]


def check_flow_decode() -> dict:
    """Phase 4: K3 against its plain version over 32 steps, on the serving
    run's 16-slot pool and on 64 slots, and at each step against
    ``flow_decode_split`` from a copy of the kernel's pre-step pool; then
    two steps from clones of one pool, bitwise; returns the bf16 output's
    max |error| against the plain version."""
    from repro_torch.attention.recurrent import FlowState, decode_step
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import (flow_decode_split,
                                                 flow_decode_step)

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
            err, err_split = 0.0, 0.0
            bh = slots * hkv
            for step in range(steps):
                q, k, v = decode_token(gen, slots, hkv, g, d, dtype)
                before = [x.clone() for x in flat_pool(pool)]
                split, split_st = flow_decode_split(
                    pool.t + 1, q.reshape(bh, g, d), k.reshape(bh, d),
                    v.reshape(bh, d), *before, hkv=hkv)
                same, out = flow_decode_step(pool, q, k, v, cfg)
                plain, ref = decode_step(plain, q, k, v, cfg)
                torch.cuda.synchronize()
                if any(a is not b for a, b in zip(same, pool)):
                    raise AssertionError(f"{tag}: decode_step returned new "
                                         "tensors, not the pool")
                err = max(err, max_err(f"{tag} out step {step}", out, ref,
                                       TOL[dtype]))
                err_split = max(err_split, max_err(
                    f"{tag} out step {step} vs split",
                    out.reshape(split.shape), split, TOL[dtype]))
                for name, a, b in zip(STATE_FLAT, flat_pool(pool), split_st):
                    max_err(f"{tag} {name} step {step} vs split", a, b,
                            STATE_TOL)
            if [x.data_ptr() for x in pool] != ptrs:
                raise AssertionError(f"{tag}: the pool moved")
            if not torch.equal(pool.t, plain.t):
                raise AssertionError(f"{tag}: t differs")
            worst = max(max_err(f"{tag} {name} after {steps} steps",
                                getattr(pool, name), getattr(plain, name),
                                STATE_TOL) for name in STATE_FIELDS)
            errs[dtype] = max(errs[dtype], err)
            print(f"[K3] {tag} x {steps} steps: out {err:.3e}, state "
                  f"{worst:.3e}, pool updated in place; against "
                  f"flow_decode_split (teacher-forced) out {err_split:.3e}",
                  flush=True)
        # two steps from clones of one pool: bitwise equal
        pool = decode_pool(16, hkv, d, SEED + 4)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        q, k, v = decode_token(gen, 16, hkv, g, d, torch.bfloat16)
        runs = [flow_decode_step(FlowState(*(x.clone() for x in pool)), q, k,
                                 v, cfg) for _ in range(2)]
        (a, out_a), (b, out_b) = runs
        if not (torch.equal(out_a, out_b)
                and all(torch.equal(x, y) for x, y in zip(a, b))):
            raise AssertionError("flow_decode: two steps from one pool "
                                 "differ")
        print("[K3] two steps from clones of one pool: out and every state "
              "tensor bitwise equal", flush=True)
    return {"max_abs_err": errs[torch.bfloat16]}


SUM_NAMES = ("k_sum", "q_sum", "ko_sum", "qi_sum")  # flow_decode_q's order


def int8_pool(state):
    """A FlowState quantized with the serving recipe (per-(slot, head)
    int8, z exempt)."""
    from repro_torch.serving.quant import quantize_state, spec_of

    return quantize_state(state, spec_of("int8"), granularity="head",
                          exempt=("z",))


def clone_pool(pool):
    return pool.with_state(type(pool.payload)(*(x.clone() for x in pool.payload)),
                           type(pool.scale)(*(x.clone() for x in pool.scale)))


def flat_q_pool(pool):
    """An int8 pool's tensors as views in flow_decode_q's flat layout."""
    st, sc = pool.payload, pool.scale
    bh, d = st.s.shape[0] * st.s.shape[1], st.s.shape[2]
    return (tuple(getattr(st, n).view(bh, d) for n in SUM_NAMES),
            st.s.view(bh, d, st.s.shape[3]),
            tuple(getattr(sc, n).view(bh, 1) for n in SUM_NAMES),
            sc.s.view(bh, 1), st.z.view(bh))


def plain_q_step(pool, q, k, v, cfg):
    """K4's plain version (``flow_decode_q_ref``) on a copy of ``pool``:
    returns (the new pool, out (B, Hq, 1, Dv)); ``pool`` is untouched."""
    from repro_torch.kernels.flow_decode import flow_decode_q_ref

    new = clone_pool(pool)
    b, hkv, d, dv = new.payload.s.shape
    bh, g = b * hkv, q.shape[1] // hkv
    new.payload.t.add_(1)
    pays, s_pay, scs, s_sc, z = flat_q_pool(new)
    out, *res = flow_decode_q_ref(
        new.payload.t, q.reshape(bh, g, d), k.reshape(bh, d),
        v.reshape(bh, dv), pays, s_pay, scs, s_sc, z, hkv=hkv, eps=cfg.eps,
        phi=cfg.phi, use_alloc=cfg.use_allocation)
    for dst, src in zip((*pays, s_pay, *scs, s_sc, z),
                        (*res[0], res[1], *res[2], res[3], res[4])):
        dst.copy_(src)
    return new, out.reshape(b, hkv * g, 1, dv)


def q_pool_close(name: str, got, want) -> tuple[int, float]:
    """Raise unless int8 pool ``got`` is within K4's tolerances of ``want``;
    returns (largest payload gap in LSB, share of payload entries that
    differ)."""
    p, w = got.payload, want.payload
    if not torch.equal(p.t, w.t):
        raise AssertionError(f"{name}: t differs")
    max_err(f"{name} z", p.z, w.z, (1e-5, 1e-5))
    gap, n, differ = 0, 0, 0
    for field in SUM_NAMES + ("s",):
        diff = (getattr(p, field).int() - getattr(w, field).int()).abs()
        gap = max(gap, int(diff.max()))
        n, differ = n + diff.numel(), differ + int((diff > 0).sum())
        max_err(f"{name} {field} scale", getattr(got.scale, field),
                getattr(want.scale, field), (1e-5, 0.0))
    if gap > 1 or differ > 1e-3 * n:
        raise AssertionError(f"{name}: payloads {gap} LSB apart, {differ} of "
                             f"{n} entries differ")
    return gap, differ / n


def check_flow_decode_q() -> dict:
    """Phase 4b: K4 against its plain version over 32 teacher-forced steps,
    on the serving run's 16-slot pool and on 64 slots, int8; returns the
    bf16 output's max |error|."""
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import flow_decode_q_step

    hkv, g, d, steps = 8, 1, 64, 32
    cfg = FlowConfig(causal=True, strict_causal=True)
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    with torch.inference_mode():
        for slots, dtype in ((16, torch.bfloat16), (16, torch.float32),
                             (64, torch.bfloat16), (64, torch.float32)):
            pool = int8_pool(decode_pool(slots, hkv, d, SEED + 2))
            free = clone_pool(pool)  # the plain version on its own outputs
            ptrs = [x.data_ptr() for x in pool.payload + pool.scale]
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
            tag = f"flow_decode_q {str(dtype)[6:]} {slots} slots"
            err, flips = 0.0, 0.0
            for step in range(steps):
                q, k, v = decode_token(gen, slots, hkv, g, d, dtype)
                want, ref = plain_q_step(pool, q, k, v, cfg)
                free, _ = plain_q_step(free, q, k, v, cfg)
                same, out = flow_decode_q_step(pool, q, k, v, cfg)
                torch.cuda.synchronize()
                if same is not pool:
                    raise AssertionError(f"{tag}: returned a new pool")
                err = max(err, max_err(f"{tag} out step {step}", out, ref,
                                       TOL[dtype]))
                flips = max(flips, q_pool_close(f"{tag} step {step}", pool,
                                                want)[1])
            if [x.data_ptr() for x in pool.payload + pool.scale] != ptrs:
                raise AssertionError(f"{tag}: the pool moved")
            drift = max(int((getattr(pool.payload, n).int()
                             - getattr(free.payload, n).int()).abs().max())
                        for n in SUM_NAMES + ("s",))
            errs[dtype] = max(errs[dtype], err)
            print(f"[K4] {tag} x {steps} steps (teacher-forced): out "
                  f"{err:.3e}, payload share differing <= {flips:.2e}, pool "
                  f"updated in place; free-running plain pool after {steps} "
                  f"steps: {drift} LSB apart (not gated)", flush=True)
        # two steps from clones of one pool: bitwise equal
        pool = int8_pool(decode_pool(16, hkv, d, SEED + 4))
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        q, k, v = decode_token(gen, 16, hkv, g, d, torch.bfloat16)
        runs = [flow_decode_q_step(clone_pool(pool), q, k, v, cfg)
                for _ in range(2)]
        (a, out_a), (b, out_b) = runs
        if not (torch.equal(out_a, out_b) and all(
                torch.equal(x, y) for x, y in zip(a.payload + a.scale,
                                                  b.payload + b.scale))):
            raise AssertionError("flow_decode_q: two steps from one pool "
                                 "differ")
        print("[K4] two steps from clones of one pool: out, payloads, scales "
              "and z bitwise equal", flush=True)
    return {"max_abs_err": errs[torch.bfloat16]}


LRA_ROWS, LRA_HEADS, LRA_N, LRA_D = 32, 4, 4096, 64
# the vision encoder at 224 x 224 (``flowformer_vision``): 16 heads whose
# dims are 6, 12, 24, 48 over the stages' 3,136, 784, 196 and 49 tokens;
# the reference bench's smaller widths (4 heads) give 8 and 16 too
VISION_STAGES = ((6, 3136), (12, 784), (24, 196), (48, 49))
SMALL_HEAD_CASES = VISION_STAGES + ((8, 3136), (16, 784))
VISION_SIZE, VISION_BATCH, VISION_HEADS = 224, 64, 16


def nc_inputs(dtype, bh, nq, m, d, seed):
    """q (BH, NQ, D), k, v (BH, M, D) and a cotangent g (BH, NQ, D)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
    return mk(bh, nq, d), mk(bh, m, d), mk(bh, m, d), mk(bh, nq, d)


def check_flow_nc() -> dict:
    """Phase 3c: K6, K7a and K7b against their plain versions; returns
    each one's max |error| at the LRA shape in bf16 (the main path's)."""
    from repro_torch.attention.pipeline import nc_forward
    from repro_torch.attention.vjp import nc_key_side
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_nc import (flow_attention_nc,
                                             flow_nc_fused_call,
                                             flow_nc_fused_parallel,
                                             flow_nc_fused_ref,
                                             flow_nc_qside_bwd_call,
                                             flow_nc_qside_bwd_parallel,
                                             flow_nc_qside_bwd_ref,
                                             flow_nc_qside_call,
                                             flow_nc_qside_ref)
    from repro_torch.kernels.flow_nc.ops import bwd_rows, cluster_blocks

    def k7b_twin(tag, q, g, key, tol, **kw):
        """K7b against its own decomposition at the card's rows per block,
        at ``tol`` and, for its fp32 outputs, at ``K7B_TWIN_RTOL``; two
        calls bitwise equal; returns the largest error."""
        got = flow_nc_qside_bwd_call(q, *key, g, **kw)
        rows = bwd_rows(q.shape[0], q.shape[1], q.shape[2], q.dtype)
        twin = flow_nc_qside_bwd_parallel(q, *key, g, rows=rows, **kw)
        err, rel = 0.0, {}
        for name, a, b in zip(("dq", "dk_sum", "dko_sum", "dkv"), got, twin):
            what = f"flow_nc_qside_bwd {tag} {name} vs flow_nc_qside_bwd_parallel"
            err = max(err, max_err_scaled(what, a, b, tol))
            if a.dtype == torch.float32:
                rel[name] = twin_close(what, a, b, K7B_TWIN_RTOL)
        print(f"[K7b] {tag}: |kernel - twin| / max |twin| per fp32 output "
              f"(bound {K7B_TWIN_RTOL}): " + json.dumps(rel), flush=True)
        again = flow_nc_qside_bwd_call(q, *key, g, **kw)
        if not all(map(torch.equal, got, again)):
            raise AssertionError(f"flow_nc_qside_bwd {tag}: two calls differ")
        return err

    def qside_errs(tag, q, g, k_sum, ko_sum, kv, tol, **kw):
        e7a = max_err_scaled(f"flow_nc_qside {tag} out",
                             flow_nc_qside_call(q, k_sum, ko_sum, kv, **kw),
                             flow_nc_qside_ref(q, k_sum, ko_sum, kv, **kw),
                             tol)
        got = flow_nc_qside_bwd_call(q, k_sum, ko_sum, kv, g, **kw)
        want = flow_nc_qside_bwd_ref(q, k_sum, ko_sum, kv, g, **kw)
        names = ("dq", "dk_sum", "dko_sum", "dkv")
        e7b = max(max_err_scaled(f"flow_nc_qside_bwd {tag} {name}", a, b,
                                 tol) for name, a, b in zip(names, got, want))
        print(f"[K7b] {tag}: max |error| and the scaled bound rtol x max "
              "|plain| per output: " + json.dumps({
                  name: [float((a.float() - b).abs().max()),
                         tol[0] * float(b.float().abs().max())]
                  for name, a, b in zip(names, got, want)}), flush=True)
        return e7a, e7b

    errs = {}
    bh, n, d = LRA_ROWS * LRA_HEADS, LRA_N, LRA_D
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = nc_inputs(dtype, bh, n, n, d, SEED + 30)
            tag = f"{str(dtype)[6:]} BH={bh} N=M={n}"
            e6 = max(max_err_scaled(f"flow_nc_fused {tag} comp={comp} out",
                                    flow_nc_fused_call(q, k, v, use_comp=comp),
                                    flow_nc_fused_ref(q, k, v, use_comp=comp),
                                    TOL[dtype]) for comp in (True, False))
            key = nc_key_side(q, k, v, 1e-6, True)
            e7a, e7b = qside_errs(tag, q, g, *key, TOL[dtype], n_sinks=n,
                                  m_sources=n)
            e7p = k7b_twin(tag, q, g, key, TOL[dtype], n_sinks=n, m_sources=n)
            torch.cuda.synchronize()
            print(f"[K6/K7] {tag}: K6 {e6:.3e}, K7a {e7a:.3e}, K7b {e7b:.3e} "
                  f"(vs its decomposition {e7p:.3e}; two calls bitwise "
                  "equal)", flush=True)
            if dtype == torch.bfloat16:
                errs = {"flow_nc_fused": e6, "flow_nc_qside": e7a,
                        "flow_nc_qside_bwd": e7b}
                again = [flow_nc_fused_call(q, k, v) for _ in range(2)]
                if not torch.equal(*again):
                    raise AssertionError(f"flow_nc_fused {tag}: two calls "
                                         "differ")
        # K7a and K7b at D = 32 and 128, N ragged against K7b's tile
        for d_ in (32, 128):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, g = nc_inputs(dtype, 16, 1000, 700, d_, SEED + d_)
                key = nc_key_side(q, k, v, 1e-6, True)
                tag = f"{str(dtype)[6:]} BH=16 N=1000 M=700 D={d_}"
                kw = dict(n_sinks=1000, m_sources=700)
                e7 = qside_errs(tag, q, g, *key, TOL[dtype], **kw)
                e7p = k7b_twin(tag, q, g, key, TOL[dtype], **kw)
                torch.cuda.synchronize()
                print(f"[K7] {tag}: K7a {e7[0]:.3e}, K7b {e7[1]:.3e} (vs its "
                      f"decomposition {e7p:.3e}; two calls bitwise equal)",
                      flush=True)
        # K6 where its clusters split unevenly or own nothing, and saturated
        for dtype in (torch.bfloat16, torch.float32):
            for i, (bh_, nq, m, logit) in enumerate((
                    (8, 400, 136, 1.0), (4, 4001, 3999, 1.0), (2, 1, 1, 1.0),
                    (4, 256, 256, 30.0))):
                q, k, v, _ = nc_inputs(dtype, bh_, nq, m, d, SEED + 32 + i)
                if logit != 1.0:
                    q, k = logit * q.sign(), logit * k.sign()
                tag = f"{str(dtype)[6:]} BH={bh_} NQ={nq} M={m} logit={logit}"
                e6 = max(max_err_scaled(
                    f"flow_nc_fused {tag} comp={comp} out",
                    flow_nc_fused_call(q, k, v, use_comp=comp),
                    flow_nc_fused_ref(q, k, v, use_comp=comp), TOL[dtype])
                    for comp in (True, False))
                torch.cuda.synchronize()
                print(f"[K6] {tag}: {e6:.3e}", flush=True)
        # the small-head route: the vision encoder's stages, 4 images x 16
        # heads, and NQ != M; K6 also against its cluster twin, K7b against
        # its own (inside k7b_twin); two calls of each bitwise equal
        for dtype in (torch.bfloat16, torch.float32):
            for d_, nq, m in [(d_, n_, n_) for d_, n_ in SMALL_HEAD_CASES] + [
                    (24, 400, 136)]:
                q, k, v, g = nc_inputs(dtype, 4 * VISION_HEADS, nq, m, d_,
                                       SEED + 50 + d_)
                tag = f"{str(dtype)[6:]} BH=64 NQ={nq} M={m} D={d_}"
                got = flow_nc_fused_call(q, k, v)
                e6 = max(max_err_scaled(f"flow_nc_fused {tag} out vs {name}",
                                        got, want, TOL[dtype])
                         for name, want in (
                             ("plain", flow_nc_fused_ref(q, k, v)),
                             ("flow_nc_fused_parallel", flow_nc_fused_parallel(
                                 q, k, v, cb=cluster_blocks(nq, m, d_)))))
                key = nc_key_side(q, k, v, 1e-6, True)
                kw = dict(n_sinks=nq, m_sources=m)
                e7a, e7b = qside_errs(tag, q, g, *key, TOL[dtype], **kw)
                e7p = k7b_twin(tag, q, g, key, TOL[dtype], **kw)
                if not (torch.equal(got, flow_nc_fused_call(q, k, v))
                        and torch.equal(flow_nc_qside_call(q, *key, **kw),
                                        flow_nc_qside_call(q, *key, **kw))):
                    raise AssertionError(f"flow_nc {tag}: two calls differ")
                torch.cuda.synchronize()
                print(f"[K6/K7 small heads] {tag}: K6 {e6:.3e} (vs plain and "
                      f"twin), K7a {e7a:.3e}, K7b {e7b:.3e} (vs its "
                      f"decomposition {e7p:.3e}); two calls of each bitwise "
                      "equal", flush=True)
                if dtype == torch.bfloat16 and (d_, nq) in VISION_STAGES:
                    for name, e in (("flow_nc_fused", e6),
                                    ("flow_nc_qside", e7a),
                                    ("flow_nc_qside_bwd", e7b)):
                        errs[f"{name}_vision"] = max(
                            errs.get(f"{name}_vision", 0.0), e)
        # G = 2 (shared GQA), N = 200 sinks per head, M = 136 sources
        b, hkv, grp, n, m = 4, 8, 2, 200, 136
        q, k, v, g = nc_inputs(torch.float32, b, hkv * grp * n, hkv * m, d,
                               SEED + 31)
        q = q.reshape(b, hkv * grp, n, d)
        k, v = k.reshape(b, hkv, m, d), v.reshape(b, hkv, m, d)
        qf, g = q.reshape(b * hkv, grp * n, d), g.reshape(b * hkv, grp * n, d)
        tag = "fp32 G=2 N=200 M=136"
        kf, vf = k.reshape(b * hkv, m, d), v.reshape(b * hkv, m, d)
        e7 = qside_errs(tag, qf, g, *nc_key_side(qf, kf, vf, 1e-6, True),
                        TOL[torch.float32], n_sinks=grp * n, m_sources=m)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    cfg = FlowConfig()
    out = flow_attention_nc(*leaves, cfg)
    want = nc_forward(*plain, cfg)
    e6 = max_err_scaled(f"flow_nc_fused {tag} out", out.detach(),
                        want.detach(), TOL[torch.float32])
    cot = g.reshape(out.shape)
    got_g = torch.autograd.grad(out, leaves, cot)
    want_g = torch.autograd.grad(want, plain, cot)
    eg = max(max_err_scaled(f"flow_attention_nc {tag} d{name}", a, b_,
                            TOL[torch.float32])
             for name, a, b_ in zip("qkv", got_g, want_g))
    torch.cuda.synchronize()
    print(f"[K6/K7] {tag}: K6 {e6:.3e}, K7a {e7[0]:.3e}, K7b {e7[1]:.3e}, "
          f"grads through FlowNCFused {eg:.3e}", flush=True)
    return errs


def requests(rng, n, vocab, lens, budgets):
    from repro_torch.serving.engine import Request

    return [Request(uid=i, prompt=rng.integers(
        0, vocab, int(rng.integers(lens[0], lens[1] + 1))).astype(np.int32),
        max_new_tokens=int(rng.integers(budgets[0], budgets[1] + 1)))
        for i in range(n)]


def serve_full_width(params, cfg, state_dtype=None) -> dict:
    """Phase 5 (5c with ``state_dtype="int8"``): the bf16 Engine at full
    width; launch counts, rates and the pools' bytes."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.quant import pool_bytes

    engine = Engine(params, cfg, slots=16, max_len=512, seed=SEED,
                    state_dtype=state_dtype, device=DEVICE)
    reqs = requests(np.random.default_rng(SEED + 4), 48, cfg.vocab_size,
                    (16, 384), (32, 64))
    for r in reqs:
        engine.submit(r)
    worker = engine.worker
    spent = timed_worker(worker)
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
    decode, idle = (("flow_decode_q", "flow_decode") if state_dtype == "int8"
                    else ("flow_decode", "flow_decode_q"))
    if launches[decode] != n_layers * steps or launches[idle]:
        raise AssertionError(f"{decode} launched {launches[decode]} times, "
                             f"want {n_layers} x {steps} steps; {idle} "
                             f"{launches[idle]} times, want 0")
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
        "pool_bytes": pool_bytes(worker.caches),
    }
    if state_dtype is None:
        print("[engine bf16] " + json.dumps(stats), flush=True)
        return stats
    stats["fp32_pool_bytes"] = pool_bytes(lm.init_caches(
        cfg, 16, 512, device=DEVICE))
    print(f"[engine bf16, {state_dtype} pools] " + json.dumps(stats),
          flush=True)
    return stats


def profile_decode(params, cfg, step_ms: float, state_dtype=None,
                   paged=None) -> dict:
    """Phase 5b (5c's with ``state_dtype``): where a decode step's time
    goes, from ``torch.profiler`` over a window of full-pool decode steps:
    device time by kernel, the kernels launched, and host time by
    operator.  Every step decodes all 16 slots, live or not, so its device
    work is that of phase 5 (5c; 17 and 17b with ``paged``, whose pool of
    a PagedSpec gathers every slot's whole page row), whose unprofiled
    mean step time gives the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Engine

    engine = Engine(params, cfg, slots=16, max_len=512, seed=SEED,
                    paged=paged, state_dtype=state_dtype, device=DEVICE)
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
    if paged is not None:  # K8a's kernel (17) or K8b's (17b)
        stats["paged_gather_ms_per_step"] = sum(
            dev_us(e) for e in dev if "paged_gather" in e.key) / 1e3 / steps
    tag = "decode" + ("" if paged is None else " softmax paged") + (
        "" if state_dtype is None else f", {state_dtype} pools")
    print(f"[profile {tag}] " + json.dumps(stats), flush=True)
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
        serving = [LAUNCHES["flow_fused"], LAUNCHES["flow_decode"]]
        if (backend == "auto" and min(serving) == 0) or (
                backend == "plain" and max(LAUNCHES.values()) > 0):
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


def serve_int8_fp32_against_plain(params, cfg):
    """Phase 6b: the int8 Engine in fp32 at full width on the kernels;
    before every decode step the plain path takes the same step from a
    copy of the same pools, with the same tokens and positions."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.layers.attention import executor_of
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    plain_cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend="plain"))
    engine = Engine(params, cfg, slots=8, max_len=256, seed=SEED,
                    dtype=torch.float32, state_dtype="int8", device=DEVICE)
    worker = engine.worker
    plain_ex = executor_of(plain_cfg, worker.plan)
    for r in requests(np.random.default_rng(SEED + 5), 12, cfg.vocab_size,
                      (16, 128), (16, 16)):
        engine.submit(r)
    real_decode, real_step, seen = lm.decode, worker.step, {}
    checked = {"steps": 0, "tokens": 0, "near_ties": 0, "logit_err": 0.0,
               "payload_share": 0.0}

    def recording_decode(*a, **kw):
        seen["logits"], caches = real_decode(*a, **kw)
        return seen["logits"], caches

    def checked_step(tokens, pos, temps, live):
        with torch.inference_mode():
            before = [clone_pool(c) for c in worker.caches]
            want, want_pools = real_decode(
                worker.params, torch.as_tensor(tokens, dtype=torch.int32,
                                               device=DEVICE)[:, None],
                before, plain_cfg, torch.as_tensor(pos, dtype=torch.int32,
                                                   device=DEVICE),
                plan=plain_ex, dtype=torch.float32)
        toks = real_step(tokens, pos, temps, live)
        step = checked["steps"]
        got, want = seen["logits"][:, -1].float(), want[:, -1].float()
        scale = float(want.abs().max())
        checked["logit_err"] = max(checked["logit_err"], max_err(
            f"int8 fp32 step {step} logits", got, want, (1e-4, 1e-4 * scale)))
        for i, (pool, ref) in enumerate(zip(worker.caches, want_pools)):
            checked["payload_share"] = max(checked["payload_share"], q_pool_close(
                f"int8 fp32 step {step} layer {i}", pool, ref)[1])
        top = torch.topk(want, 2, dim=-1)
        margin = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
        tol = (1e-4 * scale + 1e-4 * top.values[:, 0].abs()).cpu().numpy()
        plain_tok = top.indices[:, 0].cpu().numpy()
        for row in np.flatnonzero(live):
            if margin[row] <= 2 * tol[row]:
                checked["near_ties"] += 1
            elif toks[row] != plain_tok[row]:
                raise AssertionError(
                    f"int8 fp32 step {step} slot {row}: kernels {toks[row]}, "
                    f"plain {plain_tok[row]}, margin {margin[row]:.3e}")
            else:
                checked["tokens"] += 1
        checked["steps"] += 1
        return toks

    worker.step = checked_step
    lm.decode = recording_decode
    reset_launches()
    try:
        kernel_run = {r.uid: r.generated for r in engine.run()}
    finally:
        lm.decode = real_decode
    want = {"flow_fused": cfg.n_layers * worker.admission_rounds,
            "flow_decode_q": cfg.n_layers * worker.decode_steps}
    if {k: v for k, v in LAUNCHES.items() if v} != want:
        raise AssertionError(f"int8 fp32 launches {LAUNCHES}, want {want}")
    plain = Engine(params, plain_cfg, slots=8, max_len=256, seed=SEED,
                   dtype=torch.float32, state_dtype="int8", device=DEVICE)
    for r in requests(np.random.default_rng(SEED + 5), 12, cfg.vocab_size,
                      (16, 128), (16, 16)):
        plain.submit(r)
    plain_run = {r.uid: r.generated for r in plain.run()}
    same = sum(a == b for uid, gen in plain_run.items()
               for a, b in zip(gen, kernel_run[uid]))
    total = sum(len(gen) for gen in plain_run.values())
    print(f"[int8 fp32] kernels vs plain step by step over "
          f"{checked['steps']} steps: logits {checked['logit_err']:.3e}, "
          f"pools within tolerance (payload share differing <= "
          f"{checked['payload_share']:.2e}), {checked['tokens']} greedy "
          f"tokens equal to the plain argmax ({checked['near_ties']} near "
          f"ties skipped); free-running, {same} of {total} tokens agree "
          "(not gated)", flush=True)


def train_full_width(cfg) -> dict:
    """Phase 7: the trainer at full width in bf16; launch counts and rates."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.launch.train import train

    steps, batch, seq = 5, 16, 512
    torch.cuda.synchronize()
    reset_launches()
    out = train(cfg, steps=steps, batch=batch, seq=seq, seed=SEED,
                device=DEVICE)
    launches = dict(LAUNCHES)
    hist = out["history"]
    if len(hist) != steps or not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"training losses {hist}")
    n = cfg.n_layers * steps
    want = {**dict.fromkeys(KERNELS, 0), "flow_fused": 2 * n,
            "flow_fused_bwd": n}
    if launches != want:
        raise AssertionError(f"training launched {launches}, want {want}")
    step_ms = 1e3 * statistics.median(out["step_s"][1:])
    stats = {"steps": steps, "batch": batch, "seq": seq,
             "first_step_ms": 1e3 * out["step_s"][0], "step_ms": step_ms,
             "tokens_per_s": batch * seq / step_ms * 1e3,
             "history": hist, "launches": launches}
    print("[train bf16] " + json.dumps(stats), flush=True)
    return stats


# K1 launches the flow_fwd_* CUDA kernels and K2 the flow_bwd_* ones, and
# no other kernel's name holds either prefix
K12 = {"k1_ms_per_step": "flow_fwd_", "k2_ms_per_step": "flow_bwd_"}
# K5a launches the chunk_fwd_* CUDA kernels and K5b the chunk_bwd_* ones
K5A_KEY, K5B_KEY = "chunk_fwd_", "chunk_bwd_"


def paper_causal(cfg, **over):
    """The paper-faithful causal variant of ``cfg`` (``lm_table4.py``'s
    "paper-faithful causal" row), made as ``with_kind`` makes it."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, strict_causal=False, **over))


def train_paper_causal_full_width(cfg) -> dict:
    """Phase 7c: phase 7 for the paper-causal variant; every attention
    forward, its remat recompute and its dq run K5a, its dk and dv K5b."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.launch.train import train

    cfg = paper_causal(cfg)
    steps, batch, seq = 5, 16, 512
    torch.cuda.synchronize()
    reset_launches()
    out = train(cfg, steps=steps, batch=batch, seq=seq, seed=SEED,
                device=DEVICE)
    launches = dict(LAUNCHES)
    hist = out["history"]
    if len(hist) != steps or not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"paper-causal training losses {hist}")
    n = cfg.n_layers * steps
    want = {**dict.fromkeys(KERNELS, 0), "flow_chunk": 3 * n,
            "flow_chunk_dkv": n}
    if launches != want:
        raise AssertionError(f"paper-causal training launched {launches}, "
                             f"want {want}")
    step_ms = 1e3 * statistics.median(out["step_s"][1:])
    stats = {"steps": steps, "batch": batch, "seq": seq,
             "first_step_ms": 1e3 * out["step_s"][0], "step_ms": step_ms,
             "tokens_per_s": batch * seq / step_ms * 1e3,
             "history": hist, "launches": launches}
    print("[train paper-causal bf16] " + json.dumps(stats), flush=True)
    return stats


def profile_train(cfg, step_ms: float, kernels=K12, tag="train", batch=16,
                  seq=512) -> dict:
    """Phase 7b (and 7c, 15b): device time of a full-width bf16 training
    step by kernel, from ``torch.profiler`` over two steps (the weights are
    on the card before the window opens), and its share of phase 7's (7c's,
    15's) unprofiled step time; ``kernels`` names the path's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import train
    from repro_torch.models import lm

    steps = 2
    params = lm.init(cfg, torch.Generator().manual_seed(SEED + 1),
                     device=DEVICE)  # uploaded before the window opens
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train(cfg, steps=steps, batch=batch, seq=seq, seed=SEED + 1,
              device=DEVICE, params=params)
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in dev) / 1e3 / steps
    by_name = lambda key: sum(dev_us(e) for e in dev  # noqa: E731
                              if key in e.key) / 1e3 / steps
    stats = {"steps": steps, "device_ms_per_step": busy,
             "kernels_per_step": sum(e.count for e in dev) / steps,
             "step_ms_unprofiled": step_ms, "device_busy_share": busy / step_ms,
             **{label: by_name(key) for label, key in kernels.items()},
             "device_ms_per_step_by_kernel": {
                 e.key[:80]: dev_us(e) / 1e3 / steps
                 for e in sorted(dev, key=dev_us, reverse=True)[:8]},
             "host_ms_per_step_by_op_profiled": {
                 e.key[:80]: e.self_cpu_time_total / 1e3 / steps
                 for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                                 reverse=True)[:8]}}
    print(f"[profile {tag}] " + json.dumps(stats), flush=True)
    return stats


def train_fp32_both_paths(cfg, steps=3, per_layer_step=None, tag="train"):
    """Phase 8 (and 8b): fp32 training at full width and 2 layers, kernels
    vs the plain PyTorch path: per-step losses, and the first step's
    attention gradients (non-zero on the kernels: K2, or K5a and K5b,
    reached wq/wk/wv).  ``per_layer_step`` gives each kernel's launches
    per layer and step (default: 2 K1 and 1 K2)."""
    from repro_torch.data.loader import lm_loader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.launch.train import train
    from repro_torch.layers.attention import executor_of, plan_of
    from repro_torch.models import lm
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(cfg, n_layers=2)
    batch, seq = 16, 512
    per_layer_step = per_layer_step or {"flow_fused": 2, "flow_fused_bwd": 1}
    params = lm.init(cfg, torch.Generator().manual_seed(SEED + 2),
                     device=DEVICE)
    first = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             next(lm_loader(SEED, batch=batch, seq=seq,
                            vocab=cfg.vocab_size)).items()}
    hist, grads = {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        loss, _ = lm.loss_fn(leaves, first, c, dtype=torch.float32,
                             plan=executor_of(c, plan_of(c, needs_grad=True)))
        loss.backward()
        grads[backend] = {f"layer {i} {w}": blk["attn"][w]["w"].grad
                          for i, blk in enumerate(leaves["blocks"])
                          for w in ("wq", "wk", "wv")}
        torch.cuda.synchronize()
        reset_launches()
        hist[backend] = train(c, steps=steps, batch=batch, seq=seq,
                              seed=SEED, device=DEVICE, dtype=torch.float32,
                              params=params)["history"]
        n = cfg.n_layers * steps
        want = dict.fromkeys(KERNELS, 0)
        if backend == "auto":
            want.update({k: per * n for k, per in per_layer_step.items()})
        if dict(LAUNCHES) != want:
            raise AssertionError(f"{tag} backend={backend}: launches "
                                 f"{LAUNCHES}, want {want}")
    for i, (a, b) in enumerate(zip(hist["auto"], hist["plain"])):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"{tag} fp32 step {i} loss: kernels {a}, "
                                 f"plain {b}")
    worst = 0.0
    for name, g in grads["auto"].items():
        ref = grads["plain"][name]
        scale, err = float(ref.abs().max()), float((g - ref).abs().max())
        if not float(g.abs().max()) > 0 or not err <= 1e-4 * scale:
            raise AssertionError(f"{tag} fp32 step 1 {name} grad: |diff| "
                                 f"{err:.3e}, max |plain| {scale:.3e}, max "
                                 f"|kernels| {float(g.abs().max()):.3e}")
        worst = max(worst, err / scale)
    print(f"[{tag} fp32] kernels vs plain, 2 layers x {steps} steps: losses "
          f"{hist['auto']} vs {hist['plain']}; wq/wk/wv grads of step 1 "
          f"non-zero, worst |diff| / max |grad| {worst:.3e}", flush=True)


K5 = {"flow_chunk": 3, "flow_chunk_dkv": 1}


def train_paper_fp32_both_paths(cfg):
    """Phase 8b: phase 8 for the paper-causal variant (3 steps) and for
    the variant without competition (1 step), on K5a and K5b."""
    train_fp32_both_paths(paper_causal(cfg), per_layer_step=K5,
                          tag="train paper-causal")
    no_comp = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, use_competition=False))
    train_fp32_both_paths(no_comp, steps=1, per_layer_step=K5,
                          tag="train no-competition")


def expect_launches(launches: dict, k6: int, k7b: int, what: str):
    """Exactly ``k6`` K6 and ``k7b`` K7b launches and no other kernel's."""
    from repro_torch.kernels._lib import KERNELS

    want = {**dict.fromkeys(KERNELS, 0), "flow_nc_fused": k6,
            "flow_nc_qside_bwd": k7b}
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, want {want}")


def first_step_grads(loss_fn, params, batch, cfg, backend, names):
    """One fp32 step's gradients of the leaves ``names(leaves)`` lists,
    with attention on ``backend``, bound once for gradients."""
    from repro_torch.layers.attention import executor_of, plan_of
    from repro_torch.utils import tree_map

    c = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend=backend))
    leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                      params)
    plan = executor_of(c, plan_of(c, causal=False, needs_grad=True),
                       causal=False)
    loss, _ = loss_fn(leaves, batch, c, dtype=torch.float32, plan=plan)
    loss.backward()
    return c, {name: x.grad for name, x in names(leaves)}


def losses_and_grads_agree(what: str, hist: dict, grads: dict):
    """Phase 11's bounds: losses rtol 1e-4; each gradient non-zero on the
    kernels and within 1e-4 of the plain path's max |grad|."""
    for i, (a, b) in enumerate(zip(hist["auto"], hist["plain"])):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"{what} step {i} loss: kernels {a}, plain "
                                 f"{b}")
    worst = 0.0
    for name, g in grads["auto"].items():
        ref = grads["plain"][name]
        scale, err = float(ref.abs().max()), float((g - ref).abs().max())
        if not float(g.abs().max()) > 0 or not err <= 1e-4 * scale:
            raise AssertionError(f"{what} step 1 {name} grad: |diff| "
                                 f"{err:.3e}, max |plain| {scale:.3e}, max "
                                 f"|kernels| {float(g.abs().max()):.3e}")
        worst = max(worst, err / scale)
    return worst


def train_classifier_full_width(cfg) -> dict:
    """Phase 10: the LRA classifier at full width in bf16, then its
    evaluation; launch counts and rates."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.classify import (EVAL_BATCH, listops_data,
                                             train_eval_classifier)

    steps, batch, n_eval = 5, LRA_ROWS, 64
    train_data, eval_data = listops_data(512, n_eval, seq=LRA_N, seed=SEED)
    torch.cuda.synchronize()
    reset_launches()
    out = train_eval_classifier(cfg, train_data, eval_data, n_classes=10,
                                steps=steps, batch=batch, seed=SEED,
                                device=DEVICE)
    launches = dict(LAUNCHES)
    hist = out["history"]
    if len(hist) != steps or not all(math.isfinite(x) for x in hist + [
            out["loss"]]) or not 0.0 <= out["acc"] <= 1.0:
        raise AssertionError(f"classifier losses {hist}, eval {out['loss']}, "
                             f"acc {out['acc']}")
    n, eval_batches = cfg.n_layers * steps, -(-n_eval // EVAL_BATCH)
    expect_launches(launches, n + cfg.n_layers * eval_batches, n,
                    "classifier")
    step_ms = 1e3 * statistics.median(out["step_s"][1:])
    stats = {"steps": steps, "batch": batch, "seq": LRA_N,
             "first_step_ms": 1e3 * out["step_s"][0], "step_ms": step_ms,
             "tokens_per_s": batch * LRA_N / step_ms * 1e3,
             "eval_examples": n_eval, "eval_ms": 1e3 * out["eval_s"],
             "eval_loss": out["loss"], "eval_acc": out["acc"],
             "history": hist, "launches": launches}
    print("[classify bf16] " + json.dumps(stats), flush=True)
    return stats


def profile_classifier(cfg, step_ms: float) -> dict:
    """Phase 10b: device time of a full-width bf16 classifier step by
    kernel, from ``torch.profiler`` over two steps after one outside the
    window, and its share of phase 10's unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.classify import listops_data, make_classifier_step
    from repro_torch.models import classifier
    from repro_torch.training.train_state import init_train_state

    steps = 2
    step_fn, tcfg = make_classifier_step(cfg, steps=10)
    state = init_train_state(classifier.init(
        cfg, torch.Generator().manual_seed(SEED + 1), n_classes=10,
        device=DEVICE), tcfg)
    data, _ = listops_data(LRA_ROWS * (steps + 1), 0, seq=LRA_N, seed=SEED + 1)
    batches = [{k: torch.from_numpy(v[i * LRA_ROWS:(i + 1) * LRA_ROWS]).to(
        DEVICE) for k, v in data.items()} for i in range(steps + 1)]
    state, metrics = step_fn(state, batches[0])
    float(metrics["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for bt in batches[1:]:
            state, metrics = step_fn(state, bt)
            float(metrics["loss"])
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in dev) / 1e3 / steps
    by_name = lambda key: sum(dev_us(e) for e in dev  # noqa: E731
                              if key in e.key) / 1e3 / steps
    stats = {"steps": steps, "device_ms_per_step": busy,
             "kernels_per_step": sum(e.count for e in dev) / steps,
             "step_ms_unprofiled": step_ms, "device_busy_share": busy / step_ms,
             "k6_ms_per_step": by_name("flow_nc_fused_kernel"),
             "k7a_ms_per_step": by_name("flow_nc_qside_kernel"),
             "k7b_ms_per_step": by_name("flow_nc_qside_bwd_kernel")
             + by_name("flow_nc_reduce_kernel"),
             "device_ms_per_step_by_kernel": {
                 e.key[:80]: dev_us(e) / 1e3 / steps
                 for e in sorted(dev, key=dev_us, reverse=True)[:14]}}
    print("[profile classify] " + json.dumps(stats), flush=True)
    return stats


def train_classifier_fp32_both_paths(cfg):
    """Phase 11: the classifier in fp32 at full width and 2 layers, kernels
    vs the plain PyTorch path: per-step losses, and the first step's
    attention gradients (non-zero on the kernels: K7b reached wq, wk,
    wv)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.classify import listops_data, train_eval_classifier
    from repro_torch.models import classifier

    cfg = dataclasses.replace(cfg, n_layers=2)
    steps, batch = 3, LRA_ROWS
    params = classifier.init(cfg, torch.Generator().manual_seed(SEED + 2),
                             n_classes=10, device=DEVICE)
    train_data, eval_data = listops_data(256, 64, seq=LRA_N, seed=SEED + 2)
    first = {k: torch.from_numpy(v[:batch]).to(DEVICE)
             for k, v in train_data.items()}
    names = lambda p: [(f"layer {i} {w}", blk["attn"][w]["w"])  # noqa: E731
                       for i, blk in enumerate(p["blocks"])
                       for w in ("wq", "wk", "wv")]
    hist, grads = {}, {}
    for backend in ("auto", "plain"):
        c, grads[backend] = first_step_grads(classifier.loss_fn, params,
                                             first, cfg, backend, names)
        torch.cuda.synchronize()
        reset_launches()
        hist[backend] = train_eval_classifier(
            c, train_data, eval_data, n_classes=10, steps=steps, batch=batch,
            seed=SEED, device=DEVICE, dtype=torch.float32,
            params=params)["history"]
        n = cfg.n_layers * steps
        if backend == "auto":
            expect_launches(dict(LAUNCHES), n + cfg.n_layers, n,
                            f"backend={backend}")
        else:
            expect_launches(dict(LAUNCHES), 0, 0, f"backend={backend}")
    worst = losses_and_grads_agree("fp32 classifier", hist, grads)
    print(f"[classify fp32] kernels vs plain, 2 layers x {steps} steps: losses "
          f"{hist['auto']} vs {hist['plain']}; wq/wk/wv grads of step 1 "
          f"non-zero, worst |diff| / max |grad| {worst:.3e}", flush=True)

# --- the vision and time-series encoders: K6 and K7b at head dims 6-64 -------


def vision_task(cfg, batch: int):
    """The launcher's vision task arguments (``train_eval_classifier``'s
    init, loss and attention shapes) for ``cfg`` at ``VISION_SIZE``."""
    import functools

    from repro_torch.models import vision

    return dict(init_fn=functools.partial(vision.init, cfg),
                loss_fn=vision.loss_fn,
                attn_shapes=vision.attention_shapes(cfg, batch, VISION_SIZE))


def train_vision_full_width(cfg) -> dict:
    """Phase 21: the vision encoder at full width and depth in bf16 (5 steps
    of VISION_BATCH images of 224 x 224), then its evaluation over 64
    held-out images; launch counts, rates and the phase's peak memory."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.classify import (EVAL_BATCH, train_eval_classifier,
                                             vision_data)

    steps, batch, n_eval = 5, VISION_BATCH, 64
    train_data, eval_data = vision_data(2 * batch, n_eval, size=VISION_SIZE,
                                        n_classes=cfg.n_classes, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = train_eval_classifier(cfg, train_data, eval_data, steps=steps,
                                batch=batch, seed=SEED, device=DEVICE,
                                **vision_task(cfg, batch))
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    if len(hist) != steps or not all(math.isfinite(x) for x in hist + [
            out["loss"]]) or not 0.0 <= out["acc"] <= 1.0:
        raise AssertionError(f"vision losses {hist}, eval {out['loss']}, "
                             f"acc {out['acc']}")
    if out["backends"] != ["cuda_nc"] * 4:
        raise AssertionError(f"vision attention bound {out['backends']}")
    layers = sum(cfg.stage_layers)
    expect_launches(launches, layers * (steps + -(-n_eval // EVAL_BATCH)),
                    layers * steps, "vision")
    step_ms = 1e3 * statistics.median(out["step_s"][1:])
    stats = {"steps": steps, "batch": batch, "size": VISION_SIZE,
             "batch_note": f"{batch} images a step: one card's cut of the "
             "paper's ImageNet global batch",
             "first_step_ms": 1e3 * out["step_s"][0], "step_ms": step_ms,
             "images_per_s": batch / step_ms * 1e3,
             "eval_images": n_eval, "eval_ms": 1e3 * out["eval_s"],
             "eval_loss": out["loss"], "eval_acc": out["acc"],
             "peak_memory_bytes": peak, "history": hist,
             "launches": launches}
    print("[vision bf16] " + json.dumps(stats), flush=True)
    return stats


def profile_vision(cfg, step_ms: float) -> dict:
    """Phase 21's profile: device time of a full-width bf16 vision step by
    kernel, from ``torch.profiler`` over two steps after one outside the
    window, and its share of phase 21's unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.classify import make_classifier_step, vision_data
    from repro_torch.models import vision
    from repro_torch.training.train_state import init_train_state

    steps, batch = 2, VISION_BATCH
    step_fn, tcfg = make_classifier_step(cfg, steps=10,
                                         loss_fn=vision.loss_fn)
    state = init_train_state(vision.init(
        cfg, torch.Generator().manual_seed(SEED + 1), device=DEVICE), tcfg)
    data, _ = vision_data(batch * (steps + 1), 0, size=VISION_SIZE,
                          n_classes=cfg.n_classes, seed=SEED + 1)
    batches = [{k: torch.from_numpy(v[i * batch:(i + 1) * batch]).to(DEVICE)
                for k, v in data.items()} for i in range(steps + 1)]
    state, metrics = step_fn(state, batches[0])
    float(metrics["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for bt in batches[1:]:
            state, metrics = step_fn(state, bt)
            float(metrics["loss"])
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in dev) / 1e3 / steps
    by_name = lambda key: sum(dev_us(e) for e in dev  # noqa: E731
                              if key in e.key) / 1e3 / steps
    stats = {"steps": steps, "batch": batch, "device_ms_per_step": busy,
             "kernels_per_step": sum(e.count for e in dev) / steps,
             "step_ms_unprofiled": step_ms, "device_busy_share": busy / step_ms,
             "k6_ms_per_step": by_name("flow_nc_fused_kernel"),
             "k7b_ms_per_step": by_name("flow_nc_qside_bwd_kernel")
             + by_name("flow_nc_reduce_kernel"),
             "gemm_ms_per_step": by_name("gemm") + by_name("Gemm")
             + by_name("sm90_xmma"),
             "device_ms_per_step_by_kernel": {
                 e.key[:80]: dev_us(e) / 1e3 / steps
                 for e in sorted(dev, key=dev_us, reverse=True)[:16]}}
    print("[profile vision] " + json.dumps(stats), flush=True)
    return stats


def train_vision_fp32_both_paths(cfg):
    """Phase 21b: the vision encoder in fp32 at full width with one block a
    stage (D = 6, 12, 24, 48) at 224 x 224, 3 steps of 16 images, on the
    kernels and on the plain path: losses, and the first step's wq/wk/wv
    gradients (non-zero on the kernels: K7b reached them)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.classify import train_eval_classifier, vision_data
    from repro_torch.models import vision

    cfg = dataclasses.replace(cfg, stage_layers=(1, 1, 1, 1))
    steps, batch = 3, 16
    params = vision.init(cfg, torch.Generator().manual_seed(SEED + 2),
                         device=DEVICE)
    train_data, eval_data = vision_data(4 * batch, batch, size=VISION_SIZE,
                                        n_classes=cfg.n_classes, seed=SEED + 2)
    first = {k: torch.from_numpy(v[:batch]).to(DEVICE)
             for k, v in train_data.items()}
    names = lambda p: [(f"stage {i} {w}", st["blocks"][0]["attn"][w]["w"])  # noqa: E731
                       for i, st in enumerate(p["stages"])
                       for w in ("wq", "wk", "wv")]
    hist, grads = {}, {}
    for backend in ("auto", "plain"):
        c, grads[backend] = first_step_grads(vision.loss_fn, params, first,
                                             cfg, backend, names)
        torch.cuda.synchronize()
        reset_launches()
        hist[backend] = train_eval_classifier(
            c, train_data, eval_data, steps=steps, batch=batch, seed=SEED,
            device=DEVICE, dtype=torch.float32, params=params,
            **vision_task(c, batch))["history"]
        if backend == "auto":
            expect_launches(dict(LAUNCHES), 4 * (steps + 1), 4 * steps,
                            "fp32 vision")
        else:
            expect_launches(dict(LAUNCHES), 0, 0, "fp32 vision, plain")
    worst = losses_and_grads_agree("fp32 vision", hist, grads)
    print(f"[vision fp32] kernels vs plain, one block a stage x {steps} steps "
          f"of {batch} x {VISION_SIZE}^2: losses {hist['auto']} vs "
          f"{hist['plain']}; wq/wk/wv grads of step 1 non-zero, worst |diff| "
          f"/ max |grad| {worst:.3e}", flush=True)


#: the reference harness's override of the time-series config
#: (``benchmarks/timeseries_table6.py:19-20``): 96 wide, 4 heads of 24
TS_HARNESS = dict(d_model=96, n_heads=4, n_kv_heads=4, d_ff=192)


def train_timeseries_full_width(cfg) -> dict:
    """Phase 22: the time-series encoder at full width (2 layers, d 512, 8
    heads of 64) in bf16, 5 steps of 32 series of 512 steps x 8 dims (the
    reference's full Table 6 run), then its evaluation; then the
    harness's D = 24 override for 3 steps.  Launch counts (2 K6 and 2 K7b
    a step, 2 K6 an eval batch) and rates; ``launches`` is both runs'."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.classify import (EVAL_BATCH, TS_CLASSES,
                                             timeseries_data,
                                             train_eval_classifier)

    batch, length, dims, n_eval = 32, 512, 8, 64
    train_data, eval_data = timeseries_data(4 * batch, n_eval, length=length,
                                            dims=dims, n_classes=TS_CLASSES,
                                            seed=SEED)
    runs, total = {}, dict.fromkeys(LAUNCHES, 0)
    for tag, c, steps in (("full", cfg, 5),
                          ("harness D=24", dataclasses.replace(
                              cfg, **TS_HARNESS), 3)):
        torch.cuda.synchronize()
        reset_launches()
        out = train_eval_classifier(c, train_data, eval_data,
                                    n_classes=TS_CLASSES, in_dim=dims,
                                    steps=steps, batch=batch, seed=SEED,
                                    device=DEVICE)
        launches = dict(LAUNCHES)
        hist = out["history"]
        if len(hist) != steps or not all(math.isfinite(x) for x in hist + [
                out["loss"]]) or out["backends"] != ["cuda_nc"]:
            raise AssertionError(f"time series {tag}: losses {hist}, eval "
                                 f"{out['loss']}, bound {out['backends']}")
        expect_launches(launches, c.n_layers * (
            steps + -(-n_eval // EVAL_BATCH)), c.n_layers * steps,
            f"time series {tag}")
        step_ms = 1e3 * statistics.median(out["step_s"][1:])
        runs[tag] = {"steps": steps, "batch": batch, "length": length,
                     "dims": dims, "d_model": c.d_model,
                     "head_dim": c.dim_head, "step_ms": step_ms,
                     "first_step_ms": 1e3 * out["step_s"][0],
                     "tokens_per_s": batch * length / step_ms * 1e3,
                     "eval_ms": 1e3 * out["eval_s"], "eval_loss": out["loss"],
                     "eval_acc": out["acc"], "history": hist,
                     "launches": launches}
        total = {k: total[k] + launches[k] for k in total}
    print("[time series bf16] " + json.dumps(runs), flush=True)
    return {**runs["full"], "harness": runs["harness D=24"],
            "launches": total}


# --- the mamba2_1p3b slice: K9, K10a, K10b -----------------------------------

SSD_SHAPE = dict(bsz=4, heads=64, n=4096, p=64, s=128)  # the training shape
#: profile keys: every CUDA kernel of a K10a call is named ssd_fwd_*, of a
#: K10b call ssd_bwd_*
SSD_K10 = {"k10a_ms_per_step": "ssd_fwd_", "k10b_ms_per_step": "ssd_bwd_"}
#: phase 14 with bf16 conv histories: the logits' tolerance grows by this
#: share of max |logit| per generated token.  The admission's logits use no
#: history (1e-4 holds); after it the drift grew by ~4.5e-4 per step on an
#: H100 (1.1e-3 at the 3rd token, 7.0e-3 at the 16th), the tolerance by
#: about three times that.
SSD_BF16_CONV_DRIFT = 1.5e-3


def ssd_operands(bsz, heads, n, p, s, seed, strong=False):
    """x (BH, N, P), dta (BH, N, 1), bmat and cmat (B, N, S), fp32 on the
    card, in the ranges of the training path (dta = dt A <= 0; -50 per
    position for strong decay)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda *sh: torch.randn(sh, generator=gen, device=DEVICE)  # noqa: E731
    x = mk(bsz * heads, n, p) * 0.5
    dta = (torch.full((bsz * heads, n, 1), -50.0, device=DEVICE) if strong
           else -torch.rand((bsz * heads, n, 1), generator=gen,
                            device=DEVICE) * 0.2)
    return x, dta, mk(bsz, n, s) * 0.5, mk(bsz, n, s) * 0.5


def heads_view(t, heads):
    """(B, N, S) -> the (B, H, N, S) view with head stride 0."""
    return t[:, None].expand(t.shape[0], heads, *t.shape[1:])


def check_ssd() -> dict:
    """Phase 3e: K10a (both variants), K10b (through ``SSDChunkDot``) and
    K9 against their plain versions; returns each one's max |error| at
    the main path's shape."""
    from repro_torch.kernels.gather import (boundary_gather,
                                            boundary_gather_many,
                                            boundary_gather_many_ref,
                                            boundary_gather_ref)
    from repro_torch.kernels.ssd_chunk import (SSDChunkDot, ssd_chunk_call,
                                               ssd_chunk_chunked)
    from repro_torch.kernels.ssd_chunk.ops import scan_chunk

    errs = {}
    cases = [(SSD_SHAPE["bsz"], SSD_SHAPE["heads"], SSD_SHAPE["n"], False),
             (2, 8, 96, False), (2, 8, 200, False),
             (2, 8, 512, True)]
    for i, (bsz, heads, n, strong) in enumerate(cases):
        p, s = SSD_SHAPE["p"], SSD_SHAPE["s"]
        chunk = scan_chunk(n, 128)
        x, dta, bm, cm = ssd_operands(bsz, heads, n, p, s, SEED + 70 + i,
                                      strong)
        b4, c4 = heads_view(bm, heads), heads_view(cm, heads)
        tag = (f"fp32 B={bsz} H={heads} N={n} chunk={chunk}"
               + (" dta=-50" if strong else ""))
        with torch.no_grad():
            y, hins = ssd_chunk_call(x, dta, b4, c4, chunk=chunk,
                                     return_hins=True)
            y0 = ssd_chunk_call(x, dta, b4, c4, chunk=chunk)
            ry, rh = ssd_chunk_chunked(x, dta, b4, c4, chunk)
            torch.cuda.synchronize()
            e_h = max(dot_close(f"ssd_chunk_hins {tag} y", y, ry),
                      dot_close(f"ssd_chunk_hins {tag} hins", hins, rh))
            e_y = dot_close(f"ssd_chunk {tag} y", y0, ry)
        g = torch.randn(x.shape, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED + 80 + i), device=DEVICE)
        grads = {}
        for route in ("kernel", "plain"):
            leaves = [t.clone().requires_grad_(True) for t in (x, dta, bm, cm)]
            out = (SSDChunkDot.apply(*leaves, chunk) if route == "kernel"
                   else ssd_chunk_chunked(*leaves, chunk)[0])
            grads[route] = torch.autograd.grad(out, leaves, g)
            del out, leaves
        torch.cuda.synchronize()
        e_b = max(dot_close(f"ssd_chunk_bwd {tag} d{name}", a, b)
                  for name, a, b in zip(("x", "dta", "b", "c"),
                                        grads["kernel"], grads["plain"]))
        print(f"[K10] {tag}: K10a {e_y:.3e}, K10a+hins {e_h:.3e}, K10b "
              f"{e_b:.3e}", flush=True)
        if i == 0:
            errs.update(ssd_chunk=e_y, ssd_chunk_hins=e_h, ssd_chunk_bwd=e_b)
        del grads, x, dta, bm, cm, b4, c4, y, hins, y0, ry, rh, g
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 90)
    lens = ragged_lens(np.random.default_rng(SEED + 90), 16, 0, 512)
    lens[:5] = (0, 1, 2, 3, 512)
    lengths = torch.tensor(lens, device=DEVICE)
    for w in (4096, 128):
        for dtype in (torch.bfloat16, torch.float32):
            xb = torch.randn((16, 512, w), generator=gen,
                             device=DEVICE).to(dtype)
            with torch.inference_mode():
                got = boundary_gather(xb, lengths, 4)
                want = boundary_gather_ref(xb, lengths, 4)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"boundary_gather W={w} {dtype}: not "
                                     "exact")
    # one layer's x, B and C streams in one launch; unaligned widths
    for widths in ((4096, 128, 128), (3, 5, 6, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            xs = tuple(torch.randn((16, 512, w), generator=gen,
                                   device=DEVICE).to(dtype) for w in widths)
            with torch.inference_mode():
                got = boundary_gather_many(xs, lengths, 4)
                want = boundary_gather_many_ref(xs, lengths, 4)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"boundary_gather_many W={widths} "
                                     f"{dtype}: not exact")
    print("[K9] 16 rows x Lb 512, W 4096 and 128, bf16 and fp32, lengths "
          f"{sorted(set(lens.tolist()))[:6]}...; three streams (W 4096, 128, "
          "128) and unaligned (W 3, 5, 6, 128) in one launch: exact",
          flush=True)
    errs["boundary_gather"] = 0.0
    return errs


def ssd_state_bytes_per_slot(cfg) -> int:
    """The decode state of one slot: per layer h (H, P, S) fp32 and three
    bf16 conv histories of K - 1 rows (x: d_inner wide, B and C: S)."""
    s = cfg.ssd
    d_in = s.expand * cfg.d_model
    h = (d_in // s.head_dim) * s.head_dim * s.d_state * 4
    conv = (s.conv_width - 1) * (d_in + 2 * s.d_state) * 2
    return cfg.n_layers * (h + conv)


def serve_ssd_full_width(params, cfg) -> dict:
    """Phase 13: the bf16 Engine serving the full-width mamba2_1p3b; K9
    launches, rates and the pools' bytes."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.quant import pool_bytes

    engine = Engine(params, cfg, slots=16, max_len=512, seed=SEED,
                    device=DEVICE)
    reqs = requests(np.random.default_rng(SEED + 4), 48, cfg.vocab_size,
                    (16, 384), (32, 64))
    for r in reqs:
        engine.submit(r)
    worker = engine.worker
    spent = timed_worker(worker)
    torch.cuda.synchronize()
    reset_launches()
    done = engine.run()
    launches = dict(LAUNCHES)
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests retired")
    for r in done:
        if not r.done or len(r.generated) != r.max_new_tokens or not all(
                0 <= tok < cfg.vocab_size for tok in r.generated):
            raise AssertionError(f"request {r.uid}: {r.generated}")
    rounds, steps = worker.admission_rounds, worker.decode_steps
    want = {**dict.fromkeys(KERNELS, 0),
            "boundary_gather": cfg.n_layers * rounds}
    if launches != want:
        raise AssertionError(f"mamba2 serving launched {launches}, want "
                             f"{want}")
    per_slot = ssd_state_bytes_per_slot(cfg)
    n_bytes = pool_bytes(worker.caches)
    if n_bytes != 16 * per_slot:
        raise AssertionError(f"pool_bytes {n_bytes} != 16 x {per_slot}")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    stats = {
        "requests": len(reqs), "admission_rounds": rounds,
        "decode_steps": steps, "prompt_tokens": prompt_tokens,
        "decode_tokens": decode_tokens,
        "prefill_s": spent["prefill"], "decode_s": spent["step"],
        "prefill_tok_per_s": prompt_tokens / spent["prefill"],
        "decode_tok_per_s": decode_tokens / spent["step"],
        "decode_ms_per_step": 1e3 * spent["step"] / steps,
        "launches": launches, "pool_bytes": n_bytes,
        "pool_bytes_per_slot": n_bytes // 16}
    print("[engine mamba2 bf16] " + json.dumps(stats), flush=True)
    return stats


def serve_ssd_fp32_against_oracle(params, cfg, conv_dtype=torch.float32,
                                  drift=0.0, speculate_k=0):
    """Phase 14: the fp32 Engine (packed admission through K9) against a
    per-request greedy oracle on the card: unpacked ``lm.prefill`` (the
    conv history from ``_causal_conv``'s tail, no K9), then ``lm.decode``,
    teacher-forced with the Engine's tokens.  Every logit the Engine
    computed for a request's t-th token must lie within rtol_t, atol
    rtol_t x max |logit| of the oracle's, rtol_t = 1e-4 + ``drift`` t.

    ``layers.ssd.CONV_DTYPE`` is bound to ``conv_dtype`` for both paths
    (restored after).  With fp32 histories (no drift) only fp32 order
    differs, and the greedy tokens must be identical: the check sees the
    packing itself.  With the configuration's bf16 histories the two paths
    round fp32 values that their GEMMs summed at other shapes (8-slot
    batches and 16-row packed prefills against one row); a history element
    can land on the neighbouring bf16 value, and the logits drift apart
    step by step (``SSD_BF16_CONV_DRIFT``), so a token is held only where
    the oracle's top-2 margin exceeds twice the tolerance of its top
    logit.  With ``speculate_k`` (phase 20) the Engine decodes by
    self-drafted windows, and each committed token's verify row is held
    the same way."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.layers import ssd as ssd_layer
    from repro_torch.models import lm

    exact = conv_dtype == torch.float32
    bound_dtype = ssd_layer.CONV_DTYPE
    ssd_layer.CONV_DTYPE = conv_dtype
    try:
        got, seen, reqs, weights = _serve_recording_logits(params, cfg,
                                                           speculate_k)
        reset_launches()
        oracle = {}
        for r in reqs:  # teacher-forced with the Engine's tokens
            with torch.inference_mode():
                logits, caches = lm.prefill(
                    weights, torch.tensor(r.prompt[None], device=DEVICE), cfg,
                    max_len=256, dtype=torch.float32)
                oracle[r.uid] = [logits[0, -1]]
                for t, tok in enumerate(got[r.uid][:-1]):
                    logits, caches = lm.decode(
                        weights, torch.tensor([[tok]], device=DEVICE), caches,
                        cfg, len(r.prompt) + t, dtype=torch.float32)
                    oracle[r.uid].append(logits[0, -1])
    finally:
        ssd_layer.CONV_DTYPE = bound_dtype
    if LAUNCHES["boundary_gather"]:
        raise AssertionError("the unpacked oracle launched K9")
    tag = f"mamba2 fp32, {str(conv_dtype)[6:]} conv histories" + (
        f", speculative k={speculate_k}" if speculate_k else "")
    by_step, n_tok, near_ties = {}, 0, 0
    for r in reqs:
        gen = got[r.uid]
        if len(seen[r.uid]) != len(gen):
            raise AssertionError(f"request {r.uid}: {len(seen[r.uid])} "
                                 f"logit rows for {len(gen)} tokens")
        for t, (want, have) in enumerate(zip(oracle[r.uid], seen[r.uid])):
            scale, rtol = float(want.abs().max()), 1e-4 + drift * t
            top = torch.topk(want, 2)
            margin = float(top.values[0] - top.values[1])
            if gen[t] != int(top.indices[0]):
                tie = margin <= 2 * rtol * (scale + float(top.values[0].abs()))
                if exact or not tie:
                    raise AssertionError(
                        f"{tag}, request {r.uid} token {t}: Engine {gen[t]}, "
                        f"oracle {int(top.indices[0])}, oracle top-2 margin "
                        f"{margin:.3e}")
                near_ties += 1
            err = max_err(f"{tag}, request {r.uid} token {t} logits", have,
                          want, (rtol, rtol * scale))
            by_step[t] = max(by_step.get(t, 0.0), err / scale)
            n_tok += 1
    print(f"[{tag}] packed admission (K9)"
          + (" and verify windows" if speculate_k else "")
          + " vs the per-request oracle: "
          f"{n_tok - near_ties} of {n_tok} greedy tokens of {len(reqs)} "
          f"requests agree ({near_ties} near ties); logits within "
          f"{max(by_step.values()):.3e} of max |logit| (rtol 1e-4 + "
          f"{drift:g} t), by step "
          f"{[float(f'{by_step[t]:.2e}') for t in sorted(by_step)]}",
          flush=True)


def _serve_recording_logits(params, cfg, speculate_k=0):
    """Phase 14's Engine run: 12 requests of mixed lengths through 8 fp32
    slots (with ``speculate_k``, self-drafted verify windows); returns the
    generations, each request's logits row of every committed token
    (admission included), the requests and the Engine's weights."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    engine = Engine(params, cfg, slots=8, max_len=256, seed=SEED,
                    dtype=torch.float32, speculate_k=speculate_k,
                    device=DEVICE)
    worker, sched = engine.worker, engine.scheduler
    reqs = requests(np.random.default_rng(SEED + 5), 12, cfg.vocab_size,
                    (16, 128), (16, 16))
    for r in reqs:
        engine.submit(r)
    uid_of = {id(r.prompt): r.uid for r in reqs}
    seen = {r.uid: [] for r in reqs}
    real = {"prefill": lm.prefill, "decode": lm.decode, "verify": lm.verify}
    last = {}

    def recording(name):
        def run(*a, **kw):
            last["logits"], caches = real[name](*a, **kw)
            return last["logits"], caches
        return run

    real_prefill, real_step, real_window = (worker.prefill, worker.step,
                                            worker.verify)

    def admit(prompts, slot_ids, temps, **kw):
        first = real_prefill(prompts, slot_ids, temps, **kw)
        for row, prompt in enumerate(prompts):
            seen[uid_of[id(prompt)]].append(last["logits"][row, -1].clone())
        return first

    def step(tokens, pos, temps, live):
        toks = real_step(tokens, pos, temps, live)
        for slot in np.flatnonzero(live):
            seen[sched.active[slot].uid].append(
                last["logits"][slot, -1].clone())
        return toks

    def window(tokens, drafts, pos, temps, live):
        uids = [None if r is None else r.uid for r in sched.active]
        emitted, accepted = real_window(tokens, drafts, pos, temps, live)
        for slot in np.flatnonzero(live):  # the rows of committed tokens
            seen[uids[slot]].extend(last["logits"][slot, j].clone()
                                    for j in range(accepted[slot] + 1))
        return emitted, accepted

    worker.prefill, worker.step, worker.verify = admit, step, window
    lm.prefill, lm.decode = recording("prefill"), recording("decode")
    lm.verify = recording("verify")
    reset_launches()
    try:
        got = {r.uid: r.generated for r in engine.run()}
    finally:
        lm.prefill, lm.decode = real["prefill"], real["decode"]
        lm.verify = real["verify"]
    for uid, gen in got.items():  # a budget truncates a request's last
        del seen[uid][len(gen):]  # window: its rows past the budget go
    if LAUNCHES["boundary_gather"] != cfg.n_layers * (
            worker.admission_rounds):
        raise AssertionError(f"fp32 mamba2 serving launches {LAUNCHES}")
    return got, seen, reqs, worker.params


def train_ssd_full_width(cfg) -> dict:
    """Phase 15: the trainer at full width in bf16, 5 steps of 4 x 4,096;
    K10a with carry-ins twice per layer and step (the forward and its
    remat recompute), K10b once, nothing else; then one no-grad
    evaluation forward of a batch: K10a without carry-ins once per layer."""
    from repro_torch.data.loader import lm_loader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.launch.train import train
    from repro_torch.models import lm

    steps, batch, seq = 5, SSD_SHAPE["bsz"], SSD_SHAPE["n"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the peak of this phase alone
    reset_launches()
    out = train(cfg, steps=steps, batch=batch, seq=seq, seed=SEED,
                device=DEVICE)
    launches = dict(LAUNCHES)
    hist = out["history"]
    if len(hist) != steps or not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"mamba2 training losses {hist}")
    n = cfg.n_layers * steps
    want = {**dict.fromkeys(KERNELS, 0), "ssd_chunk_hins": 2 * n,
            "ssd_chunk_bwd": n}
    if launches != want:
        raise AssertionError(f"mamba2 training launched {launches}, want "
                             f"{want}")
    evaluated = {k: torch.from_numpy(v).to(DEVICE) for k, v in next(lm_loader(
        SEED + 3, batch=batch, seq=seq, vocab=cfg.vocab_size)).items()}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = lm.loss_fn(out["state"].master, evaluated, cfg)
        eval_loss = float(loss)
    eval_ms = 1e3 * (time.perf_counter() - t0)
    want = {**dict.fromkeys(KERNELS, 0), "ssd_chunk": cfg.n_layers}
    if dict(LAUNCHES) != want or not math.isfinite(eval_loss):
        raise AssertionError(f"mamba2 evaluation launched {LAUNCHES}, loss "
                             f"{eval_loss}")
    step_ms = 1e3 * statistics.median(out["step_s"][1:])
    stats = {"steps": steps, "batch": batch, "seq": seq,
             "first_step_ms": 1e3 * out["step_s"][0], "step_ms": step_ms,
             "tokens_per_s": batch * seq / step_ms * 1e3,
             "history": hist, "launches": launches,
             "eval_loss": eval_loss, "eval_forward_ms": eval_ms,
             "eval_launches": {"ssd_chunk": cfg.n_layers},
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("[train mamba2 bf16] " + json.dumps(stats), flush=True)
    stats["launches"] = {**launches, "ssd_chunk": cfg.n_layers}
    return stats


def train_ssd_fp32_both_paths(cfg, steps=3):
    """Phase 16: fp32 training at full width and 2 layers, 4 x 4,096, on
    the kernels and on the plain path -- ``ssd_scan`` bound with
    ``interpret=True`` in ``layers.ssd``'s namespace, as the reference
    runs its kernel off the TPU -- per-step losses and the first step's
    in_x/in_b/in_c/in_dt/a_log/dt_bias gradients."""
    import functools

    from repro_torch.data.loader import lm_loader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.launch.train import train
    from repro_torch.layers import ssd as ssd_layer
    from repro_torch.models import lm
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(cfg, n_layers=2)
    batch, seq = SSD_SHAPE["bsz"], SSD_SHAPE["n"]
    params = lm.init(cfg, torch.Generator().manual_seed(SEED + 2),
                     device=DEVICE)
    first = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             next(lm_loader(SEED, batch=batch, seq=seq,
                            vocab=cfg.vocab_size)).items()}
    names = ("in_x", "in_b", "in_c", "in_dt", "a_log", "dt_bias")
    kernel_scan, hist, grads = ssd_layer.ssd_scan, {}, {}
    for route in ("kernels", "plain"):
        if route == "plain":
            ssd_layer.ssd_scan = functools.partial(kernel_scan, interpret=True)
        try:
            leaves = tree_map(lambda x: x.detach().clone().requires_grad_(
                True), params)
            loss, _ = lm.loss_fn(leaves, first, cfg, dtype=torch.float32)
            loss.backward()
            grads[route] = {
                f"layer {i} {w}": (blk["ssd"][w]["w"] if isinstance(
                    blk["ssd"][w], dict) else blk["ssd"][w]).grad
                for i, blk in enumerate(leaves["blocks"]) for w in names}
            del leaves, loss
            torch.cuda.synchronize()
            reset_launches()
            hist[route] = train(cfg, steps=steps, batch=batch, seq=seq,
                                seed=SEED, device=DEVICE, dtype=torch.float32,
                                params=params)["history"]
        finally:
            ssd_layer.ssd_scan = kernel_scan
        n = cfg.n_layers * steps
        want = dict.fromkeys(KERNELS, 0)
        if route == "kernels":
            want.update(ssd_chunk_hins=2 * n, ssd_chunk_bwd=n)
        if dict(LAUNCHES) != want:
            raise AssertionError(f"mamba2 fp32 {route}: launches {LAUNCHES}, "
                                 f"want {want}")
    for i, (a, b) in enumerate(zip(hist["kernels"], hist["plain"])):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"mamba2 fp32 step {i} loss: kernels {a}, "
                                 f"plain {b}")
    worst = 0.0
    for name, g in grads["kernels"].items():
        ref = grads["plain"][name]
        scale, err = float(ref.abs().max()), float((g - ref).abs().max())
        if not float(g.abs().max()) > 0 or not err <= 1e-4 * scale:
            raise AssertionError(f"mamba2 fp32 step 1 {name} grad: |diff| "
                                 f"{err:.3e}, max |plain| {scale:.3e}, max "
                                 f"|kernels| {float(g.abs().max()):.3e}")
        worst = max(worst, err / scale)
    print(f"[train mamba2 fp32] kernels vs plain, 2 layers x {steps} steps of "
          f"{batch} x {seq}: losses {hist['kernels']} vs {hist['plain']}; "
          f"{'/'.join(names)} grads of step 1 non-zero, worst |diff| / max "
          f"|grad| {worst:.3e}", flush=True)


# --- the softmax baseline from paged KV pools: K8a, K8b -----------------------
PAGE = 64  # the serving page size (``--page-size``'s default)
PAGED_POOL = 64  # pages: half the dense-equivalent 16 x 512 / 64 = 128
#: (P, Hkv, page, D, Dv, B, MP): the serving shape (the dense-equivalent
#: pool), a narrow one with D != Dv, and one whose runs K8b's copy engine
#: does not take (page 5: 20 bytes of scales; widths not a multiple of 16)
PAGED_SHAPES = ((128, 8, PAGE, 64, 64, 16, 8), (32, 2, 8, 16, 32, 5, 6),
                (12, 2, 5, 24, 40, 3, 3))


def softmax_cfg(cfg):
    """The Transformer baseline of ``cfg``: ``attention.kind="softmax"``,
    made as the reference's ``--attn softmax`` makes it."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind="softmax"))


def paged_operands(p, hkv, page, d, dv, b, mp, seed):
    """bf16/fp32-ready pools, int8 payloads with fp32 scales, and a
    shuffled, partly mapped table: distinct pages, the sentinel P on the
    second half of row 0 and on the whole of row B - 1 (a dead slot)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    kc = torch.randn((p, hkv, page, d), generator=gen, device=DEVICE)
    vc = torch.randn((p, hkv, page, dv), generator=gen, device=DEVICE)
    table = torch.randperm(p, generator=gen, device=DEVICE)[:b * mp]
    table = table.view(b, mp).to(torch.int32).contiguous()
    table[0, mp // 2:] = p
    table[-1] = p
    kq, vq = ((x * 40).round().clamp(-127, 127).to(torch.int8)
              for x in (kc, vc))
    ks, vs = (torch.rand(x.shape[:3] + (1,), generator=gen, device=DEVICE)
              for x in (kc, vc))
    return kc, vc, table, kq, vq, ks, vs


def check_paged_gather() -> dict:
    """Phase 3f: K8a and K8b against their plain versions, exactly, at the
    serving shape, a narrow one and an odd one, bf16 and fp32 pools and
    outputs; two K8b calls bitwise equal."""
    from repro_torch.kernels.gather import (paged_gather, paged_gather_quant,
                                            paged_gather_quant_ref,
                                            paged_gather_ref)

    for shape in PAGED_SHAPES:
        kc, vc, table, kq, vq, ks, vs = paged_operands(*shape, SEED + 100)
        for dtype in (torch.bfloat16, torch.float32):
            with torch.inference_mode():
                pools = (kc.to(dtype), vc.to(dtype))
                cases = {
                    "paged_gather": (paged_gather(*pools, table),
                                     paged_gather_ref(*pools, table)),
                    "paged_gather_quant": (
                        paged_gather_quant(kq, vq, ks, vs, table,
                                           out_dtype=dtype),
                        paged_gather_quant_ref(kq, vq, ks, vs, table,
                                               out_dtype=dtype))}
                again = paged_gather_quant(kq, vq, ks, vs, table,
                                           out_dtype=dtype)
            torch.cuda.synchronize()
            for name, (got, want) in cases.items():
                for part, a, b in zip("kv", got, want):
                    if a.dtype != dtype or not torch.equal(a, b):
                        raise AssertionError(f"{name} {part} {shape} {dtype}:"
                                             " not exact")
            if not all(torch.equal(a, b) for a, b in
                       zip(again, cases["paged_gather_quant"][0])):
                raise AssertionError(f"paged_gather_quant {shape} {dtype}: "
                                     "two calls differ")
    print(f"[K8] K8a and K8b at (P, Hkv, page, D, Dv, B, MP) {PAGED_SHAPES}, "
          "bf16 and fp32, sentinel rows: exact; two K8b calls bitwise "
          "equal", flush=True)
    return {"paged_gather": 0.0, "paged_gather_quant": 0.0}


def timed_calls(obj, names) -> dict:
    """Wrap the methods ``names`` of ``obj`` with host clocks; each of the
    serving calls wrapped ends in a device-to-host copy (or in nothing on
    the device), so each is synchronized.  Returns the seconds spent per
    name, filled as the engine runs."""
    spent = dict.fromkeys(names, 0.0)

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            spent[key] += time.perf_counter() - t0
            return res
        return run

    for name in names:
        setattr(obj, name, timed(getattr(obj, name), name))
    return spent


def timed_worker(worker) -> dict:
    """``timed_calls`` of the worker's prefill and step."""
    return timed_calls(worker, ("prefill", "step"))


def serve_paged_full_width(params, cfg, state_dtype=None) -> dict:
    """Phase 17 (17b with ``state_dtype="int8"``): the bf16 Engine serving
    the softmax baseline from a 64-page pool, phase 5's traffic; launch
    counts, rates, admission rounds the pool cut short, the pools'
    bytes, and every page back on the free list after the drain."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.layers.attention import plan_of
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, PagedSpec
    from repro_torch.serving.quant import pool_bytes, trash_bytes

    engine = Engine(params, cfg, slots=16, max_len=512, seed=SEED,
                    paged=PagedSpec(PAGE, PAGED_POOL),
                    state_dtype=state_dtype, device=DEVICE)
    reqs = requests(np.random.default_rng(SEED + 4), 48, cfg.vocab_size,
                    (16, 384), (32, 64))
    for r in reqs:
        engine.submit(r)
    worker = engine.worker
    spent = timed_worker(worker)
    # each admission pass (one per step while requests wait) that the pool
    # stopped before the queue or the free slots ran out
    held, can_admit = [0], worker.can_admit

    def counted(*a, **kw):
        ok = can_admit(*a, **kw)
        held[0] += not ok
        return ok

    worker.can_admit = counted
    torch.cuda.synchronize()
    reset_launches()
    done = engine.run()
    launches = dict(LAUNCHES)
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests retired")
    for r in done:
        if not r.done or len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(r.generated)} of "
                                 f"{r.max_new_tokens} tokens")
        if not all(0 <= tok < cfg.vocab_size for tok in r.generated):
            raise AssertionError(f"request {r.uid}: token out of range")
    rounds, steps = worker.admission_rounds, worker.decode_steps
    name = "paged_gather_quant" if state_dtype == "int8" else "paged_gather"
    want = {name: cfg.n_layers * steps}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"paged launches {launches}, want {want}")
    alloc = worker.allocator
    if alloc.free_pages != alloc.num_pages != PAGED_POOL or \
            not (alloc.table == alloc.sentinel).all():
        raise AssertionError(f"{alloc.free_pages} of {alloc.num_pages} pages "
                             "free after the drain")
    if not held[0]:
        raise AssertionError("the pool never held admission back")
    per_token = cfg.kv_heads * cfg.dim_head * 2  # k and v
    width = 1 + 4 / cfg.dim_head if state_dtype == "int8" else 2
    pages = int(cfg.n_layers * PAGED_POOL * PAGE * per_token * width)
    paged_bytes = pool_bytes(worker.caches)
    pos_bytes = cfg.n_layers * 16 * 4 * (2 if state_dtype == "int8" else 1)
    if paged_bytes != pages + pos_bytes:
        raise AssertionError(f"pool_bytes {paged_bytes}, want {pages} + "
                             f"{pos_bytes}")
    dense = lm.init_caches(cfg, 16, 512, plan=plan_of(
        cfg, state_dtype=state_dtype), dtype=torch.bfloat16, device=DEVICE)
    dense_bytes = pool_bytes(dense)
    del dense
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    stats = {
        "requests": len(reqs), "admission_rounds": rounds,
        "admission_passes_held_by_the_pool": held[0],
        "decode_steps": steps, "prompt_tokens": prompt_tokens,
        "decode_tokens": decode_tokens,
        "prefill_s": spent["prefill"], "decode_s": spent["step"],
        "prefill_tok_per_s": prompt_tokens / spent["prefill"],
        "decode_tok_per_s": decode_tokens / spent["step"],
        "launches": launches, "pool_pages": alloc.num_pages,
        "free_pages_after_drain": alloc.free_pages,
        "pool_bytes": paged_bytes, "page_bytes": pages,
        "pos_bytes": pos_bytes, "trash_page_bytes": trash_bytes(worker.caches),
        "dense_pool_bytes": dense_bytes}
    tag = "" if state_dtype is None else f", {state_dtype} pools"
    print(f"[engine softmax paged bf16{tag}] " + json.dumps(stats), flush=True)
    return stats


def bind_plain_gathers():
    """Bind ``interpret=True`` into the attention layer's page-table
    gathers (the plain path on the card); returns the restoring call."""
    import functools

    from repro_torch.layers import attention as attn_layer

    real = attn_layer.paged_gather, attn_layer.paged_gather_quant
    attn_layer.paged_gather = functools.partial(real[0], interpret=True)
    attn_layer.paged_gather_quant = functools.partial(real[1],
                                                      interpret=True)

    def restore():
        attn_layer.paged_gather, attn_layer.paged_gather_quant = real
    return restore


def _paged_fp32_run(params, cfg, paged, state_dtype, record=None):
    """Phase 6's 12 requests through an fp32 Engine (8 slots, max_len 256);
    with ``record`` (a list), each decode step's (slot uids, logits,
    tokens)."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    engine = Engine(params, cfg, slots=8, max_len=256, seed=SEED, paged=paged,
                    dtype=torch.float32, state_dtype=state_dtype,
                    device=DEVICE)
    for r in requests(np.random.default_rng(SEED + 5), 12, cfg.vocab_size,
                      (16, 128), (16, 16)):
        engine.submit(r)
    real_decode, real_step, seen = lm.decode, engine.worker.step, {}

    def recording_decode(*a, **kw):
        seen["logits"], caches = real_decode(*a, **kw)
        return seen["logits"], caches

    def recording_step(*a, **kw):
        uids = [None if r is None else r.uid for r in engine.active]
        toks = real_step(*a, **kw)
        record.append((uids, seen["logits"][:, -1].float(), toks))
        return toks

    if record is not None:
        engine.worker.step = recording_step
        lm.decode = recording_decode
    try:
        done = {r.uid: r.generated for r in engine.run()}
    finally:
        lm.decode = real_decode
    return engine, done


def serve_paged_fp32(params, cfg):
    """Phase 18: the paged Engine in fp32 at full width.  (a) On the
    kernels and on the plain path (``bind_plain_gathers``), fp32 and int8
    pools of 24 pages (admission waits): identical greedy tokens.  (b)
    Paged (the dense-equivalent pool, so admission never waits and both
    runs take the same steps) against the dense Engine, step by step:
    logits within rtol 1e-4 and atol 1e-4 x max |logit|, and equal tokens
    wherever the dense run's top-2 margin clears twice that."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.engine import PagedSpec

    for state_dtype in (None, "int8"):
        runs = {}
        name = "paged_gather_quant" if state_dtype else "paged_gather"
        for path in ("kernels", "plain"):
            restore = bind_plain_gathers() if path == "plain" else None
            reset_launches()
            try:
                engine, runs[path] = _paged_fp32_run(
                    params, cfg, PagedSpec(PAGE, 24), state_dtype)
            finally:
                if restore:
                    restore()
            want = ({name: cfg.n_layers * engine.worker.decode_steps}
                    if path == "kernels" else {})
            if {k: v for k, v in LAUNCHES.items() if v} != want:
                raise AssertionError(f"paged fp32 {path} launches {LAUNCHES}"
                                     f", want {want}")
        if runs["kernels"] != runs["plain"]:
            raise AssertionError(f"paged fp32 ({state_dtype or 'fp32'} "
                                 "pools): kernels and plain tokens differ")
    n_tok = sum(len(g) for g in runs["plain"].values())
    steps = {}
    for kind, paged in (("dense", None), ("paged", PagedSpec(PAGE, 0))):
        steps[kind] = []
        _paged_fp32_run(params, cfg, paged, None, record=steps[kind])
    if len(steps["dense"]) != len(steps["paged"]):
        raise AssertionError("paged and dense runs took different steps")
    err, checked, ties, parted = 0.0, 0, 0, set()
    for i, ((uids, got, toks), (duids, want, dtoks)) in enumerate(
            zip(steps["paged"], steps["dense"])):
        if uids != duids:
            raise AssertionError(f"step {i}: slots {uids} != {duids}")
        scale = float(want.abs().max())
        rows = [j for j, u in enumerate(uids)
                if u is not None and u not in parted]
        if not rows:
            continue
        err = max(err, max_err(f"paged vs dense step {i} logits",
                               got[rows], want[rows], (1e-4, 1e-4 * scale)))
        top = torch.topk(want[rows], 2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]).cpu().numpy()
        tol = (1e-4 * scale + 1e-4 * top[:, 0].abs()).cpu().numpy()
        for row, m, t in zip(rows, margin, tol):
            if toks[row] == dtoks[row]:
                checked += 1
            elif m <= 2 * t:
                ties += 1
                parted.add(uids[row])  # a near tie: later logits part
            else:
                raise AssertionError(
                    f"step {i} slot {row}: paged {toks[row]}, dense "
                    f"{dtoks[row]}, margin {m:.3e}")
    print(f"[paged fp32] kernels and plain path agree on all {n_tok} greedy "
          f"tokens (fp32 and int8 pools of 24 pages); paged vs dense over "
          f"{len(steps['paged'])} steps: logits within {err:.3e}, {checked} "
          f"greedy tokens equal, {ties} near ties", flush=True)


SPEC_K = 4  # drafted tokens a verify window (``--speculate-k 4``)
#: phases 19 and 19b: the least share of a self draft's tokens the target
#: must accept.  A self draft is the target's own greedy decode, so it
#: differs from verify only by the window's fp32 order (bf16) and the
#: rounding of int8 pools; an H100 read 1.0 (bf16) and 0.968 (int8 pools).
#: A propose that drafted from the wrong positions, pages or state would
#: accept almost nothing.
SELF_DRAFT_MIN_ACCEPT = 0.9


def serve_speculative_full_width(params, cfg, state_dtype=None,
                                 draft="self") -> dict:
    """Phase 19 (19b with ``state_dtype="int8"``, 19c with ``draft="tiny"``):
    the bf16 Engine at full width, phase 5's weights and 48 requests, 16
    slots, speculative with ``SPEC_K`` drafts a window.  Every window must
    commit at least one token a live slot, a self draft must have at least
    ``SELF_DRAFT_MIN_ACCEPT`` of its tokens accepted (19c's random drafter
    is not held to a rate), and the kernels must run
    exactly where the path puts them: K1 once a layer and admission round
    (19c: on the drafter's pool too), K3 (19b: K4) once a layer and
    propose step (19c: the drafter's k + 1 steps), nothing else (verify is
    plain PyTorch on the card)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.engine import Engine

    engine = Engine(params, cfg, slots=16, max_len=512, seed=SEED,
                    state_dtype=state_dtype, draft=draft, speculate_k=SPEC_K,
                    device=DEVICE)
    reqs = requests(np.random.default_rng(SEED + 4), 48, cfg.vocab_size,
                    (16, 384), (32, 64))
    for r in reqs:
        engine.submit(r)
    worker, source = engine.worker, engine.draft
    spent_worker = timed_calls(worker, ("prefill", "verify"))
    spent_draft = timed_calls(source, ("admit", "propose"))
    windows = {"n": 0, "live": 0, "committed": 0, "accepted": 0}
    real_verify = worker.verify

    def checked_verify(tokens, drafts, pos, temps, live):
        emitted, accepted = real_verify(tokens, drafts, pos, temps, live)
        acc = accepted[live]
        if (acc < 0).any() or (acc > SPEC_K).any() or not (
                (emitted[live] >= 0) & (emitted[live] < cfg.vocab_size)
        ).all():
            raise AssertionError(f"window {windows['n']}: accepted {acc}")
        windows["n"] += 1
        windows["live"] += int(live.sum())
        windows["committed"] += int((acc + 1).sum())
        windows["accepted"] += int(acc.sum())
        return emitted, accepted

    worker.verify = checked_verify
    torch.cuda.synchronize()
    reset_launches()
    done = engine.run()
    launches = dict(LAUNCHES)
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests retired")
    for r in done:
        if not r.done or len(r.generated) != r.max_new_tokens or not all(
                0 <= tok < cfg.vocab_size for tok in r.generated):
            raise AssertionError(f"request {r.uid}: {r.generated}")
    n, layers = windows["n"], cfg.n_layers
    if worker.verify_windows != n or worker.decode_steps or not n:
        raise AssertionError(f"{worker.verify_windows} windows, "
                             f"{worker.decode_steps} decode steps")
    want = {"flow_fused": layers * worker.admission_rounds}
    if draft == "tiny":
        dlayers, pool = source.cfg.n_layers, source.pool
        want["flow_fused"] += dlayers * pool.admission_rounds
        want["flow_decode"] = dlayers * (SPEC_K + 1) * n
    else:
        decode = "flow_decode_q" if state_dtype == "int8" else "flow_decode"
        want[decode] = layers * SPEC_K * n
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"speculative launches {launches}, want {want}")
    share = windows["accepted"] / (SPEC_K * windows["live"])
    if draft == "self" and share < SELF_DRAFT_MIN_ACCEPT:
        raise AssertionError(f"self draft: {share:.4f} of the drafts "
                             f"accepted, want >= {SELF_DRAFT_MIN_ACCEPT}")
    spent = {**spent_worker, **spent_draft}
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    window_s = spent["propose"] + spent["verify"]
    stats = {
        "requests": len(reqs), "draft": type(source).__name__,
        "speculate_k": SPEC_K, "admission_rounds": worker.admission_rounds,
        "windows": n, "live_slot_windows": windows["live"],
        "committed_tokens_per_window": windows["committed"] / n,
        "committed_tokens_per_live_slot_window":
            windows["committed"] / windows["live"],
        "accepted_draft_share": share,
        "propose_ms_per_window": 1e3 * spent["propose"] / n,
        "verify_ms_per_window": 1e3 * spent["verify"] / n,
        "decode_tokens": decode_tokens,
        "decode_tok_per_s": decode_tokens / window_s,
        "prefill_s": spent["prefill"] + spent["admit"],
        "k1_launches": launches["flow_fused"],
        "k3_launches": launches["flow_decode"],
        "k4_launches": launches["flow_decode_q"], "launches": launches}
    tag = f"speculative bf16, {draft} draft" + (
        "" if state_dtype is None else f", {state_dtype} pools")
    print(f"[{tag}] " + json.dumps(stats), flush=True)
    return stats


def speculative_fp32_equal(params, cfg, tag, *, paged=None, draft="self",
                           k=SPEC_K) -> dict:
    """Phase 20: phase 6's 12 requests through the fp32 speculative Engine
    and through the plain fp32 Engine, both on the kernels: the greedy
    tokens must be identical (a request's first divergence and the plain
    logits' top-2 margin there are printed before the run fails).  Returns
    the speculative run's launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    runs = {}
    for name in ("plain", "speculative"):
        spec = name == "speculative"
        engine = Engine(params, cfg, slots=8, max_len=256, seed=SEED,
                        paged=paged, dtype=torch.float32,
                        draft=draft if spec else None,
                        speculate_k=k if spec else 0, device=DEVICE)
        for r in requests(np.random.default_rng(SEED + 5), 12,
                          cfg.vocab_size, (16, 128), (16, 16)):
            engine.submit(r)
        torch.cuda.synchronize()
        reset_launches()
        runs[name] = {r.uid: r for r in engine.run()}
        if spec:
            launches, windows = dict(LAUNCHES), engine.worker.verify_windows
    for uid, r in runs["plain"].items():
        got = runs["speculative"][uid].generated
        if got == r.generated:
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, r.generated))
                 if a != b)
        prefix = np.concatenate([r.prompt, np.asarray(r.generated[:j],
                                                      np.int32)])
        with torch.inference_mode():
            logits, _ = lm.forward(lm.for_serving(params, DEVICE,
                                                  torch.float32),
                                   torch.tensor(prefix[None], device=DEVICE),
                                   cfg, dtype=torch.float32)
        top = torch.topk(logits[0, -1], 2).values
        print(f"[speculative fp32, {tag}] request {uid} diverges at generated"
              f" token {j}: speculative {got[j]}, plain {r.generated[j]}, "
              f"top-2 margin {float(top[0] - top[1]):.3e} of max |logit| "
              f"{float(logits[0, -1].abs().max()):.3e}", flush=True)
        raise AssertionError(f"speculative fp32 ({tag}): greedy tokens "
                             f"differ for request {uid}")
    n_tok = sum(len(r.generated) for r in runs["plain"].values())
    print(f"[speculative fp32, {tag}] speculative and plain agree on all "
          f"{len(runs['plain'])} requests ({n_tok} greedy tokens) in "
          f"{windows} windows; speculative launches "
          f"{ {n: v for n, v in launches.items() if v} }", flush=True)
    return {"launches": launches, "windows": windows}


def ssd_speculative_fp32_equal(params, cfg) -> dict:
    """Phase 20's mamba2 case, as phase 14 holds packed against unpacked
    decoding: with ``layers.ssd.CONV_DTYPE`` bound to fp32 in both Engines
    the greedy tokens must be identical.  With the configuration's bf16
    histories a history element that the runs' GEMMs (other shapes in the
    verify window) put on either side of a bf16 rounding boundary moves
    the logits step by step, so the speculative Engine is held to phase
    14's per-request oracle with phase 14's bound
    (``serve_ssd_fp32_against_oracle``, ``SSD_BF16_CONV_DRIFT``): a token
    may differ from the oracle's argmax only at a near tie.  Returns the
    fp32-history speculative run's launches."""
    from repro_torch.layers import ssd as ssd_layer

    bound_dtype = ssd_layer.CONV_DTYPE
    ssd_layer.CONV_DTYPE = torch.float32
    try:
        exact = speculative_fp32_equal(params, cfg,
                                       "mamba2, fp32 conv histories")
    finally:
        ssd_layer.CONV_DTYPE = bound_dtype
    serve_ssd_fp32_against_oracle(params, cfg, torch.bfloat16,
                                  drift=SSD_BF16_CONV_DRIFT,
                                  speculate_k=SPEC_K)
    return exact


#: phase 20's int8 speculative logits against the fp32 forward, x max
#: |logit|: a window rounds each head of the pool to 1/254 of its amax at
#: its accepted boundary (fp32 decoding never rounds); at smoke size on the
#: CPU this moved the logits by up to 7.6e-3 of max |logit|
INT8_SPEC_RTOL = 2e-2


def speculative_int8_against_fp32(params, cfg) -> dict:
    """Phase 20's int8 case: phase 6's 12 requests through the fp32
    speculative Engine on int8 pools (self draft, k = 4) against fp32
    plain decoding.  int8 pools round the state where fp32 ones do not,
    so the tokens can part at a near tie and are held teacher-forced: each
    committed token must be the argmax of the verify-logit row it came
    from (the window's bookkeeping), every row must lie within
    ``INT8_SPEC_RTOL`` x max |logit| of the fp32 forward's logits on the
    same prefix, and the token must equal the fp32 argmax wherever the fp32
    top-2 margin clears twice that; the first tokens (the admission's, on
    fp32 boundary states) must equal the plain fp32 Engine's.  Returns the
    speculative run's launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    plain = Engine(params, cfg, slots=8, max_len=256, seed=SEED,
                   dtype=torch.float32, device=DEVICE)
    engine = Engine(params, cfg, slots=8, max_len=256, seed=SEED,
                    dtype=torch.float32, state_dtype="int8", draft="self",
                    speculate_k=SPEC_K, device=DEVICE)
    for e in (plain, engine):
        for r in requests(np.random.default_rng(SEED + 5), 12,
                          cfg.vocab_size, (16, 128), (16, 16)):
            e.submit(r)
    want = {r.uid: r.generated for r in plain.run()}
    rows, seen = {}, {}
    real_verify, real_window = lm.verify, engine.worker.verify

    def recording_verify(*a, **kw):
        seen["logits"], pending = real_verify(*a, **kw)
        return seen["logits"], pending

    def recording_window(tokens, drafts, pos, temps, live):
        uids = [None if r is None else r.uid for r in engine.active]
        emitted, accepted = real_window(tokens, drafts, pos, temps, live)
        for i in np.flatnonzero(live):
            rows.setdefault(uids[i], []).extend(
                (seen["logits"][i, j].float(), int(emitted[i, j]))
                for j in range(accepted[i] + 1))
        return emitted, accepted

    engine.worker.verify = recording_window
    lm.verify = recording_verify
    torch.cuda.synchronize()
    reset_launches()
    try:
        done = {r.uid: r for r in engine.run()}
    finally:
        lm.verify = real_verify
    launches = dict(LAUNCHES)
    weights = lm.for_serving(params, DEVICE, torch.float32)
    err, exact, ties, same = 0.0, 0, 0, 0
    for uid, r in done.items():
        gen = r.generated
        if gen[0] != want[uid][0]:
            raise AssertionError(f"int8 speculative request {uid}: first "
                                 f"token {gen[0]}, plain {want[uid][0]}")
        seq = np.concatenate([r.prompt, np.asarray(gen[:-1], np.int32)])
        with torch.inference_mode():
            logits, _ = lm.forward(weights, torch.tensor(
                seq[None], device=DEVICE), cfg, dtype=torch.float32)
        for t, (row, tok) in enumerate(rows[uid][:len(gen) - 1], start=1):
            ref = logits[0, len(r.prompt) + t - 1]
            scale = float(ref.abs().max())
            if tok != gen[t] or tok != int(row.argmax()):
                raise AssertionError(f"int8 speculative request {uid} token "
                                     f"{t}: committed {gen[t]}, window {tok},"
                                     f" its argmax {int(row.argmax())}")
            err = max(err, max_err(f"int8 speculative request {uid} token "
                                   f"{t} logits", row, ref,
                                   (0.0, INT8_SPEC_RTOL * scale)) / scale)
            top = torch.topk(ref, 2)
            if float(top.values[0] - top.values[1]) > 2 * INT8_SPEC_RTOL \
                    * scale:
                if tok != int(top.indices[0]):
                    raise AssertionError(
                        f"int8 speculative request {uid} token {t}: {tok}, "
                        f"fp32 argmax {int(top.indices[0])}")
                exact += 1
            else:
                ties += 1
        same += sum(a == b for a, b in zip(gen, want[uid]))
    total = sum(len(g) for g in want.values())
    print(f"[speculative fp32, int8 flow, self draft] teacher-forced "
          f"against the fp32 forward: logits within {err:.3e} of max "
          f"|logit| (bound {INT8_SPEC_RTOL:g}), {exact} tokens equal to the "
          f"fp32 argmax, {ties} within its margin bound; free-running, "
          f"{same} of {total} tokens equal to plain fp32 decoding (not "
          f"gated) in {engine.worker.verify_windows} windows; speculative "
          f"launches { {n: v for n, v in launches.items() if v} }",
          flush=True)
    return {"launches": launches}


def paged_bytes(b, mp, hkv, page, d, dv, act, quant):
    """Bytes one K8a (``quant`` False) or K8b launch must move: the table
    read, each gathered page read once (int8 payloads plus fp32 scales
    for K8b) and the outputs written in ``act`` bytes per element."""
    rows = b * mp * hkv * page
    read = rows * ((d + dv) + 2 * 4) if quant else rows * (d + dv) * act
    return b * mp * 4 + read + rows * (d + dv) * act


def time_paged_kernels(launches: dict, errs: dict) -> list:
    """Phase 9, K8a/K8b: one layer's gather of a paged decode step at the
    serving shape (16 slots x 8 pages of 64 x 8 kv heads, D = Dv = 64, bf16
    out), every table entry a distinct page of the dense-equivalent
    128-page pool.  The library yardstick indexes the pools (and K8b's
    scales) by the clamped, flattened table with ``torch.index_select``,
    without the head-major relayout (or the dequantization)."""
    from repro_torch.kernels.gather import (paged_gather, paged_gather_quant,
                                            paged_gather_quant_ref,
                                            paged_gather_ref)

    p, hkv, page, d, dv, b, mp = PAGED_SHAPES[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 110)
    kc, vc = (torch.randn((p, hkv, page, d), generator=gen,
                          device=DEVICE).to(torch.bfloat16) for _ in "kv")
    table = torch.randperm(p, generator=gen, device=DEVICE).view(b, mp).to(
        torch.int32).contiguous()
    idx = table.long().clamp(0, p - 1).flatten()
    kq, vq = ((x.float() * 40).round().clamp(-127, 127).to(torch.int8)
              for x in (kc, vc))
    ks, vs = (torch.rand((p, hkv, page, 1), generator=gen, device=DEVICE)
              for _ in "kv")
    bf16 = torch.bfloat16
    cases = [
        ("paged_gather", "src/repro/kernels/gather/paged.py:69",
         lambda: paged_gather(kc, vc, table),
         lambda: paged_gather_ref(kc, vc, table),
         lambda: [torch.index_select(x, 0, idx) for x in (kc, vc)],
         paged_bytes(b, mp, hkv, page, d, dv, 2, False),
         "index_select of the K and V pools by the clamped, flattened "
         "table (no head-major relayout)"),
        ("paged_gather_quant", "src/repro/kernels/gather/paged.py:134",
         lambda: paged_gather_quant(kq, vq, ks, vs, table, out_dtype=bf16),
         lambda: paged_gather_quant_ref(kq, vq, ks, vs, table,
                                        out_dtype=bf16),
         lambda: [torch.index_select(x, 0, idx) for x in (kq, vq, ks, vs)],
         paged_bytes(b, mp, hkv, page, d, dv, 2, True),
         "index_select of the int8 K and V pools and their scales by the "
         "clamped, flattened table (no relayout, no dequantization)"),
    ]
    rows = []
    with torch.inference_mode():
        for name, replaces, run, plain, library, n_bytes, what in cases:
            bound_ms, by = bound(n_bytes, 0)
            rows.append({
                "name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/paged_gather.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": time_ms(run),
                "plain_ms": time_ms(plain), "bound_ms": bound_ms,
                "bound_by": by, "library_ms": time_ms(library),
                "library": what})
        rows[-1]["launch_floor_ms"] = launch_floor_ms()
    print("[K8] device ms: " + json.dumps(
        {row["name"]: row["ms"] for row in rows}
        | {"launch_floor_ms": rows[-1]["launch_floor_ms"]}), flush=True)
    return rows


def launch_floor_ms() -> float:
    """``time_ms`` of an empty kernel (``boundary_gather_empty``, built with
    K9): the card's launch floor under the same timing."""
    from repro_torch.kernels import _lib

    empty = _lib.function("boundary_gather", "boundary_gather_empty",
                          [ctypes.c_void_p])

    def launch():
        err = empty(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel: cudaError {err}")

    return time_ms(launch)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device ms of one run of ``fn``, by CUDA events around each run.

    The L2 cache is flushed before each run (the serving loop reaches each
    kernel's operands after ~50 MB of weights).  Each run is enqueued
    behind a device-side sleep longer than the host takes to enqueue it,
    so its launches run back to back and the wrappers' host time does not
    show in the device time.  One run at a time: a plain version's hundreds
    of launches stay inside the driver's launch queue.  A run whose enqueue
    outlasted its sleep is repeated with a sleep twice as long.  A run of
    more launches than the launch queue holds blocks its own enqueue on the
    sleeping device, so no sleep covers it: time it with ``graph_ms``.
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


def graph_ms(fn) -> float:
    """Device ms of one run of ``fn`` when the run has more launches than
    the launch queue holds (the plain SSD chunk scan at the training
    shape: ~500 forward, ~1,000 backward), so that ``time_ms``'s sleep
    cannot cover its enqueue and a plain timing would count the host's
    pace: the run is captured once into a CUDA graph (after two warm-up
    runs on a side stream) and one replay, a single host call, is timed
    by ``time_ms`` (L2 flushed)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay)
    del graph
    return ms


def flow_ops_per_position(g: int, d: int, dv: int) -> int:
    """fp32 operations of one position of one (row, kv head) in the O(d^2)
    recurrent form: 2(G+1) D Dv for q_in @ S and S += k (v e)^T, and
    7 (G+1) D for the four flow sums and four flow dot products."""
    return 2 * (g + 1) * d * dv + 7 * (g + 1) * d


def bwd_ops_per_position(g: int, d: int, dv: int) -> int:
    """fp32 operations of K2 for one position of one (row, kv head), in
    the same recurrent form: the recompute (``flow_ops_per_position``)
    plus the pull-back -- 2 G D Dv each for dY S^T and q_in^T dY, 2 D Dv
    each for dS^T k and dS (v e), and 2 D Dv for rebuilding S's carry-in:
    6 (G+1) D Dv in all -- plus 14 (G+1) D for pulling back the four flow
    sums and four flow dot products, and 3 G Dv for g_out . Y and dY."""
    return 6 * (g + 1) * d * dv + 21 * (g + 1) * d + 3 * g * dv


def chunk_ops(g: int, d: int, dv: int) -> int:
    """fp32 operations of K5a for one position of one (row, kv head) in
    the recurrent form: 2 G D Dv for q @ S and 2 D Dv for S += k^T v."""
    return 2 * (g + 1) * d * dv


def chunk_dkv_ops(g: int, d: int, dv: int) -> int:
    """fp32 operations of K5b for one position of one (row, kv head) in
    the recurrent form: 2 D Dv each for U v and U^T k, and 2 G D Dv for
    U += q^T g."""
    return 2 * (g + 2) * d * dv


def nc_fused_ops(nq: int, m: int, d: int, dv: int) -> int:
    """fp32 operations of K6 for one (row, kv head): per source row D for
    k_sum, 4 D for its outflow dot and ko_sum, 2 D for cons_src, Dv for
    v * e and 2 D Dv for kv; per sink row D for q_sum, 4 D for its inflow
    dot and qi_sum, 4 D for the two phase-D dots, 2 D Dv for phi @ kv and
    Dv for the scale."""
    return (m * (2 * d * dv + 7 * d + dv) + nq * (2 * d * dv + 9 * d + dv))


def nc_qside_ops(n: int, d: int, dv: int, backward: bool) -> int:
    """fp32 operations of K7a (2 D Dv for phi @ kv, 4 D for the two flow
    dots, Dv for the scale per row) or K7b (6 D Dv for phi @ kv, u @ kv^T
    and phi^T u; 18 D for the flow dots, dI, the dq chain and the dk_sum /
    dko_sum sums; 3 Dv for dalloc and u per row)."""
    if backward:
        return n * (6 * d * dv + 18 * d + 3 * dv)
    return n * (2 * d * dv + 4 * d + dv)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_kernels(launches: dict, errs: dict) -> list:
    """Phase 9: time each kernel and its plain version at its main path's
    shapes (bf16 activations, 16 rows or slots x 8 kv heads, D = 64): K1
    and K3 at the serving path's, K2 at the training path's; and K1 at
    the training shape too."""
    from repro_torch.attention.recurrent import decode_step
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import flow_decode_call
    from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,
                                                flow_fused_bwd_ref,
                                                flow_fused_call, flow_fused_ref)

    rows = []
    # K2: one layer's attention backward of the training step
    (q, k, v, lens, totals, g_out, g_sums), kw = k2_case(
        torch.bfloat16, 16 * 8, 1, 512, 64, 128, 512, "sigmoid", SEED + 20,
        False)
    bh, g, n, d = q.shape
    st_bytes = bh * (4 * d + 1 + d * d) * 4
    b_k2 = (bh * n * (g * d + 2 * d + g * d) * 2 + bh * n * (g * d + 2 * d) * 2
            + 2 * st_bytes + bh * 4)
    bound_ms, by = bound(b_k2, bh * n * bwd_ops_per_position(g, d, d))
    train = (q, k, v, lens, totals, g_out, g_sums)
    with torch.no_grad():
        k2_ms = time_ms(lambda: flow_fused_bwd_call(*train, **kw))
        k1_train_ms = time_ms(lambda: flow_fused_call(q, k, v, lens,
                                                      chunk=128))
    b_k1 = bh * n * (g * d + 2 * d) * 2 * 2 + st_bytes + bh * 4
    k1_bound, k1_by = bound(b_k1, bh * n * flow_ops_per_position(g, d, d))
    print(f"[K1 training shape] 16 rows x 8 heads, N = 512 all valid, bf16: "
          f"{k1_train_ms:.4f} ms, bound {k1_bound:.5f} ms ({k1_by})",
          flush=True)
    k2_row = {
        "name": "flow_fused_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flow_fused_bwd.cu",
        "replaces": "src/repro/kernels/flow_fused/bwd.py:178",
        "launches": launches["flow_fused_bwd"],
        "max_abs_err": errs["flow_fused_bwd"], "ms": k2_ms,
        "plain_ms": time_ms(lambda: flow_fused_bwd_ref(
            q, k, v, lens, g_out, g_sums, **kw)),
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
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
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "training_ms": k1_train_ms, "training_bound_ms": k1_bound,
            "training_bound_by": k1_by})
        serve = (q, k, v, lens)
        # K3: one decode step of the 16-slot pool, one layer
        slots, hkv = 16, 8
        pool = decode_pool(slots, hkv, d, SEED + 6)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        tq, tk, tv = decode_token(gen, slots, hkv, 1, d, torch.bfloat16)
        bh = slots * hkv
        flat = flat_pool(pool)
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
        k4_row, sizes = time_flow_decode_q(launches, errs)
        rows[-1].update(ms_1024_slots=sizes[1024]["k3_ms"],
                        bound_ms_1024_slots=sizes[1024]["k3_bound_ms"],
                        launch_floor_ms=launch_floor_ms())
        rows.append(k4_row)
    rows.insert(1, k2_row)
    print("[K1/K2 kernels] device ms per call of each CUDA kernel: "
          + json.dumps(k12_breakdown(serve, train, kw)), flush=True)
    print("[K1/K2 kernels] registers and spill bytes: " + json.dumps(
        {name: PTXAS.get(name, "cached") for name in ("flow_fused",
                                                      "flow_fused_bwd")}),
          flush=True)
    # K5a's profiler breakdown before K6's ablation builds and timings: late
    # in the script a profiler session may see no device time at all
    rows += time_chunk_kernels(launches, errs)
    rows += time_nc_kernels(launches, errs)
    return rows


def q_step_bytes(slots: int, hkv: int, g: int, d: int, act: int) -> int:
    """Bytes one K4 launch must move: the int8 payloads and fp32 scales
    and z read and written, q, k, v read and out written in the activation
    dtype (``act`` bytes), t read."""
    bh = slots * hkv
    pool = bh * (4 * d + d * d + 5 * 4 + 4)
    return 2 * pool + bh * (g * d + 2 * d + g * d) * act + slots * 4


def q_step_ops(g: int, d: int) -> int:
    """Operations of K4 for one (slot, kv head): K3's recurrence
    (``flow_ops_per_position``) plus 3 per payload element (dequantizing
    multiply, amax, requantizing divide)."""
    return flow_ops_per_position(g, d, d) + 3 * (4 * d + d * d)


def time_flow_decode_q(launches: dict, errs: dict) -> tuple[dict, dict]:
    """Phase 9, K4: one layer's decode step of the 16-slot int8 pool (bf16
    tokens, 8 kv heads, D = 64); then K3 and K4 at 16 and 1,024 slots, so
    that the int8 pool's byte saving is measured, not assumed.  Returns
    K4's row and the times by slot count."""
    from repro_torch.kernels.flow_decode import (flow_decode_call,
                                                 flow_decode_q_call,
                                                 flow_decode_q_ref)

    hkv, d = 8, 64
    sizes, row = {}, None
    for slots in (16, 1024):
        pool = decode_pool(slots, hkv, d, SEED + 6)
        qpool = int8_pool(pool)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        tq, tk, tv = decode_token(gen, slots, hkv, 1, d, torch.bfloat16)
        bh = slots * hkv
        tok = (tq.reshape(bh, 1, d), tk.reshape(bh, d), tv.reshape(bh, d))
        flat = flat_pool(pool)
        qflat = flat_q_pool(qpool)
        k3 = time_ms(lambda: flow_decode_call(pool.t, *tok, *flat, hkv=hkv))
        k4 = time_ms(lambda: flow_decode_q_call(qpool.payload.t, *tok, *qflat,
                                                hkv=hkv))
        k3_bytes = 2 * bh * (4 * d + 1 + d * d) * 4 + bh * 4 * d * 2 + slots * 4
        k4_bytes = q_step_bytes(slots, hkv, 1, d, 2)
        sizes[slots] = {"k3_ms": k3, "k3_bound_ms": bound(
            k3_bytes, bh * flow_ops_per_position(1, d, d))[0], "k4_ms": k4,
            "k4_bound_ms": bound(k4_bytes, bh * q_step_ops(1, d))[0],
            "k3_mb": k3_bytes / 1e6, "k4_mb": k4_bytes / 1e6}
        if slots == 16:
            bound_ms, by = bound(k4_bytes, bh * q_step_ops(1, d))
            plain = [x.clone() for x in (*qflat[0], qflat[1], *qflat[2],
                                         qflat[3], qflat[4])]
            row = {
                "name": "flow_decode_q", "route": "cuda",
                "source": "src/repro_torch/csrc/flow_decode_q.cu",
                "replaces": "src/repro/kernels/flow_decode/quant.py:158",
                "launches": launches["flow_decode_q"],
                "max_abs_err": errs["flow_decode_q"], "ms": k4,
                "plain_ms": time_ms(lambda: flow_decode_q_ref(
                    qpool.payload.t, *tok, tuple(plain[:4]), plain[4],
                    tuple(plain[5:9]), plain[9], plain[10], hkv=hkv)),
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
    print("[K3 vs K4, 8 kv heads, D = 64, bf16 tokens] " + json.dumps(sizes),
          flush=True)
    return row, sizes


def time_chunk_kernels(launches: dict, errs: dict) -> list:
    """Phase 9, K5a/K5b: one layer's causal dot of the paper-causal
    training step (fp32, 16 rows x 8 kv heads, G = 1, N = 512, D = 64).
    The plain version is the chunked scan, and for K5b the backward of
    autograd through it (dk and dv only: q does not require grad)."""
    from repro_torch.attention.chunked import chunked_causal_dot_grouped
    from repro_torch.kernels.flow_chunk import (flow_chunk_call,
                                                flow_chunk_dkv_call)

    bh, g, n, d = 16 * 8, 1, 512, 64
    q, k, v, cot = chunk_operands(bh, g, n, d, d, SEED + 60)
    kl, vl = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
    graph = chunked_causal_dot_grouped(q, kl, vl, 128)
    io = 4 * bh * n * (g * d + d + d + g * d)  # q, k, v read; out written
    io_dkv = 4 * bh * n * (g * d + 2 * d + g * d + 2 * d)  # + g; dk, dv
    cases = [
        ("flow_chunk", "src/repro_torch/csrc/flow_chunk.cu",
         "src/repro/kernels/flow_chunk/flow_chunk.py:72",
         lambda: flow_chunk_call(q, k, v),
         lambda: chunked_causal_dot_grouped(q, k, v, 128),
         io, bh * n * chunk_ops(g, d, d)),
        ("flow_chunk_dkv", "src/repro_torch/csrc/flow_chunk_bwd.cu",
         "src/repro/kernels/flow_chunk/bwd.py:114",
         lambda: flow_chunk_dkv_call(q, k, v, cot),
         lambda: torch.autograd.grad(graph, (kl, vl), cot,
                                     retain_graph=True),
         io_dkv, bh * n * chunk_dkv_ops(g, d, d)),
    ]
    rows = []
    for name, source, replaces, run, plain, bytes_moved, ops in cases:
        bound_ms, by = bound(bytes_moved, ops)
        with torch.no_grad():
            ms = time_ms(run)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": time_ms(plain),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
    print("[K5a kernels] device ms per call of each CUDA kernel: "
          + json.dumps(chunk_breakdown(lambda: flow_chunk_call(q, k, v),
                                       K5A_KEY)), flush=True)
    rows[1]["k5b_breakdown"] = chunk_breakdown(
        lambda: flow_chunk_dkv_call(q, k, v, cot), K5B_KEY)
    print("[K5b kernels] device ms per call of each CUDA kernel: "
          + json.dumps(rows[1]["k5b_breakdown"]), flush=True)
    print("[K3/K4/K5a/K5b/K8 kernels] registers and spill bytes: "
          + json.dumps({name: PTXAS.get(name, "cached") for name in (
              "flow_decode", "flow_decode_q", "flow_chunk", "flow_chunk_bwd",
              "paged_gather")}), flush=True)
    return rows


def chunk_breakdown(run, prefix: str) -> dict | str:
    """Device ms per call of each CUDA kernel whose name starts with
    ``prefix`` (K5a's ``chunk_fwd_state``, ``_pass``, ``_out``; K5b's
    ``chunk_bwd_*``) in ``run``, from ``torch.profiler`` over three calls,
    tried up to three times (a late profiler session may see no device
    time); "not measured" where none saw any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        times = {}
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            m = re.search(prefix + "[a-z]+", e.key)
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if m and us:
                times[m.group(0)] = us / e.count / 1e3
        if times:
            return times
    return "not measured"


def tensor_core_bound(ops: float, products: float,
                      bytes_moved: float) -> float:
    """A kernel's bound in ms where ``products`` of its ``ops`` operations
    run on the tensor cores in 3xTF32 (three TF32 products each, 495
    TFLOP/s) and the rest on the CUDA cores (67 TFLOP/s): K6's two D x D
    products a row, K7b's three."""
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S,
                     (ops - products) / FP32_FLOPS
                     + 3 * products / TF32_FLOPS)


def time_nc_kernels(launches: dict, errs: dict) -> list:
    """Phase 9, K6/K7a/K7b: one layer's attention of the LRA training step
    (bf16, 32 rows x 4 heads, N = M = 4096, D = 64); K6 also by phase
    (``k6_breakdown``) and at 8-block clusters."""
    from repro_torch.attention.vjp import nc_key_side
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flow_nc import ops as nc_ops
    from repro_torch.kernels.flow_nc import (flow_nc_fused_call,
                                             flow_nc_fused_ref,
                                             flow_nc_qside_bwd_call,
                                             flow_nc_qside_bwd_ref,
                                             flow_nc_qside_call,
                                             flow_nc_qside_ref)

    bh, n, d = LRA_ROWS * LRA_HEADS, LRA_N, LRA_D
    q, k, v, g = nc_inputs(torch.bfloat16, bh, n, n, d, SEED + 40)
    kw = dict(n_sinks=n, m_sources=n)
    state_bytes = bh * (2 * d + d * d) * 4
    cases = [
        ("flow_nc_fused", "src/repro_torch/csrc/flow_nc_fused.cu",
         "src/repro/kernels/flow_nc/fused.py:159",
         lambda: flow_nc_fused_call(q, k, v),
         lambda: flow_nc_fused_ref(q, k, v),
         bh * n * 4 * d * 2, bh * nc_fused_ops(n, n, d, d)),
        ("flow_nc_qside", "src/repro_torch/csrc/flow_nc_qside.cu",
         "src/repro/kernels/flow_nc/flow_nc.py:64",
         lambda: flow_nc_qside_call(q, *key, **kw),
         lambda: flow_nc_qside_ref(q, *key, **kw),
         bh * n * 2 * d * 2 + state_bytes,
         bh * nc_qside_ops(n, d, d, False)),
        ("flow_nc_qside_bwd", "src/repro_torch/csrc/flow_nc_qside.cu",
         "src/repro/kernels/flow_nc/bwd.py:107",
         lambda: flow_nc_qside_bwd_call(q, *key, g, **kw),
         lambda: flow_nc_qside_bwd_ref(q, *key, g, **kw),
         bh * n * 3 * d * 2 + 2 * state_bytes,
         bh * nc_qside_ops(n, d, d, True)),
    ]
    rows = []
    with torch.no_grad():
        key = nc_key_side(q, k, v, 1e-6, True)
        for name, source, replaces, run, plain, bytes_moved, ops in cases:
            bound_ms, by = bound(bytes_moved, ops)
            rows.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": time_ms(run),
                "plain_ms": time_ms(plain), "bound_ms": bound_ms,
                "bound_by": by, "library_ms": None})
        k6 = rows[0]
        k6["tensor_core_bound_ms"] = tensor_core_bound(
            bh * nc_fused_ops(n, n, d, d), bh * 2 * n * 2 * d * d,
            bh * n * 4 * d * 2)
        rows[2]["tensor_core_bound_ms"] = tensor_core_bound(
            bh * nc_qside_ops(n, d, d, True), bh * n * 6 * d * d,
            bh * n * 3 * d * 2 + 2 * state_bytes)
        # the same kernel at 8-block clusters (the portable size: one block
        # of ~200 KB to an SM)
        fn = _lib.function("flow_nc_fused", "flow_nc_fused_fwd",
                           nc_ops._FUSED_ARGTYPES)
        out = torch.empty_like(q)

        def cb8():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     bh, n, n, d, d, 1, 8, 1, 1e-6,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(fn.error_string(err).decode())

        cb8()
        torch.cuda.synchronize()
        k6["cb8_max_abs_err"] = max_err_scaled(
            "flow_nc_fused cb=8", out, flow_nc_fused_ref(q, k, v),
            TOL[torch.bfloat16])
        k6["cb8_ms"] = time_ms(cb8)
        k6["k6_breakdown"] = k6_breakdown(q, k, v)
        # the small-head route at the vision encoder's first and last stage
        # (64 images x 16 heads, bf16): D = 6 over 3,136 tokens, D = 48
        # over 49, each row with its bound and its plain version's time
        for stage, (d_, n_) in (("vision_stage1", VISION_STAGES[0]),
                                ("vision_stage4", VISION_STAGES[-1])):
            bh_ = VISION_BATCH * VISION_HEADS
            qs, ks, vs, gs = nc_inputs(torch.bfloat16, bh_, n_, n_, d_,
                                       SEED + 41)
            key_s = nc_key_side(qs, ks, vs, 1e-6, True)
            kws = dict(n_sinks=n_, m_sources=n_)
            st_bytes = bh_ * (2 * d_ + d_ * d_) * 4
            for row, run, plain, bytes_moved, ops in (
                    (rows[0], lambda: flow_nc_fused_call(qs, ks, vs),
                     lambda: flow_nc_fused_ref(qs, ks, vs),
                     bh_ * n_ * 4 * d_ * 2, bh_ * nc_fused_ops(n_, n_, d_, d_)),
                    (rows[1], lambda: flow_nc_qside_call(qs, *key_s, **kws),
                     lambda: flow_nc_qside_ref(qs, *key_s, **kws),
                     bh_ * n_ * 2 * d_ * 2 + st_bytes,
                     bh_ * nc_qside_ops(n_, d_, d_, False)),
                    (rows[2], lambda: flow_nc_qside_bwd_call(qs, *key_s, gs,
                                                             **kws),
                     lambda: flow_nc_qside_bwd_ref(qs, *key_s, gs, **kws),
                     bh_ * n_ * 3 * d_ * 2 + 2 * st_bytes,
                     bh_ * nc_qside_ops(n_, d_, d_, True))):
                bound_ms, by = bound(bytes_moved, ops)
                row[stage] = {"bh": bh_, "n": n_, "d": d_, "ms": time_ms(run),
                              "plain_ms": time_ms(plain),
                              "bound_ms": bound_ms, "bound_by": by,
                              "max_abs_err": errs[f"{row['name']}_vision"]}
            del qs, ks, vs, gs, key_s
    print("[K6] " + json.dumps({key_: k6[key_] for key_ in (
        "ms", "bound_ms", "tensor_core_bound_ms", "cb8_ms",
        "k6_breakdown")}), flush=True)
    print("[K6] registers and spill bytes: " + json.dumps(
        PTXAS.get("flow_nc_fused", "cached")), flush=True)
    print("[K7b] " + json.dumps({key_: rows[2][key_] for key_ in (
        "ms", "bound_ms", "tensor_core_bound_ms")}) + "; registers and spill "
          "bytes: " + json.dumps(PTXAS.get("flow_nc_qside", "cached")),
          flush=True)
    print("[K6/K7 small heads] " + json.dumps({
        row["name"]: {st: row[st] for st in ("vision_stage1", "vision_stage4")}
        for row in rows}), flush=True)
    return rows


def ssd_chunk_ops(c: int, p: int, s: int, heads: int) -> int:
    """Least fp32 operations of K10a for one chunk of one (batch, head)
    row, b and c shared by ``heads`` heads: C (C + 1) S / H for c b^T
    (formed once per batch row and chunk), C (C + 1) P for the masked
    panel times x (the causal triangle, the C (C + 1) / 2 pairs j <= i
    that the masked scan needs), 2 C P S for c h^T and 2 C P S for the
    state.  About 5.28e6 at C = 128, P = 64, S = 128, H = 64.  Counted per
    head (``heads`` = 1), as a kernel that forms c b^T for each head does,
    it is C (C + 1) (S + P) + 4 C P S, about 7.36e6; with the C x C
    panels whole, as the TPU computes ``_ssd_step``, 2 C^2 (S + P) +
    4 C P S, about 1.05e7."""
    return c * (c + 1) * s // heads + c * (c + 1) * p + 4 * c * p * s


def ssd_chunk_bwd_ops(c: int, p: int, s: int, heads: int) -> int:
    """Least fp32 operations of K10b for one chunk of one row, b and c
    shared by ``heads`` heads: C (C + 1) S / H each for c b^T, W^T c and
    W b (W = sum over the heads of dM o D); C (C + 1) P each for gy x^T
    and M^T gy; 2 C P S each for b gh^T, x gh, gy h and the carry's
    cotangent.  About 1.06e7 at C = 128, P = 64, S = 128, H = 64.  Counted
    per head (``heads`` = 1), C (C + 1) (3 S + 2 P) + 8 C P S, about
    1.68e7 (2.52e7 with the C x C panels whole, as the TPU computes
    them)."""
    return 3 * c * (c + 1) * s // heads + 2 * c * (c + 1) * p + 8 * c * p * s


def time_ssd_kernels(launches: dict, errs: dict) -> list:
    """Phase 9, K9/K10a/K10b: K9 at one packed admission's x stream (16
    rows x Lb 512, W 4,096, bf16) and at the layer's x, B and C streams
    (W 4,096, 128, 128) in one launch, against three one-stream launches,
    three padded ``take_along_dim``s and an empty launch of the same build
    (the launch floor); K10a and K10b at one layer of the
    training step (fp32, B = 4 x H = 64 rows, N = 4,096, P = 64, S = 128,
    chunk 128).  K10b's plain version is the backward of autograd through
    the plain chunked scan: a graph replay of the forward and backward,
    less the forward's replay."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.gather import (boundary_gather,
                                            boundary_gather_many,
                                            boundary_gather_ref)
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_bwd_call,
                                               ssd_chunk_call,
                                               ssd_chunk_chunked)

    # the training phases leave the allocator's cache holding most of the
    # card in blocks of their sizes; a plain version that then has to free
    # cached blocks to allocate synchronizes the device on every run
    torch.cuda.empty_cache()
    rows = []
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 95)
    xb = torch.randn((16, 512, 4096), generator=gen,
                     device=DEVICE).to(torch.bfloat16)
    lens = torch.tensor(ragged_lens(np.random.default_rng(SEED + 95), 16, 16,
                                    384), device=DEVICE)
    # the layer's B and C streams (W 128), for the one-launch K9
    streams = (xb, *(torch.randn((16, 512, 128), generator=gen,
                                 device=DEVICE).to(torch.bfloat16)
                     for _ in range(2)))
    padded = [torch.cat([torch.zeros((16, 3, t.shape[2]), dtype=t.dtype,
                                     device=DEVICE), t], dim=1)
              for t in streams]
    idx = (lens.long()[:, None] + torch.arange(3, device=DEVICE))[..., None]
    with torch.inference_mode():
        bound_ms, by = bound(2 * 16 * 3 * 4096 * 2 + 16 * 4, 0)
        three_bytes = 2 * 16 * 3 * sum(t.shape[2] for t in streams) * 2
        k9 = {
            "name": "boundary_gather", "route": "cuda",
            "source": "src/repro_torch/csrc/boundary_gather.cu",
            "replaces": "src/repro/kernels/gather/boundary.py:67",
            "launches": launches["boundary_gather"],
            "max_abs_err": errs["boundary_gather"],
            "ms": time_ms(lambda: boundary_gather(xb, lens, 4)),
            "plain_ms": time_ms(lambda: boundary_gather_ref(xb, lens, 4)),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": time_ms(lambda: torch.take_along_dim(
                padded[0], idx, dim=1)),
            "library": "pad + gather: torch.take_along_dim on the "
                       "zero-padded stream (the pad made once, untimed)",
            "launch_floor_ms": launch_floor_ms(),
            "three_streams_ms": time_ms(lambda: boundary_gather_many(
                streams, lens, 4)),
            "three_launches_ms": time_ms(lambda: [
                boundary_gather(t, lens, 4) for t in streams]),
            "three_library_ms": time_ms(lambda: [
                torch.take_along_dim(p, idx, dim=1) for p in padded]),
            "three_streams_bound_ms": bound(three_bytes + 16 * 4, 0)[0]}
        rows.append(k9)
    print("[K9] one layer's x, B and C streams: " + json.dumps(
        {key: k9[key] for key in ("three_streams_ms", "three_launches_ms",
                                  "three_library_ms", "launch_floor_ms",
                                  "three_streams_bound_ms")}), flush=True)
    del xb, padded, streams
    bsz, heads, n, p, s = (SSD_SHAPE[k] for k in ("bsz", "heads", "n", "p",
                                                   "s"))
    bh, chunk = bsz * heads, 128
    x, dta, bm, cm = ssd_operands(bsz, heads, n, p, s, SEED + 96)
    b4, c4 = heads_view(bm, heads), heads_view(cm, heads)
    g = torch.randn(x.shape, generator=gen, device=DEVICE)
    ops = bh * (n // chunk) * ssd_chunk_ops(chunk, p, s, heads)
    ops_bwd = bh * (n // chunk) * ssd_chunk_bwd_ops(chunk, p, s, heads)
    io = 4 * (bh * n * (2 * p + 1) + 2 * bsz * n * s)  # x, dta, b, c; y
    hins_bytes = 4 * bh * (n // chunk) * p * s
    # bwd: x, dta, b, c, hins, g read; dx, ddta and (B, N, S) db, dc written
    io_bwd = 4 * (bh * n * (3 * p + 2) + 4 * bsz * n * s) + hins_bytes
    with torch.no_grad():
        _, hins = ssd_chunk_call(x, dta, b4, c4, chunk=chunk, return_hins=True)
    leaves = [t.clone().requires_grad_(True) for t in (x, dta, bm, cm)]

    def plain_fwd_bwd():
        # the forward runs on the graph's capture stream too: autograd runs
        # each backward op on its forward op's stream
        y, _ = ssd_chunk_chunked(leaves[0], leaves[1],
                                 heads_view(leaves[2], heads),
                                 heads_view(leaves[3], heads), chunk)
        return torch.autograd.grad(y, leaves, g)

    cases = [
        ("ssd_chunk", "src/repro/kernels/ssd_chunk/ssd_chunk.py:138",
         lambda: ssd_chunk_call(x, dta, b4, c4, chunk=chunk),
         lambda: ssd_chunk_chunked(x, dta, b4, c4, chunk), io, ops),
        ("ssd_chunk_hins", "src/repro/kernels/ssd_chunk/ssd_chunk.py:145",
         lambda: ssd_chunk_call(x, dta, b4, c4, chunk=chunk,
                                return_hins=True),
         lambda: ssd_chunk_chunked(x, dta, b4, c4, chunk), io + hins_bytes,
         ops),
        ("ssd_chunk_bwd", "src/repro/kernels/ssd_chunk/bwd.py:77",
         lambda: ssd_chunk_bwd_call(x, dta, b4, c4, hins, g, chunk=chunk),
         plain_fwd_bwd, io_bwd, ops_bwd),
    ]
    for name, replaces, run, plain, bytes_moved, n_ops in cases:
        bound_ms, by = bound(bytes_moved, n_ops)
        with torch.no_grad():
            ms = time_ms(run)
        plain_ms = graph_ms(plain)
        if name == "ssd_chunk":
            plain_fwd_ms = plain_ms
        if name == "ssd_chunk_bwd":  # the replay ran the forward too
            print(f"[K10 time] plain forward and backward {plain_ms:.4f} ms",
                  flush=True)
            plain_ms -= plain_fwd_ms
        # the per-head count: every C x C product formed for each head
        per_head = bh * (n // chunk) * (
            ssd_chunk_bwd_ops if name == "ssd_chunk_bwd" else ssd_chunk_ops)(
                chunk, p, s, 1)
        print(f"[K10 time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms (one CUDA graph replay), bound {bound_ms:.4f} ms "
              f"(per-head count: {bound(bytes_moved, per_head)[0]:.4f}"
              " ms)", flush=True)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/" + (
                "ssd_chunk_bwd.cu" if name == "ssd_chunk_bwd"
                else "ssd_chunk.cu"),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
    print("[K10 kernels] device ms per call of each CUDA kernel: "
          + json.dumps(k10_breakdown(x, dta, b4, c4, hins, g, chunk)),
          flush=True)
    return rows


def k12_breakdown(serve, train, kw) -> dict:
    """Device ms per call of each CUDA kernel of K1 at the serving shape
    (``serve`` = q, k, v, lens) and at the training shape, and of K2 at
    the training shape (``train`` = its arguments, ``kw`` its keywords),
    from ``torch.profiler`` over three calls of each.  Late in the script
    a profiler session sometimes records no device time at all, so each
    is tried up to three times; "not measured" where none saw any."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,
                                                flow_fused_call)

    runs = {"k1_serving": lambda: flow_fused_call(*serve, chunk=128),
            "k1_training": lambda: flow_fused_call(*train[:4], chunk=128),
            "k2_training": lambda: flow_fused_bwd_call(*train, **kw)}
    out = {}
    for tag, run in runs.items():
        times = {}
        for _ in range(3):
            with torch.no_grad(), profile(
                    activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                m = re.search(r"flow_(?:fwd|bwd)_[a-z0-9]+", e.key)
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                if m and us:
                    times[m.group(0)] = us / e.count / 1e3
            if times:
                break
        out[tag] = times or "not measured"
    return out


def k10_breakdown(x, dta, b4, c4, hins, g, chunk) -> dict | str:
    """Device ms per call of each CUDA kernel of a K10a (with carry-ins)
    and a K10b call at the training shape, from ``torch.profiler`` over
    three calls of each; "not measured" where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_chunk import (ssd_chunk_bwd_call,
                                               ssd_chunk_call)

    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ssd_chunk_call(x, dta, b4, c4, chunk=chunk, return_hins=True)
            ssd_chunk_bwd_call(x, dta, b4, c4, hins, g, chunk=chunk)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"ssd_(?:fwd|bwd)_[a-z]+", e.key)
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if m and us:
            out[m.group(0)] = us / e.count / 1e3
    return out or "not measured"


def main() -> int:
    setup()
    smi = card()
    t0 = time.perf_counter()

    def mark(what):
        print(f"[time] {what}: {time.perf_counter() - t0:.1f} s since the "
              "build began", flush=True)

    build_kernels()
    errs = {"flow_fused": check_flow_fused()["max_abs_err"],
            "flow_fused_bwd": check_flow_fused_bwd()["max_abs_err"],
            **check_flow_nc(),
            **check_flow_chunk(),
            "flow_decode": check_flow_decode()["max_abs_err"],
            "flow_decode_q": check_flow_decode_q()["max_abs_err"],
            **check_ssd(),
            **check_paged_gather()}
    mark("kernel checks")

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    stats = serve_full_width(params, cfg)
    profile_decode(params, cfg, 1e3 * stats["decode_s"] / stats["decode_steps"])
    quantized = serve_full_width(params, cfg, state_dtype="int8")
    profile_decode(params, cfg, 1e3 * quantized["decode_s"]
                   / quantized["decode_steps"], state_dtype="int8")
    serve_fp32_both_paths(params, cfg)
    serve_int8_fp32_against_plain(params, cfg)
    mark("flowformer_lm serving")
    from repro_torch.serving.engine import PagedSpec

    # the softmax baseline has the flow model's leaves: the same weights
    soft, spec = softmax_cfg(cfg), PagedSpec(PAGE, PAGED_POOL)
    paged = serve_paged_full_width(params, soft)
    profile_decode(params, soft, 1e3 * paged["decode_s"]
                   / paged["decode_steps"], paged=spec)
    paged_q = serve_paged_full_width(params, soft, state_dtype="int8")
    profile_decode(params, soft, 1e3 * paged_q["decode_s"]
                   / paged_q["decode_steps"], state_dtype="int8", paged=spec)
    serve_paged_fp32(params, soft)
    mark("softmax baseline serving")
    speculative = [serve_speculative_full_width(params, cfg),
                   serve_speculative_full_width(params, cfg, "int8"),
                   serve_speculative_full_width(params, cfg, draft="tiny")]
    speculative += [
        speculative_fp32_equal(params, cfg, "flow, self draft"),
        speculative_fp32_equal(params, cfg, "flow, tiny draft",
                               draft="tiny", k=2),
        speculative_int8_against_fp32(params, cfg),
        speculative_fp32_equal(params, soft, "softmax paged, self draft",
                               paged=PagedSpec(PAGE))]
    del params
    torch.cuda.empty_cache()
    mark("speculative serving")
    trained = train_full_width(cfg)
    profile_train(cfg, trained["step_ms"])
    train_fp32_both_paths(cfg)
    paper = train_paper_causal_full_width(cfg)
    profile_train(paper_causal(cfg), paper["step_ms"],
                  kernels={"k5a_ms_per_step": K5A_KEY,
                           "k5b_ms_per_step": K5B_KEY},
                  tag="train paper-causal")
    train_paper_fp32_both_paths(cfg)
    mark("flowformer_lm training")
    lra = get_config("flowformer_lra")
    classified = train_classifier_full_width(lra)
    profile_classifier(lra, classified["step_ms"])
    train_classifier_fp32_both_paths(lra)
    mark("flowformer_lra training")
    vis = get_config("flowformer_vision")
    seen = train_vision_full_width(vis)
    profile_vision(vis, seen["step_ms"])
    train_vision_fp32_both_paths(vis)
    mark("flowformer_vision training")
    series = train_timeseries_full_width(get_config("flowformer_timeseries"))
    torch.cuda.empty_cache()
    mark("flowformer_timeseries training")
    mamba = get_config("mamba2_1p3b")
    params = lm.init(mamba, torch.Generator().manual_seed(SEED),
                     device=DEVICE)
    served = serve_ssd_full_width(params, mamba)
    profile_decode(params, mamba, served["decode_ms_per_step"])
    serve_ssd_fp32_against_oracle(params, mamba)
    serve_ssd_fp32_against_oracle(params, mamba, torch.bfloat16,
                                  drift=SSD_BF16_CONV_DRIFT)
    speculative.append(ssd_speculative_fp32_equal(params, mamba))
    del params
    torch.cuda.empty_cache()
    mark("mamba2_1p3b serving")
    ssd_trained = train_ssd_full_width(mamba)
    profile_train(mamba, ssd_trained["step_ms"], kernels=SSD_K10,
                  tag="train mamba2", batch=SSD_SHAPE["bsz"],
                  seq=SSD_SHAPE["n"])
    train_ssd_fp32_both_paths(get_config("mamba2_1p3b"))
    mark("mamba2_1p3b training")
    launches = {name: sum(run["launches"][name] for run in (
        stats, quantized, trained, classified, paper, served, ssd_trained,
        paged, paged_q, seen, series, *speculative))
        for name in stats["launches"]}
    torch.cuda.empty_cache()
    rows = (time_kernels(launches, errs) + time_paged_kernels(launches, errs)
            + time_ssd_kernels(launches, errs))
    mark("kernel times")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
