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
     bf16 and fp32), plus a G = 2, N = 200, chunk-64 case, and the
     Decision-Flowformer's routes through ``flow_fused_forward`` at
     ``chunk_size=0`` with ragged lengths: N = 180 (padded to 192) at D =
     64, fp32, and N = 60 (padded to 64) at D = 24 (stored 32 wide inside
     the wrapper, the kernel told the real width), bf16 and fp32; and D =
     24 at phase 24's shape (32 trajectories x 4 heads, G = 1, N = 60 of
     64), bf16 and fp32, whose bf16 error the ``flow_fused_d24`` row
     reports;
  3b. K2 ``flow_fused_bwd`` against its plain version (autograd through
     K1's) at the training shape (16 rows x 8 kv heads, G = 1, N = 512,
     D = 64, chunk 128, bf16 and fp32) and at G = 2, N = 200 padded to 256
     (chunk 64) with random cotangents on all six state outputs, for each
     phi; at N = 180 of 192 (``chunk_size=0``, D = 64) and at D = 24 at
     phase 24's shape (N = 60 of 64; bf16, and fp32 for each phi): zero
     past the length;
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
     N = 200, D = 32 and 128 too; and through the glue with gradients at
     the Table 7 linear row's shape (``chunk_size=0``, N = 60, D = Dv = 24
     padded to 32, and D = 24 beside Dv = 64);
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
  3g. the kernels at the shapes of phases 26 and 27, against their plain
     versions, bf16 and fp32 (``check_whisper_granite_shapes``): K6 at
     Whisper's decode cross-attention (8 clips x 12 heads, NQ = 1 against
     M = 1,500; also against its cluster twin, 15 of 16 blocks owning no
     sink), its training cross-attention (NQ = 448), its encoder (NQ = M
     = 1,500) and the long encode (12 heads, NQ = M = 32,768); K7b at the
     cross-attention's and the encoder's backward (also against its
     twin); K1 and K2 at the decoder's training shape (96 rows, N = 448
     padded to 512, D = 64); K1 at granite's packed prefill (16 rows x 8
     kv heads, G = 4, N = 384, D = 128, ragged lengths); K3 over 32 steps
     at granite's pool (G = 4, D = 128) and Whisper's (8 x 12, D = 64);
  3h. K1 and K3 at the shapes of phases 28 and 29 and at Nemotron-4-
     340B's, against their plain versions, bf16 and fp32
     (``check_wide_shapes``): K1 on ragged lengths (16 prompts, N = 384)
     at (D, Dv) = (192, 128) with 16 heads, G = 1 (DeepSeek-V2-Lite's MLA),
     (192, 192) with 8 kv heads, G = 12 (Nemotron-4-340B) and (128, 128)
     with 8 kv heads, G = 8 (Qwen2-VL); K3 over 32 steps from a non-zero
     state at each of those 16-slot pools, at every step also against
     ``flow_decode_split``, and two steps from clones of one pool bitwise
     equal; DeepSeek-V2-Lite's full-width MoE at 16 x 384 and 16 x 1
     tokens: two calls bitwise equal (the fixed-order combine);
  3i. K1 and K3 at RecurrentGemma-9B's flow heads, (D, Dv) = (256, 256)
     with one kv head, G = 16 (``check_rg_shapes``), as 3h (K1 also two
     calls bitwise equal); K9 at an RG-LRU admission (16 rows, Lb 512, W
     4,096 bf16) exactly equal to its plain version, twice;
  3j. K2 and K4 at the wide pairs (``check_wide_train_shapes``);
  3k. K5a and K5b at the wide pairs (``check_wide_chunk``): (192, 128) at
     DeepSeek-V2-Lite's 4 x 16 MLA heads, (128, 192) (their dq call),
     (192, 192) at Nemotron-4-340B's 4 x 8 kv heads, G = 12, and (256, 256)
     at RecurrentGemma-9B's 4 x 1, G = 16, N = 512, and at N = 200 of 6
     rows: against their plain versions (K5a also on its dq operands) and
     their decompositions at the chunk of 32, two calls of each bitwise
     equal, fp32;
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
  25. the Engine serving the linear-attention baseline of the full-width
     flowformer_lm (``attention.kind="linear"``, as the reference's
     ``--attn linear`` makes it, phase 5's weights and traffic) in bf16,
     from fp32 ``LinearState`` pools and from int8 ones: exactly 6 K5a
     launches per admission round (each prefill's causal numerator), a
     plain decode, and nothing else; then phase 6 for it: fp32 greedy
     tokens on the kernels equal to the pinned plain path's
     (``backend="plain"``: the plain causal dot);
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
  35. the training lifecycle, on phase 7's weights and shape (bf16, 16 x
     512), checkpoints in a temporary directory removed at the end of
     35d: crash-restart through ``launch/train.py::train`` (AdamW): run A
     trains 4 steps with a checkpoint every 2 (async saves, then a final
     synchronous one); run B trains 2 and a fresh ``train()`` resumes it
     to 4: B resumes from step 2, its last two losses and every leaf of
     its final TrainState equal A's bit for bit, exactly 12 K1 and 6 K2
     a step and nothing else; a checkpoint's array bytes against
     ``CKPT_ARRAY_BYTES``; the seconds of a synchronous save, of each
     async save in the loop and of a restore;
  35b. Adafactor (``make_train_step(TrainConfig(optimizer="adafactor"))``,
     its moments in the reference's stacked layout), 3 steps: finite
     losses, exactly ``ADAFACTOR_VALUES`` fp32 values of state, phase 7's
     launches, a checkpoint round trip of the TrainState bit for bit; its
     step time beside phase 7's AdamW step;
  35c. Adafactor in fp32 at full width and 2 layers, 3 steps on the
     kernels and on the plain path: phase 8's bounds on the losses and
     on every parameter after step 3;
  35d. ``--attn softmax`` and ``--attn linear`` (3 steps each through
     ``train()``): finite losses, softmax launching no kernel of
     ``KERNELS``, linear exactly ``ATTN_KIND_LAUNCHES`` (3 K5a and 1 K5b a
     layer and step); then ``ElasticTrainer.recover(1)`` plans (1, 1),
     restores phase 35's step-4 checkpoint into ``build_train``'s
     template, and one more step equals step 5 of an uninterrupted
     5-step run bit for bit;
  36. distribution and context parallelism, on one card (a mesh is run
     from one process: every position of it is ``cuda:0``): ``cp_causal``
     on 4- and 8-way ``seq`` meshes at flowformer_lm's attention (B = 4,
     8 heads of 64, N = 4,096, chunk 128: local N 1,024 and 512) and at
     granite_8b's G = 4, D = 128: ``explain`` shows inner ``cuda_chunk``;
     forward, prefill and packed prefill (lens 512-4,096) against the
     unsharded K1 path and the pinned plain ``cumsum``, and the gradient
     of sum(out^2) (K5a, K5b) against K1 + K2, within phase 3d's K5a
     tolerance; exactly ``ways`` K5a a forward and ``2 ways`` K5a +
     ``ways`` K5b a backward; ``cp_nc`` at the LRA shape against K6,
     its gradients against the plain ``nc``'s and K6 + K7b's within
     ``CP_NC_GRAD_BOUND``;
  36b. ``build_prefill_step(seq_shard=True)``, flowformer_lm at full
     width and depth on a (1, 4) mesh, 4 x 2,048 tokens, fp32: 4 K5a a
     layer and no K1; logits and every boundary FlowState against the
     unsharded ``lm.prefill``; both wall times;
  36c. ``build_train_step`` at phase 7's shape in bf16 on (1, 1), (4, 1)
     and (2, 2) meshes, 3 steps each: losses within
     ``CP_TRAIN_LOSS_RTOL`` and one step's gradient norm within
     ``CP_TRAIN_GNORM_RTOL`` of (1, 1)'s, exactly 12 K1 and 6 K2 a
     data-parallel position and step; then ``compressed_psum`` on 4
     positions' full-width gradients: each leaf's error against the exact
     mean within half the shared int8 step, the residuals' norms, the wall
     ms a call;
  36d. ``train(mesh=make_mesh((2, 1)))`` for 3 steps with a checkpoint,
     ``ElasticTrainer.recover(1)`` onto (1, 1) restores it bit for bit,
     and one more step equals one from the run's own final state bit for
     bit;
  37, 38 (and 37b, 38b). ``deepseek_v2_lite_16b`` (2 of 27 layers, 4 x
     512, AdamW) and ``recurrentgemma_9b`` in flow mode (3 of 38 layers,
     4 x 512, Adafactor) at full width, 5 bf16 steps on K1 and K2, then
     one fp32 step against the plain path (``train_wide_full_width``);
  40, 41 (and 40b, 41b). the same runs on the same weights in the
     paper-causal mode (``strict_causal=False``): exactly 3 K5a (forward,
     remat recompute, dq) and 1 K5b a flow layer and step, no K1 or K2,
     at (192, 128) / (128, 192) and at (256, 256), G = 16; step ms,
     tokens/s, peak memory; then one fp32 step's loss and every gradient
     leaf against the pinned plain path;
  42. phase 36's ``cp_causal`` checks at DeepSeek-V2-Lite's attention (B
     4, 16 heads of (192, 128)) and RecurrentGemma-9B's (B 4, one kv
     head, G = 16, (256, 256)), 4- and 8-way, against the unsharded K1 /
     K2 path (rows of ``CP_CAUSAL_SHAPES``, run with phase 36);
  42b. ``build_prefill_step(seq_shard=True)`` for phase 40's 2-layer
     ``deepseek_v2_lite_16b`` and weights, 4 x 2,048 tokens, fp32: no
     fall-back line, 4 K5a a layer and no K1, logits and boundary states
     against the unsharded ``lm.prefill``, both wall times;
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
  23. the Decision-Flowformer at full width and depth (``flowformer_dt``:
     3 layers, d 256, 4 heads of 64, ``chunk_size=0``; offline RL, Table
     7) through ``launch/decision.py::run`` in bf16 on fp32 masters: 5
     AdamW steps of 64 trajectories of 60 steps (N = 180), then a
     16-episode rollout of 60 forwards: finite losses and return, exactly
     3 K1 and 3 K2 a step and 3 K1 a rollout forward, and nothing else;
     step ms, trajectories/s, forwards/s; then ``torch.profiler`` over two
     steps: device time by kernel and busy share;
  23b. the same model in fp32 with one block, on the kernels and on the
     plain path (``backend="plain"``): 3 steps of 64 x 60, losses and
     every parameter gradient of the first step (non-zero on the kernels)
     within phase 21b's bounds;
  24. the Table 7 harness's model (2 layers, d 96, 4 heads of 24, d_ff
     192, horizon 20, ``chunk_size=0``; ``launch.run(table7=True)``) for
     each of flow (K1 and K2 at D = 24: 2 K1 and 2 K2 a step, 2 K1 a
     rollout forward), linear (K5a and K5b at D = 24: 4 K5a and 2 K5b a
     step, 2 K5a a forward) and softmax (plain, no kernel), bf16, 20 steps
     of 32 and a 16-episode rollout; each row's return is printed (smoke
     values of a cut run, not the paper's numbers);
  26. ``whisper_small`` at full width and depth (12 + 12 layers, d 768,
     12 heads of 64, vocab 51,865; random weights from a seed; stub frame
     embeddings drawn from the seed, the conv stem being out of scope as
     in the reference), bf16: encode 8 clips of 1,500 frames (exactly one
     K6 a layer), greedy-decode 64 tokens a clip from ``init_dec_caches``
     (exactly a K3 and a K6 at one sink row a decoder layer and step),
     encode one clip of 32,768 frames (the config's ``max_seq_len``; its
     time and peak memory); each encode shape warmed up once, then timed
     5 times (the median); then 5 AdamW steps of 8 x (1,500 frames, 448
     tokens) on fp32 masters (exactly 24 K6, 24 K7b, 12 K1 and 12 K2 a
     step and nothing else); encode ms, decode tokens/s, step ms, peak
     GB; ``torch.profiler`` over decode steps, an encode and two steps;
  26b. the same in fp32 with one encoder and one decoder layer, on the
     kernels and on the plain path (``backend="plain"``): 4 clips' 32
     greedy tokens equal; 3 steps' losses and every gradient of the first
     step within phase 21b's bounds; K6 at NQ = 1, M = 1,500 on the
     layer's own projections of the memory against its plain version;
  27. ``granite_8b`` at full width (d 4,096, 32 query heads over 8 kv
     heads of 128, d_ff 14,336 swiglu, vocab 49,152, rmsnorm, untied
     head), its depth cut to 2 of 36 layers (0.84 B parameters), served
     as phase 5 in bf16: K1 and K3 at G = 4, D = 128, exactly one K1 a
     layer and admission round and one K3 a layer and decode step; then
     ``torch.profiler`` over decode steps;
  27b. phase 6 for it: fp32 greedy tokens on the kernels equal to the
     plain path's;
  28. ``deepseek_v2_lite_16b`` at full width (d 2,048; 16 MLA heads, q
     and k 192 wide (nope 128 + rope 64), v 128, kv LoRA 512; 64 routed
     experts top-6 plus 2 shared, d_ff_expert 1,408; vocab 102,400;
     random weights drawn on the card from a seed), its depth cut to 2 of
     27 layers (~1.59 B parameters), served as phase 5 in bf16: K1 and K3
     at D = 192, Dv = 128, exactly one K1 a layer and admission round and
     one K3 a layer and decode step; decode and prefill tokens/s; then
     ``torch.profiler`` over decode steps (the device's busy share);
  28b. phase 6 for it: fp32 greedy tokens and, at every layer's MoE, every
     live token's chosen experts (the valid positions of a prefill, the
     live slots of a decode step) on the kernels equal to the plain
     path's; a difference prints the plain router's top-k margin there;
  29, 29b. the same for ``qwen2_vl_72b`` at full width (d 8,192, 64 query
     heads over 8 kv heads of 128: K1 and K3 at G = 8; M-RoPE; d_ff 29,568
     swiglu; vocab 152,064), 2 of 80 layers (~4.28 B parameters), token
     ids through the table as the reference's Engine serves them;
  30. ``granite_moe_3b_a800m`` at full width (d 1,536, 24 heads over 8
     kv heads of 64: G = 3; 40 experts top-8, d_ff_expert 512; vocab
     49,155), 2 of 32 layers, served as phase 5 in bf16 with its K1 and K3
     counts;
  31. ``recurrentgemma_9b`` in flow mode at full width and depth (38
     layers: rglru, rglru, local; d 4,096; 16 query heads over one kv head
     of 256; vocab 256,000; 9.63 B parameters drawn on the card in bf16),
     phase 5's traffic in bf16: packed admission with exactly one K1 a
     flow layer and one K9 an RG-LRU layer per round, one K3 a flow layer
     per decode step, nothing else; decode and prefill tokens/s, pool
     bytes a slot, then ``torch.profiler`` over decode steps as in 5b;
     31b: one period (3 of 38 layers) in fp32, phase 6's greedy tokens on
     the kernels equal to the plain path's (K9's plain version bound in);
  32. the same config in softmax mode (the local slots are window rings
     of 2,048), 3 of 38 layers, bf16: phase 5's traffic and two prompts of
     4,096 tokens (the band path), one admission round a request and no
     kernel launched; then in fp32 six requests (one of 4,096 tokens,
     whose ring wraps) token for token equal to a solo loop of
     ``lm.prefill`` and ``lm.decode`` a request;
  33. int8 hybrid pools: (a) ``mamba2_1p3b`` at full width from int8
     pools on phase 13's traffic (K9 as phase 13; pool bytes a slot
     against the fp32 pools'); (b) the recurrentgemma smoke config (K1,
     K9, and K4 at D = 32, G = 4) in fp32 from int8 pools, each decode
     step teacher-forced against the same step from the pools dequantized
     into fp32 pools (K3): logits within (1e-4, 1e-4 max |logit|), every
     pool entry within one step of its scale plus 1e-5;
  34. fleet serving (after phase 20, on phase 5's weights): phase 5's 48
     requests and 16 slots a worker through ``FleetEngine(prefill=1,
     decode=2)`` on the one card, bf16, the three workers sharing one
     serving copy of the weights: exactly one K1 a layer per admission
     round of the prefill worker, one K3 a layer per decode step of each
     member with a live slot, nothing else; decode and prefill tokens/s
     beside phase 5's Engine, the host time of the bundles' exports and
     installs, migrations, KiB of state moved a request, ``loads()``;
     then the same traffic from int8 pools (K4 in place of K3; the
     bundles carry int8 payloads and fp32 scales);
  34b. bundle bytes at full width: flow fp32 (predicted 835,800 B
     whatever the length), flow int8 and bf16 paged softmax pools, one
     prompt at each power-of-two bucket of phase 5's prompt lengths and
     at 512 tokens, exported from one worker (``nbytes`` equal to the
     manifest's sum), installed into another worker's free slot and
     exported again: bitwise equal buffers;
  34c. phase 6's 12 requests through the fp32 fleet on the kernels (8
     slots a worker), with one forced ``migrate(uid)``, with one
     ``kill_worker`` under ``replicate=True`` and under
     ``replicate=False``: greedy tokens equal to the single fp32 Engine's
     on the kernels for flow with fp32 pools, flow with int8 pools
     (against the int8 Engine; an orphan whose int8 state is prefilled
     again is held up to the kill and its later tokens counted, see
     ``fleet_fp32_equal``), paged softmax on the dense-equivalent pool
     and (after phase 33) ``recurrentgemma_9b`` at one period (phase
     31b's weights), whose bundles carry bf16 conv histories;
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
     10, 21 and 22 for K6, K7a (none), K7b, of phase 7c for K5a, K5b, of
     phases 23 and 24 for K1, K2, K5a and K5b, of phase 25 for K5a, of
     phases 17 and 17b
     for K8a and K8b, of phase 13 for K9 and of phase 15 for K10a and
     K10b, each plus the speculative runs of phases 19, 19b, 19c and 20:
     K1, K3, K4, K8a and K9, the fleet runs of phases 34 and 34c: K1,
     K3, K4, K8a and K9, and the lifecycle runs of phases 35, 35b and
     35d: K1, K2, K5a and K5b), K1's time and bound at the training shape (in its row),
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
     so those are timed as one replay of a CUDA graph, ``graph_ms``), and
     rows ``flow_fused_d24``, ``flow_fused_bwd_d24``, ``flow_chunk_d24``
     and ``flow_chunk_dkv_d24``: K1, K2, K5a and K5b on their D = 24 route
     at one layer of phase 24 (32 trajectories x 4 heads, N = 60; bounds
     at the real width; launches those of phase 24's flow and linear
     rows); and rows ``flow_nc_fused_nq1`` (K6 at one Whisper decode
     step's cross-attention of a layer: 8 x 12, NQ = 1, M = 1,500, bf16;
     its bound counts what one sink row needs, ``nc_one_sink_ops``, no
     D x D product; launches phase 26's decode's), ``flow_fused_g4_d128`` (K1 at one
     granite admission: 16 x 8 kv heads, G = 4, N = 384, D = 128) and
     ``flow_decode_g4_d128`` (K3 at granite's pool), launches phase 27's;
     rows ``flow_fused_d192_dv128``, ``flow_decode_d192_dv128`` (K1 at
     one DeepSeek-V2-Lite admission of 16 prompts x 16 heads, N = 384, and
     K3 at its 16-slot pool; launches phase 28's), ``flow_fused_g8_d128``,
     ``flow_decode_g8_d128`` (Qwen2-VL's 8 kv heads, G = 8; phase 29's)
     and ``flow_fused_d192_g12``, ``flow_decode_d192_g12`` (Nemotron-4-
     340B's 8 kv heads of 192, G = 12; no model run reaches them, so 0
     launches); ``flow_fused_d256_g16``, ``flow_decode_d256_g16`` (K1 at
     one recurrentgemma admission of 16 prompts, G = 16, D = 256, N =
     384, with its four CUDA kernels' device ms; K3 at its 16-slot pool;
     launches phase 31's) and ``boundary_gather_rglru`` (K9 at the RG-LRU
     admission; phase 31's); the base rows' launches count phases 26-33
     too; rows ``flow_chunk_<tag>`` and ``flow_chunk_dkv_<tag>`` for the
     tags of ``WIDE_CHUNK_SHAPES``: K5a and K5b at phase 3k's shapes,
     with the device ms of their three CUDA kernels, launches those the
     wrappers counted at the pair (``PAIR_LAUNCHES``) in the main-path
     runs of phases 40, 41, 42 and 42b (0 at Nemotron-4-340B's, which no
     model run reaches; 40b's and 41b's fp32 checks against the plain
     path are not counted, as no phase's fp32 check is), bound with every
     operation a 3xTF32 product on the tensor cores (``tf32_bound``);
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
gradient within 1e-4 of that leaf's max |grad| (phase 35c: each parameter
after three Adafactor steps within 1e-4 of that leaf's max |value|) -- the same fp32 sums in
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
max_len 256 = 4 pages).  Phases 26b and 27b: as phases 21b and 6 (the K6 check at NQ = 1 as
3c's).  Phases 28b and 29b: as phase 6, and every live token's chosen
experts exactly equal (a near-tied router choice is not excused).  Phase
14 with bf16 conv
histories: the t-th token's logits within (1e-4 + 1.5e-3 t) x max |logit|
-- a history element rounded to the neighbouring bf16 value (the two
paths sum it at other GEMM shapes) moves the state, and the gap grew by
~4.5e-4 of max |logit| per token on an H100.
"""
from __future__ import annotations

import ctypes
import collections
import dataclasses
import functools
import gc
import hashlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
        print(f"[build] {name}: {log.splitlines()[0]}, {len(usage)} kernel "
              "variants; " + (usage[0] if usage else "cached"), flush=True)
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
    at once, per (dtype, D) at G = 1 and at the wide pairs' groups, from
    the library's ``<name>_occupancy`` and ``<name>_occupancy_dv`` (the
    CUDA occupancy calculator on the built kernel)."""
    from repro_torch.kernels import _lib

    fn = _lib.function(name, f"{name}_occupancy", [ctypes.c_int] * 3)
    out = {f"{dt}<{d}>": fn(d, code, 1) for dt, code in (("f32", 0),
                                                         ("bf16", 1))
           for d in (32, 64, 128)}
    # K3 at phase 3h's pairs and groups, K4 at phase 3j's
    shapes = WIDE_SHAPES if name == "flow_decode" else WIDE_Q_SHAPES
    wide = _lib.function(name, f"{name}_occupancy_dv", [ctypes.c_int] * 4)
    out.update({f"{dt}<{d},{dv}> G={g}": wide(d, dv, code, g)
                for dt, code in (("f32", 0), ("bf16", 1))
                for _, _, _, g, d, dv in shapes})
    return out


def ptxas_usage(log: str) -> dict:
    """Registers, spill bytes and static shared memory per kernel variant
    from nvcc's ``-Xptxas -v`` report, keyed by name<template args> (bf16
    for an ``__nv_bfloat16`` argument, f32 for ``float``)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            sym = m.group(1)
            k = re.search(r"\d+((?:ssd|flow)_(?:fwd|bwd)_[a-z0-9]+(?:_wide)?|"
                          r"chunk_(?:fwd|bwd)_[a-z]+|"
                          r"flow_decode(?:_q)?(?:_cols)?_kernel|"
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


def k1_inputs(dtype, rows=16, hkv=8, g=1, n=512, d=64, seed=SEED, dv=None):
    """q (BH,G,N,D), k (BH,N,D), v (BH,N,Dv; Dv = D unless given) and lens
    (BH,) on the card; each row's length is drawn like the Engine's prompts
    (16..384)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    bh = rows * hkv
    mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
    lens = np.repeat(ragged_lens(np.random.default_rng(seed), rows, 16, 384),
                     hkv)
    return (mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, dv or d),
            torch.tensor(lens, device=DEVICE))


#: K1 and K2 at phase 24's flow row (BH, G, N, D, chunk, lens): 32
#: trajectories x 4 heads of 24, N = 60 padded to K1's chunk of 64
T7_K12_SHAPE = (32 * 4, 1, 64, 24, 64, 60)


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
        # the Decision-Flowformer's routes through the packed wrapper:
        # chunk_size=0 (N padded to the kernel's chunk, lens masking the
        # tail) at D = 64, N = 180, and the Table 7 harness's D = 24
        # (stored 32 wide inside the wrapper) at N = 60
        for d, n, dtypes in ((64, 180, (torch.float32,)),
                             (24, 60, (torch.bfloat16, torch.float32))):
            for dtype in dtypes:
                gen = torch.Generator(device=DEVICE).manual_seed(SEED + d + n)
                mk = lambda *sh: torch.randn(  # noqa: E731
                    sh, generator=gen, device=DEVICE).to(dtype)
                q, k, v = mk(4, 8, n, d), mk(4, 4, n, d), mk(4, 4, n, d)
                lengths = torch.tensor([n, 1, n // 3, n - 7],
                                       dtype=torch.int32, device=DEVICE)
                cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=0)
                out, st = flow_fused_forward(q, k, v, cfg, return_state=True,
                                             lengths=lengths)
                ref_out, ref_st = fused_causal_forward(
                    q, k, v, dataclasses.replace(cfg, chunk_size=n),
                    return_state=True, lengths=lengths)
                torch.cuda.synchronize()
                tag = (f"flow_fused {str(dtype)[6:]} chunk_size=0 G=2 N={n} "
                       f"D={d}")
                e = max(max_err(f"{tag} out row {i}", out[i, :, :li],
                                ref_out[i, :, :li], TOL[dtype])
                        for i, li in enumerate(lengths.tolist()))
                worst = max(max_err(f"{tag} {name}", getattr(st, name),
                                    getattr(ref_st, name), STATE_TOL)
                            for name in STATE_FIELDS)
                print(f"[K1] {tag}: out {e:.3e}, state {worst:.3e}",
                      flush=True)
        # D = 24 at the shape phase 24's flow row gives K1 (through
        # FlowFusedDot): 32 trajectories x 4 heads, G = 1, N = 60 padded
        # to 64 (lens 60)
        bh, g, n, d, chunk, n_valid = T7_K12_SHAPE
        d24 = {}
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
            mk = lambda *sh: torch.randn(  # noqa: E731
                sh, generator=gen, device=DEVICE).to(dtype)
            q, k, v = mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, d)
            lens = torch.full((bh,), n_valid, dtype=torch.int32,
                              device=DEVICE)
            out, sums = flow_fused_call(q, k, v, lens, chunk=chunk)
            ref_out, ref_sums = flow_fused_ref(q, k, v, lens, chunk=chunk)
            torch.cuda.synchronize()
            tag = f"flow_fused {str(dtype)[6:]} BH=128 N=60 (64) D=24"
            d24[dtype] = max_err(f"{tag} out", out, ref_out, TOL[dtype])
            worst = max(max_err(f"{tag} {name}", a, b, STATE_TOL)
                        for name, a, b in zip(STATE_FIELDS, sums, ref_sums))
            print(f"[K1] {tag}: out {d24[dtype]:.3e}, state {worst:.3e}",
                  flush=True)
    return {"max_abs_err": errs[torch.bfloat16],
            "d24": d24[torch.bfloat16]}


def k2_case(dtype, bh, g, n, d, chunk, n_valid, phi, seed, state_cot):
    """Inputs of one K2 check: q, k, v, g_out on the card, K1's totals,
    and the six state cotangents (random, or zeros as in training)."""
    from repro_torch.kernels.flow_fused import flow_fused_call

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dt)

    q, k, v, g_out = mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, d), mk(bh, g, n, d)
    lens = torch.full((bh,), n_valid, dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        _, totals = flow_fused_call(q, k, v, lens, chunk=chunk, phi=phi)
    g_sums = [mk(*x.shape, dt=torch.float32) if state_cot
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
    # the Decision-Flowformer's routes: chunk_size=0 at D = 64 (N = 180
    # padded to 192), and D = 24 (stored 32 wide inside the wrapper) at
    # phase 24's shape
    cases += [(torch.float32, (4 * 4, 1, 192, 64, 64, 180, "sigmoid", True))]
    cases += [(dtype, (*T7_K12_SHAPE, phi, True))
              for dtype, phi in ((torch.bfloat16, "sigmoid"),
                                 (torch.float32, "sigmoid"),
                                 (torch.float32, "elu1"),
                                 (torch.float32, "relu"))]
    errs = {}
    for i, (dtype, (bh, g, n, d, chunk, n_valid, phi, cot)) in \
            enumerate(cases):
        args, kw = k2_case(dtype, bh, g, n, d, chunk, n_valid, phi,
                           SEED + 10 + i, cot)
        with torch.no_grad():
            got = flow_fused_bwd_call(*args, **kw)
        want = flow_fused_bwd_ref(*args[:4], *args[5:], **kw)
        torch.cuda.synchronize()
        tag = (f"flow_fused_bwd {str(dtype)[6:]} BH={bh} G={g} N={n} "
               f"valid={n_valid} {phi} D={d}")
        err = max(max_err(f"{tag} {name}", a, b, TOL[dtype])
                  for name, a, b in zip(("dq", "dk", "dv"), got, want))
        for name, a in zip(("dq", "dk", "dv"), got):
            if a[..., n_valid:, :].any():
                raise AssertionError(f"{tag} {name}: non-zero past n_valid")
        key = (dtype, "d24") if d == 24 else dtype
        errs[key] = max(errs.get(key, 0.0), err)
        print(f"[K2] {tag}: grads {err:.3e}", flush=True)
    return {"max_abs_err": errs[torch.bfloat16],
            "d24": errs[torch.bfloat16, "d24"]}


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
    # the Table 7 harness's linear row: D = Dv = 24 padded to 32 by the
    # glue, at chunk_size=0 (K5a's own chunk), N = 60; and D = 24 beside
    # Dv = 64
    d24 = {}
    for d, dv in ((24, 24), (24, 64)):
        q, k, v, g = chunk_operands(32 * 4, 1, 60, d, dv, SEED + 52 + dv)
        shaped = lambda x: x.reshape(32, 4, *x.shape[1:])  # noqa: E731
        q, g = shaped(q), shaped(g)
        k, v = shaped(k), shaped(v)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = chunked_causal_dot_cuda(*leaves, chunk=0)
        want = causal_dot_grouped(*plain, chunk_size=0, use_kernel=False)
        tag = f"fp32 chunk_size=0 G=1 N=60 D={d} Dv={dv}"
        e = dot_close(f"flow_chunk {tag} out", out.detach(), want.detach())
        gk = torch.autograd.grad(out, leaves, g)
        gp = torch.autograd.grad(want, plain, g)
        edq = dot_close(f"FlowChunkDot {tag} dq", gk[0], gp[0])
        edkv = max(dot_close(f"FlowChunkDot {tag} d{name}", a, b_)
                   for name, a, b_ in zip("kv", gk[1:], gp[1:]))
        torch.cuda.synchronize()
        if (d, dv) == (24, 24):
            d24 = {"flow_chunk_d24": max(e, edq), "flow_chunk_dkv_d24": edkv}
        print(f"[K5] {tag}: out {e:.3e}, dq (K5a) {edq:.3e}, dk/dv (K5b) "
              f"{edkv:.3e}", flush=True)
    return {"flow_chunk": e5a, "flow_chunk_dkv": e5b, **d24}


def decode_pool(slots, hkv, d, seed, dv=None):
    """A non-zero FlowState pool: counts 16..384, sums of that magnitude;
    S is D x Dv (Dv = D unless given)."""
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
        s=torch.randn((slots, hkv, d, dv or d), generator=gen, device=DEVICE))


def decode_token(gen, slots, hkv, g, d, dtype, dv=None):
    mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
    return (mk(slots, hkv * g, 1, d), mk(slots, hkv, 1, d),
            mk(slots, hkv, 1, dv or d))


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
    """A copy of an int8 pool of any state type (FlowState, RG-LRU, SSD)."""
    from repro_torch.utils import tree_map

    return pool.with_state(tree_map(torch.clone, pool.payload),
                           tree_map(torch.clone, pool.scale))


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
    if cfg.attention.kind == "linear":  # K5a in each prefill, plain decode
        expect_only(launches, {"flow_chunk": n_layers * rounds},
                    f"linear serving, {state_dtype or 'fp32'} pools")
    elif launches["flow_fused"] != n_layers * rounds:
        raise AssertionError(f"flow_fused launched {launches['flow_fused']}"
                             f" times, want {n_layers} x {rounds} rounds")
    decode, idle = (("flow_decode_q", "flow_decode") if state_dtype == "int8"
                    else ("flow_decode", "flow_decode_q"))
    if cfg.attention.kind != "linear" and (
            launches[decode] != n_layers * steps or launches[idle]):
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
    tag = "engine bf16" + (", linear" if cfg.attention.kind == "linear"
                           else "")
    if state_dtype is None:
        print(f"[{tag}] " + json.dumps(stats), flush=True)
        return stats
    stats["fp32_pool_bytes"] = pool_bytes(lm.init_caches(
        cfg, 16, 512, device=DEVICE))
    print(f"[{tag}, {state_dtype} pools] " + json.dumps(stats), flush=True)
    return stats


def device_profile(window, step_ms: float, keys: dict, tag: str, *,
                   top: int = 8, host: bool = False) -> dict:
    """Where the device time of a window of steps goes, from
    ``torch.profiler``: ``window()`` runs the steps and returns how many it
    ran.  The stats give the device time a step by kernel (the ``top``
    kernels), the kernels launched a step, and the device's busy share of
    ``step_ms``, the unprofiled time of one step.  ``keys`` maps labels to
    a kernel-name substring, or a tuple of them, whose device time a step
    is summed; ``host`` adds the profiled host time by operator."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps = window()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / steps

    def by_name(key):
        names = (key,) if isinstance(key, str) else key
        return sum(dev_ms(e) for e in dev if any(k in e.key for k in names))

    busy = sum(dev_ms(e) for e in dev)
    stats = {"steps": steps, "device_ms_per_step": busy,
             "kernels_per_step": sum(e.count for e in dev) / steps,
             "step_ms_unprofiled": step_ms,
             "device_busy_share": busy / step_ms,
             **{label: by_name(key) for label, key in keys.items()},
             "device_ms_per_step_by_kernel": {
                 e.key[:80]: dev_ms(e)
                 for e in sorted(dev, key=dev_ms, reverse=True)[:top]}}
    if host:
        cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_cpu_time_total, reverse=True)
        stats["host_ms_per_step_by_op_profiled"] = {
            e.key[:80]: e.self_cpu_time_total / 1e3 / steps
            for e in cpu[:top]}
    print(f"[profile {tag}] " + json.dumps(stats), flush=True)
    return stats


def repeat(run, steps: int):
    """A profile window of ``steps`` calls of ``run``."""
    def window():
        for _ in range(steps):
            run()
        return steps
    return window


#: kernel-name substrings of the cuBLAS GEMMs on an H100
GEMM_KEYS = ("gemm", "Gemm", "sm90_xmma", "nvjet")


def profile_decode(params, cfg, step_ms: float, state_dtype=None,
                   paged=None) -> dict:
    """Phase 5b (5c's with ``state_dtype``): where a decode step's time
    goes, from ``torch.profiler`` over a window of full-pool decode steps:
    device time by kernel, the kernels launched, and host time by
    operator.  Every step decodes all 16 slots, live or not, so its device
    work is that of phase 5 (5c; 17 and 17b with ``paged``, whose pool of
    a PagedSpec gathers every slot's whole page row), whose unprofiled
    mean step time gives the device's busy share."""
    from repro_torch.serving.engine import Engine

    engine = Engine(params, cfg, slots=16, max_len=512, seed=SEED,
                    paged=paged, state_dtype=state_dtype, device=DEVICE)
    for r in requests(np.random.default_rng(SEED + 8), 16, cfg.vocab_size,
                      (128, 128), (12, 12)):
        engine.submit(r)
    engine.step()  # the admission round stays outside the window

    def window():
        steps = 0
        while engine.step():
            steps += 1
        return steps

    # K8a's kernel (17) or K8b's (17b)
    keys = {} if paged is None else {"paged_gather_ms_per_step":
                                     "paged_gather"}
    tag = "decode" + ("" if paged is None else " softmax paged") + (
        "" if state_dtype is None else f", {state_dtype} pools")
    return device_profile(window, step_ms, keys, tag, host=True)


def recording_routes(engine, record: list):
    """Record every MoE call's chosen experts of the live tokens while
    ``engine`` runs: ``lm.moe`` wrapped to append (expert ids sorted per
    token, top-(k+1) router probabilities) of the tokens that a request
    reads -- the valid positions of a packed prefill (``lm.prefill``'s
    ``lengths``), the live slots of a decode step (``Worker.step``'s
    ``live``).  Returns the function that undoes the wrapping."""
    from repro_torch.layers import moe as moe_lib
    from repro_torch.models import lm

    real_moe, real_prefill, worker = lm.moe, lm.prefill, engine.worker
    real_step, live = worker.step, {}

    def moe(p, x, act, mcfg, **kw):
        probs, _, idx = moe_lib.route(p, x.reshape(-1, x.shape[-1]), mcfg)
        keep = live["mask"].to(x.device)
        top = torch.topk(probs[keep], mcfg.top_k + 1, dim=-1).values
        record.append((torch.sort(idx[keep], dim=-1).values.cpu(), top.cpu()))
        return real_moe(p, x, act, mcfg, **kw)

    def prefill(p, inputs, c, max_len, *, lengths=None, **kw):
        n = inputs.shape[1]
        lens = (torch.full((inputs.shape[0],), n) if lengths is None
                else lengths.cpu())
        live["mask"] = (torch.arange(n)[None, :] < lens[:, None]).reshape(-1)
        return real_prefill(p, inputs, c, max_len, lengths=lengths, **kw)

    def step(tokens, pos, temps, is_live):
        live["mask"] = torch.as_tensor(np.asarray(is_live, dtype=bool))
        return real_step(tokens, pos, temps, is_live)

    lm.moe, lm.prefill, worker.step = moe, prefill, step

    def undo():
        lm.moe, lm.prefill = real_moe, real_prefill
        worker.step = real_step
    return undo


def routes_agree(tag: str, kernel: list, plain: list) -> int:
    """Raise at the first live token whose chosen experts differ between
    the kernel run and the plain run, with the plain run's router top-k
    margin there (the k-th minus the (k+1)-th probability); returns the
    token-layer routings compared."""
    if len(kernel) != len(plain):
        raise AssertionError(f"{tag}: {len(kernel)} MoE calls on the "
                             f"kernels, {len(plain)} on the plain path")
    seen = 0
    for call, ((ka, _), (pa, ptop)) in enumerate(zip(kernel, plain)):
        bad = (ka != pa).any(dim=-1).nonzero()
        if len(bad):
            i = int(bad[0, 0])
            margin = float(ptop[i, -2] - ptop[i, -1])
            print(f"[fp32 experts] {tag}: MoE call {call}, live token {i}: "
                  f"kernels {ka[i].tolist()}, plain {pa[i].tolist()}, plain "
                  f"router top-k margin {margin:.3e}", flush=True)
            raise AssertionError(f"{tag}: chosen experts differ at MoE call "
                                 f"{call}, token {i}")
        seen += len(ka)
    return seen


def serve_fp32_both_paths(params, cfg):
    """Phase 6: fp32 greedy tokens, kernels vs the plain PyTorch path; on a
    MoE stack also every live token's chosen experts at every layer."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    runs, cfgs, routes = {}, {}, {}
    for backend in ("auto", "plain"):
        cfgs[backend] = c = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, backend=backend))
        engine = Engine(params, c, slots=8, max_len=256, seed=SEED,
                        dtype=torch.float32, device=DEVICE)
        for r in requests(np.random.default_rng(SEED + 5), 12,
                          cfg.vocab_size, (16, 128), (16, 16)):
            engine.submit(r)
        reset_launches()
        routes[backend] = []
        undo = (recording_routes(engine, routes[backend])
                if cfg.moe is not None else (lambda: None))
        # the plain path's rglru conv histories: K9's plain version
        undo_k9 = (bind_plain_boundary() if backend == "plain"
                   and "rglru" in cfg.pattern else (lambda: None))
        try:
            runs[backend] = {r.uid: r for r in engine.run()}
        finally:
            undo()
            undo_k9()
        serving = ([LAUNCHES["flow_chunk"]] if cfg.attention.kind == "linear"
                   else [LAUNCHES["flow_fused"], LAUNCHES["flow_decode"]])
        if (backend == "auto" and min(serving) == 0) or (
                backend == "plain" and max(LAUNCHES.values()) > 0):
            raise AssertionError(f"backend={backend}: launches {LAUNCHES}")
    if cfg.moe is not None:
        n_routed = routes_agree(cfg.name, routes["auto"], routes["plain"])
        print(f"[fp32 experts] {cfg.name}: every live token's {cfg.moe.top_k}"
              f" experts equal on the kernels and the plain path, "
              f"{n_routed} token-layer routings over "
              f"{len(routes['plain'])} MoE calls", flush=True)
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
    print(f"[fp32 {cfg.attention.kind}] kernels and plain path agree on all "
          f"{n_tok} greedy tokens of {len(runs['plain'])} requests",
          flush=True)


def int8_pools_close(name: str, got, want) -> float:
    """``q_pool_close`` for a flow pool; for another int8 pool (an RG-LRU
    or SSD layer's, stepped by plain code on both paths from inputs that
    differ by the flow layers' rounding) every int8 payload at most 1 LSB
    apart on at most 1e-3 of its entries, the scales within 1e-5 and the
    raw leaves at TOL.  Returns the share of payload entries that differ."""
    from repro_torch.attention.recurrent import FlowState
    from repro_torch.utils import tree_leaves

    if isinstance(got.payload, FlowState):
        return q_pool_close(name, got, want)[1]
    n, differ = 0, 0
    for i, (a, b) in enumerate(zip(tree_leaves(got.payload),
                                   tree_leaves(want.payload))):
        if a.dtype == torch.int8:
            diff = (a.int() - b.int()).abs()
            if int(diff.max()) > 1:
                raise AssertionError(f"{name} leaf {i}: payloads "
                                     f"{int(diff.max())} LSB apart")
            n, differ = n + diff.numel(), differ + int((diff > 0).sum())
        elif a.is_floating_point():
            max_err(f"{name} raw leaf {i}", a, b, TOL[torch.float32])
        elif not torch.equal(a, b):
            raise AssertionError(f"{name} leaf {i}: counts differ")
    for i, (a, b) in enumerate(zip(tree_leaves(got.scale),
                                   tree_leaves(want.scale))):
        max_err(f"{name} scale {i}", a, b, (1e-5, 0.0))
    if differ > 1e-3 * max(n, 1):
        raise AssertionError(f"{name}: {differ} of {n} payload entries "
                             "differ")
    return differ / max(n, 1)


def serve_int8_fp32_against_plain(params, cfg):
    """Phase 6b (and 39b, 39d): the int8 Engine in fp32 at full width on
    the kernels; before every decode step the plain path takes the same
    step from a copy of the same pools, with the same tokens and
    positions.  On a hybrid stack the RG-LRU pools step in plain code on
    both paths (``int8_pools_close``)."""
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
            checked["payload_share"] = max(
                checked["payload_share"], int8_pools_close(
                    f"int8 fp32 step {step} layer {i}", pool, ref))
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
        worker.step = real_step  # no cycle keeps the Engine's weights
    n_flow, n_rglru = hybrid_layers(cfg)
    want = {"flow_fused": n_flow * worker.admission_rounds,
            "flow_decode_q": n_flow * worker.decode_steps}
    if n_rglru:
        want["boundary_gather"] = n_rglru * worker.admission_rounds
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
    print(f"[int8 fp32 {cfg.name}, {cfg.n_layers} layers] kernels vs "
          f"plain step by step over "
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
    from repro_torch.launch.train import train
    from repro_torch.models import lm

    params = lm.init(cfg, torch.Generator().manual_seed(SEED + 1),
                     device=DEVICE)  # uploaded before the window opens

    def window():
        train(cfg, steps=2, batch=batch, seq=seq, seed=SEED + 1,
              device=DEVICE, params=params)
        return 2

    return device_profile(window, step_ms, kernels, tag, host=True)


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


#: phases 35-35d: phase 7's shape (16 x 512 tokens a step)
LIFE_BATCH, LIFE_SEQ = 16, 512
#: phase 35's prediction: the arrays of one AdamW checkpoint of the
#: full-width flowformer_lm, fp32 master, m and v (3 x 52,442,112 x 4 B),
#: and the two int32 step counters
CKPT_ARRAY_BYTES = 3 * 209_768_448 + 2 * 4
#: phase 35b: fp32 values in Adafactor's vr and vc for the full-width
#: flowformer_lm, in the reference's stacked layout (its adafactor_init)
ADAFACTOR_VALUES = 124_954


def bitwise_equal(a, b) -> bool:
    """Two leaves (tensors or Python numbers) equal bit for bit."""
    if not isinstance(b, torch.Tensor):
        return type(a) is type(b) and a == b
    return (isinstance(a, torch.Tensor) and a.dtype == b.dtype
            and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def states_bitwise(what: str, got, want):
    """Every leaf of two TrainStates equal bit for bit."""
    from repro_torch.utils import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    bad = sum(not bitwise_equal(x, y) for x, y in zip(a, b))
    if len(a) != len(b) or bad:
        raise AssertionError(f"{what}: {bad} of {len(b)} leaves differ "
                             f"({len(a)} against {len(b)} leaves)")
    return len(b)


def blank_like(state):
    """A restore target shaped as ``state``: empty tensors, int zeros."""
    from repro_torch.utils import tree_map

    return tree_map(lambda x: torch.empty_like(x)
                    if isinstance(x, torch.Tensor) else 0, state)


def state_array_bytes(state) -> int:
    """Bytes of the arrays a checkpoint of ``state`` stores (a Python int
    as an int32)."""
    from repro_torch.utils import tree_leaves

    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else 4 for x in tree_leaves(state))


def train_crash_restart(cfg, params, root: Path) -> dict:
    """Phase 35: crash-restart through ``launch/train.py::train`` at full
    width in bf16 (phase 7's shape and weights from the seed): run A
    trains 4 steps with a checkpoint every 2; run B trains 2, and a fresh
    ``train()`` resumes B to 4.  B resumes from step 2; its last two losses
    and every leaf of its final TrainState equal A's bit for bit (no
    kernel adds floats atomically and nothing in the step draws random
    numbers); exactly 12 K1 and 6 K2 a step and nothing else.  Then one
    synchronous save and one restore of that state, timed, into a
    directory of their own."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import train

    kw = dict(batch=LIFE_BATCH, seq=LIFE_SEQ, seed=SEED, device=DEVICE,
              params=params, ckpt_every=2)
    torch.cuda.synchronize()
    reset_launches()
    full = train(cfg, steps=4, ckpt_dir=str(root / "a"), **kw)
    first = train(cfg, steps=2, ckpt_dir=str(root / "b"), **kw)
    resumed = train(cfg, steps=4, ckpt_dir=str(root / "b"), **kw)
    launches = dict(LAUNCHES)
    n = cfg.n_layers * (4 + 2 + 2)
    expect_only(launches, {"flow_fused": 2 * n, "flow_fused_bwd": n},
                "crash-restart training")
    hist = full["history"]
    if not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"crash-restart losses {hist}")
    if (first["start_step"], resumed["start_step"]) != (0, 2):
        raise AssertionError(f"run B resumed from step "
                             f"{resumed['start_step']}, want 2")
    if first["history"] != hist[:2] or resumed["history"] != hist[2:]:
        raise AssertionError(f"losses: A {hist}, B {first['history']} then "
                             f"{resumed['history']}")
    leaves = states_bitwise("resumed run B's state against run A's",
                            resumed["state"], full["state"])
    shutil.rmtree(root / "a")
    array_bytes = state_array_bytes(resumed["state"])
    if array_bytes != CKPT_ARRAY_BYTES:
        raise AssertionError(f"checkpoint arrays {array_bytes} B, predicted "
                             f"{CKPT_ARRAY_BYTES}")
    step_dir = root / "b" / f"step_{4:012d}"
    file_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    mgr = CheckpointManager(root / "sync")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(4, resumed["state"])
    save_s = time.perf_counter() - t0
    like = blank_like(resumed["state"])
    t0 = time.perf_counter()
    back, _ = mgr.restore(4, like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    states_bitwise("a synchronous save and restore", back, resumed["state"])
    shutil.rmtree(root / "sync")
    stats = {"leaves_equal": leaves, "losses": hist,
             "array_bytes": array_bytes, "file_bytes": file_bytes,
             "sync_save_s": save_s, "restore_s": restore_s,
             "resume_restore_s": resumed["ckpt"]["restore_s"],
             "async_save_s": full["ckpt"]["async_save_s"],
             "final_save_s": full["ckpt"]["save_s"],
             "step_ms_a": [1e3 * t for t in full["step_s"]],
             "step_ms_b_resumed": [1e3 * t for t in resumed["step_s"]],
             "launches": launches}
    print("[train crash-restart] " + json.dumps(stats), flush=True)
    return stats


def lifecycle_step(cfg, tcfg, params, layout=None):
    """(step_fn, state) of ``make_train_step`` on ``cfg`` with ``tcfg``,
    attention bound once for gradients; ``params`` are cloned."""
    from repro_torch.layers.attention import executor_of, plan_of
    from repro_torch.models import lm
    from repro_torch.training.train_state import (init_train_state,
                                                  make_train_step)
    from repro_torch.utils import tree_map

    loss = functools.partial(lm.loss_fn, cfg=cfg, dtype=tcfg.compute_dtype,
                             plan=executor_of(cfg, plan_of(
                                 cfg, needs_grad=True)))
    return (make_train_step(loss, tcfg, layout=layout),
            init_train_state(tree_map(torch.clone, params), tcfg, layout))


def run_steps(step_fn, state, steps: int, batch: int, seq: int, vocab: int):
    """``steps`` steps on ``lm_loader(SEED)``; (state, losses, step s)."""
    from repro_torch.data.loader import lm_loader

    loader = lm_loader(SEED, batch=batch, seq=seq, vocab=vocab)
    hist, step_s = [], []
    for _ in range(steps):
        b = next(loader)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {k: torch.from_numpy(v).to(DEVICE)
                                         for k, v in b.items()})
        hist.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    return state, hist, step_s


def train_adafactor_full_width(cfg, params, adamw_step_ms: float,
                               root: Path) -> dict:
    """Phase 35b: Adafactor at full width in bf16, 3 steps of phase 7's
    shape through ``make_train_step(TrainConfig(optimizer="adafactor"))``:
    finite losses, exactly 124,954 fp32 values of state (the reference's
    stacked layout), phase 7's launches (12 K1, 6 K2 a step), and a
    checkpoint round trip of the TrainState bitwise; its step time beside
    phase 7's AdamW step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.training.train_state import TrainConfig
    from repro_torch.utils import tree_leaves

    steps = 3
    tcfg = TrainConfig(optimizer="adafactor", total_steps=steps, warmup=1,
                       fused_value_grad=True, compute_dtype=torch.bfloat16)
    step_fn, state = lifecycle_step(cfg, tcfg, params, layout=cfg)
    moments = tree_leaves((state.opt.vr, state.opt.vc))
    values = sum(x.numel() for x in moments)
    if values != ADAFACTOR_VALUES or any(x.dtype != torch.float32
                                         for x in moments):
        raise AssertionError(f"Adafactor state holds {values} values, want "
                             f"{ADAFACTOR_VALUES} fp32")
    torch.cuda.synchronize()
    reset_launches()
    state, hist, step_s = run_steps(step_fn, state, steps, LIFE_BATCH,
                                    LIFE_SEQ, cfg.vocab_size)
    launches = dict(LAUNCHES)
    n = cfg.n_layers * steps
    expect_only(launches, {"flow_fused": 2 * n, "flow_fused_bwd": n},
                "Adafactor training")
    if not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"Adafactor losses {hist}")
    mgr = CheckpointManager(root / "adafactor")
    t0 = time.perf_counter()
    mgr.save(steps, state)
    save_s = time.perf_counter() - t0
    back, _ = mgr.restore(steps, blank_like(state))
    leaves = states_bitwise("the Adafactor TrainState's checkpoint round "
                            "trip", back, state)
    shutil.rmtree(root / "adafactor")
    step_ms = 1e3 * statistics.median(step_s[1:])
    stats = {"steps": steps, "losses": hist, "state_values": values,
             "state_bytes": 4 * values,
             "adamw_state_bytes": 2 * 4 * sum(x.numel() for x in
                                               tree_leaves(params)),
             "first_step_ms": 1e3 * step_s[0], "step_ms": step_ms,
             "adamw_step_ms": adamw_step_ms,
             "checkpoint_leaves_equal": leaves, "sync_save_s": save_s,
             "launches": launches}
    print("[train adafactor bf16] " + json.dumps(stats), flush=True)
    return stats


def adafactor_fp32_both_paths(cfg):
    """Phase 35c: Adafactor in fp32 at full width and 2 layers (still one
    stacked leaf per weight), 3 steps on the kernels and on the plain
    path: losses within rtol 1e-4 and every parameter after step 3 within
    1e-4 of that leaf's max |plain| (phase 8's bounds)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.training.train_state import TrainConfig
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(cfg, n_layers=2)
    steps = 3
    params = lm.init(cfg, torch.Generator().manual_seed(SEED + 2),
                     device=DEVICE)
    tcfg = TrainConfig(optimizer="adafactor", total_steps=steps, warmup=1,
                       fused_value_grad=True, compute_dtype=torch.float32)
    hist, master = {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        step_fn, state = lifecycle_step(c, tcfg, params, layout=c)
        torch.cuda.synchronize()
        reset_launches()
        state, hist[backend], _ = run_steps(step_fn, state, steps, LIFE_BATCH,
                                            LIFE_SEQ, c.vocab_size)
        n = c.n_layers * steps
        expect_only(dict(LAUNCHES), {"flow_fused": 2 * n,
                                     "flow_fused_bwd": n}
                    if backend == "auto" else {},
                    f"Adafactor fp32 backend={backend}")
        master[backend] = tree_leaves(state.master)
    for i, (a, b) in enumerate(zip(hist["auto"], hist["plain"])):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"Adafactor fp32 step {i} loss: kernels "
                                 f"{a}, plain {b}")
    worst = worst_move = 0.0
    for a, b, p0 in zip(master["auto"], master["plain"],
                        tree_leaves(params)):
        scale, err = float(b.abs().max()), float((a - b).abs().max())
        if not err <= 1e-4 * scale:
            raise AssertionError(f"Adafactor fp32 master after {steps} "
                                 f"steps: |diff| {err:.3e}, max |plain| "
                                 f"{scale:.3e}")
        worst = max(worst, err / scale)
        move = float((b - p0).abs().max())
        worst_move = max(worst_move, err / move if move else 0.0)
    print(f"[adafactor fp32] kernels vs plain, 2 layers x {steps} steps: "
          f"losses {hist['auto']} vs {hist['plain']}; every parameter "
          f"within {worst:.3e} of its max (worst |diff| / max |update| "
          f"{worst_move:.3e}, not gated)", flush=True)


#: phase 35d: each --attn kind's launches a layer and step (linear: K5a in
#: the forward, its remat recompute and the backward's dq, K5b for dk, dv)
ATTN_KIND_LAUNCHES = {"softmax": {}, "linear": {"flow_chunk": 3,
                                                "flow_chunk_dkv": 1}}


def train_attn_kinds_full_width(cfg, params) -> dict:
    """Phase 35d: ``--attn softmax`` and ``--attn linear`` at full width in
    bf16, 3 steps each through ``train()`` (the same leaves as flow, phase
    7's weights): finite losses, softmax launching no kernel of
    ``KERNELS``, linear exactly ``ATTN_KIND_LAUNCHES`` a layer and step."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import train

    steps, runs, total = 3, {}, {}
    for kind, per in ATTN_KIND_LAUNCHES.items():
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, kind=kind))
        torch.cuda.synchronize()
        reset_launches()
        out = train(c, steps=steps, batch=LIFE_BATCH, seq=LIFE_SEQ,
                    seed=SEED, device=DEVICE, params=params)
        launches = dict(LAUNCHES)
        n = c.n_layers * steps
        expect_only(launches, {k: v * n for k, v in per.items()},
                    f"--attn {kind} training")
        if not all(math.isfinite(x) for x in out["history"]):
            raise AssertionError(f"--attn {kind} losses {out['history']}")
        runs[kind] = {"losses": out["history"],
                      "first_step_ms": 1e3 * out["step_s"][0],
                      "step_ms": 1e3 * statistics.median(out["step_s"][1:]),
                      "launches_per_step": {k: launches[k] // steps
                                            for k in per}}
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    print("[train --attn] " + json.dumps(runs), flush=True)
    return {**runs, "launches": total}


def elastic_resume(cfg, params, root: Path) -> dict:
    """Phase 35d's end: ``ElasticTrainer.recover(1)`` plans (1, 1) and
    restores phase 35's step-4 checkpoint (run B's) into the template of
    a 5-step run; one more step equals step 5 of an uninterrupted 5-step
    run, its loss and every leaf of its TrainState bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.loader import lm_loader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import build_train, train
    from repro_torch.runtime import ElasticTrainer, MeshPlan
    from repro_torch.training.train_state import gather_state

    steps = 5
    kw = dict(steps=steps, batch=LIFE_BATCH, seq=LIFE_SEQ, seed=SEED,
              device=DEVICE, params=params)
    torch.cuda.synchronize()
    reset_launches()
    full = train(cfg, **kw)
    trainer = ElasticTrainer(lambda plan: build_train(cfg, **kw),
                             CheckpointManager(root / "b"))
    plan, step_fn, state, step = trainer.recover(n_healthy=1)
    if plan != MeshPlan((1, 1), ("data", "model")) or step != 4:
        raise AssertionError(f"recover(1) planned {plan} at step {step}")
    loader = lm_loader(SEED, batch=LIFE_BATCH, seq=LIFE_SEQ,
                       vocab=cfg.vocab_size, start_step=step)
    state, metrics = step_fn(state, {k: torch.from_numpy(v).to(DEVICE)
                                     for k, v in next(loader).items()})
    loss = float(metrics["loss"])
    launches = dict(LAUNCHES)
    n = cfg.n_layers * (steps + 1)
    expect_only(launches, {"flow_fused": 2 * n, "flow_fused_bwd": n},
                "elastic resume")
    if loss != full["history"][-1]:
        raise AssertionError(f"step 5 after recover(1): loss {loss}, "
                             f"uninterrupted {full['history'][-1]}")
    leaves = states_bitwise("the state after recover(1) and one step",
                            gather_state(state, cfg), full["state"])
    print(f"[elastic] recover(1): plan {plan.shape}, restored step {step}; "
          f"step 5 loss {loss} equal to the uninterrupted run's, {leaves} "
          "state leaves bitwise", flush=True)
    return {"launches": launches}


#: phase 36: the context-parallel kernels at flowformer_lm's attention
#: (B = 4, 8 kv heads, G = 1, D = 64) and granite_8b's (B = 2, 8 kv heads,
#: G = 4, D = 128), and phase 42: at DeepSeek-V2-Lite's (B = 4, 16 MLA
#: heads of (192, 128), G = 1) and RecurrentGemma-9B's (B = 4, one kv head,
#: G = 16, (256, 256)); N = 4,096, chunk 128, split 4 and 8 ways on cuda:0
#: (local N 1,024 and 512); cp_nc at the LRA shape (32 x 4 heads of 64).
#: (tag, B, kv heads, G, D, Dv)
CP_CAUSAL_SHAPES = (("flowformer_lm", 4, 8, 1, 64, 64),
                    ("granite_8b G=4", 2, 8, 4, 128, 128),
                    ("deepseek_v2_lite_16b", 4, 16, 1, 192, 128),
                    ("recurrentgemma_9b G=16", 4, 1, 16, 256, 256))
CP_N, CP_CHUNK, CP_WAYS = 4096, 128, (4, 8)
CP_PACKED_LENS = (512, 4096)
CP_NC_SHAPE = (32, 4, 4096, 64)
#: phase 36b: sequence-parallel prefill, rows x tokens on a (1, 4) mesh
CP_PREFILL = (4, 2048)
#: phase 36c: the meshes of the sharded train step, and its steps
CP_TRAIN_MESHES = ((4, 1), (2, 2))
CP_TRAIN_STEPS = 3
#: phase 36c: sharded bf16 training against the (1, 1) step, relative
#: bounds on the losses and on one step's gradient norm (PR 32's chip run
#: read 2.4e-6 and 1.5e-3: bf16 slices of 4 rows round otherwise than 16)
CP_TRAIN_LOSS_RTOL = 1e-3
CP_TRAIN_GNORM_RTOL = 1e-2
#: phase 36: cp_nc's gradients against the unsharded plain nc's (and K6 +
#: K7b's), each leaf's max |diff| over its max |grad|.  PR 32's chip run
#: read dq 4.8e-4, dk 1.1e-2, dv 7.8e-7 (3.8e-6 against K7b);
#: tools/cp_nc_grad_precision.py puts the fp32 paths 5e-3 (dq), 13.9 % (dk)
#: and 6e-7 (dv) of each max from an fp64 run: dk's clamp kinks at every
#: source, so its bound is twice that distance
CP_NC_GRAD_BOUND = {"q": 1e-2, "k": 0.3, "v": 1e-4}


def cp_mesh(shape, axes):
    """A mesh of ``shape`` over every CUDA device (all of it ``cuda:0`` on
    one card), or of CPU positions in a rehearsal."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes,
                     devices=None if DEVICE == "cuda" else [DEVICE])


def cp_inputs(b, hkv, g, n, d, seed, dv=None):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=DEVICE)  # noqa: E731
    return mk(b, hkv * g, n, d), mk(b, hkv, n, d), mk(b, hkv, n, dv or d)


def wall_ms(fn, reps: int = 3) -> float:
    """Mean wall ms of ``reps`` synchronized runs of ``fn`` after one warm
    run: the host's part counts (a sharded op is host-driven)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def state_close(name: str, got, want) -> float:
    """Every FlowState field within phase 3d's K5a tolerance (``t``
    exactly)."""
    if not torch.equal(got.t.long().cpu(), want.t.long().cpu()):
        raise AssertionError(f"{name}: t {got.t.tolist()} != "
                             f"{want.t.tolist()}")
    return max(dot_close(f"{name} {f}", getattr(got, f), getattr(want, f))
               for f in STATE_FIELDS)


def sq_grads(ex, q, k, v):
    """The gradients of sum(out^2) through ``ex.forward``."""
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ex.forward(*leaves)
    return torch.autograd.grad((out.float() ** 2).sum(), leaves)


def check_context_parallel() -> dict:
    """Phases 36 and 42: ``cp_causal`` on 4- and 8-way meshes of the card
    resolves its shard-local inner to ``cuda_chunk`` (K5a), and its
    forward, prefill and packed prefill (lens spread over 512-4,096) match
    the unsharded K1 path (and, at D <= 128, the pinned plain ``cumsum``,
    whose (B, H, N, D, Dv) running states take 26 GB at DeepSeek's shape),
    and its gradient of sum(out^2) (K5a forward; K5a and K5b backward) the
    unsharded K1 + K2 gradient, all within phase 3d's K5a tolerance; at
    CP_CAUSAL_SHAPES (phase 36: flowformer_lm's and granite_8b's; phase
    42: the wide pairs of DeepSeek-V2-Lite and RecurrentGemma-9B).
    ``cp_nc`` at the LRA shape against the unsharded K6 (its gradients
    printed against the plain ``nc``'s and K6 + K7b's).  Exactly ``ways``
    K5a a forward or prefill and ``2 ways`` K5a + ``ways`` K5b a step with
    gradients (K5a at (D, Dv), the gradients' dq at (Dv, D), K5b at (D,
    Dv)), no other kernel; ``cp_nc`` launches none."""
    from repro_torch import attention
    from repro_torch.attention import (ExecutionPlan, FlowConfig, ShapeInfo,
                                       ShardSpec)
    from repro_torch.kernels import LAUNCHES, PAIR_LAUNCHES, reset_launches

    launched, pairs = collections.Counter(), collections.Counter()
    errs, times = {}, {}
    rng = np.random.default_rng(SEED + 360)
    for tag, b, hkv, g, d, dv in CP_CAUSAL_SHAPES:
        q, k, v = cp_inputs(b, hkv, g, CP_N, d, SEED + 361 + d, dv)
        wide = max(d, dv) > 128
        lens = torch.tensor(rng.integers(CP_PACKED_LENS[0],
                                         CP_PACKED_LENS[1] + 1, b),
                            dtype=torch.int32, device=DEVICE)
        cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=CP_CHUNK)
        fused = attention.resolve(ExecutionPlan(flow=cfg))
        plain = attention.resolve(ExecutionPlan(
            flow=dataclasses.replace(cfg, backend="cumsum")))
        shapes = ShapeInfo.from_qkv(q, k, v)
        with torch.no_grad():
            want = {"forward": fused.forward(q, k, v),
                    "prefill": fused.prefill(q, k, v),
                    "packed": fused.prefill(q, k, v, lengths=lens)}
            floor = {} if wide else {
                "forward": plain.forward(q, k, v),
                "prefill": plain.prefill(q, k, v),
                "packed": plain.prefill(q, k, v, lengths=lens)}
        want_g = sq_grads(attention.resolve(ExecutionPlan(
            flow=cfg, needs_grad=True)), q, k, v)
        torch.cuda.synchronize()
        for ways in CP_WAYS:
            plan = ExecutionPlan(flow=cfg, shard=ShardSpec(
                axis="seq", mesh=cp_mesh((ways,), ("seq",))))
            ex = attention.resolve(plan)
            rows = dict((n, (ok, w)) for n, ok, w in attention.explain(
                plan, shapes, platform=DEVICE, op="forward").sections[0][1])
            ok, why = rows["cp_causal"]
            if not ok or "inner=cuda_chunk" not in why:
                raise AssertionError(f"cp_causal {tag} {ways}-way: {why}")
            print(f"[cp] {tag} {ways}-way: explain cp_causal: {why}",
                  flush=True)
            name = f"cp_causal {tag} {ways}-way local N={CP_N // ways}"
            torch.cuda.synchronize()
            reset_launches()
            with torch.no_grad():
                got = {"forward": ex.forward(q, k, v),
                       "prefill": ex.prefill(q, k, v),
                       "packed": ex.prefill(q, k, v, lengths=lens)}
            torch.cuda.synchronize()
            la, lp = dict(LAUNCHES), dict(PAIR_LAUNCHES)
            expect_only(la, {"flow_chunk": 3 * ways}, f"{name} forwards")
            expect_pairs(lp, chunk_pairs(d, dv, k5a=3 * ways),
                         f"{name} forwards")
            launched.update(la)
            pairs.update(lp)
            e = {"out_vs_k1": dot_close(f"{name} out vs K1", got["forward"],
                                        want["forward"])}
            if floor:
                e["out_vs_cumsum"] = dot_close(f"{name} out vs cumsum",
                                               got["forward"],
                                               floor["forward"])
            # a packed row's outputs past its length are padding, which
            # K1 leaves at zero
            live = (torch.arange(CP_N, device=DEVICE)[None, :]
                    < lens[:, None].long())[:, None, :, None]
            for op in ("prefill", "packed"):
                keep = live if op == "packed" else True
                e[f"{op}_out_vs_k1"] = dot_close(
                    f"{name} {op} out vs K1", got[op][0] * keep,
                    want[op][0] * keep)
                e[f"{op}_state_vs_k1"] = state_close(
                    f"{name} {op} state vs K1", got[op][1], want[op][1])
                if floor:
                    e[f"{op}_state_vs_cumsum"] = state_close(
                        f"{name} {op} state vs cumsum", got[op][1],
                        floor[op][1])
            reset_launches()
            got_g = sq_grads(attention.resolve(dataclasses.replace(
                plan, needs_grad=True)), q, k, v)
            torch.cuda.synchronize()
            la, lp = dict(LAUNCHES), dict(PAIR_LAUNCHES)
            expect_only(la, {"flow_chunk": 2 * ways, "flow_chunk_dkv": ways},
                        f"{name} gradients")
            expect_pairs(lp, chunk_pairs(d, dv, k5a=ways, dq=ways, k5b=ways),
                         f"{name} gradients")
            launched.update(la)
            pairs.update(lp)
            e["grad_vs_k2"] = max(dot_close(f"{name} d{n} vs K1 + K2", a, b_)
                                  for n, a, b_ in zip("qkv", got_g, want_g))
            e["grad_vs_k2_of_max"] = max(
                float((a - b_).abs().max() / b_.abs().max())
                for a, b_ in zip(got_g, want_g))
            with torch.no_grad():
                times[f"{tag} {ways}-way"] = {
                    "cp_forward_ms": wall_ms(lambda: ex.forward(q, k, v)),
                    "k1_forward_ms": wall_ms(lambda: fused.forward(q, k,
                                                                   v))}
            errs[f"{tag} {ways}-way"] = e
            print(f"[cp] {name}: " + json.dumps(
                {n: f"{x:.3e}" for n, x in e.items()}), flush=True)
        del q, k, v, want, floor, want_g
        torch.cuda.empty_cache()
    rows_n, h, n, d = CP_NC_SHAPE
    q, k, v = cp_inputs(rows_n, h, 1, n, d, SEED + 369)
    cfg = FlowConfig()
    with torch.no_grad():
        want = attention.resolve(ExecutionPlan(flow=cfg)).forward(q, k, v)
    kernel_g = sq_grads(attention.resolve(ExecutionPlan(flow=cfg,
                                                        needs_grad=True)),
                        q, k, v)
    # cp_nc differentiates plain einsums: its own plain version is the
    # unsharded plain nc
    want_g = sq_grads(attention.resolve(ExecutionPlan(
        flow=dataclasses.replace(cfg, backend="nc"), needs_grad=True)),
        q, k, v)
    plan = ExecutionPlan(flow=cfg, shard=ShardSpec(
        axis="seq", mesh=cp_mesh((4,), ("seq",))))
    name = f"cp_nc LRA {rows_n}x{h} N={n} 4-way"
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        got = attention.resolve(plan).forward(q, k, v)
    got_g = sq_grads(attention.resolve(dataclasses.replace(
        plan, needs_grad=True)), q, k, v)
    torch.cuda.synchronize()
    expect_only(dict(LAUNCHES), {}, name)
    # every source's conserved flow cons_src sits at 1, where its clamp
    # kinks, so roundings on either side move single dk entries by their
    # whole size (the plain fp32 path against an fp64 run alike): dk's
    # bound only catches a wrong or missing gradient
    e = {"out_vs_k6": max_err_scaled(f"{name} out vs K6", got, want,
                                     TOL[torch.float32])}
    for tag_, ref_g in (("nc", want_g), ("k7b", kernel_g)):
        for n_, a, b_ in zip("qkv", got_g, ref_g):
            rel = float((a - b_).abs().max() / b_.abs().max())
            e[f"d{n_}_vs_{tag_}_of_max"] = rel
            if not rel <= CP_NC_GRAD_BOUND[n_]:
                raise AssertionError(
                    f"{name} d{n_} vs {tag_}: {rel:.3e} of its max, bound "
                    f"{CP_NC_GRAD_BOUND[n_]}")
    errs[name] = e
    print(f"[cp] {name}: " + json.dumps({x: f"{y:.3e}" for x, y in
                                         e.items()}), flush=True)
    del q, k, v, want, want_g, kernel_g, got, got_g
    torch.cuda.empty_cache()
    print("[cp] forward wall ms (mean of 3 synchronized runs): "
          + json.dumps(times), flush=True)
    return {"launches": dict(launched), "pair_launches": dict(pairs),
            "errs": errs, "times": times}


def cp_prefill_full_width(cfg, params) -> dict:
    """Phase 36b (and 42b): ``build_prefill_step(seq_shard=True)`` for
    ``cfg`` at full width (flowformer_lm at full depth; 42b:
    deepseek_v2_lite_16b at phase 40's 2 layers and weights) on a (1, 4)
    mesh of the card, 4 x 2,048 tokens, fp32: every flow layer binds
    ``cp_causal`` (no fall-back line from the build; exactly 4 K5a a
    layer, at the heads' (D, Dv), no K1); its last-token logits and every layer's boundary
    FlowState against the unsharded ``lm.prefill`` (K1, one a layer)
    within phase 3d's K5a tolerance; both wall times."""
    import contextlib
    import io

    from repro_torch.config import ShapeSpec
    from repro_torch.kernels import LAUNCHES, PAIR_LAUNCHES, reset_launches
    from repro_torch.launch.steps import (RunPlan, build_prefill_step,
                                          training_shapes)
    from repro_torch.models import lm

    rows, n = CP_PREFILL
    f32 = torch.float32
    n_flow = hybrid_layers(cfg)[0]
    shape = ShapeSpec("prefill", n, rows, "prefill")
    heads = training_shapes(cfg, shape)
    toks = torch.from_numpy(np.random.default_rng(SEED + 370).integers(
        0, cfg.vocab_size, (rows, n))).to(DEVICE)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        step, _, _, _ = build_prefill_step(
            cfg, shape, cp_mesh((1, 4), ("data", "model")), RunPlan(),
            seq_shard=True, dtype=f32)
    print(said.getvalue(), end="", flush=True)
    if "fell back" in said.getvalue():
        raise AssertionError(f"{cfg.name}: the seq-shard plan fell back")
    wall = {}

    def run(name, fn):
        fn()  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = 1e3 * (time.perf_counter() - t0)
        return out, dict(LAUNCHES), dict(PAIR_LAUNCHES)

    with torch.no_grad():
        (logits, caches), la, lp = run("sharded_ms", lambda: step(
            params, {"inputs": toks}))
        (ul, uc), lu, _ = run("unsharded_ms", lambda: lm.prefill(
            params, toks, cfg, n, dtype=f32))
    expect_only(la, {"flow_chunk": 4 * n_flow}, "seq-sharded prefill")
    expect_pairs(lp, chunk_pairs(heads.d, heads.dv, k5a=4 * n_flow),
                 "seq-sharded prefill")
    expect_only(lu, {"flow_fused": n_flow}, "unsharded prefill")
    e = {"logits": dot_close("seq-sharded prefill logits", logits, ul)}
    e["states"] = max(state_close(f"seq-sharded prefill layer {i}", a, b)
                      for i, (a, b) in enumerate(zip(caches, uc)))
    stats = {"config": cfg.name, "errs": e, **wall, "launches": la,
             "pair_launches": lp}
    print("[cp prefill] " + json.dumps(stats), flush=True)
    return stats


def cp_train_full_width(cfg, params) -> dict:
    """Phase 36c: ``build_train_step`` for flowformer_lm at full width, 16
    x 512 in bf16 (phase 7's batches), 3 steps each on (1, 1), and on
    (4, 1) and (2, 2) meshes of the card: losses within
    ``CP_TRAIN_LOSS_RTOL`` and gradient norms within
    ``CP_TRAIN_GNORM_RTOL`` of the (1, 1) run's, exactly 12 K1 and 6 K2
    per data-parallel position a step.  Then ``compressed_psum`` on the
    full-width gradients of 4 positions: each leaf's error against the
    exact mean within half its shared int8 step (pmax |g| / 254), the
    residual's norm and the ms a call."""
    from repro_torch.config import ShapeSpec
    from repro_torch.distribution.sharding import dp_axes
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import RunPlan, build_train_step
    from repro_torch.layers.attention import executor_of, plan_of
    from repro_torch.models import lm
    from repro_torch.training.compression import compressed_psum
    from repro_torch.utils import global_norm, tree_cast, tree_leaves, tree_map

    shape = ShapeSpec("train", LIFE_SEQ, LIFE_BATCH, "train")
    over = {"total_steps": CP_TRAIN_STEPS, "fused_value_grad": True}
    runs, launched = {}, collections.Counter()
    for ms in ((1, 1), *CP_TRAIN_MESHES):
        mesh = cp_mesh(ms, ("data", "model"))
        step, init_state, _, _ = build_train_step(cfg, shape, mesh,
                                                  RunPlan(), over)
        torch.cuda.synchronize()
        reset_launches()
        state, hist, step_s = run_steps(
            lambda st, b: step(st, b), init_state(params), CP_TRAIN_STEPS,
            LIFE_BATCH, LIFE_SEQ, cfg.vocab_size)
        del state
        la = dict(LAUNCHES)
        dp = mesh.axes_size(dp_axes(mesh))
        n = cfg.n_layers * CP_TRAIN_STEPS * dp
        expect_only(la, {"flow_fused": 2 * n, "flow_fused_bwd": n},
                    f"sharded training {ms}")
        launched.update(la)
        runs[str(ms)] = {"losses": hist, "step_ms": [1e3 * t for t in step_s]}
        torch.cuda.empty_cache()
    base = runs["(1, 1)"]["losses"]
    for key, run in runs.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], base))
        run["loss_rel_vs_1x1"] = rel
        if not rel <= CP_TRAIN_LOSS_RTOL:
            raise AssertionError(f"sharded training {key}: losses "
                                 f"{run['losses']} vs (1, 1) {base}")
    # the gradient norms of one step from the same state: (1, 1) against
    # each mesh
    from repro_torch.data.loader import lm_loader

    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in next(lm_loader(
        SEED, batch=LIFE_BATCH, seq=LIFE_SEQ, vocab=cfg.vocab_size)).items()}
    gnorms = {}
    for ms in ((1, 1), *CP_TRAIN_MESHES):
        step, init_state, _, _ = build_train_step(
            cfg, shape, cp_mesh(ms, ("data", "model")), RunPlan(), over)
        reset_launches()
        _, m = step(init_state(params), batch)
        gnorms[str(ms)] = float(m["grad_norm"])
        launched.update(dict(LAUNCHES))
        torch.cuda.empty_cache()
    g0 = gnorms["(1, 1)"]
    for key, gn in gnorms.items():
        runs[key]["grad_norm"] = gn
        if not abs(gn - g0) <= CP_TRAIN_GNORM_RTOL * g0:
            raise AssertionError(f"sharded training {key}: grad norm {gn} "
                                 f"vs (1, 1) {g0}")
    # compressed_psum on 4 positions' full-width gradients
    loss = functools.partial(lm.loss_fn, cfg=cfg, dtype=torch.bfloat16,
                             plan=executor_of(cfg, plan_of(cfg,
                                                           needs_grad=True)))
    compute = tree_cast(params, torch.bfloat16)
    leaves = tree_leaves(compute)
    grads = []
    reset_launches()
    for i in range(4):
        rows = slice(i * LIFE_BATCH // 4, (i + 1) * LIFE_BATCH // 4)
        ps = [x.detach().requires_grad_(True) for x in leaves]
        it = iter(ps)
        tree = tree_map(lambda _: next(it), compute)
        value, _ = loss(tree, {k: v[rows] for k, v in batch.items()})
        grads.append([gr.float() for gr in torch.autograd.grad(value, ps)])
    launched.update(dict(LAUNCHES))
    mesh = cp_mesh((4, 1), ("data", "model"))
    zeros = [[torch.zeros_like(x) for x in grads[0]] for _ in range(4)]
    means, resid = compressed_psum(grads, zeros, mesh, "data")
    exact = [((grads[0][j] + grads[1][j]) + grads[2][j] + grads[3][j]) / 4
             for j in range(len(grads[0]))]
    # each position's rounding is at most half the shared step pmax|g| /
    # 127 of its leaf, so their mean's is too; 1e-3 of it for the fp32
    # roundings of the exact mean and of the dequantized payloads (a few
    # ulp of pmax|g|, 254 half-steps)
    errs = [float((a - b).abs().max()) for a, b in zip(means[0], exact)]
    steps_ = [max(float(g[j].abs().max()) for g in grads) / 127
              for j in range(len(exact))]
    worst = max(e / (s / 2) if s else (0.0 if e == 0 else math.inf)
                for e, s in zip(errs, steps_))
    ms_call = wall_ms(lambda: compressed_psum(grads, zeros, mesh, "data"))
    comp = {"max_err_vs_exact_mean": max(errs),
            "max_abs_exact_mean": max(float(b.abs().max()) for b in exact),
            "worst_err_of_half_step": worst,
            "residual_norm": [float(global_norm(r)) for r in resid],
            "grad_norm": [float(global_norm(gr)) for gr in grads],
            "ms_per_call": ms_call, "leaves": len(exact),
            "values": sum(x.numel() for x in exact)}
    if not worst <= 1 + 1e-3:
        raise AssertionError(f"compressed_psum: {comp}")
    del grads, zeros, means, resid, exact
    torch.cuda.empty_cache()
    stats = {"runs": runs, "compressed_psum": comp,
             "launches": dict(launched)}
    print("[cp train] " + json.dumps(stats), flush=True)
    return stats


def cp_elastic_remesh(cfg, params, root: Path) -> dict:
    """Phase 36d: ``train(mesh=make_mesh((2, 1)))`` for 3 steps of phase
    7's shape, checkpointed; ``ElasticTrainer.recover(1)`` re-plans onto
    (1, 1), builds its mesh and restores that checkpoint bitwise; one more
    step from the restored state equals one step from the run's own final
    state bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.loader import lm_loader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import build_train, train
    from repro_torch.runtime import ElasticTrainer, MeshPlan
    from repro_torch.training.train_state import gather_state, place_state

    kw = dict(batch=LIFE_BATCH, seq=LIFE_SEQ, seed=SEED, device=DEVICE,
              params=params)
    torch.cuda.synchronize()
    reset_launches()
    run = train(cfg, steps=3, ckpt_dir=str(root / "cp"), ckpt_every=3,
                mesh=cp_mesh((2, 1), ("data", "model")), **kw)
    trainer = ElasticTrainer(
        lambda plan: build_train(cfg, steps=4, mesh=trainer.mesh, **kw),
        CheckpointManager(root / "cp"),
        devices=None if DEVICE == "cuda" else [DEVICE])
    plan, step_fn, state, step = trainer.recover(n_healthy=1)
    if plan != MeshPlan((1, 1), ("data", "model")) or step != 3:
        raise AssertionError(f"recover(1) planned {plan} at step {step}")
    leaves = states_bitwise("the restored state", gather_state(state, cfg),
                            run["state"])
    b = {k: torch.from_numpy(v).to(DEVICE) for k, v in next(lm_loader(
        SEED, batch=LIFE_BATCH, seq=LIFE_SEQ, vocab=cfg.vocab_size,
        start_step=step)).items()}
    resumed, m1 = step_fn(state, b)
    direct, m2 = step_fn(place_state(run["state"], trainer.mesh, cfg), b)
    states_bitwise("one step after recover(1) against one from the run's "
                   "own state", gather_state(resumed, cfg),
                   gather_state(direct, cfg))
    if float(m1["loss"]) != float(m2["loss"]):
        raise AssertionError(f"losses {float(m1['loss'])} != "
                             f"{float(m2['loss'])}")
    launches = dict(LAUNCHES)
    n = cfg.n_layers * (3 * 2 + 2)
    expect_only(launches, {"flow_fused": 2 * n, "flow_fused_bwd": n},
                "elastic re-mesh")
    shutil.rmtree(root / "cp")
    stats = {"losses_2x1": run["history"], "plan": list(plan.shape),
             "restored_step": step, "leaves_equal": leaves,
             "step4_loss": float(m1["loss"]), "launches": launches}
    print("[cp elastic] " + json.dumps(stats), flush=True)
    return stats


def expect_launches(launches: dict, k6: int, k7b: int, what: str):
    """Exactly ``k6`` K6 and ``k7b`` K7b launches and no other kernel's."""
    expect_only(launches, {"flow_nc_fused": k6, "flow_nc_qside_bwd": k7b},
                what)


def expect_only(launches: dict, want: dict, what: str):
    """Exactly the ``want`` launches and no other kernel's."""
    from repro_torch.kernels._lib import KERNELS

    full = {**dict.fromkeys(KERNELS, 0), **want}
    if launches != full:
        raise AssertionError(f"{what} launched {launches}, want {full}")


def chunk_pairs(d: int, dv: int, *, k5a: int = 0, dq: int = 0,
                k5b: int = 0) -> dict:
    """The ``PAIR_LAUNCHES`` of a run of ``k5a`` K5a at (d, dv), ``dq`` K5a
    at (dv, d) (``FlowChunkDot``'s dq) and ``k5b`` K5b at (d, dv)."""
    want = collections.Counter({f"flow_chunk_{d}x{dv}": k5a,
                                f"flow_chunk_dkv_{d}x{dv}": k5b})
    want[f"flow_chunk_{dv}x{d}"] += dq
    return {key: n for key, n in want.items() if n}


def expect_pairs(pairs: dict, want: dict, what: str):
    """Exactly the ``want`` K5a / K5b launches by (D, Dv), as the wrappers
    counted them (``PAIR_LAUNCHES``)."""
    if dict(pairs) != want:
        raise AssertionError(f"{what} launched K5a / K5b at {dict(pairs)}, "
                             f"want {want}")


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

    def window():
        nonlocal state
        for bt in batches[1:]:
            state, metrics = step_fn(state, bt)
            float(metrics["loss"])
        return len(batches) - 1

    keys = {"k6_ms_per_step": "flow_nc_fused_kernel",
            "k7a_ms_per_step": "flow_nc_qside_kernel",
            "k7b_ms_per_step": ("flow_nc_qside_bwd_kernel",
                                 "flow_nc_reduce_kernel")}
    return device_profile(window, step_ms, keys, "classify", top=14)


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

    def window():
        nonlocal state
        for bt in batches[1:]:
            state, metrics = step_fn(state, bt)
            float(metrics["loss"])
        return len(batches) - 1

    keys = {"k6_ms_per_step": "flow_nc_fused_kernel",
            "k7b_ms_per_step": ("flow_nc_qside_bwd_kernel",
                                 "flow_nc_reduce_kernel"),
            "gemm_ms_per_step": GEMM_KEYS}
    return device_profile(window, step_ms, keys, "vision", top=16)


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


# --- the Decision-Flowformer (offline RL, Table 7) and the linear branch -----
#: phase 23's shape: the paper's DT (``flowformer_dt``: 3 layers, d 256, 4
#: heads of 64) on trajectories of 60 steps (N = 180), 64 a batch
DT_BATCH, DT_STEPS = 64, 5
#: phase 24's: the Table 7 harness (``benchmarks/rl_table7.py``: 2 layers,
#: d 96, 4 heads of 24, horizon 20, batch 32), cut from 120 steps to 20
T7_BATCH, T7_STEPS = 32, 20


def dt_batch(horizon: int, batch: int, seed: int) -> dict:
    """One batch of ``batch`` trajectories of ``horizon`` steps on the
    card, as the launcher draws them."""
    from repro_torch.launch import decision as launch

    arrays = launch.batch_arrays(launch.trajectories(seed, batch,
                                                     horizon=horizon))
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in arrays.items()}


def train_dt_full_width() -> dict:
    """Phase 23: ``flowformer_dt`` at full width and depth in bf16 on fp32
    masters (``launch/decision.py::run``): 5 AdamW steps of 64
    trajectories of 60 steps (N = 180), then a 16-episode rollout of 60
    forwards; exactly 3 K1 and 3 K2 a step and 3 K1 a rollout forward, and
    nothing else; step ms, trajectories/s, the rollout's forwards/s; then
    ``torch.profiler`` over two steps: device time by kernel and busy
    share."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import decision as launch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = launch.run("flow", steps=DT_STEPS, batch=DT_BATCH, device=DEVICE)
    launches = dict(LAUNCHES)
    cfg, hist, horizon = out["cfg"], out["history"], 60
    if not all(math.isfinite(x) for x in hist) or not math.isfinite(
            out["return"]):
        raise AssertionError(f"DT: losses {hist}, return {out['return']}")
    n = cfg.n_layers
    expect_only(launches, {"flow_fused": n * (DT_STEPS + horizon),
                           "flow_fused_bwd": n * DT_STEPS}, "DT phase 23")
    step_ms = 1e3 * statistics.median(out["step_s"][1:])
    stats = {"steps": DT_STEPS, "batch": DT_BATCH, "horizon": horizon,
             "n_tokens": 3 * horizon, "d_model": cfg.d_model,
             "head_dim": cfg.dim_head, "history": hist, "step_ms": step_ms,
             "first_step_ms": 1e3 * out["step_s"][0],
             "trajectories_per_s": DT_BATCH / step_ms * 1e3,
             "rollout_s": out["rollout_s"],
             "rollout_forwards_per_s": horizon / out["rollout_s"],
             "return": out["return"],
             "behavior_return": out["behavior_return"],
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    stats["profile"] = profile_dt(out["params"], cfg, step_ms)
    print("[DT bf16] " + json.dumps({k: v for k, v in stats.items()
                                     if k != "profile"}), flush=True)
    return stats


def profile_dt(params, cfg, step_ms: float) -> dict:
    """Phase 23's profile: device time of a bf16 DT step by kernel, from
    ``torch.profiler`` over two steps after one outside the window, and its
    share of phase 23's unprofiled step time."""
    from repro_torch.launch import decision as launch
    from repro_torch.layers.attention import executor_of, plan_of
    from repro_torch.training.optimizer import adamw_init

    step = launch.make_step(cfg, total=DT_STEPS, plan=executor_of(
        cfg, plan_of(cfg, needs_grad=True)))
    opt = adamw_init(params)
    batch = dt_batch(60, DT_BATCH, SEED + 3)
    params, opt, loss = step(params, opt, batch, 1)
    float(loss)

    def window():
        nonlocal params, opt
        for i in range(2):
            params, opt, loss = step(params, opt, batch, 2 + i)
            float(loss)
        return 2

    return device_profile(window, step_ms, K12, "DT")


def train_dt_fp32_both_paths():
    """Phase 23b: ``flowformer_dt`` at full width with one block, fp32, 3
    steps of 64 trajectories of 60 steps, on the kernels and on the plain
    path (``backend="plain"``): losses, and every gradient of the first
    step (each leaf non-zero on the kernels) within phase 21b's bounds."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import decision as launch
    from repro_torch.layers.attention import executor_of, plan_of
    from repro_torch.models import decision
    from repro_torch.utils import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("flowformer_dt"), n_layers=1)
    steps = 3
    params = decision.init(cfg, torch.Generator().manual_seed(SEED + 2),
                           state_dim=launch.STATE_DIM,
                           action_dim=launch.ACTION_DIM, max_ep_len=60,
                           device=DEVICE)
    first = dt_batch(60, DT_BATCH, SEED + 4)
    hist, grads = {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        reset_launches()
        loss, _ = decision.loss_fn(leaves, first, c, dtype=torch.float32,
                                   plan=executor_of(c, plan_of(
                                       c, needs_grad=True)))
        flat = torch.autograd.grad(loss, tree_leaves(leaves))
        grads[backend] = {f"leaf {i}": g for i, g in enumerate(flat)}
        hist[backend] = launch.run(
            "flow", cfg=c, steps=steps, batch=DT_BATCH, device=DEVICE,
            dtype=torch.float32, params=params, n_episodes=0)["history"]
        want = ({"flow_fused": steps + 1, "flow_fused_bwd": steps + 1}
                if backend == "auto" else {})
        expect_only(dict(LAUNCHES), want, f"fp32 DT, {backend}")
    worst = losses_and_grads_agree("fp32 DT", hist, grads)
    print(f"[DT fp32] kernels vs plain, one block x {steps} steps of "
          f"{DT_BATCH} x 60: losses {hist['auto']} vs {hist['plain']}; all "
          f"{len(grads['auto'])} parameter gradients of step 1 non-zero, "
          f"worst |diff| / max |grad| {worst:.3e}", flush=True)


def train_table7() -> dict:
    """Phase 24: the Table 7 harness's model (2 layers, d 96, 4 heads of
    24, d_ff 192, horizon 20, ``chunk_size=0``) for each kind, bf16, 20
    steps of 32 trajectories and a 16-episode rollout of 20 forwards:
    flow on K1 and K2 at D = 24 (2 K1 and 2 K2 a step, 2 K1 a forward),
    linear on K5a and K5b at D = 24 (2 x 2 K5a and 2 K5b a step, 2 K5a a
    forward), softmax plain; each row's return (smoke values of a cut
    run, not the paper's numbers)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import decision as launch

    rows, horizon = {}, launch.TABLE7_HORIZON
    for kind in launch.KINDS:
        torch.cuda.synchronize()
        reset_launches()
        out = launch.run(kind, table7=True, steps=T7_STEPS, batch=T7_BATCH,
                         device=DEVICE)
        launches = dict(LAUNCHES)
        n = out["cfg"].n_layers
        want = {"flow": {"flow_fused": n * (T7_STEPS + horizon),
                         "flow_fused_bwd": n * T7_STEPS},
                "linear": {"flow_chunk": n * (2 * T7_STEPS + horizon),
                           "flow_chunk_dkv": n * T7_STEPS},
                "softmax": {}}[kind]
        expect_only(launches, want, f"Table 7 {kind}")
        if out["cfg"].dim_head != 24 or not all(
                math.isfinite(x) for x in out["history"] + [out["return"]]):
            raise AssertionError(f"Table 7 {kind}: D {out['cfg'].dim_head}, "
                                 f"losses {out['history']}, return "
                                 f"{out['return']}")
        rows[kind] = {"return": out["return"],
                      "final_loss": out["history"][-1],
                      "step_ms": 1e3 * statistics.median(out["step_s"][1:]),
                      "rollout_s": out["rollout_s"], "launches": launches}
    rows["behavior policy (dataset)"] = {
        "return": out["behavior_return"]}
    print("[Table 7, smoke values] " + json.dumps(rows), flush=True)
    return rows


def linear_cfg(cfg):
    """The linear-attention baseline of ``cfg`` (as the reference's
    ``--attn linear`` makes it): the same weights' shapes."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind="linear"))


# --- the Whisper encoder-decoder and the dense LM archs ----------------------

#: phase 26's shapes: the real model's 30-second window (1,500 encoder
#: frames, 448 decoder positions), 8 clips; 64 greedy tokens a clip; one
#: encode at the config's ``max_seq_len`` (the assigned 32k prefill shape)
WHISPER_CLIPS, WHISPER_FRAMES, WHISPER_DEC = 8, 1500, 448
WHISPER_TOKENS, WHISPER_LONG, WHISPER_STEPS = 64, 32768, 5
#: timed encodes at each of phase 26's encode shapes, after one warm-up;
#: the median is reported
WHISPER_ENCODES = 5
#: Whisper's <|startoftranscript|> token, the decoder's first input
WHISPER_SOT = 50258
#: phase 26b: clips, greedy tokens and AdamW steps of the fp32 comparison
WHISPER_FP32_CLIPS, WHISPER_FP32_TOKENS, WHISPER_FP32_STEPS = 4, 32, 3
#: phase 27: granite_8b at full width, its depth cut from 36 layers to 2
GRANITE_LAYERS = 2


def whisper_frames(clips: int, n: int, d: int, seed: int) -> torch.Tensor:
    """Stub frame embeddings (clips, n, d) fp32 on the card, from the seed
    (the conv stem is out of scope, as in the reference)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn((clips, n, d), generator=gen, device=DEVICE)


def whisper_batch(cfg, clips: int, seed: int) -> dict:
    """One training batch: ``whisper_frames`` and next-token pairs of
    WHISPER_DEC text tokens drawn with numpy from the seed."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (clips, WHISPER_DEC + 1))
    toks = torch.from_numpy(toks).to(DEVICE)
    return {"frames": whisper_frames(clips, WHISPER_FRAMES, cfg.d_model,
                                     seed),
            "inputs": toks[:, :-1], "targets": toks[:, 1:]}


def whisper_start(cfg, clips: int) -> torch.Tensor:
    return torch.full((clips, 1), min(WHISPER_SOT, cfg.vocab_size - 1),
                      dtype=torch.long, device=DEVICE)


K6_KEYS = {"k6_ms": "flow_nc_fused_kernel",
           "k7b_ms": "flow_nc_qside_bwd_kernel",
           "k7b_reduce_ms": "flow_nc_reduce_kernel",
           "gemm_ms": GEMM_KEYS}


def serve_whisper_full_width(params, cfg) -> dict:
    """Phase 26, serving: ``whisper_small`` at full width and depth in
    bf16.  Encode WHISPER_CLIPS clips of WHISPER_FRAMES stub frames (one
    K6 a layer), greedy-decode WHISPER_TOKENS tokens a clip from
    ``init_dec_caches`` (a K3 and a K6 at one sink row a decoder layer a
    step), and encode one clip of WHISPER_LONG frames; each encode shape
    warmed up once, then timed WHISPER_ENCODES times (the median is
    reported); exactly those launches and nothing else; encode ms, decode
    tokens/s, peak memory; then ``torch.profiler`` over a decode step and
    an encode."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import encdec, lm

    sp = lm.for_serving(params, DEVICE, torch.bfloat16)
    ex = encdec.executors(cfg)
    n_enc, n_dec = cfg.n_encoder_layers or cfg.n_layers, cfg.n_layers
    clips, toks = WHISPER_CLIPS, WHISPER_TOKENS
    frames = whisper_frames(clips, WHISPER_FRAMES, cfg.d_model, SEED + 40)
    start = whisper_start(cfg, clips)
    def timed(run):
        """WHISPER_ENCODES timed calls of ``run``: (seconds each, the last
        result)."""
        took = []
        for _ in range(WHISPER_ENCODES):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            took.append(time.perf_counter() - t0)
        return took, out

    with torch.inference_mode():
        # warm-up outside the counted runs, at the timed shapes: the first
        # GEMMs' and kernels' set-up
        long_frames = whisper_frames(1, WHISPER_LONG, cfg.d_model, SEED + 41)
        encdec.encode(sp, long_frames, cfg, plan=ex)
        mem = encdec.encode(sp, frames, cfg, plan=ex)
        encdec.greedy_decode(sp, mem, start, cfg, 2, plan=ex)
        del mem
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        encode_s, memory = timed(lambda: encdec.encode(sp, frames, cfg,
                                                       plan=ex))
        enc_launches = dict(LAUNCHES)
        expect_only(enc_launches, {"flow_nc_fused": WHISPER_ENCODES * n_enc},
                    "Whisper encode")
        reset_launches()
        t0 = time.perf_counter()
        tokens, logits = encdec.greedy_decode(sp, memory, start, cfg, toks,
                                              plan=ex)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec_launches = dict(LAUNCHES)
        expect_only(dec_launches, {"flow_decode": n_dec * toks,
                                   "flow_nc_fused": n_dec * toks},
                    "Whisper greedy decode")
        peak = torch.cuda.max_memory_allocated()
        if tokens.shape != (clips, toks) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"Whisper tokens {tuple(tokens.shape)}")
        if not (torch.isfinite(memory).all() and torch.isfinite(logits).all()):
            raise AssertionError("Whisper: non-finite memory or logits")
        del logits
        # one clip at the config's max_seq_len
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        long_s, long_mem = timed(lambda: encdec.encode(sp, long_frames, cfg,
                                                       plan=ex))
        long_launches = dict(LAUNCHES)
        expect_only(long_launches, {"flow_nc_fused": WHISPER_ENCODES * n_enc},
                    f"Whisper encode of {WHISPER_LONG} frames")
        long_peak = torch.cuda.max_memory_allocated()
        if not torch.isfinite(long_mem).all():
            raise AssertionError("Whisper: non-finite long memory")
        del long_mem, long_frames
        launches = {name: enc_launches[name] + dec_launches[name]
                    + long_launches[name] for name in enc_launches}
        encode_ms = 1e3 * statistics.median(encode_s)
        stats = {"clips": clips, "frames": WHISPER_FRAMES,
                 "encode_ms": encode_ms,
                 "encode_ms_each": [1e3 * t for t in encode_s],
                 "encode_frames_per_s": clips * WHISPER_FRAMES / encode_ms
                 * 1e3,
                 "greedy_tokens_per_clip": toks, "decode_s": decode_s,
                 "decode_ms_per_step": 1e3 * decode_s / toks,
                 "decode_tok_per_s": clips * toks / decode_s,
                 "peak_gb": peak / 1e9, "long_frames": WHISPER_LONG,
                 "long_encode_ms": 1e3 * statistics.median(long_s),
                 "long_encode_ms_each": [1e3 * t for t in long_s],
                 "long_encode_peak_gb": long_peak / 1e9,
                 "decode_launches": dec_launches, "launches": launches,
                 "first_tokens": tokens[0, :8].tolist()}
        print("[Whisper bf16 serving] " + json.dumps(stats), flush=True)
        caches = encdec.init_dec_caches(cfg, clips, toks + 1, device=DEVICE)
        tok = start
        stats["profile_decode"] = device_profile(
            repeat(lambda: encdec.decode_step(sp, tok, memory, caches, cfg, 3,
                                              plan=ex), 4),
            stats["decode_ms_per_step"],
            {**K6_KEYS, "k3_ms": "flow_decode_kernel"}, "Whisper decode step")
        stats["profile_encode"] = device_profile(
            repeat(lambda: encdec.encode(sp, frames, cfg, plan=ex), 2),
            stats["encode_ms"], K6_KEYS, "Whisper encode")
    return stats


def train_whisper_full_width(cfg) -> dict:
    """Phase 26, training: ``whisper_small`` at full width and depth,
    WHISPER_STEPS AdamW steps of WHISPER_CLIPS x (WHISPER_FRAMES frames,
    WHISPER_DEC tokens) in bf16 on fp32 masters (``make_train_step`` on
    ``launch.steps.model_loss_fn``, attention bound once for gradients):
    finite losses, and exactly (12 + 12) K6 and K7b (encoder and
    cross-attention) and 12 K1 and K2 (decoder self-attention) a step and
    nothing else; step ms, peak memory; then ``torch.profiler`` over two
    steps."""
    from repro_torch.config import ShapeSpec
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.layers.attention import plan_of
    from repro_torch.models import encdec
    from repro_torch.training.train_state import (TrainConfig,
                                                  init_train_state,
                                                  make_train_step)
    from repro_torch.utils import tree_map

    n_enc, n_dec = cfg.n_encoder_layers or cfg.n_layers, cfg.n_layers
    steps, clips = WHISPER_STEPS, WHISPER_CLIPS
    xplan = plan_of(cfg, needs_grad=True)
    shape = ShapeSpec("whisper_train", WHISPER_DEC, clips, "train")
    be = steps_lib.check_flow_trainable(cfg, shape, "cuda", xplan)
    params = encdec.init(cfg, torch.Generator().manual_seed(SEED + 1),
                         device=DEVICE)
    tcfg = TrainConfig(total_steps=steps, warmup=max(5, steps // 10),
                       fused_value_grad=True, compute_dtype=torch.bfloat16)
    loss = steps_lib.model_loss_fn(cfg, dtype=torch.bfloat16, plan=xplan)
    step_fn = make_train_step(loss, tcfg,
                              decay=tree_map(lambda x: x.ndim >= 2, params))
    state = init_train_state(params, tcfg)
    batches = [whisper_batch(cfg, clips, SEED + 42 + i)
               for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        hist.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"Whisper losses {hist}")
    nc = steps * (n_enc + n_dec)
    expect_only(launches, {"flow_nc_fused": nc, "flow_nc_qside_bwd": nc,
                           "flow_fused": steps * n_dec,
                           "flow_fused_bwd": steps * n_dec},
                "Whisper training")
    step_ms = 1e3 * statistics.median(step_s[1:])
    stats = {"steps": steps, "clips": clips, "frames": WHISPER_FRAMES,
             "dec_tokens": WHISPER_DEC, "backend": be.name, "history": hist,
             "first_step_ms": 1e3 * step_s[0], "step_ms": step_ms,
             "clips_per_s": clips / step_ms * 1e3,
             "peak_gb": peak / 1e9, "launches": launches}
    print("[Whisper bf16 training] " + json.dumps(stats), flush=True)
    b = batches[0]
    stats["profile"] = device_profile(
        repeat(lambda: float(step_fn(state, b)[1]["loss"]), 2), step_ms,
        {**K6_KEYS, "k1_ms": K12["k1_ms_per_step"],
         "k2_ms": K12["k2_ms_per_step"]}, "Whisper training step")
    return stats


def whisper_fp32_both_paths(cfg) -> dict:
    """Phase 26b: ``whisper_small`` at full width with one encoder and one
    decoder layer, fp32, on the kernels and on the plain path
    (``backend="plain"``): WHISPER_FP32_CLIPS clips of WHISPER_FRAMES
    frames greedy-decoded for WHISPER_FP32_TOKENS tokens, the tokens
    equal; WHISPER_FP32_STEPS AdamW steps of those clips with WHISPER_DEC
    tokens, the losses and every gradient of the first step within phase
    21b's bounds (each leaf non-zero on the kernels); and K6 at one sink
    row against the memory (the decode's cross-attention, NQ = 1, M =
    WHISPER_FRAMES, on the layer's own projections) against its plain
    version, bf16 and fp32."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flow_nc import (flow_nc_fused_call,
                                             flow_nc_fused_ref)
    from repro_torch.launch import steps as steps_lib
    from repro_torch.layers.attention import _split_heads, plan_of
    from repro_torch.layers.linear import dense
    from repro_torch.layers.norms import apply_norm
    from repro_torch.models import encdec
    from repro_torch.training.train_state import (TrainConfig,
                                                  init_train_state,
                                                  make_train_step)
    from repro_torch.utils import tree_leaves, tree_map

    cfg = dataclasses.replace(cfg, n_layers=1, n_encoder_layers=1)
    clips, toks, steps = (WHISPER_FP32_CLIPS, WHISPER_FP32_TOKENS,
                          WHISPER_FP32_STEPS)
    f32 = torch.float32
    params = encdec.init(cfg, torch.Generator().manual_seed(SEED + 2),
                         device=DEVICE)
    batch = whisper_batch(cfg, clips, SEED + 50)
    start = whisper_start(cfg, clips)
    hist, grads, tokens, memory = {}, {}, {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        ex = encdec.executors(c, plan_of(c, needs_grad=True))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        reset_launches()
        loss, _ = encdec.loss_fn(leaves, batch, c, dtype=f32, plan=ex)
        flat = torch.autograd.grad(loss, tree_leaves(leaves))
        grads[backend] = {f"leaf {i}": g for i, g in enumerate(flat)}
        tcfg = TrainConfig(total_steps=10, warmup=5, fused_value_grad=True,
                           compute_dtype=f32)
        step_fn = make_train_step(
            steps_lib.model_loss_fn(c, dtype=f32, plan=ex), tcfg,
            decay=tree_map(lambda x: x.ndim >= 2, params))
        state = init_train_state(tree_map(torch.clone, params), tcfg)
        hist[backend] = []
        for _ in range(steps):
            state, metrics = step_fn(state, batch)
            hist[backend].append(float(metrics["loss"]))
        with torch.inference_mode():  # serving binds without needs_grad
            serve = encdec.executors(c)
            memory[backend] = encdec.encode(params, batch["frames"], c,
                                            dtype=f32, plan=serve)
            tokens[backend], _ = encdec.greedy_decode(
                params, memory[backend], start, c, toks, dtype=f32,
                plan=serve)
        want = ({"flow_nc_fused": 2 * (steps + 1) + 1 + toks,
                 "flow_nc_qside_bwd": 2 * (steps + 1),
                 "flow_fused": steps + 1, "flow_fused_bwd": steps + 1,
                 "flow_decode": toks} if backend == "auto" else {})
        expect_only(dict(LAUNCHES), want, f"fp32 Whisper, {backend}")
    if not torch.equal(tokens["auto"], tokens["plain"]):
        diff = (tokens["auto"] != tokens["plain"]).nonzero()[0].tolist()
        raise AssertionError(f"fp32 Whisper greedy tokens differ first at "
                             f"clip {diff[0]}, token {diff[1]}")
    worst = losses_and_grads_agree("fp32 Whisper", hist, grads)
    # K6 at the decode's cross-attention shape, on the layer's projections
    # of the memory and of the start token's normed embedding
    bp = params["decoder"][0]
    x = apply_norm(bp["norm_x"],
                   params["embed"]["table"][start[:, 0]][:, None], cfg.norm)
    q = _split_heads(dense(bp["cross_attn"]["wq"], x), cfg.n_heads)
    k = _split_heads(dense(bp["cross_attn"]["wk"], memory["auto"]),
                     cfg.kv_heads)
    v = _split_heads(dense(bp["cross_attn"]["wv"], memory["auto"]),
                     cfg.kv_heads)
    hd, m = cfg.dim_head, memory["auto"].shape[1]
    k6 = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, f32):
            qf = q.reshape(-1, 1, hd).to(dtype).contiguous()
            kf = k.reshape(-1, m, hd).to(dtype).contiguous()
            vf = v.reshape(-1, m, hd).to(dtype).contiguous()
            k6[str(dtype)[6:]] = max_err_scaled(
                f"flow_nc_fused {str(dtype)[6:]} NQ=1 M={m} (decode)",
                flow_nc_fused_call(qf, kf, vf),
                flow_nc_fused_ref(qf, kf, vf), TOL[dtype])
    n_tok = tokens["auto"].numel()
    print(f"[Whisper fp32] kernels vs plain, one encoder and one decoder "
          f"layer: {n_tok} greedy tokens of {clips} clips equal; losses "
          f"{hist['auto']} vs {hist['plain']} over {steps} steps of {clips} "
          f"x ({WHISPER_FRAMES}, {WHISPER_DEC}); all {len(grads['auto'])} "
          f"gradients of step 1 non-zero, worst |diff| / max |grad| "
          f"{worst:.3e}; K6 at NQ = 1, M = {m} on the layer's projections: "
          + json.dumps(k6), flush=True)
    return {"worst_grad": worst, "k6_nq1": k6}


def serve_granite_full_width(cfg) -> dict:
    """Phases 27 and 27b: ``granite_8b`` at full width (d 4096, 32 query
    heads over 8 kv heads of 128, d_ff 14,336 swiglu, vocab 49,152,
    rmsnorm, untied head) with its depth cut to GRANITE_LAYERS of 36:
    phase 5's traffic through the bf16 Engine (K1 and K3 at G = 4, D =
    128: exactly one K1 a layer and admission round and one K3 a layer and
    decode step), then ``torch.profiler`` over decode steps; then phase
    6's fp32 greedy requests on the kernels and on the plain path, tokens
    equal."""
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(cfg, n_layers=GRANITE_LAYERS)
    params = lm.init(cfg, torch.Generator().manual_seed(SEED),
                     device=DEVICE)
    n_params = sum(x.numel() for x in tree_leaves(params))
    stats = serve_full_width(params, cfg)
    stats["n_params"] = n_params
    stats["depth"] = f"{GRANITE_LAYERS} of 36 layers"
    stats["profile"] = profile_decode(
        params, cfg, 1e3 * stats["decode_s"] / stats["decode_steps"])
    print(f"[granite_8b serving] {n_params:,} parameters, "
          f"{stats['depth']}: decode {stats['decode_tok_per_s']:.1f} tok/s, "
          f"prefill {stats['prefill_tok_per_s']:.1f} tok/s", flush=True)
    serve_fp32_both_paths(params, cfg)
    del params
    torch.cuda.empty_cache()
    return stats


def check_whisper_granite_shapes() -> dict:
    """Phase 3g: the kernels at the shapes phases 26 and 27 give them,
    against their plain versions, bf16 and fp32: K6 at Whisper's decode
    cross-attention (8 clips x 12 heads, NQ = 1 against M = 1,500; also
    against its cluster twin, 15 of 16 blocks owning no sink), its
    training cross-attention (NQ = 448, M = 1,500), its encoder (NQ = M =
    1,500) and the long encode (12 heads, NQ = M = 32,768); K7b at the
    cross-attention's and the encoder's backward (NQ = 448 and 1,500
    against M = 1,500; also against its twin); K1 and K2 at the decoder's
    training shape (96 rows, G = 1, N = 448 padded to 512, D = 64); K1 at
    granite's packed prefill (16 rows x 8 kv heads, G = 4, N = 384, D =
    128, ragged lengths 16-384); K3 over 32 steps at granite's pool (16
    slots x 8 kv heads, G = 4, D = 128) and Whisper's (8 slots x 12
    heads, G = 1, D = 64).  Returns the bf16 errors of the new rows."""
    from repro_torch.attention.recurrent import FlowState, decode_step
    from repro_torch.attention.vjp import nc_key_side
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import flow_decode_step
    from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,
                                                flow_fused_bwd_ref,
                                                flow_fused_call, flow_fused_ref)
    from repro_torch.kernels.flow_nc import (flow_nc_fused_call,
                                             flow_nc_fused_parallel,
                                             flow_nc_fused_ref,
                                             flow_nc_qside_bwd_call,
                                             flow_nc_qside_bwd_parallel,
                                             flow_nc_qside_bwd_ref)
    from repro_torch.kernels.flow_nc.ops import bwd_rows, cluster_blocks

    errs = {}
    bh = WHISPER_CLIPS * 12
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            for bh_, nq, m in ((bh, 1, WHISPER_FRAMES),
                               (bh, WHISPER_DEC, WHISPER_FRAMES),
                               (bh, WHISPER_FRAMES, WHISPER_FRAMES),
                               (12, WHISPER_LONG, WHISPER_LONG)):
                q, k, v, g = nc_inputs(dtype, bh_, nq, m, 64, SEED + 60 + nq)
                tag = f"{name} BH={bh_} NQ={nq} M={m}"
                got = flow_nc_fused_call(q, k, v)
                e6 = max_err_scaled(f"flow_nc_fused {tag} out", got,
                                    flow_nc_fused_ref(q, k, v), TOL[dtype])
                line = f"[K6] {tag}: {e6:.3e}"
                if nq == 1:
                    twin = flow_nc_fused_parallel(
                        q, k, v, cb=cluster_blocks(nq, m, 64))
                    e_twin = max_err_scaled(f"flow_nc_fused {tag} vs twin",
                                            got, twin, TOL[dtype])
                    line += f" (vs its cluster twin {e_twin:.3e})"
                    if dtype == torch.bfloat16:
                        errs["flow_nc_fused_nq1"] = e6
                if nq in (WHISPER_DEC, WHISPER_FRAMES) and bh_ == bh:
                    kw = dict(n_sinks=nq, m_sources=m)
                    key = nc_key_side(q, k, v, 1e-6, True)
                    got_b = flow_nc_qside_bwd_call(q, *key, g, **kw)
                    want_b = flow_nc_qside_bwd_ref(q, *key, g, **kw)
                    twin_b = flow_nc_qside_bwd_parallel(
                        q, *key, g, rows=bwd_rows(bh_, nq, 64, dtype), **kw)
                    names = ("dq", "dk_sum", "dko_sum", "dkv")
                    e7 = max(max_err_scaled(f"flow_nc_qside_bwd {tag} {n_}",
                                            a, b, TOL[dtype])
                             for n_, a, b in zip(names, got_b, want_b))
                    rel = {n_: twin_close(f"flow_nc_qside_bwd {tag} {n_} "
                                          "vs twin", a, b, K7B_TWIN_RTOL)
                           for n_, a, b in zip(names, got_b, twin_b)
                           if a.dtype == torch.float32}
                    line += (f"; K7b {e7:.3e}, |kernel - twin| / max |twin| "
                             + json.dumps(rel))
                torch.cuda.synchronize()
                print(line, flush=True)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            # K1 at granite's packed prefill: G = 4, D = 128
            q, k, v, lens = k1_inputs(dtype, rows=16, hkv=8, g=4, n=384,
                                      d=128, seed=SEED + 61)
            out, sums = flow_fused_call(q, k, v, lens, chunk=128)
            ref_out, ref_sums = flow_fused_ref(q, k, v, lens, chunk=128)
            tag = f"flow_fused {name} BH=128 G=4 N=384 D=128"
            e1 = max_err(f"{tag} out", out, ref_out, TOL[dtype])
            worst = max(max_err(f"{tag} {n_}", a, b, STATE_TOL)
                        for n_, a, b in zip(STATE_FIELDS, sums, ref_sums))
            torch.cuda.synchronize()
            print(f"[K1] {tag}: out {e1:.3e}, state {worst:.3e}", flush=True)
            if dtype == torch.bfloat16:
                errs["flow_fused_g4_d128"] = e1
            # K1 and K2 at Whisper's decoder training shape
            args, kw = k2_case(dtype, bh, 1, 512, 64, 128, WHISPER_DEC,
                               "sigmoid", SEED + 62, False)
            q, k, v, lens = args[:4]
            out, _ = flow_fused_call(q, k, v, lens, chunk=128)
            ref_out, _ = flow_fused_ref(q, k, v, lens, chunk=128)
            e1 = max_err(f"flow_fused {name} BH={bh} N=448 (512)", out,
                         ref_out, TOL[dtype])
            got = flow_fused_bwd_call(*args, **kw)
            want = flow_fused_bwd_ref(*args[:4], *args[5:], **kw)
            e2 = max(max_err(f"flow_fused_bwd {name} BH={bh} N=448 {n_}", a,
                             b, TOL[dtype])
                     for n_, a, b in zip(("dq", "dk", "dv"), got, want))
            torch.cuda.synchronize()
            print(f"[K1/K2] {name} BH={bh} G=1 N=448 (512) D=64: K1 out "
                  f"{e1:.3e}, K2 grads {e2:.3e}", flush=True)
    # K3 over 32 steps at granite's and Whisper's pools
    cfg = FlowConfig(causal=True, strict_causal=True)
    with torch.inference_mode():
        for slots, hkv, g, d in ((16, 8, 4, 128), (WHISPER_CLIPS, 12, 1, 64)):
            for dtype in (torch.bfloat16, torch.float32):
                pool = decode_pool(slots, hkv, d, SEED + 63)
                plain = FlowState(*(x.clone() for x in pool))
                gen = torch.Generator(device=DEVICE).manual_seed(SEED + 64)
                tag = (f"flow_decode {str(dtype)[6:]} {slots} slots x {hkv} "
                       f"kv heads G={g} D={d}")
                err = 0.0
                for step in range(32):
                    q, k, v = decode_token(gen, slots, hkv, g, d, dtype)
                    _, out = flow_decode_step(pool, q, k, v, cfg)
                    plain, ref = decode_step(plain, q, k, v, cfg)
                    err = max(err, max_err(f"{tag} out step {step}", out,
                                           ref, TOL[dtype]))
                worst = max(max_err(f"{tag} {n_} after 32 steps",
                                    getattr(pool, n_), getattr(plain, n_),
                                    STATE_TOL) for n_ in STATE_FIELDS)
                torch.cuda.synchronize()
                print(f"[K3] {tag} x 32 steps: out {err:.3e}, state "
                      f"{worst:.3e}", flush=True)
                if dtype == torch.bfloat16 and g == 4:
                    errs["flow_decode_g4_d128"] = err
    return errs


def time_whisper_granite_kernels(whisper: dict, granite: dict,
                                 errs: dict) -> list:
    """Phase 9, the new shapes: K6 at one Whisper decode step's
    cross-attention of one layer (8 clips x 12 heads, NQ = 1, M = 1,500,
    bf16), K1 at one granite admission of 16 prompts (8 kv heads, G = 4,
    N = 384, D = 128, bf16, phase 3g's ragged lengths) and K3 at one
    granite decode step of the 16-slot pool (G = 4, D = 128); each beside
    its plain version and its bound; ``launches`` are phase 26's greedy
    decode's (K6) and phase 27's (K1, K3)."""
    from repro_torch.attention.recurrent import decode_step
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import flow_decode_call
    from repro_torch.kernels.flow_fused import flow_fused_call, flow_fused_ref
    from repro_torch.kernels.flow_nc import (flow_nc_fused_call,
                                             flow_nc_fused_ref)

    rows = []
    bh, m, d = WHISPER_CLIPS * 12, WHISPER_FRAMES, 64
    with torch.inference_mode():
        q, k, v, _ = nc_inputs(torch.bfloat16, bh, 1, m, d, SEED + 65)
        b_k6 = bh * (1 + 2 * m + 1) * d * 2
        bound_ms, by = bound(b_k6, bh * nc_one_sink_ops(m, d, d))
        rows.append({
            "name": "flow_nc_fused_nq1", "route": "cuda",
            "source": "src/repro_torch/csrc/flow_nc_fused.cu",
            "replaces": "src/repro/kernels/flow_nc/fused.py:159",
            "launches": whisper["decode_launches"]["flow_nc_fused"],
            "max_abs_err": errs["flow_nc_fused_nq1"],
            "ms": time_ms(lambda: flow_nc_fused_call(q, k, v)),
            "plain_ms": time_ms(lambda: flow_nc_fused_ref(q, k, v)),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "shape": "8 clips x 12 heads, NQ = 1, M = 1,500, D = 64, bf16"})
        q, k, v, lens = k1_inputs(torch.bfloat16, rows=16, hkv=8, g=4,
                                  n=384, d=128, seed=SEED + 61)
        bh_, g, n, d = q.shape
        valid = int(lens.sum())
        st_bytes = bh_ * (4 * d + 1 + d * d) * 4
        b_k1 = (valid * (g * d + 2 * d) * 2 + bh_ * g * n * d * 2 + st_bytes
                + bh_ * 4)
        bound_ms, by = bound(b_k1, valid * flow_ops_per_position(g, d, d))
        rows.append({
            "name": "flow_fused_g4_d128", "route": "cuda",
            "source": "src/repro_torch/csrc/flow_fused.cu",
            "replaces": "src/repro/kernels/flow_fused/flow_fused.py:207",
            "launches": granite["launches"]["flow_fused"],
            "max_abs_err": errs["flow_fused_g4_d128"],
            "ms": time_ms(lambda: flow_fused_call(q, k, v, lens, chunk=128)),
            "plain_ms": time_ms(lambda: flow_fused_ref(q, k, v, lens,
                                                       chunk=128)),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "shape": "16 prompts x 8 kv heads, G = 4, N = 384, D = 128, "
                     "bf16"})
        slots, hkv, g, d = 16, 8, 4, 128
        pool = decode_pool(slots, hkv, d, SEED + 66)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 67)
        tq, tk, tv = decode_token(gen, slots, hkv, g, d, torch.bfloat16)
        bh_ = slots * hkv
        args = (pool.t, tq.reshape(bh_, g, d), tk.reshape(bh_, d),
                tv.reshape(bh_, d), *flat_pool(pool))
        cfg = FlowConfig(causal=True, strict_causal=True)
        b_k3 = (2 * bh_ * (4 * d + 1 + d * d) * 4
                + bh_ * (2 * g * d + 2 * d) * 2 + slots * 4)
        bound_ms, by = bound(b_k3, bh_ * flow_ops_per_position(g, d, d))
        rows.append({
            "name": "flow_decode_g4_d128", "route": "cuda",
            "source": "src/repro_torch/csrc/flow_decode.cu",
            "replaces": "src/repro/kernels/flow_decode/flow_decode.py:137",
            "launches": granite["launches"]["flow_decode"],
            "max_abs_err": errs["flow_decode_g4_d128"],
            "ms": time_ms(lambda: flow_decode_call(*args, hkv=hkv)),
            "plain_ms": time_ms(lambda: decode_step(pool, tq, tk, tv, cfg)),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "shape": "16 slots x 8 kv heads, G = 4, D = 128, bf16 tokens"})
    print("[Whisper and granite shapes] " + json.dumps(rows), flush=True)
    return rows


# --- the MoE, MLA and M-RoPE archs: K1 and K3 at D = 192, D != Dv, G = 8, 12 --

#: the depth cut of phases 28-30: 2 of 27 (DeepSeek-V2-Lite), 80
#: (Qwen2-VL-72B) and 32 (Granite-MoE-3B) layers; widths stay as published
WIDE_LAYERS = 2
#: phase 3h's and the new rows' shapes: (tag, prompts or slots, kv heads, G,
#: D, Dv) of DeepSeek-V2-Lite's MLA heads, Nemotron-4-340B's and
#: Qwen2-VL-72B's; N = 384 for K1
WIDE_SHAPES = (("d192_dv128", 16, 16, 1, 192, 128),
               ("d192_g12", 16, 8, 12, 192, 192),
               ("g8_d128", 16, 8, 8, 128, 128))


def wide_arch(name: str):
    """The config of ``name`` at full width, its depth cut to
    WIDE_LAYERS."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), n_layers=WIDE_LAYERS)


def check_fused_decode(shapes) -> dict:
    """K1 and K3 at each of ``shapes`` ((tag, prompts or slots, kv heads,
    G, D, Dv)) against their plain versions, bf16 and fp32: K1 on ragged
    lengths (N = 384) and two calls bitwise equal; K3 over 32 steps from a
    non-zero pool, at each step also against ``flow_decode_split`` from a
    copy of the kernel's pre-step pool, and two steps from clones of one
    pool bitwise equal.  Returns the bf16 errors, keyed
    ``flow_fused_<tag>`` and ``flow_decode_<tag>``."""
    from repro_torch.attention.recurrent import FlowState, decode_step
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import (flow_decode_split,
                                                 flow_decode_step)
    from repro_torch.kernels.flow_fused import flow_fused_call, flow_fused_ref

    errs = {}
    cfg = FlowConfig(causal=True, strict_causal=True)
    with torch.inference_mode():
        for tag, rows, hkv, g, d, dv in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype)[6:]
                q, k, v, lens = k1_inputs(dtype, rows=rows, hkv=hkv, g=g,
                                          n=384, d=d, seed=SEED + 70, dv=dv)
                out, sums = flow_fused_call(q, k, v, lens, chunk=128)
                ref_out, ref_sums = flow_fused_ref(q, k, v, lens, chunk=128)
                what = (f"flow_fused {name} BH={rows * hkv} G={g} N=384 "
                        f"D={d} Dv={dv}")
                e1 = max_err(f"{what} out", out, ref_out, TOL[dtype])
                worst = max(max_err(f"{what} {n_}", a, b, STATE_TOL)
                            for n_, a, b in zip(STATE_FIELDS, sums, ref_sums))
                out2, sums2 = flow_fused_call(q, k, v, lens, chunk=128)
                if not (torch.equal(out, out2) and all(
                        torch.equal(a, b) for a, b in zip(sums, sums2))):
                    raise AssertionError(f"{what}: two calls differ")
                torch.cuda.synchronize()
                print(f"[K1] {what}: out {e1:.3e}, state {worst:.3e}; two "
                      "calls bitwise equal", flush=True)
                pool = decode_pool(rows, hkv, d, SEED + 71, dv=dv)
                plain = FlowState(*(x.clone() for x in pool))
                gen = torch.Generator(device=DEVICE).manual_seed(SEED + 72)
                what = (f"flow_decode {name} {rows} slots x {hkv} kv heads "
                        f"G={g} D={d} Dv={dv}")
                bh = rows * hkv
                e3, e_split = 0.0, 0.0
                for step in range(32):
                    tq, tk, tv = decode_token(gen, rows, hkv, g, d, dtype,
                                              dv=dv)
                    before = [x.clone() for x in flat_pool(pool)]
                    split, split_st = flow_decode_split(
                        pool.t + 1, tq.reshape(bh, g, d), tk.reshape(bh, d),
                        tv.reshape(bh, dv), *before, hkv=hkv)
                    _, got = flow_decode_step(pool, tq, tk, tv, cfg)
                    plain, want = decode_step(plain, tq, tk, tv, cfg)
                    e3 = max(e3, max_err(f"{what} out step {step}", got,
                                         want, TOL[dtype]))
                    e_split = max(e_split, max_err(
                        f"{what} out step {step} vs split",
                        got.reshape(split.shape), split, TOL[dtype]))
                    for n_, a, b in zip(STATE_FLAT, flat_pool(pool),
                                        split_st):
                        max_err(f"{what} {n_} step {step} vs split", a, b,
                                STATE_TOL)
                worst = max(max_err(f"{what} {n_} after 32 steps",
                                    getattr(pool, n_), getattr(plain, n_),
                                    STATE_TOL) for n_ in STATE_FIELDS)
                # two steps from clones of one pool: bitwise equal
                tq, tk, tv = decode_token(gen, rows, hkv, g, d, dtype, dv=dv)
                (a, out_a), (b, out_b) = [
                    flow_decode_step(FlowState(*(x.clone() for x in pool)),
                                     tq, tk, tv, cfg) for _ in range(2)]
                if not (torch.equal(out_a, out_b)
                        and all(torch.equal(x, y) for x, y in zip(a, b))):
                    raise AssertionError(f"{what}: two steps from one pool "
                                         "differ")
                torch.cuda.synchronize()
                print(f"[K3] {what} x 32 steps: out {e3:.3e}, state "
                      f"{worst:.3e}; against flow_decode_split (teacher-"
                      f"forced) out {e_split:.3e}; two steps from clones "
                      "bitwise equal", flush=True)
                if dtype == torch.bfloat16:
                    errs[f"flow_fused_{tag}"] = e1
                    errs[f"flow_decode_{tag}"] = e3
    return errs


def check_wide_shapes() -> dict:
    """Phase 3h: K1 and K3 at the shapes of phases 28 and 29 and at
    Nemotron-4-340B's, against their plain versions, bf16 and fp32: K1 on
    ragged lengths (16 prompts, N = 384) at (D, Dv) = (192, 128) with 16
    heads, G = 1 (DeepSeek-V2-Lite's MLA), (192, 192) with 8 kv heads, G =
    12 (Nemotron-4-340B) and (128, 128) with 8 kv heads, G = 8 (Qwen2-VL);
    K3 over 32 steps from a non-zero state at each of those pools (16
    slots), at each step also against ``flow_decode_split`` from a copy of
    the kernel's pre-step pool, and two steps from clones of one pool
    bitwise equal at each; then DeepSeek-V2-Lite's MoE at full width (64
    experts top-6, 2 shared, d 2,048, d_ff 1,408) at a prefill's and a
    decode step's tokens: two calls bitwise equal (the fixed-order
    combine), bf16 and fp32.  Returns the bf16 errors of the new rows."""
    from repro_torch.layers import moe
    from repro_torch.utils import tree_cast

    errs = check_fused_decode(WIDE_SHAPES)
    with torch.inference_mode():
        # the MoE's combine: no atomics, two calls bitwise equal
        arch = wide_arch("deepseek_v2_lite_16b")
        mcfg, d_model = arch.moe, arch.d_model
        params = moe.moe_init(torch.Generator(device=DEVICE).manual_seed(
            SEED + 73), d_model, arch.d_ff, arch.act, mcfg)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 74)
        for dtype in (torch.bfloat16, torch.float32):
            for b, n in ((16, 384), (16, 1)):
                x = torch.randn((b, n, d_model), generator=gen,
                                device=DEVICE).to(dtype)
                w = tree_cast(params, dtype)
                (a, aux_a), (b_, aux_b) = [moe.moe(w, x, arch.act, mcfg)
                                           for _ in range(2)]
                if not (torch.equal(a, b_) and torch.equal(aux_a, aux_b)):
                    raise AssertionError(f"moe {dtype} {b} x {n}: two calls "
                                         "differ")
        del params
        torch.cuda.synchronize()
        print("[MoE] DeepSeek-V2-Lite's MoE (64 experts top-6, 2 shared, d "
              "2,048) at 16 x 384 and 16 x 1 tokens, bf16 and fp32: two "
              "calls bitwise equal", flush=True)
    return errs


#: phase 3i's and the new rows' shape: RecurrentGemma-9B's local slots in
#: flow mode, 16 prompts (or slots) over one kv head, G = 16, D = Dv = 256
RG_SHAPES = (("d256_g16", 16, 1, 16, 256, 256),)
#: the RG-LRU width (d_model) and conv width of recurrentgemma_9b: K9's
#: stream at each rglru layer's packed admission
RG_WIDTH, RG_CONV = 4096, 4


def check_rg_shapes() -> dict:
    """Phase 3i: K1 and K3 at RecurrentGemma-9B's flow heads (RG_SHAPES)
    against their plain versions, bf16 and fp32, two calls bitwise equal
    (``check_fused_decode``); K9 at the rglru admission's stream (16 rows,
    Lb 512, W 4,096 bf16, lengths 16..384) exactly equal to its plain
    version, twice."""
    from repro_torch.kernels.gather import boundary_gather, boundary_gather_ref

    errs = check_fused_decode(RG_SHAPES)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 77)
    lens = torch.tensor(ragged_lens(np.random.default_rng(SEED + 77), 16, 16,
                                    384), device=DEVICE)
    xb = torch.randn((16, 512, RG_WIDTH), generator=gen,
                     device=DEVICE).to(torch.bfloat16)
    with torch.inference_mode():
        got = [boundary_gather(xb, lens, RG_CONV) for _ in range(2)]
        want = boundary_gather_ref(xb, lens, RG_CONV)
    torch.cuda.synchronize()
    if not all(torch.equal(x, want) for x in got):
        raise AssertionError("boundary_gather at the rglru admission: not "
                             "exact")
    print(f"[K9] rglru admission, 16 rows x Lb 512, W {RG_WIDTH} bf16: "
          "exact, twice", flush=True)
    errs["boundary_gather_rglru"] = 0.0
    return errs


def serve_wide_full_width(name: str, fp32: bool = True,
                          profile: bool = True, int8: bool = False) -> dict:
    """Phases 28-30: ``name`` at full width, its depth cut to WIDE_LAYERS,
    random weights drawn on the card from a seed: phase 5's traffic
    through the bf16 Engine (exactly one K1 a layer and admission round
    and one K3 a layer and decode step), decode and prefill tokens/s,
    then ``torch.profiler`` over decode steps (the device's busy share);
    then phase 6 in fp32 (28b, 29b): greedy tokens, and on a MoE stack
    every live token's chosen experts, on the kernels equal to the plain
    path's.  With ``int8`` (39, 39b) also phase 5c's traffic from int8
    pools (one K4 a layer and decode step, no K3), kept under ``"int8"``,
    and phase 6b in fp32 against the plain int8 step."""
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves

    cfg = wide_arch(name)
    params = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                     device=DEVICE)
    n_params = sum(x.numel() for x in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    stats = serve_full_width(params, cfg)
    stats["n_params"] = n_params
    stats["depth"] = f"{WIDE_LAYERS} layers"
    if profile:
        stats["profile"] = profile_decode(
            params, cfg, 1e3 * stats["decode_s"] / stats["decode_steps"])
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    busy = stats.get("profile", {}).get("device_busy_share")
    print(f"[{cfg.name} serving] {n_params:,} parameters, {stats['depth']}: "
          f"decode {stats['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{stats['prefill_tok_per_s']:.1f} tok/s, device busy share of a "
          f"decode step {busy}, peak {stats['peak_gb']:.1f} GB", flush=True)
    if fp32:
        serve_fp32_both_paths(params, cfg)
    if int8:
        stats["int8"] = serve_full_width(params, cfg, state_dtype="int8")
        print(f"[{cfg.name} serving, int8 pools] decode "
              f"{stats['int8']['decode_tok_per_s']:.1f} tok/s ("
              f"{stats['decode_tok_per_s']:.1f} from fp32 pools), pools "
              f"{stats['int8']['pool_bytes']} bytes", flush=True)
        serve_int8_fp32_against_plain(params, cfg)
    del params
    torch.cuda.empty_cache()
    return stats


def time_wide_kernels(runs: dict, errs: dict) -> list:
    """Phase 9, the new shapes: K1 at one admission of 16 prompts of N =
    384 (phase 3h's ragged lengths, bf16) and K3 at one decode step of the
    16-slot pool (bf16 tokens) at each of WIDE_SHAPES, each beside its
    plain version and its bound, K1's with the device ms of each of its
    four CUDA kernels (``breakdown_ms``); ``launches`` are phase 28's (D = 192, Dv
    = 128) and 29's (G = 8), and 0 at Nemotron-4-340B's shape, which no
    model run reaches (its full width does not fit the script's time)."""
    launched = {"d192_dv128": runs["deepseek"]["launches"],
                "g8_d128": runs["qwen2_vl"]["launches"]}
    rows = fused_decode_rows(WIDE_SHAPES, launched, errs)
    print("[MoE, MLA and M-RoPE shapes] " + json.dumps(rows), flush=True)
    return rows


def fused_decode_rows(shapes, launched: dict, errs: dict) -> list:
    """The ``kernels`` rows of K1 and K3 at each of ``shapes`` (tag, prompts
    or slots, kv heads, G, D, Dv): K1 at one admission of N = 384 (phase
    3h's ragged lengths, bf16), with the device ms of each of its four
    CUDA kernels (``breakdown_ms``), and K3 at one decode step of the pool
    (bf16 tokens), each beside its plain version and its bound;
    ``launched`` maps a tag to a serving run's launch counts (0 where no
    run reaches the shape)."""
    from repro_torch.attention.recurrent import decode_step
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import flow_decode_call
    from repro_torch.kernels.flow_fused import flow_fused_call, flow_fused_ref

    rows = []
    cfg = FlowConfig(causal=True, strict_causal=True)
    with torch.inference_mode():
        for tag, n_rows, hkv, g, d, dv in shapes:
            counts = launched.get(tag, {"flow_fused": 0, "flow_decode": 0})
            q, k, v, lens = k1_inputs(torch.bfloat16, rows=n_rows, hkv=hkv,
                                      g=g, n=384, d=d, seed=SEED + 70, dv=dv)
            bh, n = q.shape[0], q.shape[2]
            valid = int(lens.sum())
            st_bytes = bh * (4 * d + 1 + d * dv) * 4
            b_k1 = (valid * (g * d + d + dv) * 2 + bh * g * n * dv * 2
                    + st_bytes + bh * 4)
            bound_ms, by = bound(b_k1, valid * flow_ops_per_position(g, d, dv))
            shape = (f"{n_rows} prompts x {hkv} kv heads, G = {g}, N = 384, "
                     f"D = {d}, Dv = {dv}, bf16")
            rows.append({
                "name": f"flow_fused_{tag}", "route": "cuda",
                "source": "src/repro_torch/csrc/flow_fused.cu",
                "replaces": "src/repro/kernels/flow_fused/flow_fused.py:207",
                "launches": counts["flow_fused"],
                "max_abs_err": errs[f"flow_fused_{tag}"],
                "ms": time_ms(lambda: flow_fused_call(q, k, v, lens,
                                                      chunk=128)),
                "plain_ms": time_ms(lambda: flow_fused_ref(q, k, v, lens,
                                                           chunk=128)),
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                "shape": shape,
                "breakdown_ms": chunk_breakdown(
                    lambda: flow_fused_call(q, k, v, lens, chunk=128),
                    "flow_fwd_")})
            pool = decode_pool(n_rows, hkv, d, SEED + 75, dv=dv)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 76)
            tq, tk, tv = decode_token(gen, n_rows, hkv, g, d, torch.bfloat16,
                                      dv=dv)
            bh = n_rows * hkv
            args = (pool.t, tq.reshape(bh, g, d), tk.reshape(bh, d),
                    tv.reshape(bh, dv), *flat_pool(pool))
            b_k3 = (2 * bh * (4 * d + 1 + d * dv) * 4
                    + bh * (g * d + d + dv + g * dv) * 2 + n_rows * 4)
            bound_ms, by = bound(b_k3, bh * flow_ops_per_position(g, d, dv))
            rows.append({
                "name": f"flow_decode_{tag}", "route": "cuda",
                "source": "src/repro_torch/csrc/flow_decode.cu",
                "replaces": "src/repro/kernels/flow_decode/flow_decode.py:137",
                "launches": counts["flow_decode"],
                "max_abs_err": errs[f"flow_decode_{tag}"],
                "ms": time_ms(lambda: flow_decode_call(*args, hkv=hkv)),
                "plain_ms": time_ms(lambda: decode_step(pool, tq, tk, tv,
                                                        cfg)),
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                "shape": f"{n_rows} slots x {hkv} kv heads, G = {g}, D = {d}, "
                         f"Dv = {dv}, bf16 tokens"})
    return rows


# --- the RecurrentGemma hybrid stack: phases 31-33 ---------------------------

#: phase 32's long prompts: two windows of the local slots (the band path)
RG_LONG = 4096
#: phase 31b's and 32's depth: one period of the pattern
RG_PERIOD = 3
#: phase 32's other prompts: phase 5's lengths, all below one window
RG_SOFT_LENS = (16, 384)


def init_serving_weights(cfg, seed: int) -> dict:
    """``lm.init``'s tree drawn on the card from a CUDA generator seeded
    with ``seed``, each block's matrices cast to bf16 as it is drawn (the
    full-depth recurrentgemma_9b is 38.5 GB in fp32, 19.3 GB in bf16);
    norms and the RG-LRU's ``lam`` and ``conv_b`` stay fp32, as
    ``lm.for_serving`` leaves them."""
    from repro_torch.layers.embeddings import embedding_init
    from repro_torch.layers.norms import norm_init
    from repro_torch.models import lm
    from repro_torch.utils import tree_map

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def served(tree):
        return tree_map(lambda x: x.to(DEVICE, torch.bfloat16
                                       if x.ndim >= 2 else x.dtype), tree)

    p = {"embed": served(embedding_init(gen, cfg.vocab_size, cfg.d_model)),
         "blocks": [served(lm._block_init(gen, cfg.block_kind(i), cfg))
                    for i in range(cfg.n_layers)],
         "final_norm": served(norm_init(cfg.d_model, cfg.norm))}
    if not cfg.tie_embeddings:
        p["head"] = served(embedding_init(gen, cfg.vocab_size, cfg.d_model))
    return p


def hybrid_layers(cfg) -> tuple[int, int]:
    """(flow attention layers, RG-LRU layers) of a hybrid stack: the local
    slots are flow attention in flow mode, window rings otherwise."""
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    flow = sum(k in ("attn", "local") for k in kinds) \
        if cfg.attention.kind == "flow" else 0
    return flow, kinds.count("rglru")


def rg_cfg(kind: str = "flow", n_layers: int | None = None):
    """recurrentgemma_9b at full width, attention ``kind`` (the local
    slots' mode), its depth cut to ``n_layers`` where given."""
    from repro_torch.configs import get_config

    cfg = get_config("recurrentgemma_9b")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind))
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)


def serve_hybrid_full_width(params, cfg, reqs, max_len: int,
                            state_dtype=None) -> dict:
    """Phases 31, 32 and 39c: the bf16 Engine over ``reqs`` at full width,
    16 slots: launch counts (flow mode packs: one K1 a flow layer and one
    K9 an RG-LRU layer per admission round, one K3 -- K4 from int8 pools
    -- a flow layer per decode step; softmax mode admits one request a
    round and launches nothing), decode and prefill tokens/s and the
    pools' bytes a slot."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.quant import pool_bytes

    engine = Engine(params, cfg, slots=16, max_len=max_len, seed=SEED,
                    state_dtype=state_dtype, device=DEVICE)
    worker = engine.worker
    if worker.packable is not (cfg.attention.kind == "flow"):
        raise AssertionError(f"{cfg.attention.kind} mode: packable "
                             f"{worker.packable}")
    for r in reqs:
        engine.submit(r)
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
    n_flow, n_rglru = hybrid_layers(cfg)
    want = dict.fromkeys(KERNELS, 0)
    decode = "flow_decode_q" if state_dtype == "int8" else "flow_decode"
    if worker.packable:
        want.update({"flow_fused": n_flow * rounds, decode: n_flow * steps,
                     "boundary_gather": n_rglru * rounds})
    elif rounds != len(reqs):
        raise AssertionError(f"{rounds} admission rounds for {len(reqs)} "
                             "requests, want one a request")
    if launches != want:
        raise AssertionError(f"{cfg.attention.kind} hybrid launched "
                             f"{launches}, want {want}")
    n_bytes = pool_bytes(worker.caches)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    stats = {
        "layers": cfg.n_layers, "flow_layers": n_flow,
        "rglru_layers": n_rglru, "requests": len(reqs),
        "admission_rounds": rounds, "decode_steps": steps,
        "prompt_tokens": prompt_tokens, "decode_tokens": decode_tokens,
        "prefill_s": spent["prefill"], "decode_s": spent["step"],
        "prefill_tok_per_s": prompt_tokens / spent["prefill"],
        "decode_tok_per_s": decode_tokens / spent["step"],
        "decode_ms_per_step": 1e3 * spent["step"] / steps,
        "launches": launches, "pool_bytes_per_slot": n_bytes // 16,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[engine recurrentgemma {cfg.attention.kind} bf16, "
          f"{state_dtype or 'fp32'} pools] " + json.dumps(stats), flush=True)
    return stats


def serve_rg_flow_full_width() -> dict:
    """Phase 31: recurrentgemma_9b in flow mode at full width and depth
    (38 layers, weights drawn on the card in bf16) on phase 5's traffic
    (48 requests, prompts 16-384, budgets 32-64); then ``torch.profiler``
    over decode steps of the full pool (device ms by kernel, the busy
    share); then (39c) the same traffic from int8 pools on the same
    weights: the flow slots on K4 (D = Dv = 256, G = 16), the RG-LRU
    pools dequantized and requantized around their fp32 step, kept under
    ``"int8"``."""
    from repro_torch.utils import tree_leaves

    cfg = rg_cfg("flow")
    torch.cuda.reset_peak_memory_stats()
    params = init_serving_weights(cfg, SEED)
    n_params = sum(x.numel() for x in tree_leaves(params))
    reqs = requests(np.random.default_rng(SEED + 4), 48, cfg.vocab_size,
                    (16, 384), (32, 64))
    stats = serve_hybrid_full_width(params, cfg, reqs, 512)
    stats["n_params"] = n_params
    stats["profile"] = profile_decode(params, cfg,
                                      stats["decode_ms_per_step"])
    print(f"[recurrentgemma_9b flow serving] {n_params:,} parameters, "
          f"{cfg.n_layers} layers: decode {stats['decode_tok_per_s']:.1f} "
          f"tok/s, prefill {stats['prefill_tok_per_s']:.1f} tok/s, device "
          f"busy share of a decode step "
          f"{stats['profile']['device_busy_share']}, pools "
          f"{stats['pool_bytes_per_slot']} bytes a slot", flush=True)
    reqs = requests(np.random.default_rng(SEED + 4), 48, cfg.vocab_size,
                    (16, 384), (32, 64))  # fresh: a Request keeps its tokens
    stats["int8"] = serve_hybrid_full_width(params, cfg, reqs, 512,
                                            state_dtype="int8")
    print(f"[recurrentgemma_9b flow serving, int8 pools] {cfg.n_layers} "
          f"layers: decode {stats['int8']['decode_tok_per_s']:.1f} tok/s "
          f"({stats['int8']['decode_ms_per_step']:.3f} ms a step, "
          f"{stats['decode_ms_per_step']:.3f} from fp32 pools), pools "
          f"{stats['int8']['pool_bytes_per_slot']} bytes a slot", flush=True)
    del params
    torch.cuda.empty_cache()
    return stats


def serve_rg_fp32_both_paths() -> None:
    """Phase 31b: one period (3 of 38 layers) in fp32, flow mode: phase
    6's greedy tokens through the kernels (K1, K9, K3) equal to the
    plain-pinned path's (K9's plain version bound in); then (39d) phase
    6b from int8 pools, K4 at D = Dv = 256, G = 16, step by step against
    the plain int8 step."""
    from repro_torch.models import lm

    cfg = rg_cfg("flow", RG_PERIOD)
    params = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                     device=DEVICE)
    serve_fp32_both_paths(params, cfg)
    serve_int8_fp32_against_plain(params, cfg)
    del params
    torch.cuda.empty_cache()


def rg_softmax_requests(cfg, seed: int, n: int, lens, budgets, long: int):
    """``requests`` plus ``long`` prompts of RG_LONG tokens (the local
    slots' band path, 4,096 = 2 windows), budgets as the others'."""
    from repro_torch.serving.engine import Request

    reqs = requests(np.random.default_rng(seed), n, cfg.vocab_size, lens,
                    budgets)
    rng = np.random.default_rng(seed + 1)
    return reqs + [Request(uid=n + i, prompt=rng.integers(
        0, cfg.vocab_size, RG_LONG).astype(np.int32),
        max_new_tokens=int(rng.integers(budgets[0], budgets[1] + 1)))
        for i in range(long)]


def serve_rg_softmax() -> dict:
    """Phase 32: softmax mode (the local slots are window rings of 2,048)
    at full width, one period (3 of 38 layers), bf16: phase 5's traffic
    plus two prompts of 4,096 tokens, admitted one request a round; the
    long prompts' decode writes over a full ring.  Then fp32 (32b): every
    request's greedy tokens equal to a solo per-request loop's
    (``lm.prefill`` of the prompt alone, then ``lm.decode``)."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg = rg_cfg("softmax", RG_PERIOD)
    max_len = RG_LONG + 64 + 8
    params = init_serving_weights(cfg, SEED)
    reqs = rg_softmax_requests(cfg, SEED + 4, 48, RG_SOFT_LENS, (32, 64), 2)
    stats = serve_hybrid_full_width(params, cfg, reqs, max_len)
    print(f"[recurrentgemma_9b softmax serving] {cfg.n_layers} layers: "
          f"{stats['admission_rounds']} admission rounds for "
          f"{stats['requests']} requests, decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s", flush=True)
    del params
    torch.cuda.empty_cache()
    params = lm.for_serving(lm.init(cfg, torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE), DEVICE,
        torch.float32)
    reqs = rg_softmax_requests(cfg, SEED + 6, 5, RG_SOFT_LENS, (16, 16), 1)
    engine = Engine(params, cfg, slots=4, max_len=max_len, seed=SEED,
                    dtype=torch.float32, device=DEVICE)
    for r in reqs:
        engine.submit(r)
    got = {r.uid: r.generated for r in engine.run()}
    with torch.inference_mode():
        for r in reqs:
            logits, caches = lm.prefill(
                params, torch.tensor(r.prompt[None], device=DEVICE), cfg,
                max_len, dtype=torch.float32)
            solo = [int(logits[0, -1].argmax())]
            for i in range(r.max_new_tokens - 1):
                logits, caches = lm.decode(
                    params, torch.tensor([[solo[-1]]], dtype=torch.int32,
                                         device=DEVICE), caches, cfg,
                    torch.tensor([len(r.prompt) + i], dtype=torch.int32,
                                 device=DEVICE), dtype=torch.float32)
                solo.append(int(logits[0, 0].argmax()))
            if got[r.uid] != solo:
                raise AssertionError(f"softmax fp32 request {r.uid} (prompt "
                                     f"{len(r.prompt)}): engine "
                                     f"{got[r.uid]}, solo {solo}")
    n_tok = sum(len(g) for g in got.values())
    print(f"[fp32 softmax hybrid] the per-request Engine and the solo loop "
          f"agree on all {n_tok} greedy tokens of {len(reqs)} requests "
          f"(one prompt of {RG_LONG}: its ring wraps)", flush=True)
    del params
    torch.cuda.empty_cache()
    return stats


def deq_close(name: str, pool, ref) -> float:
    """An int8 pool, dequantized, against the fp32 state ``ref`` of the
    same step: every quantized entry within one step of its new scale plus
    1e-5 (``tests/test_torch_quant.py``'s bound for int8 pools), the raw
    leaves (FlowState's z, the counts) at TOL; returns the largest gap in
    units of the scale."""
    from repro_torch.serving.quant import QuantizedPool, dequantize_state
    from repro_torch.utils import tree_leaves

    if not isinstance(pool, QuantizedPool):
        raise AssertionError(f"{name}: not an int8 pool")
    worst = 0.0
    for pay, sc, deq, want in zip(tree_leaves(pool.payload),
                                  tree_leaves(pool.scale),
                                  tree_leaves(dequantize_state(pool)),
                                  tree_leaves(ref)):
        if pay.dtype != torch.int8:
            if not pay.is_floating_point():
                if not torch.equal(pay, want.to(pay.dtype)):
                    raise AssertionError(f"{name}: counts differ")
                continue
            max_err(f"{name} raw leaf", deq, want, TOL[torch.float32])
            continue
        gap = (deq - want.float()).abs()
        if not (gap <= sc + 1e-5).all():
            raise AssertionError(f"{name}: dequantized entries "
                                 f"{float((gap / sc).max()):.2f} scales from "
                                 "the fp32 step")
        worst = max(worst, float((gap / sc).max()))
    return worst


def rg_int8_teacher_forced() -> dict:
    """Phase 33b: the reference's recurrentgemma_9b ``smoke_config()`` (3
    layers, d 128, the flow slot at D = 32, G = 4) served in fp32 from
    int8 pools: the RG-LRU pools dequantized, stepped and requantized,
    the flow slot on K4.  Before every decode step the same step runs
    from the pools dequantized into fp32 pools (K3, the fp32 RG-LRU
    step): the int8 step's logits within (1e-4, 1e-4 max |logit|) of it,
    and every pool within one scale step of it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.layers.attention import executor_of
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.quant import dequantize_state
    from repro_torch.utils import tree_map

    cfg = get_smoke_config("recurrentgemma_9b")
    n_flow, n_rglru = hybrid_layers(cfg)
    params = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                     device=DEVICE)
    engine = Engine(params, cfg, slots=4, max_len=96, seed=SEED,
                    dtype=torch.float32, state_dtype="int8", device=DEVICE)
    worker = engine.worker
    fp32_ex = executor_of(cfg, dataclasses.replace(worker.plan,
                                                   state_dtype=None))
    for r in requests(np.random.default_rng(SEED + 9), 6, cfg.vocab_size,
                      (5, 40), (8, 8)):
        engine.submit(r)
    real_decode, real_step, seen = lm.decode, worker.step, {}
    checked = {"steps": 0, "logit_err": 0.0, "scale_steps": 0.0}

    def recording_decode(*a, **kw):
        seen["logits"], caches = real_decode(*a, **kw)
        return seen["logits"], caches

    def checked_step(tokens, pos, temps, live):
        with torch.inference_mode():
            # copies: K3 updates its pool in place, and dequantizing
            # passes the raw leaves (the counts, z) through uncopied
            fp32 = [tree_map(torch.clone, dequantize_state(c))
                    for c in worker.caches]
            want, want_pools = real_decode(
                worker.params, torch.as_tensor(tokens, dtype=torch.int32,
                                               device=DEVICE)[:, None],
                fp32, cfg, torch.as_tensor(pos, dtype=torch.int32,
                                           device=DEVICE),
                plan=fp32_ex, dtype=torch.float32)
        launched = dict(LAUNCHES)
        toks = real_step(tokens, pos, temps, live)
        step = checked["steps"]
        got, want = seen["logits"][:, -1].float(), want[:, -1].float()
        scale = float(want.abs().max())
        checked["logit_err"] = max(checked["logit_err"], max_err(
            f"int8 hybrid step {step} logits", got, want,
            (1e-4, 1e-4 * scale)))
        for i, (pool, ref) in enumerate(zip(worker.caches, want_pools)):
            checked["scale_steps"] = max(checked["scale_steps"], deq_close(
                f"int8 hybrid step {step} layer {i}", pool, ref))
        if LAUNCHES["flow_decode_q"] != launched["flow_decode_q"] + n_flow:
            raise AssertionError("the int8 step did not run K4 once a flow "
                                 "layer")
        checked["steps"] += 1
        return toks

    worker.step = checked_step
    lm.decode = recording_decode
    reset_launches()
    try:
        done = engine.run()
    finally:
        lm.decode = real_decode
    rounds, steps = worker.admission_rounds, worker.decode_steps
    want = {"flow_fused": n_flow * rounds, "boundary_gather": n_rglru * rounds,
            "flow_decode_q": n_flow * steps, "flow_decode": n_flow * steps}
    if {k: v for k, v in LAUNCHES.items() if v} != want:
        raise AssertionError(f"int8 hybrid launches {LAUNCHES}, want {want} "
                             "(K3: the fp32 reference steps)")
    # the main path's launches: K3's ran the fp32 reference steps
    launches = {k: (0 if k == "flow_decode" else v)
                for k, v in LAUNCHES.items()}
    stats = {"requests": len(done), "steps": checked["steps"],
             "logit_err": checked["logit_err"],
             "max_gap_in_scales": checked["scale_steps"],
             "launches": launches}
    print("[int8 hybrid smoke, teacher-forced against fp32 pools] "
          + json.dumps(stats), flush=True)
    del params
    torch.cuda.empty_cache()
    return stats


def time_rg_kernels(rg: dict, errs: dict) -> list:
    """Phase 9, RecurrentGemma-9B's rows: K1 and K3 at RG_SHAPES (launches
    from phase 31) and K9 at one rglru admission (16 rows, Lb 512, W
    4,096 bf16; lengths 16..384), beside its plain version and the pad +
    gather library call."""
    from repro_torch.kernels.gather import boundary_gather, boundary_gather_ref

    rows = fused_decode_rows(RG_SHAPES, {"d256_g16": rg["launches"]}, errs)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 78)
    lens = torch.tensor(ragged_lens(np.random.default_rng(SEED + 78), 16, 16,
                                    384), device=DEVICE)
    xb = torch.randn((16, 512, RG_WIDTH), generator=gen,
                     device=DEVICE).to(torch.bfloat16)
    padded = torch.cat([torch.zeros((16, RG_CONV - 1, RG_WIDTH),
                                    dtype=xb.dtype, device=DEVICE), xb], dim=1)
    idx = (lens.long()[:, None] + torch.arange(
        RG_CONV - 1, device=DEVICE))[..., None]
    with torch.inference_mode():
        bound_ms, by = bound(2 * 16 * (RG_CONV - 1) * RG_WIDTH * 2 + 16 * 4,
                             0)
        rows.append({
            "name": "boundary_gather_rglru", "route": "cuda",
            "source": "src/repro_torch/csrc/boundary_gather.cu",
            "replaces": "src/repro/kernels/gather/boundary.py:67",
            "launches": rg["launches"]["boundary_gather"],
            "max_abs_err": errs["boundary_gather_rglru"],
            "ms": time_ms(lambda: boundary_gather(xb, lens, RG_CONV)),
            "plain_ms": time_ms(lambda: boundary_gather_ref(xb, lens,
                                                            RG_CONV)),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": time_ms(lambda: torch.take_along_dim(
                padded, idx, dim=1)),
            "shape": f"16 rows x Lb 512, W {RG_WIDTH}, bf16, one stream"})
    print("[RecurrentGemma shapes] " + json.dumps(rows), flush=True)
    return rows


# --- the wide heads in training and from int8 pools: phases 3j, 37-39 ------

#: phase 3j's K2 shapes: (tag, prompts, kv heads, G, D, Dv) -- DeepSeek-V2-
#: Lite's MLA heads at G = 1 and 2, Nemotron-4-340B's at G = 12 and
#: RecurrentGemma-9B's at G = 16; N = 384, ragged lengths 16..384
WIDE_K2_SHAPES = (("d192_dv128", 4, 4, 1, 192, 128),
                  ("d192_dv128_g2", 4, 2, 2, 192, 128),
                  ("d192_g12", 4, 2, 12, 192, 192),
                  ("d256_g16", 4, 1, 16, 256, 256))
#: phase 3j's K4 pools and phase 9's K2 / K4 rows: (tag, slots or batch,
#: kv heads, G, D, Dv) of the three head shapes
WIDE_Q_SHAPES = (("d192_dv128", 16, 16, 1, 192, 128),
                 ("d192_g12", 16, 8, 12, 192, 192),
                 ("d256_g16", 16, 1, 16, 256, 256))
#: phases 37 and 38 (and 40, 41 in the paper-causal mode): (config, depth,
#: batch, optimizer, seq-sharded prefill on the same weights: phase 42b)
#: of the wide training runs at full width (5 bf16 steps of batch x 512
#: tokens).
#: RecurrentGemma-9B's 2.69 B parameters at 3 layers (2.1 B of them its
#: embedding and head) take 32 GB of AdamW state, and the update holds the
#: old and the new state at once beside 10.8 GB of gradients: out of
#: memory on 80 GB; Adafactor's factored moments fit
WIDE_TRAIN = (("deepseek_v2_lite_16b", 2, 4, "adamw", True),
              ("recurrentgemma_9b", 3, 4, "adafactor", False))
WIDE_TRAIN_STEPS, WIDE_TRAIN_SEQ = 5, 512


def k2_wide_case(dtype, rows, hkv, g, d, dv, seed, state_cot):
    """K2's inputs at a wide pair: q, k, v, g_out on the card (N = 384,
    each prompt's length drawn in 16..384 and shared by its kv heads), K1's
    totals and the six state cotangents (random, or zeros as in
    training)."""
    from repro_torch.kernels.flow_fused import flow_fused_call

    q, k, v, lens = k1_inputs(dtype, rows=rows, hkv=hkv, g=g, n=384, d=d,
                              seed=seed, dv=dv)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    g_out = torch.randn((q.shape[0], g, 384, dv), generator=gen,
                        device=DEVICE).to(dtype)
    with torch.no_grad():
        _, totals = flow_fused_call(q, k, v, lens, chunk=128)
    g_sums = [torch.randn(x.shape, generator=gen, device=DEVICE) if state_cot
              else torch.zeros_like(x) for x in totals]
    return q, k, v, lens, totals, g_out, g_sums


def check_wide_k2() -> dict:
    """Phase 3j, K2: at each of WIDE_K2_SHAPES on ragged lengths, bf16 (the
    training step's zero state cotangents) and fp32 (random ones), against
    ``flow_fused_bwd_ref`` (autograd through K1's plain version) at phase
    3b's tolerances, and in fp32 also against ``flow_fused_bwd_parallel``
    (the kernel's own decomposition at its super-chunk); zero past each
    row's length; two calls bitwise equal.  Returns the bf16 errors, keyed
    ``flow_fused_bwd_<tag>``."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,
                                                flow_fused_bwd_parallel,
                                                flow_fused_bwd_ref)

    tile = _lib.function("flow_fused_bwd", "flow_fused_bwd_tile",
                         [ctypes.c_int] * 2)
    errs = {}
    for i, (tag, rows, hkv, g, d, dv) in enumerate(WIDE_K2_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            cot = dtype == torch.float32
            q, k, v, lens, totals, g_out, g_sums = k2_wide_case(
                dtype, rows, hkv, g, d, dv, SEED + 80 + i, cot)
            with torch.no_grad():
                got = flow_fused_bwd_call(q, k, v, lens, totals, g_out,
                                          g_sums, chunk=128)
                again = flow_fused_bwd_call(q, k, v, lens, totals, g_out,
                                            g_sums, chunk=128)
            want = flow_fused_bwd_ref(q, k, v, lens, g_out, g_sums,
                                      chunk=128)
            torch.cuda.synchronize()
            what = (f"flow_fused_bwd {name} BH={q.shape[0]} G={g} N=384 "
                    f"ragged D={d} Dv={dv}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{what}: two calls differ")
            err = max(max_err(f"{what} {n_}", a, b, TOL[dtype])
                      for n_, a, b in zip(("dq", "dk", "dv"), got, want))
            line = f"grads {err:.3e} against the autograd twin"
            if cot:
                t = tile(g, d)
                twin = flow_fused_bwd_parallel(q, k, v, lens, g_out, g_sums,
                                               chunk=32, tile=t)
                e2 = max(max_err(f"{what} {n_} vs parallel twin", a, b,
                                 TOL[dtype])
                         for n_, a, b in zip(("dq", "dk", "dv"), got, twin))
                line += (f", {e2:.3e} against the decomposition twin "
                         f"(super-chunk {t})")
            for n_, x in zip(("dq", "dk", "dv"), got):
                for r, li in enumerate(lens.tolist()):
                    if x[r, ..., li:, :].any():
                        raise AssertionError(f"{what} {n_}: non-zero past "
                                             f"row {r}'s length {li}")
            print(f"[K2] {what}: {line}; two calls bitwise equal",
                  flush=True)
            if dtype == torch.bfloat16:
                errs[f"flow_fused_bwd_{tag}"] = err
    # a group whose pull-back does not fit is refused, naming D and G
    for d in (192, 256):
        g = next(g for g in range(1, 64) if not _lib.k2_group_fits(d, g))
        if tile(g, d) != 0 or tile(g - 1, d) == 0:
            raise AssertionError(f"K2's tile count at D={d}: G={g - 1} -> "
                                 f"{tile(g - 1, d)}, G={g} -> {tile(g, d)}; "
                                 "_lib.k2_group_fits disagrees")
        q, k, v, lens = k1_inputs(torch.bfloat16, rows=1, hkv=1, g=g,
                                  n=64, d=d, seed=SEED + 89)
        # K1 may refuse the group too: K2 reads no totals, only checks them
        totals = [torch.zeros(s, device=DEVICE)
                  for s in [(1, d)] * 4 + [(1,), (1, d, d)]]
        g_out, g_sums = torch.zeros_like(q), [torch.zeros_like(x)
                                              for x in totals]
        try:
            flow_fused_bwd_call(q, k, v, lens, totals, g_out, g_sums,
                                chunk=64)
        except ValueError as e:
            if f"G={g}" not in str(e) or f"({d}, {d})" not in str(e):
                raise
        else:
            raise AssertionError(f"K2 took G={g} at D={d}")
        print(f"[K2] D={d}: G={g - 1} fits a block, G={g} is refused by the "
              "workspace count, naming D and G (as _lib.k2_group_fits says)",
              flush=True)
    return errs


def check_wide_k4() -> dict:
    """Phase 3j, K4: 32 teacher-forced steps from a non-zero int8 pool of
    16 slots at each of WIDE_Q_SHAPES, bf16 and fp32 tokens, against its
    plain version (``flow_decode_q_ref`` on a copy of the pool: out at
    TOL, payloads at most 1 LSB apart on at most 1e-3 of the entries, as
    phase 4b counts them) and at each step against ``flow_decode_q_split``
    (the kernel's order); the pool updated in place; two steps from clones
    of one pool bitwise equal.  Returns the bf16 errors, keyed
    ``flow_decode_q_<tag>``."""
    from repro_torch.core.flow_attention import FlowConfig
    from repro_torch.kernels.flow_decode import (flow_decode_q_split,
                                                 flow_decode_q_step)

    cfg = FlowConfig(causal=True, strict_causal=True)
    errs = {}
    with torch.inference_mode():
        for i, (tag, slots, hkv, g, d, dv) in enumerate(WIDE_Q_SHAPES):
            bh = slots * hkv
            for dtype in (torch.bfloat16, torch.float32):
                pool = int8_pool(decode_pool(slots, hkv, d, SEED + 90 + i,
                                             dv=dv))
                ptrs = [x.data_ptr() for x in pool.payload + pool.scale]
                gen = torch.Generator(device=DEVICE).manual_seed(SEED + 95)
                what = (f"flow_decode_q {str(dtype)[6:]} {slots} slots x "
                        f"{hkv} kv heads G={g} D={d} Dv={dv}")
                err, e_split, flips = 0.0, 0.0, 0.0
                for step in range(32):
                    q, k, v = decode_token(gen, slots, hkv, g, d, dtype,
                                           dv=dv)
                    want, ref = plain_q_step(pool, q, k, v, cfg)
                    before = clone_pool(pool)
                    before.payload.t.add_(1)
                    pays, s_pay, scs, s_sc, z = flat_q_pool(before)
                    split, *_ = flow_decode_q_split(
                        before.payload.t, q.reshape(bh, g, d),
                        k.reshape(bh, d), v.reshape(bh, dv), pays, s_pay,
                        scs, s_sc, z, hkv=hkv)
                    same, out = flow_decode_q_step(pool, q, k, v, cfg)
                    torch.cuda.synchronize()
                    if same is not pool:
                        raise AssertionError(f"{what}: returned a new pool")
                    err = max(err, max_err(f"{what} out step {step}", out,
                                           ref, TOL[dtype]))
                    e_split = max(e_split, max_err(
                        f"{what} out step {step} vs split",
                        out.reshape(split.shape), split, TOL[dtype]))
                    flips = max(flips, q_pool_close(f"{what} step {step}",
                                                    pool, want)[1])
                if [x.data_ptr() for x in pool.payload + pool.scale] != ptrs:
                    raise AssertionError(f"{what}: the pool moved")
                q, k, v = decode_token(gen, slots, hkv, g, d, dtype, dv=dv)
                (a, out_a), (b, out_b) = [
                    flow_decode_q_step(clone_pool(pool), q, k, v, cfg)
                    for _ in range(2)]
                if not (torch.equal(out_a, out_b) and all(
                        torch.equal(x, y) for x, y in zip(
                            a.payload + a.scale, b.payload + b.scale))):
                    raise AssertionError(f"{what}: two steps from one pool "
                                         "differ")
                print(f"[K4] {what} x 32 steps (teacher-forced): out "
                      f"{err:.3e}, against flow_decode_q_split {e_split:.3e},"
                      f" payload share differing <= {flips:.2e}, pool "
                      "updated in place; two steps from clones bitwise "
                      "equal", flush=True)
                if dtype == torch.bfloat16:
                    errs[f"flow_decode_q_{tag}"] = err
    return errs


def check_wide_train_shapes() -> dict:
    """Phase 3j: K2 and K4 at the wide pairs (``check_wide_k2``,
    ``check_wide_k4``)."""
    return {**check_wide_k2(), **check_wide_k4()}


def wide_train_cfg(name: str, depth: int):
    """``name`` at full width, its depth cut to ``depth`` (RecurrentGemma in
    flow mode, one period of its pattern)."""
    if name == "recurrentgemma_9b":
        return rg_cfg("flow", depth)
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), n_layers=depth)


def train_wide_full_width(name: str, depth: int, batch: int,
                          optimizer: str, seq_shard_prefill: bool) -> dict:
    """Phases 37 and 38: ``name`` at full width, depth cut to ``depth``,
    weights drawn on the card from a seed, through ``launch.train.train``
    with ``optimizer``: WIDE_TRAIN_STEPS bf16 steps of ``batch`` x
    WIDE_TRAIN_SEQ tokens on K1 and K2 under ``auto`` (exactly 2 K1 --
    forward and remat recompute -- and 1 K2 a flow layer and step, nothing
    else); step ms, tokens/s and peak memory.  Then ``wide_train_both_paths``
    (37b, 38b), and on the same weights the paper-causal mode (phases 40
    and 41, ``train_wide_run``: exactly 3 K5a and 1 K5b a flow layer and
    step, no K1 or K2; 40b and 41b, one fp32 step against the pinned plain
    path) and, where ``seq_shard_prefill``, its sequence-parallel prefill
    (42b, ``cp_prefill_full_width``)."""
    from repro_torch.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import training_shapes
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves

    cfg = wide_train_cfg(name, depth)
    heads = training_shapes(cfg, ShapeSpec("train", WIDE_TRAIN_SEQ, batch,
                                           "train"))
    n_flow = hybrid_layers(cfg)[0]
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9  # what earlier phases hold
    params = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                     device=DEVICE)
    n_params = sum(x.numel() for x in tree_leaves(params))
    fwd = 2 if cfg.remat else 1  # the forward and its remat recompute
    stats = {"config": cfg.name,
             "depth": f"{depth} of {get_config(name).n_layers} layers",
             "n_params": n_params, "held_before_gb": held,
             **train_wide_run(cfg, params, batch, optimizer,
                              {"flow_fused": fwd, "flow_fused_bwd": 1},
                              f"{name} bf16")}
    wide_train_both_paths(cfg, params, n_flow)
    paper = paper_causal(cfg)
    stats["paper"] = train_wide_run(
        paper, params, batch, optimizer,
        {"flow_chunk": fwd + 1, "flow_chunk_dkv": 1},
        f"{name} paper-causal bf16",
        per_pair=chunk_pairs(heads.d, heads.dv, k5a=fwd, dq=1, k5b=1))
    wide_train_both_paths(paper, params, n_flow,
                          per_layer={"flow_chunk": fwd + 1,
                                     "flow_chunk_dkv": 1})
    if seq_shard_prefill:
        stats["cp_prefill"] = cp_prefill_full_width(cfg, params)
    del params
    torch.cuda.empty_cache()
    return stats


def train_wide_run(cfg, params, batch: int, optimizer: str,
                   per_layer: dict, tag: str,
                   per_pair: dict | None = None) -> dict:
    """WIDE_TRAIN_STEPS bf16 steps of ``cfg`` from ``params`` through
    ``launch.train.train``: finite losses and exactly ``per_layer``
    launches a flow layer and step, nothing else, and of K5a and K5b
    exactly ``per_pair`` by (D, Dv) (``chunk_pairs``; none by default);
    step ms, tokens/s and peak memory."""
    from repro_torch.kernels import LAUNCHES, PAIR_LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.launch.train import train

    n_flow = hybrid_layers(cfg)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = train(cfg, steps=WIDE_TRAIN_STEPS, batch=batch, seq=WIDE_TRAIN_SEQ,
                seed=SEED, device=DEVICE, params=params, optimizer=optimizer)
    launches, pairs = dict(LAUNCHES), dict(PAIR_LAUNCHES)
    hist = out["history"]
    if len(hist) != WIDE_TRAIN_STEPS or not all(math.isfinite(x)
                                                for x in hist):
        raise AssertionError(f"{tag} training losses {hist}")
    n = n_flow * WIDE_TRAIN_STEPS
    want = {**dict.fromkeys(KERNELS, 0),
            **{k: per * n for k, per in per_layer.items()}}
    if launches != want:
        raise AssertionError(f"{tag} training launched {launches}, want "
                             f"{want}")
    expect_pairs(pairs, {k: per * n for k, per in (per_pair or {}).items()},
                 f"{tag} training")
    step_ms = 1e3 * statistics.median(out["step_s"][1:])
    stats = {"optimizer": optimizer, "flow_layers": n_flow,
             "strict_causal": cfg.attention.strict_causal,
             "steps": WIDE_TRAIN_STEPS, "batch": batch,
             "seq": WIDE_TRAIN_SEQ, "first_step_ms": 1e3 * out["step_s"][0],
             "step_ms": step_ms,
             "tokens_per_s": batch * WIDE_TRAIN_SEQ / step_ms * 1e3,
             "history": hist, "launches": launches, "pair_launches": pairs,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[train {tag}] " + json.dumps(stats), flush=True)
    del out
    torch.cuda.empty_cache()
    return stats


def wide_train_both_paths(cfg, params, n_flow: int, batch: int = 2,
                          per_layer: dict | None = None):
    """Phases 37b and 38b (40b and 41b in the paper-causal mode): one fp32
    step of ``batch`` x WIDE_TRAIN_SEQ tokens at the run's full width and
    depth, on the kernels (``per_layer`` launches a flow layer: by
    default K1 twice with remat, and K2) and pinned to
    ``backend="plain"`` (no launch): the loss within rtol 1e-4, every
    gradient leaf within 1e-4 of the plain path's max |grad| (phase 11's
    bounds), the attention projections' gradients non-zero on the
    kernels."""
    from repro_torch.data.loader import lm_loader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.layers.attention import executor_of, plan_of
    from repro_torch.models import lm
    from repro_torch.utils import tree_map

    first = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             next(lm_loader(SEED, batch=batch, seq=WIDE_TRAIN_SEQ,
                            vocab=cfg.vocab_size)).items()}
    losses, grads = {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        torch.cuda.synchronize()
        reset_launches()
        loss, _ = lm.loss_fn(leaves, first, c, dtype=torch.float32,
                             plan=executor_of(c, plan_of(c, needs_grad=True)))
        loss.backward()
        torch.cuda.synchronize()
        want = dict.fromkeys(KERNELS, 0)
        if backend == "auto":
            # with remat the backward runs each block's forward again
            want.update({k: per * n_flow for k, per in (per_layer or {
                "flow_fused": 2 if cfg.remat else 1,
                "flow_fused_bwd": 1}).items()})
        if dict(LAUNCHES) != want:
            raise AssertionError(f"{cfg.name} fp32 backend={backend}: "
                                 f"launches {LAUNCHES}, want {want}")
        losses[backend] = float(loss)
        grads[backend] = [(path, x.grad) for path, x in named_leaves(leaves)]
        del leaves, loss
    a, b = losses["auto"], losses["plain"]
    if not abs(a - b) <= 1e-4 * abs(b):
        raise AssertionError(f"{cfg.name} fp32 loss: kernels {a}, plain {b}")
    worst, attn_ok = 0.0, []
    for (path, g), (_, ref) in zip(grads["auto"], grads["plain"]):
        if g is None or ref is None:
            if (g is None) != (ref is None):
                raise AssertionError(f"{cfg.name} {path}: a gradient on one "
                                     "path only")
            continue
        scale, err = float(ref.abs().max()), float((g - ref).abs().max())
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{cfg.name} fp32 {path} grad: |diff| "
                                 f"{err:.3e}, max |plain| {scale:.3e}")
        if scale > 0:
            worst = max(worst, err / scale)
        if path.endswith((".attn.wq.w", ".attn.wk.w", ".attn.wv.w",
                          ".attn.kv_down.w", ".attn.kv_up.w")):
            attn_ok.append(float(g.abs().max()) > 0)
    if not attn_ok or not all(attn_ok):
        raise AssertionError(f"{cfg.name}: attention projections' gradients "
                             f"on the kernels {attn_ok}")
    mode = "" if cfg.attention.strict_causal else " paper-causal"
    print(f"[train {cfg.name}{mode} fp32] kernels vs plain, one step of "
          f"{batch} x "
          f"{WIDE_TRAIN_SEQ}: loss {a:.6f} vs {b:.6f}; {len(grads['auto'])} "
          f"gradient leaves, worst |diff| / max |grad| {worst:.3e}; "
          f"{len(attn_ok)} attention projections' gradients non-zero",
          flush=True)


def named_leaves(tree, prefix=""):
    """(dotted path, tensor) of every tensor of a nested dict / list."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [x for k, v in items
            for x in named_leaves(v, f"{prefix}.{k}" if prefix else str(k))]


def time_wide_train_kernels(runs: dict, errs: dict) -> list:
    """Phase 9, the wide training and int8 rows: K2 at one layer's
    backward of a training step at each of WIDE_Q_SHAPES' heads (batch x
    kv heads rows, N = 512 all valid, bf16, zero state cotangents as in
    training: 8 x 16 MLA heads, 4 x 8 Nemotron heads at G = 12, 4 x 1
    RecurrentGemma heads at G = 16), with the device ms of each of its
    five CUDA kernels; K4 at one decode step of the 16-slot int8 pool
    (bf16 tokens) at each.  ``runs`` maps a tag to the runs whose launches
    count (phases 37-39; 0 at Nemotron-4-340B's shape, which no model run
    reaches)."""
    from repro_torch.kernels.flow_decode import (flow_decode_q_call,
                                                 flow_decode_q_ref)
    from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,
                                                flow_fused_bwd_ref,
                                                flow_fused_call)

    batch = {"d192_dv128": 8, "d192_g12": 4, "d256_g16": 4}
    rows = []
    for tag, slots, hkv, g, d, dv in WIDE_Q_SHAPES:
        train_run, serve_run = runs.get(tag, (None, None))
        bh, n = batch[tag] * hkv, WIDE_TRAIN_SEQ
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 97)
        mk = lambda *s_: torch.randn(s_, generator=gen,  # noqa: E731
                                     device=DEVICE).to(torch.bfloat16)
        q, k, v, g_out = mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, dv), \
            mk(bh, g, n, dv)
        lens = torch.full((bh,), n, dtype=torch.int32, device=DEVICE)
        with torch.no_grad():
            _, totals = flow_fused_call(q, k, v, lens, chunk=128)
        g_sums = [torch.zeros_like(x) for x in totals]
        args = (q, k, v, lens, totals, g_out, g_sums)
        st_bytes = bh * (4 * d + 1 + d * dv) * 4
        b_k2 = (bh * n * (g * d + d + dv + g * dv) * 2
                + bh * n * (g * d + d + dv) * 2 + 2 * st_bytes + bh * 4)
        bound_ms, by = bound(b_k2, bh * n * bwd_ops_per_position(g, d, dv))
        with torch.no_grad():
            rows.append({
                "name": f"flow_fused_bwd_{tag}", "route": "cuda",
                "source": "src/repro_torch/csrc/flow_fused_bwd_wide.cu",
                "replaces": "src/repro/kernels/flow_fused/bwd.py:178",
                "launches": train_run["launches"]["flow_fused_bwd"]
                if train_run else 0,
                "max_abs_err": errs[f"flow_fused_bwd_{tag}"],
                "ms": time_ms(lambda: flow_fused_bwd_call(*args, chunk=128)),
                "plain_ms": time_ms(lambda: flow_fused_bwd_ref(
                    q, k, v, lens, g_out, g_sums, chunk=128)),
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                "shape": f"{batch[tag]} x {hkv} kv heads, G = {g}, N = {n} "
                         f"all valid, D = {d}, Dv = {dv}, bf16",
                "breakdown_ms": chunk_breakdown(
                    lambda: flow_fused_bwd_call(*args, chunk=128),
                    "flow_bwd_")})
        del q, k, v, g_out, args, totals, g_sums
        qpool = int8_pool(decode_pool(slots, hkv, d, SEED + 98, dv=dv))
        tq, tk, tv = decode_token(gen, slots, hkv, g, d, torch.bfloat16,
                                  dv=dv)
        bh = slots * hkv
        tok = (tq.reshape(bh, g, d), tk.reshape(bh, d), tv.reshape(bh, dv))
        qflat = flat_q_pool(qpool)
        plain = [x.clone() for x in (*qflat[0], qflat[1], *qflat[2],
                                     qflat[3], qflat[4])]
        bound_ms, by = bound(q_step_bytes(slots, hkv, g, d, 2, dv),
                             bh * q_step_ops(g, d, dv))
        with torch.inference_mode():
            rows.append({
                "name": f"flow_decode_q_{tag}", "route": "cuda",
                "source": "src/repro_torch/csrc/flow_decode_q.cu",
                "replaces": "src/repro/kernels/flow_decode/quant.py:158",
                "launches": serve_run["launches"]["flow_decode_q"]
                if serve_run else 0,
                "max_abs_err": errs[f"flow_decode_q_{tag}"],
                "ms": time_ms(lambda: flow_decode_q_call(
                    qpool.payload.t, *tok, *qflat, hkv=hkv)),
                "plain_ms": time_ms(lambda: flow_decode_q_ref(
                    qpool.payload.t, *tok, tuple(plain[:4]), plain[4],
                    tuple(plain[5:9]), plain[9], plain[10], hkv=hkv)),
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                "shape": f"{slots} slots x {hkv} kv heads, G = {g}, D = {d},"
                         f" Dv = {dv}, int8 pool, bf16 tokens"})
    print("[wide training and int8 shapes] " + json.dumps(rows), flush=True)
    return rows


# --- K5a and K5b at the wide pairs: phases 3k, 40-42b -------------------------

#: phase 3k's shapes and phase 9's wide K5a / K5b rows: (tag, rows = batch
#: x kv heads, G, N, D, Dv) of one flow layer of the paper-causal training
#: steps of phases 40 and 41 -- DeepSeek-V2-Lite's 4 x 16 MLA heads, their
#: dq call (D and Dv swapped) and RecurrentGemma-9B's 4 x 1 kv head at G =
#: 16 -- and of Nemotron-4-340B's 4 x 8 kv heads of 192 at G = 12, which no
#: model run reaches
WIDE_CHUNK_SHAPES = (("d192_dv128", 64, 1, 512, 192, 128),
                     ("d128_dv192", 64, 1, 512, 128, 192),
                     ("d192_g12", 32, 12, 512, 192, 192),
                     ("d256_g16", 4, 16, 512, 256, 256))
#: phase 3k's second case at each pair: rows and an N no multiple of the
#: kernels' chunk of 32
WIDE_CHUNK_RAGGED = (6, 200)


def check_wide_chunk() -> dict:
    """Phase 3k: K5a and K5b at each of WIDE_CHUNK_SHAPES, and at N = 200
    of 6 rows at the same pair and group, against their plain versions
    (K5a also on the swapped operands of its dq call) and their
    decompositions (``flow_chunk_parallel``, ``flow_chunk_dkv_parallel``
    at the kernels' chunk of 32), within phase 3d's K5a tolerance; two
    calls of each bitwise equal.  Returns each row's max |error| against
    the plain versions."""
    from repro_torch.kernels.flow_chunk import (flow_chunk_call,
                                                flow_chunk_dkv_call,
                                                flow_chunk_dkv_parallel,
                                                flow_chunk_dkv_ref,
                                                flow_chunk_parallel,
                                                flow_chunk_ref)

    errs = {}
    for tag, rows, g, n, d, dv in WIDE_CHUNK_SHAPES:
        e5a = e5b = edq = 0.0
        for r, nn in ((rows, n), WIDE_CHUNK_RAGGED):
            q, k, v, cot = chunk_operands(r, g, nn, d, dv,
                                          SEED + 110 + d + dv + g + nn)
            name = f"{tag} rows={r} G={g} N={nn} ({d}, {dv})"
            with torch.no_grad():
                out = flow_chunk_call(q, k, v)
                e5a = max(e5a, dot_close(f"flow_chunk {name}", out,
                                         flow_chunk_ref(q, k, v)))
                dot_close(f"flow_chunk {name} vs flow_chunk_parallel", out,
                          flow_chunk_parallel(q, k, v, 32))
                if not torch.equal(flow_chunk_call(q, k, v), out):
                    raise AssertionError(f"flow_chunk {name}: two calls "
                                         "differ")
                edq = max(edq, dot_close(f"flow_chunk {name} dq (g, v, k)",
                                         flow_chunk_call(cot, v, k),
                                         flow_chunk_ref(cot, v, k)))
                dkv = flow_chunk_dkv_call(q, k, v, cot)
                for x, a, b in zip("kv", dkv,
                                   flow_chunk_dkv_ref(q, k, v, cot)):
                    e5b = max(e5b, dot_close(f"flow_chunk_dkv {name} d{x}",
                                             a, b))
                for x, a, b in zip("kv", dkv, flow_chunk_dkv_parallel(
                        q, k, v, cot, 32)):
                    dot_close(f"flow_chunk_dkv {name} d{x} vs "
                              "flow_chunk_dkv_parallel", a, b)
                if not all(map(torch.equal, flow_chunk_dkv_call(q, k, v, cot),
                               dkv)):
                    raise AssertionError(f"flow_chunk_dkv {name}: two calls "
                                         "differ")
            torch.cuda.synchronize()
            del q, k, v, cot, out, dkv
            torch.cuda.empty_cache()
        errs[f"flow_chunk_{tag}"], errs[f"flow_chunk_dkv_{tag}"] = e5a, e5b
        print(f"[K5 wide] {tag} (rows {rows}, G = {g}, N = {n}; and 6 rows "
              f"at N = 200): K5a {e5a:.3e}, its dq operands {edq:.3e}, K5b "
              f"{e5b:.3e}; both within their decompositions' bound, two "
              "calls of each bitwise equal", flush=True)
    return errs


def time_wide_chunk_kernels(pairs: dict, errs: dict) -> list:
    """Phase 9, the wide K5a and K5b rows: each at one flow layer of
    WIDE_CHUNK_SHAPES (fp32, the pipeline's operands), with the device ms
    of each of its three CUDA kernels; the plain versions as
    ``time_chunk_kernels``'s (the chunked scan, and for K5b the backward of
    autograd through it); launches the main path's ``PAIR_LAUNCHES`` at
    the row's (D, Dv), ``pairs`` (0 at Nemotron-4-340B's shape, which no
    model run reaches); bounds with every operation a 3xTF32 product
    (``tf32_bound``)."""
    from repro_torch.attention.chunked import chunked_causal_dot_grouped
    from repro_torch.kernels.flow_chunk import (flow_chunk_call,
                                                flow_chunk_dkv_call)

    rows = []
    for tag, bh, g, n, d, dv in WIDE_CHUNK_SHAPES:
        q, k, v, cot = chunk_operands(bh, g, n, d, dv, SEED + 120)
        kl, vl = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
        graph = chunked_causal_dot_grouped(q, kl, vl, 128)
        io = 4 * bh * n * (g * d + d + dv + g * dv)  # q, k, v read; out
        io_dkv = io + 4 * bh * n * (d + dv)  # g read; dk, dv written
        shape = (f"{bh} rows, G = {g}, N = {n}, D = {d}, Dv = {dv}, fp32")
        for name, source, replaces, run, plain, bytes_moved, ops, key in (
                ("flow_chunk", "src/repro_torch/csrc/flow_chunk_wide.cu",
                 "src/repro/kernels/flow_chunk/flow_chunk.py:72",
                 lambda: flow_chunk_call(q, k, v),
                 lambda: chunked_causal_dot_grouped(q, k, v, 128),
                 io, bh * n * chunk_ops(g, d, dv), K5A_KEY),
                ("flow_chunk_dkv",
                 "src/repro_torch/csrc/flow_chunk_bwd_wide.cu",
                 "src/repro/kernels/flow_chunk/bwd.py:114",
                 lambda: flow_chunk_dkv_call(q, k, v, cot),
                 lambda: torch.autograd.grad(graph, (kl, vl), cot,
                                             retain_graph=True),
                 io_dkv, bh * n * chunk_dkv_ops(g, d, dv), K5B_KEY)):
            bound_ms, by = tf32_bound(bytes_moved, ops)
            with torch.no_grad():
                ms = time_ms(run)
            rows.append({
                "name": f"{name}_{tag}", "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": pairs.get(f"{name}_{d}x{dv}", 0),
                "max_abs_err": errs[f"{name}_{tag}"], "ms": ms,
                "plain_ms": time_ms(plain), "bound_ms": bound_ms,
                "bound_by": by, "library_ms": None, "shape": shape,
                "breakdown_ms": chunk_breakdown(run, key)})
        del q, k, v, cot, kl, vl, graph
        torch.cuda.empty_cache()
    print("[wide K5a/K5b shapes] " + json.dumps(rows), flush=True)
    print("[wide K5a/K5b kernels] registers and spill bytes: " + json.dumps(
        {name: PTXAS.get(name, "cached")
         for name in ("flow_chunk_wide", "flow_chunk_bwd_wide")}),
        flush=True)
    return rows


# --- fleet serving: phases 34-34c ----------------------------------------------

#: phase 34b's prediction of an fp32 flow bundle of flowformer_lm: 6 layers
#: x (8 kv heads x (4 x 64 + 1 + 64 x 64) x 4 B + 4 B of t)
FLOW_BUNDLE_BYTES = 6 * (8 * (4 * 64 + 1 + 64 * 64) * 4 + 4)


def fleet_launches_exact(fleet, launches: dict, decode: str, what: str):
    """Phase 34's launch rule: exactly one K1 a layer per admission round
    of the prefill workers, one ``decode`` (K3, or K4 from int8 pools) a
    layer per decode step of each member that had a live slot, and
    nothing else."""
    from repro_torch.kernels._lib import KERNELS

    n = fleet.cfg.n_layers
    rounds = sum(w.admission_rounds for w in fleet.prefills)
    steps = sum(w.decode_steps for w in fleet.workers)
    if any(w.decode_steps for w in fleet.prefills):
        raise AssertionError(f"{what}: a prefill worker decoded")
    want = dict.fromkeys(KERNELS, 0)
    want.update({"flow_fused": n * rounds, decode: n * steps})
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def keep_first_bundle(fleet) -> dict:
    """Wrap the fleet's ``transport.export`` to keep the first bundle it
    makes (under ``"bundle"``)."""
    kept, export = {}, fleet.transport.export

    def keep(*a, **kw):
        bundle = export(*a, **kw)
        kept.setdefault("bundle", bundle)
        return bundle

    fleet.transport.export = keep
    return kept


def serve_fleet_full_width(params, cfg, single: dict,
                           state_dtype=None) -> dict:
    """Phase 34 (its int8 half with ``state_dtype="int8"``): phase 5's 48
    requests and 16 slots a worker through ``FleetEngine(prefill=1,
    decode=2)`` on the one card, bf16, the workers sharing one serving
    copy of phase 5's weights: exact launch counts, decode and prefill
    tokens/s beside ``single`` (phase 5's or 5c's Engine), the host time
    of the bundles' exports and installs, migrations, KiB of state moved
    a request and ``loads()``; an int8 fleet's bundles carry int8
    payloads and fp32 scales."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.fleet import FleetEngine
    from repro_torch.utils import tree_leaves

    fleet = FleetEngine(params, cfg, prefill=1, decode=2, slots=16,
                        max_len=512, seed=SEED, state_dtype=state_dtype)
    served = {tuple(x.data_ptr() for x in tree_leaves(w.params))
              for w in fleet.prefills + fleet.workers}
    reqs = requests(np.random.default_rng(SEED + 4), 48, cfg.vocab_size,
                    (16, 384), (32, 64))
    for r in reqs:
        fleet.submit(r)
    prefill = timed_calls(fleet.prefills[0], ("prefill",))
    steps = [timed_calls(w, ("step",)) for w in fleet.workers]
    moved = timed_calls(fleet.transport, ("export", "install"))
    kept = keep_first_bundle(fleet)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fleet.step()
    loads_admitted = fleet.loads()
    done = fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    tag = f"fleet bf16, {state_dtype or 'fp32'} pools"
    if len(done) != len(reqs):
        raise AssertionError(f"{tag}: {len(done)} of {len(reqs)} retired")
    for r in done:
        if not r.done or len(r.generated) != r.max_new_tokens or not all(
                0 <= tok < cfg.vocab_size for tok in r.generated):
            raise AssertionError(f"{tag}: request {r.uid}: {r.generated}")
    fleet_launches_exact(fleet, launches, "flow_decode_q" if state_dtype
                         else "flow_decode", tag)
    bundle = kept["bundle"]
    if bundle.nbytes != sum(e.nbytes for e in bundle.manifest):
        raise AssertionError(f"{tag}: the manifest does not add up")
    kinds = {(e.path.split(".")[1], e.dtype) for e in bundle.manifest}
    if state_dtype and not {("payload", "int8"),
                            ("scale", "float32")} <= kinds:
        raise AssertionError(f"{tag}: bundle leaves {sorted(kinds)}")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    decode_s = sum(s["step"] for s in steps)
    kb = list(fleet.kb_by_uid.values())
    stats = {
        "requests": len(reqs), "serving_weight_copies": len(served),
        "admission_rounds": fleet.prefills[0].admission_rounds,
        "decode_steps": [w.decode_steps for w in fleet.workers],
        "prefill_s": prefill["prefill"], "decode_s": decode_s,
        "transport_s": moved["export"] + moved["install"],
        "wall_s": wall,
        "prefill_tok_per_s": prompt_tokens / prefill["prefill"],
        "decode_tok_per_s": decode_tokens / decode_s,
        "wall_tok_per_s": decode_tokens / wall,
        "engine_prefill_tok_per_s": single["prefill_tok_per_s"],
        "engine_decode_tok_per_s": single["decode_tok_per_s"],
        "migrations": fleet.migrations, "bytes_migrated":
        fleet.bytes_migrated, "kib_per_request": sum(kb) / len(kb),
        "admission_bundle_bytes": bundle.nbytes,
        "loads_after_first_step": loads_admitted,
        "loads_after_drain": fleet.loads(), "launches": launches}
    if len(served) != 1:
        raise AssertionError(f"{tag}: {len(served)} serving copies of the "
                             "weights on one card")
    print(f"[{tag}] " + json.dumps(stats), flush=True)
    return stats


def fleet_bundle_bytes(params, cfg) -> dict:
    """Phase 34b: bundle bytes at full width.  For flow fp32, flow int8
    and bf16 paged softmax pools (``PagedSpec(PAGE)``), one prompt at each
    power-of-two bucket of phase 5's prompt lengths and at 512 tokens:
    export it from one worker (``bundle.nbytes`` equal to the manifest's
    sum), install it into another worker's free slot (its other slots
    busy) and export it again: the two buffers bitwise equal."""
    from repro_torch.serving.engine import PagedSpec
    from repro_torch.serving.transport import StateTransport
    from repro_torch.serving.worker import Worker, _bucket_len

    lens = [len(r.prompt) for r in requests(
        np.random.default_rng(SEED + 4), 48, cfg.vocab_size, (16, 384),
        (32, 64))]
    buckets = sorted({_bucket_len(n, 512) for n in lens} | {512})
    pools = {"flow fp32": (cfg, {}),
             "flow int8": (cfg, {"state_dtype": "int8"}),
             "softmax paged bf16": (softmax_cfg(cfg),
                                    {"paged": PagedSpec(PAGE)})}
    rng = np.random.default_rng(SEED + 34)
    t, sizes = StateTransport(), {}
    for tag, (c, kw) in pools.items():
        src, dst = (Worker(params, c, slots=4, max_len=512, seed=SEED,
                           device=DEVICE, **kw) for _ in range(2))
        busy = [rng.integers(0, c.vocab_size, 100).astype(np.int32)
                for _ in range(3)]
        src.prefill(busy[:2], [0, 2], np.zeros(2, np.float32),
                    spans=[100, 100])
        dst.prefill(busy, [0, 1, 3], np.zeros(3, np.float32),
                    spans=[100] * 3)
        sizes[tag] = {}
        for n in buckets:
            prompt = rng.integers(0, c.vocab_size, n).astype(np.int32)
            src.prefill([prompt], [1], np.zeros(1, np.float32), spans=[n])
            first = t.export(src, 1, n)
            if first.nbytes != sum(e.nbytes for e in first.manifest):
                raise AssertionError(f"{tag} at {n}: manifest != buffer")
            t.install(dst, 2, first, span=n)
            again = t.export(dst, 2, n)
            if again.manifest != first.manifest or not np.array_equal(
                    again.buffer, first.buffer):
                raise AssertionError(f"{tag} at {n} tokens: export, "
                                     "install, export is not bitwise")
            src.release_slot(1)
            dst.release_slot(2)
            sizes[tag][n] = first.nbytes
        del src, dst
    flow = set(sizes["flow fp32"].values())
    flow_q = set(sizes["flow int8"].values())
    if len(flow) != 1 or len(flow_q) != 1:
        raise AssertionError(f"flow bundles vary with length: {sizes}")
    paged = sizes["softmax paged bf16"]
    per_token = (paged[512] - paged[256]) / 256
    stats = {"flow_fp32_bytes": flow.pop(), "flow_int8_bytes": flow_q.pop(),
             "flow_fp32_bytes_predicted": FLOW_BUNDLE_BYTES,
             "paged_bf16_bytes_by_bucket": paged,
             "paged_bf16_bytes_per_token": per_token,
             "paged_bf16_mean_bytes_phase5_prompts": sum(
                 paged[_bucket_len(n, 512)] for n in lens) / len(lens),
             "round_trips_bitwise": len(buckets) * len(pools)}
    stats["crossover_tokens"] = stats["flow_fp32_bytes"] / per_token
    print("[fleet bundle bytes] " + json.dumps(stats), flush=True)
    return stats


def fleet_fp32_equal(params, cfg, tag: str, *, paged=None, state_dtype=None,
                     need=("flow_fused", "flow_decode")) -> dict:
    """Phase 34c: phase 6's 12 requests through the fp32 fleet on the
    kernels (``FleetEngine(prefill=1, decode=2)``, 8 slots a worker, as
    phase 6's Engine), three times: one forced ``migrate(uid)`` after 6
    steps; one ``kill_worker`` of the busier member after 6 steps with
    retained bundles (replay, and the orphans no survivor slot takes
    prefilled again); and the same with ``replicate=False``.  Each run's
    greedy tokens must equal the single fp32 Engine's on the kernels
    (with the same pools), token for token, and each launches the
    kernels of ``need``.  One exception, from int8 pools: an orphan whose
    state is prefilled again (every orphan under ``replicate=False``, and
    under ``replicate=True`` those no survivor slot took) is held equal
    up to the kill and counted after it, not held: an int8 pool rounds
    its state every decode step, and a state prefilled again is rounded
    once from another fp32 state, so its later tokens may part, in the
    reference as in the port (``tests/test_torch_fleet.py`` holds the
    two fleets equal there).  Returns the runs' summed launches and the
    admission bundle's bytes."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.fleet import FleetEngine

    def traffic():
        return requests(np.random.default_rng(SEED + 5), 12, cfg.vocab_size,
                        (16, 128), (16, 16))

    engine = Engine(params, cfg, slots=8, max_len=256, seed=SEED, paged=paged,
                    dtype=torch.float32, state_dtype=state_dtype,
                    device=DEVICE)
    for r in traffic():
        engine.submit(r)
    want = {r.uid: r.generated for r in engine.run()}
    del engine
    launches, runs, kept = dict.fromkeys(KERNELS, 0), {}, {}
    for mode in ("migrate", "kill, replicate", "kill, re-prefill"):
        fleet = FleetEngine(params, cfg, prefill=1, decode=2, slots=8,
                            max_len=256, seed=SEED, paged=paged,
                            dtype=torch.float32, state_dtype=state_dtype,
                            replicate=mode != "kill, re-prefill")
        if mode == "migrate":
            kept = keep_first_bundle(fleet)
        reqs = traffic()
        for r in reqs:
            fleet.submit(r)
        reset_launches()
        for _ in range(6):
            fleet.step()
        committed = {r.uid: len(r.generated) for r in reqs}
        refilled = set()
        if mode == "migrate":
            uid = next(r.uid for r in reqs if fleet.locate(r.uid))
            fleet.migrate(uid)
            event = f"request {uid} migrated"
        else:
            victim = max(range(2), key=lambda i: fleet.members[i].load)
            orphans = fleet.kill_worker(victim)
            refilled = ({r.uid for r in fleet.queue} if fleet.replicate
                        else set(orphans))
            event = (f"{len(orphans)} orphans, {len(refilled)} prefilled "
                     "again")
        fleet.run()
        for name, n in LAUNCHES.items():
            launches[name] += n
        if any(LAUNCHES[name] == 0 for name in need):
            raise AssertionError(f"{tag}, {mode}: launches {LAUNCHES}, "
                                 f"need {need}")
        got = {r.uid: r.generated for r in reqs}
        # from int8 pools an orphan prefilled again is held up to the kill
        loose = refilled if state_dtype else set()
        parted = [0, 0]  # its tokens after the kill: equal, all
        for uid, toks in want.items():
            n = committed[uid] if uid in loose else len(toks)
            parted[0] += sum(a == b for a, b in zip(got[uid][n:], toks[n:]))
            parted[1] += len(toks) - n
            if got[uid][:n] == toks[:n] and len(got[uid]) == len(toks):
                continue
            j = next((i for i, (a, b) in enumerate(zip(got[uid], toks))
                      if a != b), min(len(got[uid]), len(toks)))
            print(f"[fleet fp32] {tag}, {mode}: request {uid} diverges at "
                  f"generated token {j}: fleet {got[uid][j:j + 4]}, engine "
                  f"{toks[j:j + 4]}", flush=True)
            raise AssertionError(f"{tag}, {mode}: fleet greedy tokens "
                                 f"differ from the Engine's ({uid})")
        runs[mode] = {"event": event, "migrations": fleet.migrations,
                      "recoveries": fleet.recoveries,
                      "bytes_migrated": fleet.bytes_migrated}
        if loose:
            runs[mode]["prefilled_again_tokens_equal_after_kill"] = parted
        del fleet
    bundle = kept["bundle"]
    n_tok = sum(len(g) for g in want.values())
    print(f"[fleet fp32] {tag}: the {n_tok} greedy tokens of "
          f"{len(want)} requests equal the Engine's in every run"
          + (" (int8 orphans prefilled again: up to the kill)"
             if state_dtype else "") + ": "
          + json.dumps(runs) + f"; admission bundle {bundle.nbytes} B ("
          + ", ".join(sorted({e.dtype for e in bundle.manifest}))
          + "); launches " + json.dumps({k: n for k, n in launches.items()
                                         if n}), flush=True)
    return {"launches": launches, "bundle_bytes": bundle.nbytes,
            "dtypes": sorted({e.dtype for e in bundle.manifest})}


def fleet_rg_fp32_equal() -> dict:
    """Phase 34c's hybrid stack: ``recurrentgemma_9b`` at one period (3 of
    38 layers, phase 31b's weights, fp32), whose bundles carry the
    RG-LRU's bf16 conv histories beside a D = 256 FlowState."""
    from repro_torch.models import lm

    cfg = rg_cfg("flow", RG_PERIOD)
    params = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                     device=DEVICE)
    out = fleet_fp32_equal(params, cfg, "recurrentgemma_9b, one period",
                           need=("flow_fused", "flow_decode",
                                 "boundary_gather"))
    if "bfloat16" not in out["dtypes"]:
        raise AssertionError(f"RG-LRU bundle dtypes {out['dtypes']}")
    del params
    torch.cuda.empty_cache()
    return out


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


def serve_ssd_full_width(params, cfg, state_dtype=None) -> dict:
    """Phase 13 (33a with ``state_dtype="int8"``): the bf16 Engine serving
    the full-width mamba2_1p3b; K9 launches, rates and the pools' bytes
    (int8 pools: payloads and scales, beside the fp32 pools' bytes)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._lib import KERNELS
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
    if state_dtype is None and n_bytes != 16 * per_slot:
        raise AssertionError(f"pool_bytes {n_bytes} != 16 x {per_slot}")
    if state_dtype is not None and not n_bytes < 16 * per_slot / 3:
        raise AssertionError(f"{state_dtype} pool_bytes {n_bytes}, fp32 "
                             f"16 x {per_slot}")
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
        "pool_bytes_per_slot": n_bytes // 16,
        "fp32_pool_bytes_per_slot": per_slot}
    tag = "" if state_dtype is None else f", {state_dtype} pools"
    print(f"[engine mamba2 bf16{tag}] " + json.dumps(stats), flush=True)
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


def bind_plain_boundary():
    """Bind ``interpret=True`` into the RG-LRU layer's conv-history gather
    (K9's plain version on the card); returns the restoring call."""
    import functools

    from repro_torch.layers import rglru as rglru_layer

    real = rglru_layer.boundary_gather
    rglru_layer.boundary_gather = functools.partial(real, interpret=True)

    def restore():
        rglru_layer.boundary_gather = real
    return restore


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


def nc_one_sink_ops(m: int, d: int, dv: int) -> int:
    """fp32 operations that the non-causal pair needs for one (row, kv
    head) at a single sink row, where no D x Dv product is needed:
    phi(q) . (phi(k)^T v_hat) is the sum of v_hat_j weighted by phi(q) .
    phi(k_j), which is the outflow dot.  Per source row D for k_sum, 2 D
    for the outflow dot, 2 D for ko_sum, 2 D for cons_src, Dv for v * e
    and 2 Dv for the weighted sum; at the sink 9 D for its dots and sums
    and Dv for the scale."""
    return m * (7 * d + 3 * dv) + 9 * d + dv


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
        {name: PTXAS.get(name, "cached") for name in (
            "flow_fused", "flow_fused_bwd", "flow_fused_bwd_wide")}),
          flush=True)
    # K5a's profiler breakdown before K6's ablation builds and timings: late
    # in the script a profiler session may see no device time at all
    rows += time_chunk_kernels(launches, errs)
    rows += time_nc_kernels(launches, errs)
    return rows


def q_step_bytes(slots: int, hkv: int, g: int, d: int, act: int,
                 dv: int | None = None) -> int:
    """Bytes one K4 launch must move: the int8 payloads (four sums of D, S
    of D x Dv; Dv = D unless given) and fp32 scales and z read and
    written, q, k, v read and out written in the activation dtype (``act``
    bytes), t read."""
    bh, dv = slots * hkv, dv or d
    pool = bh * (4 * d + d * dv + 5 * 4 + 4)
    return 2 * pool + bh * (g * d + d + dv + g * dv) * act + slots * 4


def q_step_ops(g: int, d: int, dv: int | None = None) -> int:
    """Operations of K4 for one (slot, kv head): K3's recurrence
    (``flow_ops_per_position``) plus 3 per payload element (dequantizing
    multiply, amax, requantizing divide)."""
    dv = dv or d
    return flow_ops_per_position(g, d, dv) + 3 * (4 * d + d * dv)


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
    autograd through it (dk and dv only: q does not require grad).  Bounds
    with every operation a 3xTF32 product (``tf32_bound``)."""
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
        bound_ms, by = tf32_bound(bytes_moved, ops)
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


def time_d24_kernels(table7: dict, errs: dict) -> list:
    """Phase 9, the D = 24 route of K1, K2, K5a and K5b: one layer of
    phase 24's Table 7 step (32 trajectories x 4 heads, N = 60 padded to
    64, D = 24; K1 and K2 bf16 through their wrappers, which store the
    lanes 32 wide, K5a and K5b fp32 on the glue's padded operands as the
    linear row's dot).  The plain versions run on the same inputs; the
    bounds count the real width (the padding is the route's cost);
    ``launches`` are phase 24's flow and linear rows'."""
    from repro_torch.attention.chunked import chunked_causal_dot_grouped
    from repro_torch.kernels.flow_chunk import (flow_chunk_call,
                                                flow_chunk_dkv_call)
    from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,
                                                flow_fused_bwd_ref,
                                                flow_fused_call, flow_fused_ref)

    bh, g, n, w, chunk, nv = T7_K12_SHAPE
    d = 32  # the stored width of K5a's and K5b's padded operands
    (q, k, v, lens, totals, g_out, g_sums), kw = k2_case(
        torch.bfloat16, bh, g, n, w, chunk, nv, "sigmoid", SEED + 70, False)
    st_bytes = bh * (4 * w + 1 + w * w) * 4
    io = nv * bh * (g * w + 2 * w) * 2
    flow_l, lin_l = table7["flow"]["launches"], table7["linear"]["launches"]
    rows = []
    with torch.no_grad():
        for name, run, plain, bytes_moved, ops in (
                ("flow_fused", lambda: flow_fused_call(q, k, v, lens, **kw),
                 lambda: flow_fused_ref(q, k, v, lens, **kw),
                 io + nv * bh * g * w * 2 + st_bytes + bh * 4,
                 nv * bh * flow_ops_per_position(g, w, w)),
                ("flow_fused_bwd", lambda: flow_fused_bwd_call(
                    q, k, v, lens, totals, g_out, g_sums, **kw),
                 lambda: flow_fused_bwd_ref(q, k, v, lens, g_out, g_sums,
                                            **kw),
                 2 * io + nv * bh * g * w * 2 + 2 * st_bytes + bh * 4,
                 nv * bh * bwd_ops_per_position(g, w, w))):
            bound_ms, by = bound(bytes_moved, ops)
            rows.append({
                "name": f"{name}_d24", "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": ("src/repro/kernels/flow_fused/flow_fused.py:207"
                             if name == "flow_fused" else
                             "src/repro/kernels/flow_fused/bwd.py:178"),
                "launches": flow_l[name], "max_abs_err": errs[f"{name}_d24"],
                "ms": time_ms(run), "plain_ms": time_ms(plain),
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                "shape": "32 x 4 heads, N = 60 (64), D = 24 (32), bf16"})
    cq, ck, cv, cot = chunk_operands(bh, g, n, d, d, SEED + 71)
    for x in (cq, ck, cv, cot):
        x[..., w:] = 0  # the glue's padding, after phi
        x[..., nv:, :] = 0
    kl, vl = ck.clone().requires_grad_(True), cv.clone().requires_grad_(True)
    graph = chunked_causal_dot_grouped(cq, kl, vl, 64)
    io = 4 * bh * nv * (g * w + w + w + g * w)
    io_dkv = 4 * bh * nv * (g * w + 2 * w + g * w + 2 * w)
    for name, source, replaces, run, plain, bytes_moved, ops in (
            ("flow_chunk", "flow_chunk.cu", "flow_chunk/flow_chunk.py:72",
             lambda: flow_chunk_call(cq, ck, cv),
             lambda: chunked_causal_dot_grouped(cq, ck, cv, 64), io,
             bh * nv * chunk_ops(g, w, w)),
            ("flow_chunk_dkv", "flow_chunk_bwd.cu", "flow_chunk/bwd.py:114",
             lambda: flow_chunk_dkv_call(cq, ck, cv, cot),
             lambda: torch.autograd.grad(graph, (kl, vl), cot,
                                         retain_graph=True), io_dkv,
             bh * nv * chunk_dkv_ops(g, w, w))):
        bound_ms, by = tf32_bound(bytes_moved, ops)
        with torch.no_grad():
            ms = time_ms(run)
        rows.append({
            "name": f"{name}_d24", "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": lin_l[name], "max_abs_err": errs[f"{name}_d24"],
            "ms": ms, "plain_ms": time_ms(plain), "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None,
            "shape": "32 x 4 heads, N = 60 (64), D = Dv = 24 (32), fp32"})
    print("[D = 24 route] " + json.dumps(rows), flush=True)
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


def tf32_bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """``bound`` for a kernel whose every operation is a product run on
    the tensor cores in 3xTF32 (K5a, K5b): ``tensor_core_bound`` with all
    of ``ops`` products, and what bounds it."""
    ms = tensor_core_bound(ops, ops, bytes_moved)
    return ms, ("bytes" if ms <= 1e3 * bytes_moved / HBM_BYTES_PER_S
                else "operations")


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
        # a phase's reference cycles (a patched bound method, a closure)
        # may hold its weights until the next collection: free them now
        gc.collect()
        torch.cuda.empty_cache()

    build_kernels()
    k1, k2 = check_flow_fused(), check_flow_fused_bwd()
    errs = {"flow_fused": k1["max_abs_err"], "flow_fused_d24": k1["d24"],
            "flow_fused_bwd": k2["max_abs_err"],
            "flow_fused_bwd_d24": k2["d24"],
            **check_flow_nc(),
            **check_flow_chunk(),
            "flow_decode": check_flow_decode()["max_abs_err"],
            "flow_decode_q": check_flow_decode_q()["max_abs_err"],
            **check_ssd(),
            **check_paged_gather(),
            **check_whisper_granite_shapes(),
            **check_wide_shapes(),
            **check_rg_shapes(),
            **check_wide_train_shapes(),
            **check_wide_chunk()}
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
    # the linear-attention baseline has the flow model's leaves too
    lin = linear_cfg(cfg)
    lin_served = serve_full_width(params, lin)
    lin_quant = serve_full_width(params, lin, state_dtype="int8")
    serve_fp32_both_paths(params, lin)
    mark("linear baseline serving")
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
    mark("speculative serving")
    fleet = [serve_fleet_full_width(params, cfg, stats),
             serve_fleet_full_width(params, cfg, quantized, "int8")]
    fleet_bundle_bytes(params, cfg)
    fleet += [fleet_fp32_equal(params, cfg, "flow, fp32 pools"),
              fleet_fp32_equal(params, cfg, "flow, int8 pools",
                               state_dtype="int8",
                               need=("flow_fused", "flow_decode_q")),
              fleet_fp32_equal(params, soft, "softmax paged",
                               paged=PagedSpec(PAGE),
                               need=("paged_gather",))]
    del params
    torch.cuda.empty_cache()
    mark("fleet serving")
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
    params = lm.init(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        root = Path(tmp)
        restarted = train_crash_restart(cfg, params, root)
        factored = train_adafactor_full_width(cfg, params,
                                              trained["step_ms"], root)
        adafactor_fp32_both_paths(cfg)
        kinds = train_attn_kinds_full_width(cfg, params)
        resumed = elastic_resume(cfg, params, root)
        mark("flowformer_lm training lifecycle")
        distributed = [check_context_parallel(),
                       cp_prefill_full_width(cfg, params),
                       cp_train_full_width(cfg, params),
                       cp_elastic_remesh(cfg, params, root)]
    del params
    torch.cuda.empty_cache()
    mark("distribution and context parallelism")
    wide_trained = {w[0]: train_wide_full_width(*w) for w in WIDE_TRAIN}
    # K5a / K5b by (D, Dv) over the main-path runs that count them
    pairs = collections.Counter()
    for run in (*distributed, *wide_trained.values(),
                *(w["paper"] for w in wide_trained.values()),
                *(w["cp_prefill"] for w in wide_trained.values()
                  if "cp_prefill" in w)):
        pairs.update(run.get("pair_launches", {}))
    mark("deepseek_v2_lite_16b and recurrentgemma_9b training, strict and "
         "paper-causal; deepseek_v2_lite_16b seq-sharded prefill")
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
    dt = train_dt_full_width()
    train_dt_fp32_both_paths()
    table7 = train_table7()
    torch.cuda.empty_cache()
    mark("flowformer_dt training and Table 7")
    whisper = get_config("whisper_small")
    from repro_torch.models import encdec

    params = encdec.init(whisper, torch.Generator().manual_seed(SEED),
                         device=DEVICE)
    heard = serve_whisper_full_width(params, whisper)
    del params
    torch.cuda.empty_cache()
    taught = train_whisper_full_width(whisper)
    torch.cuda.empty_cache()
    whisper_fp32_both_paths(whisper)
    torch.cuda.empty_cache()
    mark("whisper_small serving and training")
    granite = serve_granite_full_width(get_config("granite_8b"))
    mark("granite_8b serving")
    deepseek = serve_wide_full_width("deepseek_v2_lite_16b", int8=True)
    mark("deepseek_v2_lite_16b serving, fp32 and int8 pools")
    qwen = serve_wide_full_width("qwen2_vl_72b")
    mark("qwen2_vl_72b serving")
    granite_moe = serve_wide_full_width("granite_moe_3b_a800m", fp32=False,
                                        profile=False)
    mark("granite_moe_3b_a800m serving")
    rg_flow = serve_rg_flow_full_width()
    serve_rg_fp32_both_paths()
    mark("recurrentgemma_9b flow serving, fp32 and int8 pools")
    rg_soft = serve_rg_softmax()
    rg_int8 = rg_int8_teacher_forced()
    mark("recurrentgemma_9b softmax and int8 serving")
    fleet.append(fleet_rg_fp32_equal())
    mark("recurrentgemma_9b fleet serving")
    mamba = get_config("mamba2_1p3b")
    params = lm.init(mamba, torch.Generator().manual_seed(SEED),
                     device=DEVICE)
    served = serve_ssd_full_width(params, mamba)
    served_q = serve_ssd_full_width(params, mamba, state_dtype="int8")
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
        paged, paged_q, seen, series, *speculative, lin_served, lin_quant,
        dt, *(table7[kind] for kind in ("flow", "linear", "softmax")),
        heard, taught, granite, deepseek, qwen, granite_moe, rg_flow,
        rg_soft, rg_int8, served_q, *fleet, restarted, factored, kinds,
        resumed, *distributed, deepseek["int8"], rg_flow["int8"],
        *wide_trained.values(), *(w["paper"] for w in wide_trained.values()),
        wide_trained["deepseek_v2_lite_16b"]["cp_prefill"]))
        for name in stats["launches"]}
    torch.cuda.empty_cache()
    rows = (time_kernels(launches, errs) + time_paged_kernels(launches, errs)
            + time_ssd_kernels(launches, errs)
            + time_d24_kernels(table7, errs)
            + time_whisper_granite_kernels(heard, granite, errs)
            + time_wide_kernels({"deepseek": deepseek, "qwen2_vl": qwen},
                                errs)
            + time_rg_kernels(rg_flow, errs)
            + time_wide_train_kernels(
                {"d192_dv128": (wide_trained["deepseek_v2_lite_16b"],
                                deepseek["int8"]),
                 "d256_g16": (wide_trained["recurrentgemma_9b"],
                              rg_flow["int8"])}, errs)
            + time_wide_chunk_kernels(pairs, errs))
    mark("kernel times")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
