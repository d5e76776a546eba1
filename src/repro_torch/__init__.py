"""Flowformer on PyTorch and CUDA: the port of the JAX package ``repro``.

The JAX package stays the reference; this package runs the same model on
an NVIDIA H100.  Plain tensor code is PyTorch, and each Pallas kernel of
the reference is a CUDA kernel written by hand for ``sm_90a``
(``csrc/``), built with ``nvcc`` on first use and bound with ``ctypes``.

Importing the package builds nothing and needs no GPU.  Entry points take
``device=`` and default to ``"cuda"``; they raise when no GPU is present
unless the caller asks for ``device="cpu"``, where every kernel wrapper
runs its plain PyTorch version.

Layout (each module mirrors its counterpart in ``repro``):

    config.py, configs/     ModelConfig and the flowformer_lm configs
    core/                   FlowConfig, phi maps, GQA grouping
    attention/              FlowState, plain strategies, backend registry,
                            FlowFusedDot (autograd over K1 and K2)
    kernels/flow_fused/     K1: strict-causal flow attention; K2: its
                            backward (bwd.py)
    kernels/flow_decode/    K3: one batched decode step, in place; K4: the
                            same on an int8 pool (quant.py)
    csrc/                   the CUDA sources of the kernels
    layers/, models/lm.py   the decoder-only LM and its loss
    serving/                Scheduler, Worker and Engine; int8 state
                            pools (quant.py)
    training/, data/        AdamW, schedules, the train step; lm_loader
    launch/                 train.py, classify.py, serve.py: the entry
                            points
    interop.py              JAX param trees (as numpy) -> torch params
"""
