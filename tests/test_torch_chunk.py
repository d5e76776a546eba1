"""Port vs reference: the causal dot (K5a, K5b) and the causal pipeline.

The same numpy inputs, made from a seed, go through the JAX package (its
flow_chunk Pallas kernels in interpret mode, its XLA scans and its
pipeline) and through the port on CPU tensors, where the kernel wrappers
run their plain versions:

* ``flow_chunk_parallel`` (K5a's own decomposition: chunk states, their
  prefix, per-chunk products) at chunks 16-64, G 1-3, N 1-512 ragged
  against the chunk and D != Dv, forward and dq operands, against
  ``repro.kernels.flow_chunk.flow_chunk_call``;
* ``flow_chunk_dkv_parallel`` (K5b's own decomposition: chunk states, their
  suffix, per-chunk transposed panels) at the same chunks, G, N and widths
  against ``repro.kernels.flow_chunk.bwd.flow_chunk_dkv_call``;
* ``flow_chunk_ref``, ``chunked_causal_dot_grouped`` and the kernel glue
  ``chunked_causal_dot_cuda`` (N = 200 padded to the chunk) against
  ``repro.kernels.flow_chunk.flow_chunk_call``; ``flow_chunk_dkv_ref``
  against ``flow_chunk_dkv_call``; G in {1, 2}, D != Dv;
* ``FlowChunkDot``'s gradients against ``jax.vjp`` of
  ``repro.attention.vjp.flow_chunk_dot``;
* ``causal_forward`` (on the cumsum, chunked and K5a dots) and the
  quadratic oracle against ``repro.attention.pipeline.causal_forward`` in
  the paper-faithful, strict and no-competition modes, with and without
  allocation, for each phi and both GQA modes; strict ``return_state`` with
  per-row ``lengths``;
* which backend the registry picks for the causal modes.

The dot's operands are made as the causal pipeline hands them to it:
q = phi(q) over the count-scaled inflow (positive, ~4 / D), k = phi(k) in
(0, 1), v and the cotangent standard normal.  Everything is fp32.
Tolerance: rtol 2e-4, atol 2e-5, as for the other flow math
(``tests/test_torch_flow.py``): both sides sum the same fp32 terms in
another order, and the sums grow with the position.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.attention import pipeline as j_pipeline  # noqa: E402
from repro.attention._pallas import chunked_causal_dot_pallas  # noqa: E402
from repro.attention.dots import causal_dot as j_causal_dot  # noqa: E402
from repro.attention.dots import causal_dot_grouped as j_causal_dot_grouped  # noqa: E402
from repro.attention.vjp import flow_chunk_dot  # noqa: E402
from repro.core.flow_attention import FlowConfig as JFlowConfig  # noqa: E402
from repro.core.reference import flow_attention_causal_ref as j_causal_oracle  # noqa: E402
from repro.kernels.flow_chunk.bwd import flow_chunk_dkv_call as j_dkv_call  # noqa: E402
from repro.kernels.flow_chunk.flow_chunk import flow_chunk_call as j_chunk_call  # noqa: E402
from repro_torch import attention  # noqa: E402
from repro_torch.attention import ExecutionPlan, ShapeInfo  # noqa: E402
from repro_torch.attention._cuda import chunked_causal_dot_cuda  # noqa: E402
from repro_torch.attention.chunked import chunked_causal_dot_grouped  # noqa: E402
from repro_torch.attention.dots import causal_dot, causal_dot_grouped  # noqa: E402
from repro_torch.attention.pipeline import causal_forward  # noqa: E402
from repro_torch.attention.vjp import FlowChunkDot  # noqa: E402
from repro_torch.core.flow_attention import (FlowConfig,  # noqa: E402
                                             flow_attention,
                                             flow_attention_causal)
from repro_torch.core.reference import flow_attention_causal_ref  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flow_chunk import (flow_chunk_call,  # noqa: E402
                                            flow_chunk_dkv_call,
                                            flow_chunk_dkv_parallel,
                                            flow_chunk_dkv_ref,
                                            flow_chunk_parallel, flow_chunk_ref)

RTOL, ATOL = 2e-4, 2e-5


def close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def dot_operands(rng, lead, g, n, d, dv):
    """q (*lead, G, N, D), k (*lead, N, D), v (*lead, N, Dv) and a
    cotangent (*lead, G, N, Dv), shaped like the pipeline's dot operands:
    q_in = phi(q) * pos / I with I = phi(q) . cumsum(phi(k)), sigmoid
    phi."""
    pq = 1 / (1 + np.exp(-randn(rng, *lead, g, n, d)))
    pk = 1 / (1 + np.exp(-randn(rng, *lead, n, d)))
    inflow = np.einsum("...gnd,...nd->...gn", pq, np.cumsum(pk, axis=-2))
    pos = np.arange(1, n + 1, dtype=np.float32)
    q = (pq * (pos / inflow)[..., None]).astype(np.float32)
    return q, pk.astype(np.float32), randn(rng, *lead, n, dv), randn(
        rng, *lead, g, n, dv)


# (G, N, D, Dv, chunk): D != Dv, N = 200 not a multiple of the chunk
DOT_CASES = [(1, 64, 16, 8, 16), (2, 200, 8, 16, 64), (2, 48, 16, 16, 16)]


@pytest.mark.parametrize("g,n,d,dv,chunk", DOT_CASES)
def test_flow_chunk_plain_versions_match_pallas(g, n, d, dv, chunk):
    rng = np.random.default_rng(n + 10 * g + d)
    n_pad = -(-n // chunk) * chunk
    q, k, v, cot = dot_operands(rng, (3,), g, n_pad, d, dv)
    want = j_chunk_call(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                        interpret=True)
    before = dict(LAUNCHES)
    close(flow_chunk_call(t(q), t(k), t(v)), want, "flow_chunk_call (cpu)")
    close(flow_chunk_ref(t(q), t(k), t(v)), want, "flow_chunk_ref")
    close(chunked_causal_dot_grouped(t(q), t(k), t(v), chunk), want,
          "chunked_causal_dot_grouped")
    j_dk, j_dv = j_dkv_call(*map(jnp.asarray, (q, k, v, cot)), chunk=chunk,
                            interpret=True)
    for fn in (flow_chunk_dkv_ref, flow_chunk_dkv_call):
        dk, dv_ = fn(t(q), t(k), t(v), t(cot))
        close(dk, j_dk, f"{fn.__name__} dk")
        close(dv_, j_dv, f"{fn.__name__} dv")
    assert LAUNCHES == before, "the CPU path must not count a launch"


# (chunk, G, N, Dk, Dv, swap): K5a's chunk-parallel twin; N ragged against
# the chunk, and swap = the backward's dq (cotangent, v, k) operands
PARALLEL_CASES = [
    (16, 1, 1, 32, 128, False), (16, 2, 130, 64, 32, True),
    (16, 3, 200, 64, 64, False), (16, 1, 512, 128, 128, False),
    (32, 1, 512, 64, 64, False), (32, 2, 1, 128, 128, True),
    (32, 3, 130, 32, 128, False), (32, 2, 200, 64, 32, False),
    (64, 1, 200, 128, 128, False), (64, 2, 512, 64, 32, False),
    (64, 3, 130, 64, 64, True), (64, 1, 512, 32, 128, True)]


@pytest.mark.parametrize("chunk,g,n,d,dv,swap", PARALLEL_CASES)
def test_flow_chunk_parallel_matches_pallas(chunk, g, n, d, dv, swap):
    """``flow_chunk_parallel`` (chunk states, their exclusive prefix in
    order, per-chunk products; the last chunk ragged) against the
    reference kernel on the operands zero-padded to its chunk."""
    rng = np.random.default_rng(n + 7 * g + d + dv + chunk)
    q, k, v, cot = dot_operands(rng, (2,), g, n, d, dv)
    if swap:
        q, k, v = cot, v, k
    n_pad = -(-n // chunk) * chunk
    pad = lambda x: np.pad(x, [(0, 0)] * (x.ndim - 2)  # noqa: E731
                           + [(0, n_pad - n), (0, 0)])
    want = j_chunk_call(*(jnp.asarray(pad(x)) for x in (q, k, v)),
                        chunk=chunk, interpret=True)
    got = flow_chunk_parallel(t(q), t(k), t(v), chunk)
    assert got.shape == q.shape[:-1] + (v.shape[-1],)
    close(got, np.asarray(want)[:, :, :n], "flow_chunk_parallel")


# (chunk, G, N, D, Dv): K5b's chunk-parallel twin, N ragged against the chunk
DKV_PARALLEL_CASES = [
    (16, 1, 1, 32, 128), (16, 2, 130, 64, 32), (16, 3, 200, 64, 64),
    (16, 1, 512, 128, 128), (32, 1, 512, 64, 64), (32, 2, 1, 128, 128),
    (32, 3, 130, 32, 128), (32, 2, 200, 64, 32), (64, 1, 200, 128, 128),
    (64, 2, 512, 64, 32), (64, 3, 130, 64, 64), (64, 1, 512, 32, 128)]


@pytest.mark.parametrize("chunk,g,n,d,dv", DKV_PARALLEL_CASES)
def test_flow_chunk_dkv_parallel_matches_pallas(chunk, g, n, d, dv):
    """``flow_chunk_dkv_parallel`` (chunk states summed over the group, their
    exclusive suffix from the last chunk down, the transposed causal panels
    per chunk; the last chunk ragged) against the reference kernel on the
    operands zero-padded to its chunk."""
    rng = np.random.default_rng(n + 5 * g + d + dv + chunk)
    q, k, v, cot = dot_operands(rng, (2,), g, n, d, dv)
    n_pad = -(-n // chunk) * chunk
    pad = lambda x: np.pad(x, [(0, 0)] * (x.ndim - 2)  # noqa: E731
                           + [(0, n_pad - n), (0, 0)])
    want = j_dkv_call(*(jnp.asarray(pad(x)) for x in (q, k, v, cot)),
                      chunk=chunk, interpret=True)
    got = flow_chunk_dkv_parallel(t(q), t(k), t(v), t(cot), chunk)
    assert got[0].shape == k.shape and got[1].shape == v.shape
    close(got[0], np.asarray(want[0])[:, :n], "dk")
    close(got[1], np.asarray(want[1])[:, :n], "dv")


@pytest.mark.parametrize("g,n,d,dv,chunk", DOT_CASES)
def test_kernel_glue_pads_like_the_reference(g, n, d, dv, chunk):
    """(B, H, G, N, D) through ``chunked_causal_dot_cuda`` (pad to the
    chunk, flatten, ``FlowChunkDot``, slice) against
    ``chunked_causal_dot_pallas``, values and gradients."""
    rng = np.random.default_rng(7 * n + g)
    qg, k, v, cot = dot_operands(rng, (2, 2), g, n, d, dv)
    want, vjp = jax.vjp(lambda *a: chunked_causal_dot_pallas(
        *a, chunk=chunk, interpret=True), *map(jnp.asarray, (qg, k, v)))
    leaves = [t(x).requires_grad_(True) for x in (qg, k, v)]
    got = chunked_causal_dot_cuda(*leaves, chunk=chunk)
    close(got.detach(), want, "out")
    grads = torch.autograd.grad(got, leaves, t(cot))
    for name, a, b_ in zip("qkv", grads, vjp(jnp.asarray(cot))):
        close(a, b_, f"d{name}")


@pytest.mark.parametrize("g,n,d,dv,chunk", DOT_CASES)
def test_flow_chunk_dot_grads_match_jax_vjp(g, n, d, dv, chunk):
    rng = np.random.default_rng(3 * n + g + dv)
    n_pad = -(-n // chunk) * chunk
    q, k, v, cot = dot_operands(rng, (2,), g, n_pad, d, dv)
    want, vjp = jax.vjp(lambda *a: flow_chunk_dot(*a, chunk, True),
                        *map(jnp.asarray, (q, k, v)))
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = FlowChunkDot.apply(*leaves)
    close(out.detach(), want, "out")
    grads = torch.autograd.grad(out, leaves, t(cot))
    for name, a, b_ in zip("qkv", grads, vjp(jnp.asarray(cot))):
        close(a, b_, f"d{name}")


@pytest.mark.parametrize("n,chunk", [(32, 8), (20, 8), (16, 16)])
def test_causal_dots_match_reference(n, chunk):
    rng = np.random.default_rng(n + chunk)
    qg, k, v, _ = dot_operands(rng, (2, 3), 2, n, 8, 4)
    q = qg[:, :, 0]
    close(causal_dot(t(q), t(k), t(v), chunk),
          j_causal_dot(*map(jnp.asarray, (q, k, v)), chunk), "causal_dot")
    want = j_causal_dot_grouped(*map(jnp.asarray, (qg, k, v)), chunk,
                                use_pallas=False)
    for use_kernel in (None, False):  # CPU tensors: the plain versions
        close(causal_dot_grouped(t(qg), t(k), t(v), chunk,
                                 use_kernel=use_kernel), want,
              f"causal_dot_grouped use_kernel={use_kernel}")


def j_cfg(cfg: FlowConfig) -> JFlowConfig:
    return JFlowConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(JFlowConfig)
                          if f.name != "backend"})


def j_dot(kind, chunk):
    if kind == "cumsum":
        return lambda *a: j_causal_dot_grouped(*a, chunk_size=0,
                                               use_pallas=False)
    return lambda *a: j_causal_dot_grouped(*a, chunk_size=chunk,
                                           use_pallas=False)


def port_dots(chunk):
    return {"cumsum": lambda *a: causal_dot_grouped(*a, chunk_size=0,
                                                    use_kernel=False),
            "chunked": lambda *a: chunked_causal_dot_grouped(*a, chunk),
            "kernel glue": lambda *a: chunked_causal_dot_cuda(*a,
                                                              chunk=chunk)}


MODES = {"paper": dict(strict_causal=False),
         "strict": dict(strict_causal=True),
         "no_comp": dict(strict_causal=False, use_competition=False)}


# (mode, phi, use_alloc, gqa, hq/hkv)
PIPE_CASES = [
    ("paper", "sigmoid", True, "shared", (4, 2)),
    ("paper", "elu1", False, "expand", (4, 2)),
    ("paper", "relu", True, "shared", (2, 2)),
    ("strict", "sigmoid", False, "shared", (4, 2)),
    ("strict", "elu1", True, "expand", (4, 2)),
    ("strict", "relu", True, "shared", (2, 2)),
    ("no_comp", "sigmoid", True, "shared", (4, 2)),
    ("no_comp", "elu1", False, "shared", (2, 2)),
    ("no_comp", "relu", True, "expand", (4, 2)),
]


@pytest.mark.parametrize("mode,phi,alloc,gqa,heads", PIPE_CASES)
def test_causal_forward_matches_reference(mode, phi, alloc, gqa, heads):
    rng = np.random.default_rng(len(mode) + len(phi) + heads[0])
    hq, hkv = heads
    n, d, dv, chunk = 32, 8, 8, 8
    cfg = FlowConfig(causal=True, phi=phi, use_allocation=alloc,
                     gqa_mode=gqa, chunk_size=chunk, **MODES[mode])
    q, k, v = (randn(rng, 2, hq, n, d), randn(rng, 2, hkv, n, d),
               randn(rng, 2, hkv, n, dv))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = j_pipeline.causal_forward(jq, jk, jv, j_cfg(cfg),
                                     j_dot("chunked", chunk))
    close(j_pipeline.causal_forward(jq, jk, jv, j_cfg(cfg),
                                    j_dot("cumsum", chunk)), want,
          "reference cumsum vs chunked")
    for name, dot in port_dots(chunk).items():
        close(causal_forward(t(q), t(k), t(v), cfg, dot), want, name)
    close(flow_attention_causal_ref(t(q), t(k), t(v), cfg),
          j_causal_oracle(jq, jk, jv, j_cfg(cfg)), "quadratic oracle")
    close(flow_attention_causal_ref(t(q), t(k), t(v), cfg), want,
          "oracle vs pipeline")


@pytest.mark.parametrize("lengths", [None, (32, 1, 17)])
def test_strict_return_state_with_lengths_matches_reference(lengths):
    rng = np.random.default_rng(5)
    n, chunk = 32, 8
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=chunk)
    q, k, v = (randn(rng, 3, 4, n, 8), randn(rng, 3, 2, n, 8),
               randn(rng, 3, 2, n, 8))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want_out, want_st = j_pipeline.causal_forward(
        *map(jnp.asarray, (q, k, v)), j_cfg(cfg), j_dot("chunked", chunk),
        return_state=True, lengths=None if lens is None else jnp.asarray(lens))
    for name, dot in port_dots(chunk).items():
        out, st = causal_forward(t(q), t(k), t(v), cfg, dot,
                                 return_state=True,
                                 lengths=None if lens is None else t(lens))
        close(out, want_out, f"{name} out")
        assert st.t.tolist() == np.asarray(want_st.t).tolist()
        for field in ("q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s"):
            close(getattr(st, field), getattr(want_st, field),
                  f"{name} {field}")


def test_state_ops_refuse_the_paper_and_ablation_modes():
    q = torch.randn((1, 2, 16, 8))
    for mode in ("paper", "no_comp"):
        cfg = FlowConfig(causal=True, chunk_size=8, **MODES[mode])
        with pytest.raises(ValueError, match="strict_causal competition"):
            causal_forward(q, q, q, cfg, port_dots(8)["cumsum"],
                           return_state=True)
        with pytest.raises(ValueError, match="strict_causal competition"):
            flow_attention_causal(q, q, q, cfg, return_state=True)


def test_registry_entry_points_match_the_oracle():
    rng = np.random.default_rng(11)
    q, k, v = randn(rng, 2, 4, 24, 8), randn(rng, 2, 2, 24, 8), randn(rng, 2, 2, 24, 8)
    for mode in MODES:
        cfg = FlowConfig(causal=True, chunk_size=8, **MODES[mode])
        want = flow_attention_causal_ref(t(q), t(k), t(v), cfg)
        close(flow_attention_causal(t(q), t(k), t(v),
                                    dataclasses.replace(cfg, causal=False)),
              want, f"flow_attention_causal {mode}")
        close(flow_attention(t(q), t(k), t(v), cfg), want,
              f"flow_attention {mode}")


def shapes(n):
    return ShapeInfo(b=16, hq=8, hkv=8, n=n, m=n, d=64, dv=64)


@pytest.mark.parametrize("mode", ["paper", "no_comp"])
@pytest.mark.parametrize("n,want", [(512, "chunked"), (200, "cumsum"),
                                    (128, "cumsum")])
def test_cpu_auto_resolves_chunked_or_cumsum(mode, n, want):
    plan = ExecutionPlan(flow=FlowConfig(causal=True, **MODES[mode]))
    assert attention.resolve(plan).backend("forward", shapes(n),
                                           "cpu").name == want
    assert attention.resolve_for_training(plan, shapes(n), "cpu").name == want


@pytest.mark.parametrize("mode", ["paper", "no_comp"])
@pytest.mark.parametrize("n", [512, 200])
def test_cuda_resolves_the_chunk_kernel_and_plain_refuses(mode, n):
    cfg = FlowConfig(causal=True, **MODES[mode])
    plan = ExecutionPlan(flow=cfg)
    assert attention.resolve_for_training(plan, shapes(n),
                                          "cuda").name == "cuda_chunk"
    why = dict((name, reason) for name, ok, reason in
               attention.explain(plan, shapes(n), platform="cuda",
                                 op="forward").sections[0][1])
    assert why["cuda_fused"].startswith("implements the strict-causal")
    assert "pinned" in why["cumsum"]
    assert why["fused_causal"].startswith("implements the strict-causal")
    pinned = {"plain": "chunked" if n == 512 else "cumsum",
              "cumsum": "cumsum"}
    for pin, name in pinned.items():
        ex = attention.resolve(ExecutionPlan(flow=dataclasses.replace(
            cfg, backend=pin)))
        assert ex.backend("forward", shapes(n), "cuda").name == name


def test_cuda_chunk_refuses_what_the_kernel_does_not_take():
    cfg = FlowConfig(causal=True, strict_causal=False)
    bad = dataclasses.replace(shapes(512), d=96)
    with pytest.raises(attention.ResolutionError,
                       match="kernel takes D and Dv in") as err:
        attention.resolve(ExecutionPlan(flow=cfg)).backend("forward", bad,
                                                           "cuda")
    assert "pinned" in dict(err.value.rejections)["chunked"]
    odd = dataclasses.replace(shapes(512), d=32, dv=128)
    assert attention.resolve(ExecutionPlan(flow=cfg)).backend(
        "forward", odd, "cuda").name == "cuda_chunk"


@pytest.mark.parametrize("mode", ["paper", "no_comp"])
def test_state_ops_still_need_strict_competition(mode):
    cfg = FlowConfig(causal=True, **MODES[mode])
    for name in ("cuda_chunk", "chunked", "cumsum"):
        be = attention.registry._REGISTRY[name]
        ok, why = be.supports(cfg, shapes(512), "cuda", op="prefill_packed")
        assert not ok and why == ("recurrent state requires strict_causal "
                                  "competition")
    # the plan runs its state ops strict, as the reference's does: packed
    # prefill then resolves as for the strict config, unless competition
    # is off
    ex = attention.resolve(ExecutionPlan(flow=cfg, packed=True))
    if mode == "paper":
        assert ex.backend("prefill_packed", shapes(512),
                          "cuda").name == "cuda_fused"
    else:
        with pytest.raises(attention.ResolutionError, match="competition"):
            ex.backend("prefill_packed", shapes(512), "cuda")
