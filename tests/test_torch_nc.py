"""Port vs reference: non-causal Flow-Attention and the flow_nc kernels.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode, or its XLA pipeline) and through the port's plain
versions on the CPU:

* ``flow_nc_fused_ref`` (K6) against ``flow_nc_fused_call``, with
  competition on and off, and against the plain ``nc`` path;
* ``flow_nc_fused_parallel`` (K6 as the CUDA kernel splits it over a
  cluster of 1-16 blocks) against ``flow_nc_fused_call`` at 1e-5;
* ``flow_nc_qside_ref`` (K7a) against ``flow_nc_qside_call``;
* ``flow_nc_qside_bwd_ref`` (K7b, written out by hand) against
  ``flow_nc_qside_bwd_call`` and against autograd of K7a's plain version;
* ``flow_nc_qside_bwd_parallel`` (K7b as the CUDA kernel splits the rows:
  per-block partials summed in block order) against
  ``flow_nc_qside_bwd_call`` at N = 1, 200 and 4,096, the last block
  ragged;
* ``FlowNCFused`` gradients against ``jax.vjp`` of the reference's
  ``flow_nc_fused`` custom VJP, and its backward (K7b on the key side,
  no K7a) against autograd through ``_nc_decomposed`` within 1e-6 of each
  gradient's largest entry, fp32 and bf16;
* G = 2 grouping against ``flow_attention_nc_pallas``;
* every phi and both ablations through the plain ``nc`` backend (and the
  quadratic oracle) against ``repro.attention.pipeline.nc_forward``;
* at every head dim of ``NC_HEAD_DIMS`` (the vision and time-series
  encoders' 6-48 beside 32, 64 and 128): K6's plain version and its
  cluster decomposition against ``repro.core.flow_attention.
  flow_attention_nc``, K7a's against the reference's ``flow_nc_qside_ref``
  and K7b's plain version and decomposition against ``jax.vjp`` of it.

Tolerance: rtol 1e-4, atol 1e-5 (those of ``tests/test_kernels.py``):
both sides sum the same fp32 terms in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.attention import pipeline as j_pipeline  # noqa: E402
from repro.attention.vjp import flow_nc_fused as j_flow_nc_fused  # noqa: E402
from repro.core.flow_attention import FlowConfig as JFlowConfig  # noqa: E402
from repro.core.flow_attention import flow_attention_nc as j_flow_nc  # noqa: E402
from repro.kernels.flow_nc.ref import flow_nc_qside_ref as j_qside_ref  # noqa: E402
from repro.core.reference import flow_attention_nc_ref as j_nc_oracle  # noqa: E402
from repro.kernels.flow_nc import flow_attention_nc_pallas  # noqa: E402
from repro.kernels.flow_nc.bwd import flow_nc_qside_bwd_call as j_qside_bwd  # noqa: E402
from repro.kernels.flow_nc.flow_nc import flow_nc_qside_call as j_qside  # noqa: E402
from repro.kernels.flow_nc.fused import flow_nc_fused_call as j_fused  # noqa: E402
from repro_torch.attention.pipeline import nc_forward  # noqa: E402
from repro_torch.attention import vjp  # noqa: E402
from repro_torch.attention.vjp import FlowNCFused, _nc_decomposed  # noqa: E402
from repro_torch.core.flow_attention import FlowConfig, flow_attention_nc  # noqa: E402
from repro_torch.core.reference import flow_attention_nc_ref  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels._lib import NC_HEAD_DIMS  # noqa: E402
from repro_torch.kernels.flow_nc import (flow_attention_nc as kernel_nc,  # noqa: E402
                                         flow_nc_fused_call,
                                         flow_nc_fused_parallel,
                                         flow_nc_fused_ref,
                                         flow_nc_qside_bwd_call,
                                         flow_nc_qside_bwd_parallel,
                                         flow_nc_qside_bwd_ref,
                                         flow_nc_qside_call,
                                         flow_nc_qside_ref)

TOL = dict(rtol=1e-4, atol=1e-5)
EPS = 1e-6


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def key_side(rng, bh, n, m, d):
    """q and realistic key-side reductions (k_sum, ko_sum, kv) as numpy."""
    q, k, v = randn(rng, bh, n, d), randn(rng, bh, m, d), randn(rng, bh, m, d)
    pk, pq = 1 / (1 + np.exp(-k)), 1 / (1 + np.exp(-q))
    k_sum = pk.sum(1)
    src_out = 1 / np.einsum("bmd,bd->bm", pk + EPS, pq.sum(1) + EPS)
    ko_sum = (pk * src_out[..., None]).sum(1)
    kv = np.einsum("bmd,bme->bde", pk, v)
    return [x.astype(np.float32) for x in (q, k_sum, ko_sum, kv)]


T = torch.from_numpy


@pytest.mark.parametrize("use_comp", [True, False])
@pytest.mark.parametrize("nq,m", [(96, 96), (200, 136)])
def test_flow_nc_fused_ref_matches_pallas_and_plain_path(use_comp, nq, m):
    rng = np.random.default_rng(nq + m + use_comp)
    q, k, v = randn(rng, 3, nq, 16), randn(rng, 3, m, 16), randn(rng, 3, m, 16)
    want = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), eps=EPS,
                   use_comp=use_comp, interpret=True)
    before = dict(LAUNCHES)
    got = flow_nc_fused_call(T(q), T(k), T(v), eps=EPS, use_comp=use_comp)
    assert LAUNCHES == before, "the CPU path must not count a launch"
    close(got, want)
    close(flow_nc_fused_ref(T(q), T(k), T(v), use_comp=use_comp), want)
    plain = nc_forward(T(q)[:, None], T(k)[:, None], T(v)[:, None],
                       FlowConfig(use_competition=use_comp))[:, 0]
    close(got, plain)


@pytest.mark.parametrize("cb", [1, 3, 8, 16])
@pytest.mark.parametrize("nq,m,logit", [(256, 256, 1.0), (400, 136, 1.0),
                                        (1, 1, 1.0), (256, 256, 30.0)])
@pytest.mark.parametrize("use_comp", [True, False])
def test_flow_nc_fused_parallel_matches_pallas(cb, nq, m, logit, use_comp):
    """K6's cluster decomposition: per-block partials of every phase summed
    in rank order, blocks that own no rows (M = 136 or N = 1 at CB = 16)
    included; NQ = 400 against M = 136 is G = 2 over N = 200; logit 30
    puts q and k at +-30, where sigmoid saturates."""
    rng = np.random.default_rng(nq + m + cb + int(logit) + use_comp)
    q, k, v = randn(rng, 2, nq, 16), randn(rng, 2, m, 16), randn(rng, 2, m, 16)
    if logit != 1.0:
        q, k = logit * np.sign(q), logit * np.sign(k)
    want = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), eps=EPS,
                   use_comp=use_comp, interpret=True)
    got = flow_nc_fused_parallel(T(q), T(k), T(v), cb=cb, eps=EPS,
                                 use_comp=use_comp)
    assert got.shape == (2, nq, 16) and torch.isfinite(got).all()
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m", [(96, 96), (200, 136)])
def test_flow_nc_qside_ref_matches_pallas(n, m):
    q, k_sum, ko_sum, kv = key_side(np.random.default_rng(n), 3, n, m, 16)
    want = j_qside(*map(jnp.asarray, (q, k_sum, ko_sum, kv)), n_sinks=n,
                   m_sources=m, interpret=True)
    got = flow_nc_qside_call(T(q), T(k_sum), T(ko_sum), T(kv), n_sinks=n,
                             m_sources=m)
    close(got, want)
    close(flow_nc_qside_ref(T(q), T(k_sum), T(ko_sum), T(kv), n_sinks=n,
                            m_sources=m), want)


@pytest.mark.parametrize("against", ["pallas", "autograd"])
@pytest.mark.parametrize("n,m", [(96, 96), (200, 136)])
def test_flow_nc_qside_bwd_ref_matches(against, n, m):
    rng = np.random.default_rng(n + 7)
    q, k_sum, ko_sum, kv = key_side(rng, 3, n, m, 16)
    g = randn(rng, 3, n, 16)
    got = flow_nc_qside_bwd_call(T(q), T(k_sum), T(ko_sum), T(kv), T(g),
                                 n_sinks=n, m_sources=m)
    if against == "pallas":
        want = j_qside_bwd(*map(jnp.asarray, (q, k_sum, ko_sum, kv, g)),
                           n_sinks=n, m_sources=m, interpret=True)
    else:
        leaves = [T(x).requires_grad_(True) for x in (q, k_sum, ko_sum, kv)]
        out = flow_nc_qside_ref(*leaves, n_sinks=n, m_sources=m)
        want = torch.autograd.grad(out, leaves, T(g))
    for a, b in zip(got, want):
        close(a, b.detach() if isinstance(b, torch.Tensor) else b)
    np.testing.assert_array_equal(
        got[0], flow_nc_qside_bwd_ref(T(q), T(k_sum), T(ko_sum), T(kv), T(g),
                                      n_sinks=n, m_sources=m)[0])


# (N, D, rows per block): one block, several, the last one ragged; N = 1
QSIDE_BWD_SPLITS = [(1, 16, 64), (200, 16, 64), (200, 32, 128),
                    (200, 64, 192), (4096, 64, 1408), (4096, 32, 4096)]


@pytest.mark.parametrize("n,d,rows", QSIDE_BWD_SPLITS)
def test_flow_nc_qside_bwd_parallel_matches_pallas(n, d, rows):
    """K7b's decomposition: each block of ``rows`` rows forms its partial
    dk_sum, dko_sum and dkv, and the totals add the partials in block
    order; dq per row."""
    rng = np.random.default_rng(n + d + rows)
    q, k_sum, ko_sum, kv = key_side(rng, 2, n, 136, d)
    g = randn(rng, 2, n, d)
    want = j_qside_bwd(*map(jnp.asarray, (q, k_sum, ko_sum, kv, g)),
                       n_sinks=n, m_sources=136, interpret=True)
    got = flow_nc_qside_bwd_parallel(T(q), T(k_sum), T(ko_sum), T(kv), T(g),
                                     n_sinks=n, m_sources=136, rows=rows)
    assert got[0].shape == (2, n, d) and got[3].shape == (2, d, d)
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("use_comp", [True, False])
def test_flow_nc_fused_grads_match_jax_vjp(use_comp):
    rng = np.random.default_rng(11 + use_comp)
    q, k, v, g = (randn(rng, 3, 96, 16) for _ in range(4))
    out, pull = jax.vjp(lambda q, k, v: j_flow_nc_fused(
        q, k, v, EPS, 256, use_comp, True), *map(jnp.asarray, (q, k, v)))
    leaves = [T(x).requires_grad_(True) for x in (q, k, v)]
    got = FlowNCFused.apply(*leaves, EPS, use_comp)
    close(got.detach(), out)
    grads = torch.autograd.grad(got, leaves, T(g))
    for a, b in zip(grads, pull(jnp.asarray(g))):
        close(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_comp", [True, False])
def test_flow_nc_fused_backward_is_the_decomposition_gradient(
        dtype, use_comp, monkeypatch):
    """``FlowNCFused.backward`` (K7b on ``nc_key_side``'s reductions, their
    cotangents pulled back by autograd) against autograd through
    ``_nc_decomposed`` (which runs K7a's ``FlowNCQside`` forward): dq, dk
    and dv in the inputs' dtype, within 1e-6 of each one's largest entry;
    and the backward never runs the sink side's forward."""
    rng = np.random.default_rng(21 + use_comp)
    q, k, v, g = (T(randn(rng, 3, 96, 16)).to(dtype) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = FlowNCFused.apply(*leaves, EPS, use_comp)
    calls = []
    monkeypatch.setattr(vjp, "flow_nc_qside_call",
                        lambda *a, **kw: calls.append(1))
    got = torch.autograd.grad(out, leaves, g)
    assert not calls, "FlowNCFused.backward ran the sink side's forward"
    monkeypatch.undo()
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(_nc_decomposed(*ref, EPS, use_comp), ref, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        scale = float(b.float().abs().max())
        assert scale > 0
        assert float((a.float() - b.float()).abs().max()) <= 1e-6 * scale


def test_grouped_g2_matches_pallas_wrapper():
    rng = np.random.default_rng(5)
    q, k, v = randn(rng, 2, 4, 50, 16), randn(rng, 2, 2, 70, 16), \
        randn(rng, 2, 2, 70, 16)
    want = flow_attention_nc_pallas(*map(jnp.asarray, (q, k, v)),
                                    JFlowConfig(), interpret=True)
    leaves = [T(x).requires_grad_(True) for x in (q, k, v)]
    got = kernel_nc(*leaves, FlowConfig())
    close(got.detach(), want)
    close(got.detach(), nc_forward(T(q), T(k), T(v), FlowConfig()))
    # grads through FlowNCFused (K7a/K7b plain versions) vs the plain path
    got_g = torch.autograd.grad(got.sum(), leaves)
    plain = [T(x).requires_grad_(True) for x in (q, k, v)]
    want_g = torch.autograd.grad(nc_forward(*plain, FlowConfig()).sum(), plain)
    for a, b in zip(got_g, want_g):
        close(a, b)


CASES = [("sigmoid", True, True, "shared"), ("elu1", True, True, "shared"),
         ("relu", True, True, "shared"), ("sigmoid", False, True, "shared"),
         ("sigmoid", True, False, "shared"), ("elu1", False, True, "expand"),
         ("relu", True, False, "expand")]


@pytest.mark.parametrize("phi,comp,alloc,gqa", CASES)
def test_plain_nc_backend_matches_reference(phi, comp, alloc, gqa):
    rng = np.random.default_rng(len(phi) + 2 * comp + alloc)
    q, k, v = randn(rng, 2, 4, 40, 16), randn(rng, 2, 2, 56, 16), \
        randn(rng, 2, 2, 56, 16)
    kw = dict(phi=phi, use_competition=comp, use_allocation=alloc,
              gqa_mode=gqa)
    want = j_pipeline.nc_forward(*map(jnp.asarray, (q, k, v)),
                                 JFlowConfig(**kw))
    cfg = FlowConfig(**kw)
    close(flow_attention_nc(T(q), T(k), T(v), cfg), want)  # auto -> nc
    close(flow_attention_nc_ref(T(q), T(k), T(v), cfg),
          j_nc_oracle(*map(jnp.asarray, (q, k, v)), JFlowConfig(**kw)))
    close(flow_attention_nc_ref(T(q), T(k), T(v), cfg), want)


def test_plain_nc_grads_match_jax():
    rng = np.random.default_rng(3)
    q, k, v, g = (randn(rng, 2, 2, 48, 16) for _ in range(4))
    _, pull = jax.vjp(lambda q, k, v: j_pipeline.nc_forward(
        q, k, v, JFlowConfig()), *map(jnp.asarray, (q, k, v)))
    leaves = [T(x).requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(nc_forward(*leaves, FlowConfig()), leaves,
                                T(g))
    for a, b in zip(grads, pull(jnp.asarray(g))):
        close(a, b)


# ---------------------------------------------------------------------------
# Every head dim the non-causal kernels take
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", NC_HEAD_DIMS)
def test_nc_fused_plain_and_twin_match_reference_at_every_head_dim(d):
    """K6's plain version and its cluster decomposition (16 blocks, the
    wrapper's, and 3) against the reference's registry-routed non-causal
    attention, NQ = 200 sinks over M = 136 sources."""
    rng = np.random.default_rng(100 + d)
    q, k, v = randn(rng, 2, 200, d), randn(rng, 2, 136, d), randn(rng, 2, 136, d)
    want = np.asarray(j_flow_nc(*(jnp.asarray(x)[:, None] for x in (q, k, v)),
                                JFlowConfig()))[:, 0]
    close(flow_nc_fused_ref(T(q), T(k), T(v)), want)
    for cb in (16, 3):
        close(flow_nc_fused_parallel(T(q), T(k), T(v), cb=cb), want)


@pytest.mark.parametrize("d", NC_HEAD_DIMS)
def test_nc_qside_plain_versions_match_reference_at_every_head_dim(d):
    """K7a's plain version against the reference's ``flow_nc_qside_ref``,
    and K7b's (written out) and its block decomposition (rows of 128, the
    small-head kernel's tile at D = 48, over N = 300: three blocks, the
    last ragged) against ``jax.vjp`` of it."""
    rng = np.random.default_rng(200 + d)
    q, k_sum, ko_sum, kv = key_side(rng, 2, 300, 136, d)
    g = randn(rng, 2, 300, d)
    kw = dict(n_sinks=300, m_sources=136)
    out, pull = jax.vjp(lambda *xs: j_qside_ref(*xs, **kw),
                        *map(jnp.asarray, (q, k_sum, ko_sum, kv)))
    close(flow_nc_qside_ref(T(q), T(k_sum), T(ko_sum), T(kv), **kw), out)
    want = pull(jnp.asarray(g))
    args = (T(q), T(k_sum), T(ko_sum), T(kv), T(g))
    for got in (flow_nc_qside_bwd_ref(*args, **kw),
                flow_nc_qside_bwd_parallel(*args, rows=128, **kw)):
        assert got[0].shape == (2, 300, d) and got[3].shape == (2, d, d)
        for a, b in zip(got, want):
            close(a, b)
