"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a GPU every
test here skips with that reason.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: |kernel - plain| <= 1e-4 + 1e-4 |plain| in fp32 (the same fp32
terms summed in another order; no TF32 on either side but in K6's and
the products of K5a, K5b, K6 and K7b, which run in 3xTF32 (each operand
split into a tf32 head and rest, three tensor-core products) and are held
to the same tolerances), 1e-2 + 1e-2 |plain| in bf16 (both
round once from fp32); training losses rtol 1e-4 and
attention gradients within 1e-4 of each leaf's max |grad|.  The causal
dot (K5a, K5b) is held to 1e-4 + 1e-4 |plain| + 1e-4 max |plain|: it sums
N D terms whose size is that of its largest outputs, so an output that
cancels keeps an error of the terms' size.  The int8 decode (K4): outputs
as K3's, z rtol 1e-5 atol 1e-5, t exact, scales rtol 1e-5, payloads
within one LSB with at most a share of 1e-3 differing (the amax is exact,
the values are summed in another order, so a value within ~1e-5 of a
half-integer may round the other way).  The SSD chunk scan and its
backward (K10a, K10b), fp32: 1e-4 + 1e-4 |plain| + 1e-4 max |plain|, as
the causal dot (a chunk sums C S products as large as its outputs); the
boundary gather (K9) and the page-table gathers (K8a, K8b): exact (a
copy, and one fp32 product rounded once).
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import attention  # noqa: E402
from repro_torch.attention._cuda import chunked_causal_dot_cuda  # noqa: E402
from repro_torch.attention.dots import causal_dot_grouped  # noqa: E402
from repro_torch.attention.fused import fused_causal_forward  # noqa: E402
from repro_torch.attention.recurrent import FlowState, decode_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.flow_attention import FlowConfig  # noqa: E402
from repro_torch.kernels import (LAUNCHES, PAIR_LAUNCHES,  # noqa: E402
                                 reset_launches)
from repro_torch.kernels._lib import KERNELS  # noqa: E402
from repro_torch.kernels.flow_chunk import (flow_chunk_call,  # noqa: E402
                                            flow_chunk_dkv_call,
                                            flow_chunk_dkv_parallel,
                                            flow_chunk_dkv_ref,
                                            flow_chunk_parallel, flow_chunk_ref)
from repro_torch.kernels.flow_decode import (flow_decode_call,  # noqa: E402
                                             flow_decode_q_call,
                                             flow_decode_q_step,
                                             flow_decode_split,
                                             flow_decode_step)
from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,  # noqa: E402
                                            flow_fused_bwd_ref,
                                            flow_fused_call,
                                            flow_fused_forward,
                                            flow_fused_ref)
from repro_torch.kernels.flow_nc import (flow_nc_fused_call,  # noqa: E402
                                         flow_nc_fused_parallel,
                                         flow_nc_fused_ref,
                                         flow_nc_qside_bwd_call,
                                         flow_nc_qside_bwd_parallel,
                                         flow_nc_qside_bwd_ref,
                                         flow_nc_qside_call, flow_nc_qside_ref)
from repro_torch.attention.vjp import FlowNCQside, nc_key_side  # noqa: E402
from repro_torch.data.loader import lm_loader  # noqa: E402
from repro_torch.launch.classify import listops_data, train_eval_classifier  # noqa: E402
from repro_torch.models import classifier, vision  # noqa: E402
from repro_torch.data.synthetic import pixel_images  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.layers.attention import executor_of, plan_of  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.quant import (dequantize_state,  # noqa: E402
                                       quantize_like, quantize_state, spec_of)

from repro_torch.kernels.flow_nc.ops import (CLUSTER_BLOCKS,  # noqa: E402
                                            bwd_rows, cluster_blocks)
from repro_torch.kernels.gather import (boundary_gather,  # noqa: E402
                                        boundary_gather_many,
                                        boundary_gather_many_ref,
                                        boundary_gather_ref)
from repro_torch.kernels.gather import (paged_gather,  # noqa: E402
                                        paged_gather_quant,
                                        paged_gather_quant_ref,
                                        paged_gather_ref)
from repro_torch.layers import attention as attn_layer  # noqa: E402
from repro_torch.serving.paged import PagedSpec  # noqa: E402
from repro_torch.kernels.ssd_chunk import (SSDChunkDot,  # noqa: E402
                                           ssd_chunk_bwd_call,
                                           ssd_chunk_call, ssd_chunk_chunked)
from repro_torch.layers import ssd as ssd_layer  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)
K7B_TWIN_RTOL = 6e-6  # chip_smoke.K7B_TWIN_RTOL


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("phi,g,n,chunk,d", [
    ("sigmoid", 1, 37, 8, 32), ("elu1", 2, 100, 64, 64),
    ("relu", 1, 300, 128, 128), ("sigmoid", 4, 16, 16, 64)])
def test_flow_fused_kernel_matches_plain(gen, phi, g, n, chunk, d):
    b, hkv = 3, 2
    q = torch.randn((b, hkv * g, n, d), generator=gen, device="cuda")
    k = torch.randn((b, hkv, n, d), generator=gen, device="cuda")
    v = torch.randn((b, hkv, n, d), generator=gen, device="cuda")
    lengths = torch.tensor([n, 1, max(1, n // 3)], dtype=torch.int32,
                           device="cuda")
    cfg = FlowConfig(phi=phi, causal=True, strict_causal=True,
                     chunk_size=chunk)
    reset_launches()
    out, st = flow_fused_forward(q, k, v, cfg, return_state=True,
                                 lengths=lengths)
    assert LAUNCHES["flow_fused"] == 1
    ref, ref_st = fused_causal_forward(q, k, v, cfg, return_state=True,
                                       lengths=lengths)
    torch.testing.assert_close(out, ref, **TOL)
    for a, b_ in zip(st, ref_st):
        torch.testing.assert_close(a, b_, **TOL)


def decode_pool(gen, slots, hkv, d):
    """A non-zero FlowState pool of at most 5 slots."""
    return FlowState(
        t=torch.tensor([3, 40, 7, 1, 99][:slots], dtype=torch.int32,
                       device="cuda"),
        q_sum=torch.rand((slots, hkv, d), generator=gen, device="cuda") * 9,
        k_sum=torch.rand((slots, hkv, d), generator=gen, device="cuda") * 9,
        ko_sum=torch.rand((slots, hkv, d), generator=gen, device="cuda") * 9,
        qi_sum=torch.rand((slots, hkv, d), generator=gen, device="cuda") * 9,
        z=torch.rand((slots, hkv), generator=gen, device="cuda") * 9 + 1,
        s=torch.randn((slots, hkv, d, d), generator=gen, device="cuda"))


def flat_state(pool):
    """The pool's state tensors as flow_decode_call's flat views."""
    bh = pool.s.shape[0] * pool.s.shape[1]
    return [x.view((bh,) + x.shape[2:]) for x in
            (pool.k_sum, pool.q_sum, pool.ko_sum, pool.qi_sum, pool.z,
             pool.s)]


@pytest.mark.parametrize("phi,g,d", [("sigmoid", 1, 64), ("elu1", 2, 32),
                                     ("relu", 1, 128)])
def test_flow_decode_kernel_matches_plain_in_place(gen, phi, g, d):
    slots, hkv = 5, 2
    cfg = FlowConfig(phi=phi, causal=True, strict_causal=True)
    pool = decode_pool(gen, slots, hkv, d)
    plain = FlowState(*(x.clone() for x in pool))
    ptrs = [x.data_ptr() for x in pool]
    reset_launches()
    for _ in range(4):
        q = torch.randn((slots, hkv * g, 1, d), generator=gen, device="cuda")
        k = torch.randn((slots, hkv, 1, d), generator=gen, device="cuda")
        v = torch.randn((slots, hkv, 1, d), generator=gen, device="cuda")
        same, out = flow_decode_step(pool, q, k, v, cfg)
        plain, ref = decode_step(plain, q, k, v, cfg)
        assert all(a is b_ for a, b_ in zip(same, pool))
        torch.testing.assert_close(out, ref, **TOL)
    assert LAUNCHES["flow_decode"] == 4
    assert [x.data_ptr() for x in pool] == ptrs
    for a, b_ in zip(pool, plain):
        torch.testing.assert_close(a, b_, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("phi,g,d,use_alloc", [
    ("sigmoid", 1, 64, True), ("elu1", 2, 32, True), ("relu", 1, 128, False),
    ("sigmoid", 3, 128, True)])
def test_flow_decode_kernel_matches_its_split_order(gen, phi, g, d,
                                                    use_alloc, dtype):
    """Four steps; at each ``flow_decode_split`` (the kernel's own fp32
    order) starts from a copy of the kernel's pre-step pool."""
    slots, hkv = 5, 2
    bh = slots * hkv
    pool = decode_pool(gen, slots, hkv, d)
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for _ in range(4):
        q = torch.randn((bh, g, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((bh, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((bh, d), generator=gen, device="cuda").to(dtype)
        before = [x.clone() for x in flat_state(pool)]
        pool.t.add_(1)
        want, want_st = flow_decode_split(pool.t, q, k, v, *before, hkv=hkv,
                                          phi=phi, use_alloc=use_alloc)
        out = flow_decode_call(pool.t, q, k, v, *flat_state(pool), hkv=hkv,
                               phi=phi, use_alloc=use_alloc)
        assert out.dtype == dtype
        torch.testing.assert_close(out, want, **tol)
        for a, b_ in zip(flat_state(pool), want_st):
            torch.testing.assert_close(a, b_, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 32), (1, 128)])
def test_flow_decode_kernel_is_deterministic(gen, g, d, dtype):
    """Two steps from clones of one pool: out and every state tensor
    bitwise equal."""
    slots, hkv = 5, 2
    cfg = FlowConfig(causal=True, strict_causal=True)
    pool = decode_pool(gen, slots, hkv, d)
    q = torch.randn((slots, hkv * g, 1, d), generator=gen,
                    device="cuda").to(dtype)
    k = torch.randn((slots, hkv, 1, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((slots, hkv, 1, d), generator=gen, device="cuda").to(dtype)
    runs = [flow_decode_step(FlowState(*(x.clone() for x in pool)), q, k, v,
                             cfg) for _ in range(2)]
    (a, out_a), (b, out_b) = runs
    assert torch.equal(out_a, out_b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_decode_wrapper_refuses_a_copy_of_the_pool(gen):
    bh, d = 4, 64
    state = [torch.zeros((bh, d), device="cuda") for _ in range(4)]
    z = torch.zeros((bh,), device="cuda")
    s = torch.zeros((d, bh, d), device="cuda").transpose(0, 1)  # not contiguous
    q = torch.randn((bh, 1, d), generator=gen, device="cuda")
    t = torch.ones((bh,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flow_decode_call(t, q, q[:, 0], q[:, 0], *state, z, s, hkv=1)


@pytest.mark.parametrize("d,dv", [(96, 96), (64, 48)])
def test_auto_raises_on_a_head_dim_no_kernel_takes(gen, d, dv):
    ex = attention.resolve(attention.ExecutionPlan(flow=FlowConfig()))
    q = torch.randn((2, 2, 16, d), generator=gen, device="cuda")
    v = torch.randn((2, 2, 16, dv), generator=gen, device="cuda")
    reset_launches()
    with pytest.raises(attention.ResolutionError, match="kernel takes"):
        ex.prefill(q, q, v, lengths=torch.tensor([16, 3], device="cuda"))
    pool = attention.init_state(2, 2, d, dv, device="cuda")
    with pytest.raises(attention.ResolutionError, match="kernel takes"):
        ex.decode_step(pool, q[:, :, :1], q[:, :, :1], v[:, :, :1])
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


def test_engine_kernels_match_plain_greedy(gen):
    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 17, 9, 64)]
    runs = {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        engine = Engine(params, c, slots=2, max_len=128, dtype=torch.float32)
        for uid, p in enumerate(prompts):
            engine.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        reset_launches()
        runs[backend] = {r.uid: r.generated for r in engine.run()}
        rounds, steps = (engine.worker.admission_rounds,
                         engine.worker.decode_steps)
        want = dict.fromkeys(KERNELS, 0)
        if backend == "auto":
            want.update(flow_fused=2 * rounds, flow_decode=2 * steps)
        assert LAUNCHES == want
    assert runs["auto"] == runs["plain"]


@pytest.mark.parametrize("phi,g,n,chunk,n_valid,d", [
    ("sigmoid", 1, 40, 8, 37, 32), ("elu1", 2, 128, 64, 100, 64),
    ("relu", 1, 384, 128, 300, 128), ("sigmoid", 4, 64, 16, 64, 64)])
def test_flow_fused_bwd_kernel_matches_plain(gen, phi, g, n, chunk, n_valid,
                                             d):
    bh = 6
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    q, k, v, g_out = mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, d), mk(bh, g, n, d)
    lens = torch.full((bh,), n_valid, dtype=torch.int32, device="cuda")
    _, totals = flow_fused_call(q, k, v, lens, chunk=chunk, phi=phi)
    g_sums = [mk(*x.shape) for x in totals]
    reset_launches()
    got = flow_fused_bwd_call(q, k, v, lens, totals, g_out, g_sums,
                              chunk=chunk, phi=phi)
    assert LAUNCHES["flow_fused_bwd"] == 1
    want = flow_fused_bwd_ref(q, k, v, lens, g_out, g_sums, chunk=chunk,
                              phi=phi)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **TOL)
        assert not a[..., n_valid:, :].any()


def packed_lens(rows, hkv, seed):
    """Per (row, kv head) lengths as the Engine's packed admission gives
    them (prompts of 16-384 in a 512-wide pack), with a row of 1 and a row
    of 512."""
    lens = np.random.default_rng(seed).integers(16, 385, rows)
    lens[:2] = 1, 512
    return torch.tensor(np.repeat(lens, hkv), dtype=torch.int32,
                        device="cuda")


@pytest.mark.parametrize("dtype,g", [(torch.bfloat16, 1), (torch.float32, 1),
                                     (torch.float32, 4)])
def test_flow_fused_kernels_match_plain_at_the_main_path_shape(gen, dtype, g):
    """K1 and K2 at the packed-prefill shape of the serving path (16 rows x
    8 kv heads, N = 512, D = 64), random cotangents on out and on all six
    state outputs; bf16 held to 1e-2, fp32 and every state to 1e-4."""
    bh, n, d = 16 * 8, 512, 64
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v, g_out = mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, d), mk(bh, g, n, d)
    lens = packed_lens(16, 8, g)
    reset_launches()
    with torch.no_grad():
        out, sums = flow_fused_call(q, k, v, lens, chunk=128)
        g_sums = [torch.randn(x.shape, generator=gen, device="cuda")
                  for x in sums]
        got = flow_fused_bwd_call(q, k, v, lens, sums, g_out, g_sums,
                                  chunk=128)
    assert LAUNCHES["flow_fused"] == 1 and LAUNCHES["flow_fused_bwd"] == 1
    ref, ref_sums = flow_fused_ref(q, k, v, lens, chunk=128)
    torch.testing.assert_close(out, ref, **tol)
    for a, b_ in zip(sums, ref_sums):
        torch.testing.assert_close(a, b_, **TOL)
    want = flow_fused_bwd_ref(q, k, v, lens, g_out, g_sums, chunk=128)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **tol)
    for i, li in enumerate(lens.tolist()):
        assert not out[i, :, li:].any()
        assert not any(a[i, ..., li:, :].any() for a in got)


@pytest.mark.parametrize("g,n,d,chunk", [(1, 512, 64, 128), (2, 200, 128, 8)])
def test_flow_fused_kernels_are_deterministic(gen, g, n, d, chunk):
    """Two calls on the same inputs are bitwise equal: every sum over
    positions, chunks and the group runs in a fixed order, no atomics."""
    bh = 24
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    q, k, v, g_out = mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, d), mk(bh, g, n, d)
    lens = torch.randint(1, n + 1, (bh,), generator=gen, device="cuda",
                         dtype=torch.int32)
    g_sums = None
    runs = []
    with torch.no_grad():
        for _ in range(2):
            out, sums = flow_fused_call(q, k, v, lens, chunk=chunk)
            if g_sums is None:
                g_sums = [torch.randn(x.shape, generator=gen, device="cuda")
                          for x in sums]
            runs.append((out, *sums, *flow_fused_bwd_call(
                q, k, v, lens, sums, g_out, g_sums, chunk=chunk)))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def test_flow_fused_call_refuses_autograd_outside_flow_fused_dot(gen):
    q = torch.randn((2, 1, 16, 32), generator=gen, device="cuda",
                    requires_grad=True)
    k = torch.randn((2, 16, 32), generator=gen, device="cuda")
    lens = torch.full((2,), 16, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no autograd graph"):
        flow_fused_call(q, k, k, lens, chunk=16)
    with torch.no_grad():
        flow_fused_call(q, k, k, lens, chunk=16)
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=16)
    reset_launches()
    out, _ = flow_fused_forward(q[:, None, 0], k[:, None], k[:, None], cfg)
    out.sum().backward()
    assert LAUNCHES["flow_fused"] == 1 and LAUNCHES["flow_fused_bwd"] == 1
    assert q.grad.abs().sum() > 0


def test_training_kernels_match_plain_fp32(gen):
    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             next(lm_loader(0, batch=2, seq=32, vocab=cfg.vocab_size)).items()}
    hist, grads = {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        loss, _ = lm.loss_fn(leaves, batch, c, dtype=torch.float32,
                             plan=executor_of(c, plan_of(c, needs_grad=True)))
        loss.backward()
        grads[backend] = [blk["attn"][w]["w"].grad for blk in leaves["blocks"]
                          for w in ("wq", "wk", "wv")]
        reset_launches()
        hist[backend] = train(c, steps=3, batch=2, seq=32, dtype=torch.float32,
                              params=params)["history"]
        n = cfg.n_layers * 3
        want = dict.fromkeys(KERNELS, 0)
        if backend == "auto":
            want.update(flow_fused=2 * n, flow_fused_bwd=n)
        assert LAUNCHES == want
    np.testing.assert_allclose(hist["auto"], hist["plain"], rtol=1e-4)
    for a, b_ in zip(grads["auto"], grads["plain"]):
        scale = float(b_.abs().max())
        assert scale > 0 and float(a.abs().max()) > 0
        assert float((a - b_).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype,d,bh,nq,m,comp", [
    (torch.float32, 64, 6, 200, 136, True), (torch.float32, 32, 4, 100, 70, False),
    (torch.bfloat16, 128, 3, 300, 129, True),
    (torch.float32, 64, 2, 2100, 1500, True)])  # K7b over many row splits
def test_flow_nc_kernels_match_plain(gen, dtype, d, bh, nq, m, comp):
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v, g = mk(bh, nq, d), mk(bh, m, d), mk(bh, m, d), mk(bh, nq, d)
    reset_launches()
    torch.testing.assert_close(flow_nc_fused_call(q, k, v, use_comp=comp),
                               flow_nc_fused_ref(q, k, v, use_comp=comp), **tol)
    k_sum, ko_sum, kv = nc_key_side(q, k, v, 1e-6, comp)
    kw = dict(n_sinks=nq, m_sources=m)
    torch.testing.assert_close(flow_nc_qside_call(q, k_sum, ko_sum, kv, **kw),
                               flow_nc_qside_ref(q, k_sum, ko_sum, kv, **kw),
                               **tol)
    got = flow_nc_qside_bwd_call(q, k_sum, ko_sum, kv, g, **kw)
    want = flow_nc_qside_bwd_ref(q, k_sum, ko_sum, kv, g, **kw)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **tol)
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "flow_nc_fused": 1,
                        "flow_nc_qside": 1, "flow_nc_qside_bwd": 1}


@pytest.mark.parametrize("comp", [True, False])
@pytest.mark.parametrize("dtype,bh,nq,m,logit", [
    (torch.float32, 2, 256, 256, 1.0), (torch.float32, 2, 400, 136, 1.0),
    (torch.float32, 3, 1, 1, 1.0), (torch.float32, 2, 256, 256, 30.0),
    (torch.bfloat16, 3, 400, 136, 1.0), (torch.bfloat16, 2, 4096, 4096, 1.0),
    (torch.float32, 2, 4001, 3999, 1.0)])
def test_flow_nc_fused_cluster_kernel_matches_plain_and_parallel(
        gen, dtype, bh, nq, m, logit, comp):
    """K6 against its plain version and its own decomposition (the CPU
    tests' shapes: G = 2 as NQ = 400 over M = 136, N = 1, saturated
    logits; and the LRA length, staged in shared memory in bf16 and
    streamed in fp32), and two calls bitwise equal."""
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    q, k, v = mk(bh, nq, 64), mk(bh, m, 64), mk(bh, m, 64)
    if logit != 1.0:
        q, k = logit * q.sign(), logit * k.sign()
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    reset_launches()
    got = flow_nc_fused_call(q, k, v, use_comp=comp)
    assert torch.equal(got, flow_nc_fused_call(q, k, v, use_comp=comp))
    assert LAUNCHES["flow_nc_fused"] == 2
    for want in (flow_nc_fused_ref(q, k, v, use_comp=comp),
                 flow_nc_fused_parallel(q, k, v, cb=CLUSTER_BLOCKS,
                                        use_comp=comp)):
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,bh,n,m", [(32, 4, 1000, 700), (64, 4, 4096, 4096),
                                      (64, 3, 1, 1), (128, 2, 333, 136),
                                      (64, 128, 4096, 4096)])
def test_flow_nc_qside_bwd_kernel_matches_plain_and_parallel(gen, dtype, d,
                                                             bh, n, m):
    """K7b against its plain version and its own decomposition (per-block
    partials at the card's rows per block, added in order), N ragged
    against its tile, N = 1 and the LRA shape (22 tiles a block); also
    within rtol x max |plain| (the cotangents are ~1e-3 at N = 4,096), its
    fp32 outputs within K7B_TWIN_RTOL x max |twin| of the twin (chip_smoke's
    bound: a sum left to drift in the tensor cores' accumulators read
    1.1e-5 to 1.3e-5 there and passed rtol); two calls bitwise equal."""
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v, g = mk(bh, n, d), mk(bh, m, d), mk(bh, m, d), mk(bh, n, d)
    key = nc_key_side(q, k, v, 1e-6, True)
    kw = dict(n_sinks=n, m_sources=m)
    reset_launches()
    got = flow_nc_qside_bwd_call(q, *key, g, **kw)
    assert LAUNCHES["flow_nc_qside_bwd"] == 1
    rows = bwd_rows(bh, n, d, dtype)
    twin = flow_nc_qside_bwd_parallel(q, *key, g, rows=rows, **kw)
    for want in (flow_nc_qside_bwd_ref(q, *key, g, **kw), twin):
        for a, b_ in zip(got, want):
            torch.testing.assert_close(a, b_, rtol=rtol, atol=atol)
            assert float((a.float() - b_.float()).abs().max()) <= rtol * float(
                b_.float().abs().max())
    for a, b_ in zip(got, twin):
        if a.dtype == torch.float32:
            assert float((a - b_).abs().max()) <= K7B_TWIN_RTOL * float(
                b_.abs().max())
    again = flow_nc_qside_bwd_call(q, *key, g, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,bh,nq,m", [
    (6, 8, 3136, 3136), (12, 8, 784, 784), (24, 8, 196, 196), (48, 8, 49, 49),
    (8, 4, 3136, 3136), (16, 4, 784, 784), (24, 4, 400, 136), (48, 3, 1, 1),
    (6, 2, 1000, 1500)])
def test_flow_nc_small_head_kernels_match_plain_and_twins(gen, dtype, d, bh,
                                                          nq, m):
    """K6, K7a and K7b at the vision encoder's head dims and stage lengths
    (the small-head route: 6/12/24/48 at 3,136/784/196/49 tokens, the
    reference bench's 8 and 16, NQ != M, N = M = 1): against the plain
    versions and the twins (K6's cluster split at ``cluster_blocks``, K7b's
    at the card's rows per block; K7b's fp32 outputs within K7B_TWIN_RTOL x
    max |twin|), and two calls of each bitwise equal."""
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v, g = mk(bh, nq, d), mk(bh, m, d), mk(bh, m, d), mk(bh, nq, d)
    reset_launches()
    got = flow_nc_fused_call(q, k, v)
    assert torch.equal(got, flow_nc_fused_call(q, k, v))
    for want in (flow_nc_fused_ref(q, k, v),
                 flow_nc_fused_parallel(q, k, v, cb=cluster_blocks(nq, m, d))):
        torch.testing.assert_close(got, want, **tol)
    key = nc_key_side(q, k, v, 1e-6, True)
    kw = dict(n_sinks=nq, m_sources=m)
    out = flow_nc_qside_call(q, *key, **kw)
    assert torch.equal(out, flow_nc_qside_call(q, *key, **kw))
    torch.testing.assert_close(out, flow_nc_qside_ref(q, *key, **kw), **tol)
    got = flow_nc_qside_bwd_call(q, *key, g, **kw)
    twin = flow_nc_qside_bwd_parallel(q, *key, g, rows=bwd_rows(
        bh, nq, d, dtype), **kw)
    for want in (flow_nc_qside_bwd_ref(q, *key, g, **kw), twin):
        for a, b_ in zip(got, want):
            torch.testing.assert_close(a, b_, **tol)
            assert float((a.float() - b_.float()).abs().max()) <= tol[
                "rtol"] * float(b_.float().abs().max())
    for a, b_ in zip(got, twin):
        if a.dtype == torch.float32:
            assert float((a - b_).abs().max()) <= K7B_TWIN_RTOL * float(
                b_.abs().max())
    again = flow_nc_qside_bwd_call(q, *key, g, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "flow_nc_fused": 2,
                        "flow_nc_qside": 2, "flow_nc_qside_bwd": 2}


def test_vision_step_kernels_match_plain_fp32(gen):
    """The vision encoder at full width and one block a stage (D = 6, 12,
    24, 48; 64 x 64 images: 256, 64, 16 and 4 tokens), fp32: loss and every
    wq/wk/wv gradient on the kernels (one K6 and one K7b a stage) against
    the plain path."""
    cfg = dataclasses.replace(get_config("flowformer_vision"),
                              stage_layers=(1, 1, 1, 1))
    params = vision.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    xs, ys = pixel_images(0, 4, size=64, n_classes=cfg.n_classes, channels=3)
    batch = {"images": torch.from_numpy(xs).cuda(),
             "labels": torch.from_numpy(ys).cuda()}
    loss, grads = {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        reset_launches()
        out, _ = vision.loss_fn(leaves, batch, c, dtype=torch.float32,
                                plan=executor_of(c, plan_of(
                                    c, causal=False, needs_grad=True),
                                    causal=False))
        out.backward()
        want = dict.fromkeys(KERNELS, 0)
        if backend == "auto":
            want.update(flow_nc_fused=4, flow_nc_qside_bwd=4)
        assert LAUNCHES == want
        loss[backend] = float(out)
        grads[backend] = [blk["attn"][w]["w"].grad for st in leaves["stages"]
                          for blk in st["blocks"] for w in ("wq", "wk", "wv")]
    assert abs(loss["auto"] - loss["plain"]) <= 1e-4 * abs(loss["plain"])
    for a, b_ in zip(grads["auto"], grads["plain"]):
        scale = float(b_.abs().max())
        assert scale > 0 and float(a.abs().max()) > 0
        assert float((a - b_).abs().max()) <= 1e-4 * scale


def test_flow_nc_qside_call_refuses_autograd_outside_flow_nc_qside(gen):
    q = torch.randn((2, 16, 32), generator=gen, device="cuda",
                    requires_grad=True)
    sums = torch.rand((2, 32), generator=gen, device="cuda") * 8
    kv = torch.randn((2, 32, 32), generator=gen, device="cuda")
    with pytest.raises(RuntimeError, match="no autograd graph"):
        flow_nc_qside_call(q, sums, sums, kv, n_sinks=16, m_sources=16)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        flow_nc_fused_call(q, q.detach(), q.detach())
    with torch.no_grad():
        flow_nc_qside_call(q, sums, sums, kv, n_sinks=16, m_sources=16)
    reset_launches()
    out = FlowNCQside.apply(q, sums, sums, kv, 16, 16, 1e-6)
    out.sum().backward()
    assert LAUNCHES["flow_nc_qside"] == 1 and LAUNCHES["flow_nc_qside_bwd"] == 1
    assert q.grad.abs().sum() > 0


def test_classifier_training_kernels_match_plain_fp32(gen):
    cfg = get_smoke_config("flowformer_lra")
    params = classifier.init(cfg, torch.Generator().manual_seed(0),
                             n_classes=10, device="cuda")
    train_data, eval_data = listops_data(32, 16, seq=128)
    steps = 3
    first = {k: torch.from_numpy(v[:4]).cuda() for k, v in train_data.items()}
    hist, grads = {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        loss, _ = classifier.loss_fn(leaves, first, c, dtype=torch.float32,
                                     plan=executor_of(c, plan_of(
                                         c, causal=False, needs_grad=True),
                                         causal=False))
        loss.backward()
        grads[backend] = [blk["attn"][w]["w"].grad for blk in leaves["blocks"]
                          for w in ("wq", "wk", "wv")]
        reset_launches()
        hist[backend] = train_eval_classifier(
            c, train_data, eval_data, n_classes=10, steps=steps, batch=4,
            dtype=torch.float32, params=params)["history"]
        want = dict.fromkeys(KERNELS, 0)
        if backend == "auto":
            n = cfg.n_layers * steps
            want.update(flow_nc_fused=n + cfg.n_layers, flow_nc_qside_bwd=n)
        assert LAUNCHES == want
    np.testing.assert_allclose(hist["auto"], hist["plain"], rtol=1e-4)
    for a, b_ in zip(grads["auto"], grads["plain"]):
        scale = float(b_.abs().max())
        assert scale > 0 and float(a.abs().max()) > 0
        assert float((a - b_).abs().max()) <= 1e-4 * scale


def assert_dot_close(got, want):
    """K5a/K5b tolerance: 1e-4 + 1e-4 |plain| + 1e-4 max |plain|."""
    bound = 1e-4 + 1e-4 * want.abs() + 1e-4 * want.abs().max()
    assert bool(((got - want).abs() <= bound).all()), float(
        (got - want).abs().max())


def dot_operands(gen, bh, g, n, d, dv):
    """The pipeline's dot operands: q_in = phi(q) * pos / I (sigmoid phi),
    k = phi(k), v and the cotangent standard normal."""
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    pq, pk = torch.sigmoid(mk(bh, g, n, d)), torch.sigmoid(mk(bh, n, d))
    pos = torch.arange(1, n + 1, device="cuda", dtype=torch.float32)
    inflow = torch.einsum("bgnd,bnd->bgn", pq, torch.cumsum(pk, 1))
    q = (pq * (pos / inflow)[..., None]).contiguous()
    return q, pk.contiguous(), mk(bh, n, dv), mk(bh, g, n, dv)


@pytest.mark.parametrize("g,n,d,dv", [(1, 512, 64, 64), (2, 200, 32, 32),
                                      (2, 200, 128, 128), (3, 130, 64, 32),
                                      (1, 1, 32, 128)])
def test_flow_chunk_kernels_match_plain(gen, g, n, d, dv):
    q, k, v, cot = dot_operands(gen, 6, g, n, d, dv)
    reset_launches()
    assert_dot_close(flow_chunk_call(q, k, v), flow_chunk_ref(q, k, v))
    assert_dot_close(flow_chunk_call(cot, v, k), flow_chunk_ref(cot, v, k))
    for a, b_ in zip(flow_chunk_dkv_call(q, k, v, cot),
                     flow_chunk_dkv_ref(q, k, v, cot)):
        assert_dot_close(a, b_)
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "flow_chunk": 2,
                        "flow_chunk_dkv": 1}
    with pytest.raises(ValueError, match="fp32 only"):
        flow_chunk_call(q.bfloat16(), k.bfloat16(), v.bfloat16())


@pytest.mark.parametrize("g,n,d,dv", [(1, 512, 64, 64), (2, 1, 64, 64),
                                      (1, 1, 128, 32), (3, 130, 64, 32),
                                      (2, 200, 128, 128), (1, 97, 32, 128)])
def test_flow_chunk_kernel_matches_its_decomposition(gen, g, n, d, dv):
    """K5a against ``flow_chunk_parallel`` at the kernel's own chunk (64,
    32 at a width of 128), N = 1 and a ragged last chunk included, and on
    the backward's dq operands; two calls bitwise equal."""
    q, k, v, cot = dot_operands(gen, 4, g, n, d, dv)
    chunk = 32 if max(d, dv) >= 128 else 64
    out = flow_chunk_call(q, k, v)
    assert_dot_close(out, flow_chunk_parallel(q, k, v, chunk))
    assert_dot_close(flow_chunk_call(cot, v, k),
                     flow_chunk_parallel(cot, v, k, chunk))
    assert torch.equal(flow_chunk_call(q, k, v), out)


@pytest.mark.parametrize("g,n,d,dv", [(1, 512, 64, 64), (2, 200, 32, 128),
                                      (3, 130, 128, 32), (2, 1, 64, 64),
                                      (3, 200, 128, 128), (1, 130, 64, 32)])
def test_flow_chunk_dkv_kernel_matches_plain_and_its_decomposition(gen, g, n,
                                                                   d, dv):
    """K5b against its plain version and ``flow_chunk_dkv_parallel`` at the
    kernel's own chunk (64, 32 at a width of 128), N = 1 and a ragged last
    chunk included; two calls bitwise equal."""
    q, k, v, cot = dot_operands(gen, 4, g, n, d, dv)
    chunk = 32 if max(d, dv) >= 128 else 64
    got = flow_chunk_dkv_call(q, k, v, cot)
    for want in (flow_chunk_dkv_ref(q, k, v, cot),
                 flow_chunk_dkv_parallel(q, k, v, cot, chunk)):
        for a, b_ in zip(got, want):
            assert_dot_close(a, b_)
    assert all(torch.equal(a, b_) for a, b_ in zip(
        flow_chunk_dkv_call(q, k, v, cot), got))


def test_flow_chunk_call_refuses_autograd_outside_flow_chunk_dot(gen):
    q, k, v, _ = dot_operands(gen, 2, 2, 40, 32, 64)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        flow_chunk_call(q, k, v)
    with torch.no_grad():
        flow_chunk_call(q, k, v)
    reset_launches()
    out = chunked_causal_dot_cuda(q[None], k[None], v[None], chunk=16)
    out.sum().backward()
    assert LAUNCHES["flow_chunk"] == 2 and LAUNCHES["flow_chunk_dkv"] == 1
    assert q.grad.abs().sum() > 0


def paper_causal(cfg, **over):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, strict_causal=False, **over))


def test_paper_causal_training_step_runs_k5a_and_k5b_only(gen):
    """Full depth: 6 layers x (forward, remat recompute, dq) K5a and 6
    K5b per step, and no other kernel."""
    cfg = paper_causal(get_config("flowformer_lm"))
    reset_launches()
    out = train(cfg, steps=1, batch=2, seq=128, dtype=torch.bfloat16)
    assert np.isfinite(out["history"]).all()
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "flow_chunk": 18,
                        "flow_chunk_dkv": 6}


def test_paper_causal_training_kernels_match_plain_fp32(gen):
    cfg = paper_causal(get_smoke_config("flowformer_lm"), chunk_size=16)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    hist = {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        reset_launches()
        hist[backend] = train(c, steps=3, batch=2, seq=64, dtype=torch.float32,
                              params=params)["history"]
        n = cfg.n_layers * 3
        want = dict.fromkeys(KERNELS, 0)
        if backend == "auto":
            want.update(flow_chunk=3 * n, flow_chunk_dkv=n)
        assert LAUNCHES == want
    np.testing.assert_allclose(hist["auto"], hist["plain"], rtol=1e-4)


def int8_pool(gen, slots, hkv, d):
    """A non-zero int8 FlowState pool on the card (the serving recipe)."""
    st = FlowState(
        t=torch.tensor([3, 40, 7, 1, 99][:slots], dtype=torch.int32,
                       device="cuda"),
        q_sum=torch.rand((slots, hkv, d), generator=gen, device="cuda") * 9,
        k_sum=torch.rand((slots, hkv, d), generator=gen, device="cuda") * 9,
        ko_sum=torch.rand((slots, hkv, d), generator=gen, device="cuda") * 9,
        qi_sum=torch.rand((slots, hkv, d), generator=gen, device="cuda") * 9,
        z=torch.rand((slots, hkv), generator=gen, device="cuda") * 9 + 1,
        s=torch.randn((slots, hkv, d, d), generator=gen, device="cuda"))
    return quantize_state(st, spec_of("int8"), granularity="head",
                          exempt=("z",))


def assert_int8_pool_close(pool, want):
    p, w = pool.payload, want.payload
    assert torch.equal(p.t, w.t)
    torch.testing.assert_close(p.z, w.z, rtol=1e-5, atol=1e-5)
    n = differ = 0
    for name in ("q_sum", "k_sum", "ko_sum", "qi_sum", "s"):
        diff = (getattr(p, name).int() - getattr(w, name).int()).abs()
        assert int(diff.max()) <= 1, name
        n, differ = n + diff.numel(), differ + int((diff > 0).sum())
        torch.testing.assert_close(getattr(pool.scale, name),
                                   getattr(want.scale, name), rtol=1e-5,
                                   atol=0)
    assert differ <= 1e-3 * n, f"{differ} of {n} payload entries differ"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("phi", ["sigmoid", "elu1", "relu"])
@pytest.mark.parametrize("g,d", [(1, 32), (2, 32), (1, 64), (2, 64),
                                 (1, 128), (2, 128)])
def test_flow_decode_q_kernel_matches_plain_in_place(gen, g, d, phi, dtype):
    """Four steps; at each the plain version (dequantize, the fp32 step,
    requantize) starts from a copy of the kernel's pre-step pool."""
    slots, hkv = 5, 2
    cfg = FlowConfig(phi=phi, causal=True, strict_causal=True)
    pool = int8_pool(gen, slots, hkv, d)
    ptrs = [x.data_ptr() for x in pool.payload + pool.scale]
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    reset_launches()
    for _ in range(4):
        q = torch.randn((slots, hkv * g, 1, d), generator=gen,
                        device="cuda").to(dtype)
        k = torch.randn((slots, hkv, 1, d), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((slots, hkv, 1, d), generator=gen,
                        device="cuda").to(dtype)
        before = pool.with_state(FlowState(*(x.clone() for x in pool.payload)),
                                 FlowState(*(x.clone() for x in pool.scale)))
        same, out = flow_decode_q_step(pool, q, k, v, cfg)
        new, ref = decode_step(dequantize_state(before), q, k, v, cfg)
        assert same is pool and out.dtype == dtype
        torch.testing.assert_close(out, ref, **tol)
        assert_int8_pool_close(pool, quantize_like(before, new))
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "flow_decode_q": 4}
    assert [x.data_ptr() for x in pool.payload + pool.scale] == ptrs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 32), (1, 128)])
def test_flow_decode_q_kernel_is_deterministic(gen, g, d, dtype):
    """Two steps from clones of one pool: out, payloads, scales and z
    bitwise equal."""
    slots, hkv = 5, 2
    cfg = FlowConfig(causal=True, strict_causal=True)
    pool = int8_pool(gen, slots, hkv, d)
    q = torch.randn((slots, hkv * g, 1, d), generator=gen,
                    device="cuda").to(dtype)
    k = torch.randn((slots, hkv, 1, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((slots, hkv, 1, d), generator=gen, device="cuda").to(dtype)
    runs = []
    for _ in range(2):
        copy = pool.with_state(FlowState(*(x.clone() for x in pool.payload)),
                               FlowState(*(x.clone() for x in pool.scale)))
        runs.append(flow_decode_q_step(copy, q, k, v, cfg))
    (a, out_a), (b, out_b) = runs
    assert torch.equal(out_a, out_b)
    for x, y in zip(a.payload + a.scale, b.payload + b.scale):
        assert torch.equal(x, y)


def test_flow_decode_q_wrapper_refuses_a_copy_or_another_payload(gen):
    bh, d = 4, 64
    pays = [torch.zeros((bh, d), dtype=torch.int8, device="cuda")
            for _ in range(4)]
    scales = [torch.ones((bh, 1), device="cuda") for _ in range(5)]
    z = torch.ones((bh,), device="cuda")
    s = torch.zeros((d, bh, d), dtype=torch.int8,
                    device="cuda").transpose(0, 1)  # not contiguous
    q = torch.randn((bh, 1, d), generator=gen, device="cuda")
    t = torch.ones((bh,), dtype=torch.int32, device="cuda")
    reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        flow_decode_q_call(t, q, q[:, 0], q[:, 0], pays, s, scales[:4],
                           scales[4], z, hkv=1)
    with pytest.raises(ValueError, match="int8 payloads only"):
        flow_decode_q_call(t, q, q[:, 0], q[:, 0], pays,
                           s.contiguous().float(), scales[:4], scales[4], z,
                           hkv=1)
    assert LAUNCHES["flow_decode_q"] == 0


def test_int8_engine_runs_k4_and_never_k3(gen):
    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    engine = Engine(params, cfg, slots=2, max_len=128, dtype=torch.float32,
                    state_dtype="int8")
    rng = np.random.default_rng(0)
    for uid, n in enumerate((5, 40, 17, 9)):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=6))
    reset_launches()
    done = engine.run()
    assert len(done) == 4 and all(len(r.generated) == 6 for r in done)
    w = engine.worker
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0),
                        "flow_fused": cfg.n_layers * w.admission_rounds,
                        "flow_decode_q": cfg.n_layers * w.decode_steps}


def ssd_close(got, want):
    """The SSD kernels' tolerance (see the module docstring)."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 + 1e-4 * scale)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("rows,n,w,dtype", [
    (3, 32, 24, torch.float32), (16, 512, 4096, torch.bfloat16),
    (16, 512, 128, torch.float32), (5, 7, 3, torch.bfloat16)])
def test_boundary_gather_kernel_matches_plain_exactly(gen, rows, n, w, dtype):
    xb = torch.randn((rows, n, w), generator=gen, device="cuda").to(dtype)
    lens = [0, 1, 2, 3, n] + [int(i) for i in torch.randint(
        0, n + 1, (rows,), generator=gen, device="cuda")]
    lengths = torch.tensor(lens[:rows], dtype=torch.int32, device="cuda")
    reset_launches()
    got = boundary_gather(xb, lengths, 4)
    assert LAUNCHES["boundary_gather"] == 1
    assert torch.equal(got, boundary_gather_ref(xb, lengths, 4))


@pytest.mark.parametrize("widths,dtype,offset", [
    ((4096, 128, 128), torch.bfloat16, 0), ((24,), torch.float32, 0),
    ((3, 5, 6, 128), torch.bfloat16, 0), ((8, 4, 2, 1), torch.bfloat16, 0),
    ((16, 8), torch.float32, 1), ((16, 32, 8), torch.bfloat16, 1)])
def test_boundary_gather_many_kernel_matches_plain_exactly(gen, widths, dtype,
                                                           offset):
    """One launch for 1-4 streams, exactly the plain gather of each: the
    16-byte path, and the 4- and 2-byte ones for widths or pointers
    (``offset`` elements into a buffer) that are not 16-byte aligned."""
    rows, n = 6, 40

    def stream(w):
        buf = torch.randn(rows * n * w + offset, generator=gen, device="cuda")
        return buf.to(dtype)[offset:].view(rows, n, w)

    xs = tuple(stream(w) for w in widths)
    lengths = torch.tensor([0, 1, 2, 3, n, 17], dtype=torch.int32,
                           device="cuda")
    reset_launches()
    got = boundary_gather_many(xs, lengths, 4)
    assert LAUNCHES["boundary_gather"] == 1
    for a, b in zip(got, boundary_gather_many_ref(xs, lengths, 4)):
        assert torch.equal(a, b)


def ssd_operands(gen, bsz, h, n, p, s, decay):
    """x, dta, bmat, cmat; ``decay`` "strong" sets dta = -50, "ties" puts
    decays below the spacing of the cumsum and zeros among them (where a
    clamped difference's derivative would depend on summation order)."""
    mk = lambda *sh: torch.randn(sh, generator=gen, device="cuda")  # noqa: E731
    x = mk(bsz * h, n, p) * 0.5
    dta = (torch.full((bsz * h, n, 1), -50.0, device="cuda")
           if decay == "strong" else
           -torch.rand((bsz * h, n, 1), generator=gen, device="cuda") * 0.2)
    if decay == "ties":
        dta[:, 5::7] = -1e-9
        dta[:, 3::11] = 0.0
    return x, dta, mk(bsz, n, s) * 0.5, mk(bsz, n, s) * 0.5


@pytest.mark.parametrize("bsz,h,n,p,s,chunk,decay", [
    (1, 2, 64, 32, 32, 32, "mild"), (2, 3, 96, 64, 128, 96, "mild"),
    (1, 2, 200, 32, 32, 8, "mild"), (2, 2, 256, 64, 128, 128, "strong"),
    (2, 4, 512, 64, 128, 128, "ties"), (4, 64, 4096, 64, 128, 128, "mild"),
    (2, 8, 512, 32, 32, 128, "ties")])
def test_ssd_chunk_kernels_match_plain(gen, bsz, h, n, p, s, chunk, decay):
    x, dta, bm, cm = ssd_operands(gen, bsz, h, n, p, s, decay)
    b4, c4 = bm[:, None].expand(bsz, h, n, s), cm[:, None].expand(bsz, h, n, s)
    reset_launches()
    y, hins = ssd_chunk_call(x, dta, b4, c4, chunk=chunk, return_hins=True)
    y0 = ssd_chunk_call(x, dta, b4, c4, chunk=chunk)
    ry, rh = ssd_chunk_chunked(x, dta, b4, c4, chunk)
    ssd_close(y, ry)
    ssd_close(hins, rh)
    assert torch.equal(y0, y)
    g = torch.randn(x.shape, generator=gen, device="cuda")
    got = ssd_chunk_bwd_call(x, dta, b4, c4, hins, g, chunk=chunk)
    leaves = [t.clone().requires_grad_(True) for t in (x, dta, bm, cm)]
    want_y, _ = ssd_chunk_chunked(
        leaves[0], leaves[1], leaves[2][:, None].expand(bsz, h, n, s),
        leaves[3][:, None].expand(bsz, h, n, s), chunk)
    want = torch.autograd.grad(want_y, leaves, g)
    ssd_close(got[0], want[0])
    ssd_close(got[1], want[1])
    assert got[2].shape == got[3].shape == (bsz, n, s)  # summed over heads
    ssd_close(got[2], want[2])
    ssd_close(got[3], want[3])
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "ssd_chunk": 1,
                        "ssd_chunk_hins": 1, "ssd_chunk_bwd": 1}


@pytest.mark.parametrize("bsz,h,n,p,s,chunk", [
    (2, 8, 512, 64, 128, 128), (2, 3, 200, 32, 32, 8)])
def test_ssd_chunk_kernels_are_deterministic(gen, bsz, h, n, p, s, chunk):
    """Two calls on the same inputs are bitwise equal: every sum over
    heads, positions or column tiles runs in a fixed order."""
    x, dta, bm, cm = ssd_operands(gen, bsz, h, n, p, s, "mild")
    g = torch.randn(x.shape, generator=gen, device="cuda")
    runs = []
    for _ in range(2):
        y, hins = ssd_chunk_call(x, dta, bm, cm, chunk=chunk,
                                 return_hins=True)
        runs.append((y, hins, ssd_chunk_call(x, dta, bm, cm, chunk=chunk),
                     *ssd_chunk_bwd_call(x, dta, bm, cm, hins, g,
                                         chunk=chunk)))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def test_ssd_chunk_dot_gradients_match_plain(gen):
    bsz, h, n, p, s, chunk = 2, 4, 256, 64, 128, 128
    x, dta, bm, cm = ssd_operands(gen, bsz, h, n, p, s, "mild")
    g = torch.randn(x.shape, generator=gen, device="cuda")
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (x, dta, bm, cm)]
        b4 = leaves[2][:, None].expand(bsz, h, n, s)
        c4 = leaves[3][:, None].expand(bsz, h, n, s)
        y = (SSDChunkDot.apply(*leaves, chunk)
             if route == "kernel" else
             ssd_chunk_chunked(leaves[0], leaves[1], b4, c4, chunk)[0])
        grads[route] = torch.autograd.grad(y, leaves, g)
    for a, b_ in zip(grads["kernel"], grads["plain"]):
        ssd_close(a, b_)
    with pytest.raises(RuntimeError, match="SSDChunkDot"):
        ssd_chunk_call(x.requires_grad_(True), dta,
                       bm[:, None].expand(bsz, h, n, s),
                       cm[:, None].expand(bsz, h, n, s), chunk=chunk)


def test_ssd_block_has_no_plain_fallback_on_cuda(gen):
    cfg = get_smoke_config("mamba2_1p3b")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    bp = params["blocks"][0]["ssd"]
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device="cuda")
    reset_launches()
    with torch.no_grad():
        out = ssd_layer.ssd_block(bp, x, cfg)
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "ssd_chunk": 1}
    with torch.no_grad():
        want = ssd_layer.ssd_block(
            tree_map(lambda t: t.cpu(), bp), x.cpu(), cfg)
    ssd_close(out.cpu(), want)
    narrow = dataclasses.replace(cfg, ssd=dataclasses.replace(
        cfg.ssd, head_dim=16))
    params = lm.init(narrow, torch.Generator().manual_seed(0), device="cuda")
    with pytest.raises(ValueError, match=r"kernel takes \(P, S\) in"):
        ssd_layer.ssd_block(params["blocks"][0]["ssd"], x, narrow)


def test_ssd_engine_runs_k9_per_admission_and_matches_the_cpu(gen):
    cfg = get_smoke_config("mamba2_1p3b")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 17, 9, 64)]
    runs = {}
    for device in ("cuda", "cpu"):
        engine = Engine(params, cfg, slots=2, max_len=128,
                        dtype=torch.float32, device=device)
        for uid, p in enumerate(prompts):
            engine.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        reset_launches()
        runs[device] = {r.uid: r.generated for r in engine.run()}
        if device == "cuda":
            assert LAUNCHES == {**dict.fromkeys(KERNELS, 0),
                                "boundary_gather": cfg.n_layers
                                * engine.worker.admission_rounds}
    assert runs["cuda"] == runs["cpu"]


def paged_case(gen, p, hkv, page, d, dv, b, mp):
    """Pools and a shuffled, partly mapped table with sentinel ids (P, a
    dead slot's row, and out-of-range ids on both sides)."""
    kc = torch.randn((p, hkv, page, d), generator=gen, device="cuda")
    vc = torch.randn((p, hkv, page, dv), generator=gen, device="cuda")
    table = torch.stack([torch.randperm(p, generator=gen, device="cuda")[:mp]
                         for _ in range(b)]).to(torch.int32)
    table[0, mp // 2:] = p
    table[-1] = p
    table[1 % b, 0] = -3
    return kc, vc, table


PAGED_SHAPES = [(64, 8, 64, 64, 64, 16, 8), (24, 2, 8, 16, 32, 5, 6),
                (9, 3, 4, 8, 24, 3, 3), (7, 2, 5, 24, 40, 3, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_gather_kernels_match_plain_exactly(gen, shape, dtype):
    kc, vc, table = paged_case(gen, *shape)
    kc, vc = kc.to(dtype), vc.to(dtype)
    reset_launches()
    got = paged_gather(kc, vc, table)
    assert LAUNCHES["paged_gather"] == 1
    for a, b in zip(got, paged_gather_ref(kc, vc, table)):
        assert a.dtype == dtype and torch.equal(a, b)
    kq, vq = ((x.float() * 40).round().clamp(-127, 127).to(torch.int8)
              for x in (kc, vc))
    ks, vs = (torch.rand(x.shape[:3] + (1,), generator=gen, device="cuda")
              for x in (kc, vc))
    got = paged_gather_quant(kq, vq, ks, vs, table, out_dtype=dtype)
    assert LAUNCHES["paged_gather_quant"] == 1
    want = paged_gather_quant_ref(kq, vq, ks, vs, table, out_dtype=dtype)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [PAGED_SHAPES[0], PAGED_SHAPES[3]])
def test_paged_gather_quant_kernel_is_deterministic(gen, shape, dtype):
    """Two K8b calls on the same pools: bitwise equal."""
    kc, vc, table = paged_case(gen, *shape)
    kq, vq = ((x * 40).round().clamp(-127, 127).to(torch.int8)
              for x in (kc, vc))
    ks, vs = (torch.rand(x.shape[:3] + (1,), generator=gen, device="cuda")
              for x in (kc, vc))
    runs = [paged_gather_quant(kq, vq, ks, vs, table, out_dtype=dtype)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_paged_engine_kernels_match_plain_fp32(gen, monkeypatch):
    base = get_smoke_config("flowformer_lm")
    cfg = dataclasses.replace(base, attention=dataclasses.replace(
        base.attention, kind="softmax"))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 17, 5, 23, 12)]
    runs = {}
    for state_dtype in (None, "int8"):
        for path in ("kernels", "plain"):
            if path == "plain":
                monkeypatch.setattr(attn_layer, "paged_gather", lambda *a, **k:
                                    paged_gather(*a, **k, interpret=True))
                monkeypatch.setattr(attn_layer, "paged_gather_quant",
                                    lambda *a, **k: paged_gather_quant(
                                        *a, **k, interpret=True))
            engine = Engine(params, cfg, slots=2, max_len=64,
                            paged=PagedSpec(8, 10), dtype=torch.float32,
                            state_dtype=state_dtype, device="cuda")
            for uid, p in enumerate(prompts):
                engine.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
            reset_launches()
            runs[path] = {r.uid: r.generated for r in engine.run()}
            name = "paged_gather_quant" if state_dtype else "paged_gather"
            want = cfg.n_layers * engine.worker.decode_steps \
                if path == "kernels" else 0
            assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), name: want}
            assert engine.worker.allocator.free_pages == 10
        monkeypatch.undo()
        assert runs["kernels"] == runs["plain"], state_dtype


def speculative_traffic(engine, vocab):
    rng = np.random.default_rng(3)
    for uid, n in enumerate((5, 40, 17, 9, 23)):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, vocab, n).astype(np.int32), max_new_tokens=7 + uid))
    return {r.uid: r.generated for r in engine.run()}


@pytest.mark.parametrize("draft,k", [("self", 4), ("tiny", 2)])
def test_speculative_engine_greedy_equals_plain(gen, draft, k):
    """fp32 greedy tokens of the speculative Engine (K1 prefill, K3 in the
    proposes, the verify in plain PyTorch on the card) against the plain
    Engine's (K1, K3), token for token."""
    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    kw = dict(slots=3, max_len=128, dtype=torch.float32)
    want = speculative_traffic(Engine(params, cfg, **kw), cfg.vocab_size)
    engine = Engine(params, cfg, draft=draft, speculate_k=k, **kw)
    reset_launches()
    assert speculative_traffic(engine, cfg.vocab_size) == want
    w = engine.worker
    assert w.decode_steps == 0 and w.verify_windows > 0
    assert LAUNCHES["flow_fused"] >= cfg.n_layers * w.admission_rounds
    assert LAUNCHES["flow_decode"] > 0


@pytest.mark.parametrize("state_dtype", [None, "int8"])
def test_self_draft_propose_leaves_the_pools_bitwise_unchanged(gen,
                                                               state_dtype):
    from repro_torch.serving.draft import SelfDraft
    from repro_torch.serving.quant import QuantizedPool, pool_bytes

    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    engine = Engine(params, cfg, slots=2, max_len=128, dtype=torch.float32,
                    state_dtype=state_dtype, speculate_k=4)
    assert isinstance(engine.draft, SelfDraft)
    rng = np.random.default_rng(4)
    for uid, n in enumerate((12, 30)):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=20))
    engine.step()  # admission and one window
    w, sched = engine.worker, engine.scheduler
    pools = w.caches
    assert all(isinstance(c, QuantizedPool) == (state_dtype == "int8")
               for c in pools)
    leaves = [(x, x.clone()) for c in pools for x in (
        [*c.payload, *c.scale] if isinstance(c, QuantizedPool) else c)]
    assert sum(x.numel() * x.element_size() for x, _ in leaves) == \
        pool_bytes(pools)
    name = "flow_decode_q" if state_dtype else "flow_decode"
    reset_launches()
    drafts = engine.draft.propose(sched.last_tokens(), sched.pos,
                                  sched.live_mask())
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 4 * cfg.n_layers and drafts.shape == (2, 4)
    assert w.caches is pools
    for x, before in leaves:
        assert torch.equal(x, before)  # payloads, scales, t and z


def test_ssd_scan_takes_a_single_row(gen):
    """At B = 1 the head-major reshape of ``ssd_scan`` is a strided view;
    the glue hands K10a contiguous operands (the stateless forward of one
    sequence)."""
    bsz, n, h, p, s = 1, 100, 4, 64, 128
    xh = torch.randn((bsz, n, h, p), generator=gen, device="cuda")
    dt = torch.rand((bsz, n, h), generator=gen, device="cuda") * 0.1
    b = torch.randn((bsz, n, s), generator=gen, device="cuda")
    c = torch.randn((bsz, n, s), generator=gen, device="cuda")
    a = -torch.rand((h,), generator=gen, device="cuda")
    reset_launches()
    y = ssd_layer.ssd_scan(xh, dt, b, c, a, chunk=32)
    assert LAUNCHES["ssd_chunk"] == 1
    ssd_close(y, ssd_layer.ssd_scan(xh, dt, b, c, a, chunk=32,
                                    interpret=True))


# ---------------------------------------------------------------------------
# K1/K2 at chunk_size=0 and D = 24, K5a/K5b at D = 24, the Decision-Flowformer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("phi", ["sigmoid", "elu1", "relu"])
@pytest.mark.parametrize("n,d", [(60, 24), (180, 24), (180, 64)])
def test_flow_fused_padded_routes_match_plain(gen, phi, n, d):
    """K1 at ``chunk_size=0`` (N padded to 64) and D = 24 (rows padded to
    32) with ``lens`` against the plain scan at the real shapes; K2 through
    ``FlowFusedDot`` against autograd of the plain scan."""
    b, hkv, g = 3, 2, 2
    q = torch.randn((b, hkv * g, n, d), generator=gen, device="cuda")
    k = torch.randn((b, hkv, n, d), generator=gen, device="cuda")
    v = torch.randn((b, hkv, n, d), generator=gen, device="cuda")
    lengths = torch.tensor([n, 1, n // 3], dtype=torch.int32, device="cuda")
    cfg = FlowConfig(phi=phi, causal=True, strict_causal=True, chunk_size=0)
    plain = dataclasses.replace(cfg, chunk_size=n)
    reset_launches()
    out, st = flow_fused_forward(q, k, v, cfg, return_state=True,
                                 lengths=lengths)
    ref, ref_st = fused_causal_forward(q, k, v, plain, return_state=True,
                                       lengths=lengths)
    for i, li in enumerate(lengths.tolist()):
        torch.testing.assert_close(out[i, :, :li], ref[i, :, :li], **TOL)
    for a, b_ in zip(st, ref_st):
        torch.testing.assert_close(a, b_, **TOL)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = flow_fused_forward(*leaves, cfg)[0]
    want = fused_causal_forward(*refs, plain)
    cot = torch.randn(got.shape, generator=gen, device="cuda")
    torch.testing.assert_close(got, want, **TOL)
    for a, b_ in zip(torch.autograd.grad(got, leaves, cot),
                     torch.autograd.grad(want, refs, cot)):
        scale = float(b_.abs().max())
        assert float((a - b_).abs().max()) <= 1e-4 * scale + 1e-6
    assert LAUNCHES["flow_fused"] == 2 and LAUNCHES["flow_fused_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flow_fused_d24_writes_zero_lanes_and_is_deterministic(gen, dtype):
    """K1 and K2 at D = 24: the wrappers pad to 32 and slice back, so the
    results are D = 24 wide, bitwise repeatable, zero past ``lens`` for
    the gradients, and equal to the plain versions at D = 24."""
    bh, g, n = 8, 2, 192
    mk = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                device="cuda").to(dtype)
    q, k, v, g_out = mk(bh, g, n, 24), mk(bh, n, 24), mk(bh, n, 24), \
        mk(bh, g, n, 24)
    lens = torch.full((bh,), 150, dtype=torch.int32, device="cuda")
    out, sums = flow_fused_call(q, k, v, lens, chunk=64)
    again = flow_fused_call(q, k, v, lens, chunk=64)
    assert torch.equal(out, again[0])
    assert all(torch.equal(a, b) for a, b in zip(sums, again[1]))
    assert out.shape == q.shape and sums[5].shape == (bh, 24, 24)
    ref_out, ref_sums = flow_fused_ref(q, k, v, lens, chunk=64)
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out, ref_out, **tol)
    g_sums = [torch.zeros_like(x) for x in sums]
    grads = flow_fused_bwd_call(q, k, v, lens, sums, g_out, g_sums, chunk=64)
    again = flow_fused_bwd_call(q, k, v, lens, sums, g_out, g_sums, chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = flow_fused_bwd_ref(q, k, v, lens, g_out, g_sums, chunk=64)
    for a, b in zip(grads, want):
        assert a.shape[-1] == 24 and not a[..., 150:, :].any()
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.parametrize("d,dv", [(24, 24), (24, 64), (64, 24)])
def test_flow_chunk_kernels_at_d24_match_plain(gen, d, dv):
    """K5a and K5b through the glue at D or Dv = 24 (padded to 32) and at
    ``chunk_size=0`` (K5a's own chunk), against the plain cumsum dot."""
    b, h, g, n = 2, 3, 2, 180
    qg = torch.sigmoid(torch.randn((b, h, g, n, d), generator=gen,
                                   device="cuda"))
    k = torch.sigmoid(torch.randn((b, h, n, d), generator=gen, device="cuda"))
    v = torch.randn((b, h, n, dv), generator=gen, device="cuda")
    cot = torch.randn((b, h, g, n, dv), generator=gen, device="cuda")
    leaves = [x.clone().requires_grad_(True) for x in (qg, k, v)]
    refs = [x.clone().requires_grad_(True) for x in (qg, k, v)]
    reset_launches()
    out = chunked_causal_dot_cuda(*leaves, chunk=0)
    want = causal_dot_grouped(*refs, chunk_size=0, use_kernel=False)
    scale = float(want.abs().max())
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4 + 1e-4 * scale)
    for a, b_ in zip(torch.autograd.grad(out, leaves, cot),
                     torch.autograd.grad(want, refs, cot)):
        s = float(b_.abs().max())
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4 + 1e-4 * s)
    assert LAUNCHES["flow_chunk"] == 2 and LAUNCHES["flow_chunk_dkv"] == 1


@pytest.mark.parametrize("kind,width", [("flow", "paper"), ("flow", "table7"),
                                        ("linear", "table7")])
def test_decision_step_on_the_kernels_matches_plain(gen, kind, width):
    """One fp32 Decision-Flowformer step (N = 60 or 180) on the kernels
    against ``backend="plain"``: the loss at rtol 1e-4, every gradient
    within 1e-4 of its leaf's max |grad|, and the kernels launched."""
    from repro_torch.launch import decision as launch
    from repro_torch.models import decision
    from repro_torch.utils import tree_leaves

    base = get_config("flowformer_dt")
    cfg = launch.with_kind(launch.table7_config(base) if width == "table7"
                           else dataclasses.replace(base, n_layers=1), kind)
    horizon = 20 if width == "table7" else 60
    batch = launch.batch_arrays(launch.trajectories(0, 8, horizon=horizon))
    batch = {k_: torch.from_numpy(x).cuda() for k_, x in batch.items()}
    params = decision.init(cfg, torch.Generator().manual_seed(0),
                           state_dim=17, action_dim=6, max_ep_len=horizon)
    losses, grads = {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        reset_launches()
        loss, _ = decision.loss_fn(leaves, batch, c, dtype=torch.float32,
                                   plan=executor_of(c, plan_of(
                                       c, needs_grad=True)))
        grads[backend] = torch.autograd.grad(loss, tree_leaves(leaves))
        losses[backend] = float(loss)
        launched = {k_: n_ for k_, n_ in LAUNCHES.items() if n_}
        if backend == "plain":
            assert not launched
        elif kind == "flow":
            assert launched == {"flow_fused": cfg.n_layers,
                                "flow_fused_bwd": cfg.n_layers}
        else:
            assert launched == {"flow_chunk": 2 * cfg.n_layers,
                                "flow_chunk_dkv": cfg.n_layers}
    assert abs(losses["auto"] - losses["plain"]) <= 1e-4 * abs(losses["plain"])
    for a, b_ in zip(grads["auto"], grads["plain"]):
        scale = float(b_.abs().max())
        assert float((a - b_).abs().max()) <= 1e-4 * scale + 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [1, 448])
def test_flow_nc_fused_at_whisper_cross_attention(gen, nq, dtype):
    """K6 at Whisper's cross-attention: one sink row (decode; 15 of the 16
    blocks of each cluster own none) or 448 (training) against the 1,500
    encoder frames, D = 64, against its plain version and its twin."""
    bh, m, d = 24, 1500, 64
    q = torch.randn((bh, nq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((bh, m, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((bh, m, d), generator=gen, device="cuda").to(dtype)
    reset_launches()
    out = flow_nc_fused_call(q, k, v)
    assert LAUNCHES["flow_nc_fused"] == 1
    for want in (flow_nc_fused_ref(q, k, v),
                 flow_nc_fused_parallel(q, k, v,
                                        cb=cluster_blocks(nq, m, d))):
        # bf16: atol scaled by max |want| (as chip_smoke's max_err_scaled),
        # since at NQ = 1 the outputs are a sigmoid times a weighted mean
        # of 1,500 rows of v, ~0.02; capped at the unscaled 1e-2
        scale = float(want.float().abs().max())
        tol = TOL if dtype == torch.float32 else dict(
            rtol=1e-2, atol=1e-2 * min(1.0, scale))
        torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flow_nc_qside_bwd_at_whisper_cross_attention(gen, dtype):
    """K7b at the cross-attention's backward: 448 decoder sinks against
    the key side of 1,500 frames, against its plain version."""
    bh, n, m, d = 24, 448, 1500, 64
    q = torch.randn((bh, n, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((bh, m, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((bh, m, d), generator=gen, device="cuda").to(dtype)
    g = torch.randn((bh, n, d), generator=gen, device="cuda").to(dtype)
    key = nc_key_side(q, k, v, 1e-6, True)
    kw = dict(n_sinks=n, m_sources=m)
    reset_launches()
    got = flow_nc_qside_bwd_call(q, *key, g, **kw)
    assert LAUNCHES["flow_nc_qside_bwd"] == 1
    want = flow_nc_qside_bwd_ref(q, *key, g, **kw)
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for a, b_ in zip(got, want):
        scale = float(b_.float().abs().max())
        torch.testing.assert_close(a.float(), b_.float(), rtol=tol["rtol"],
                                   atol=tol["atol"] + tol["rtol"] * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flow_fused_and_decode_at_g4_d128(gen, dtype):
    """K1 (packed prefill, ragged lengths) and 8 K3 steps at granite_8b's
    grouping: 8 kv heads of 128, G = 4, against their plain versions."""
    b, hkv, g, n, d = 4, 8, 4, 384, 128
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=128)
    q = torch.randn((b, hkv * g, n, d), generator=gen, device="cuda")
    k = torch.randn((b, hkv, n, d), generator=gen, device="cuda")
    v = torch.randn((b, hkv, n, d), generator=gen, device="cuda")
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    lengths = torch.tensor([384, 1, 100, 257], dtype=torch.int32,
                           device="cuda")
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    reset_launches()
    out, st = flow_fused_forward(q, k, v, cfg, return_state=True,
                                 lengths=lengths)
    ref, ref_st = fused_causal_forward(q, k, v, cfg, return_state=True,
                                       lengths=lengths)
    for i, li in enumerate(lengths.tolist()):
        torch.testing.assert_close(out[i, :, :li].float(),
                                   ref[i, :, :li].float(), **tol)
    for a, b_ in zip(st, ref_st):
        torch.testing.assert_close(a, b_, **TOL)
    plain = FlowState(*(x.clone() for x in st))
    for _ in range(8):
        tq = torch.randn((b, hkv * g, 1, d), generator=gen,
                         device="cuda").to(dtype)
        tk = torch.randn((b, hkv, 1, d), generator=gen,
                         device="cuda").to(dtype)
        tv = torch.randn((b, hkv, 1, d), generator=gen,
                         device="cuda").to(dtype)
        _, got = flow_decode_step(st, tq, tk, tv, cfg)
        plain, want = decode_step(plain, tq, tk, tv, cfg)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    for a, b_ in zip(st, plain):
        torch.testing.assert_close(a, b_, **TOL)
    assert LAUNCHES["flow_fused"] == 1 and LAUNCHES["flow_decode"] == 8


def test_whisper_on_the_kernels_matches_plain(gen):
    """The smoke Whisper in fp32 on the card: the loss and every gradient
    on the kernels (K6, K7b, K1, K2) against ``backend="plain"``, and 6
    greedy tokens (K3 and K6 at one sink row a step) equal."""
    from repro_torch.models import encdec
    from repro_torch.utils import tree_leaves

    cfg = get_smoke_config("whisper_small")
    params = encdec.init(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33))).cuda()
    batch = {"frames": torch.randn((2, 96, cfg.d_model), generator=gen,
                                   device="cuda"),
             "inputs": toks[:, :-1], "targets": toks[:, 1:]}
    losses, grads, chosen = {}, {}, {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params)
        reset_launches()
        loss, _ = encdec.loss_fn(leaves, batch, c, dtype=torch.float32,
                                 plan=encdec.executors(c, plan_of(
                                     c, needs_grad=True)))
        grads[backend] = torch.autograd.grad(loss, tree_leaves(leaves))
        losses[backend] = float(loss)
        with torch.no_grad():
            mem = encdec.encode(params, batch["frames"], c,
                                dtype=torch.float32)
            chosen[backend], _ = encdec.greedy_decode(
                params, mem, toks[:, :1], c, 6, dtype=torch.float32)
        launched = {k_: n_ for k_, n_ in LAUNCHES.items() if n_}
        if backend == "plain":
            assert not launched
        else:
            # loss: 2 encoder and 2 cross K6 and K7b, 2 K1 and K2; encode:
            # 2 K6; 6 decode steps: a K3 and a K6 per decoder layer
            assert launched == {"flow_nc_fused": 4 + 2 + 12,
                                "flow_nc_qside_bwd": 4, "flow_fused": 2,
                                "flow_fused_bwd": 2, "flow_decode": 12}
    assert abs(losses["auto"] - losses["plain"]) <= 1e-4 * abs(losses["plain"])
    for a, b_ in zip(grads["auto"], grads["plain"]):
        scale = float(b_.abs().max())
        assert float((a - b_).abs().max()) <= 1e-4 * scale
    assert torch.equal(chosen["auto"], chosen["plain"])


# --- K1 and K3 at D = 192: MLA (Dv = 128) and Nemotron-4-340B (Dv = 192) ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g,dv", [(4, 1, 128), (2, 12, 192)])
def test_flow_fused_and_decode_at_d192(gen, hkv, g, dv, dtype):
    """K1 (packed prefill, ragged lengths) and 8 K3 steps at D = 192:
    DeepSeek-V2's MLA heads (Dv = 128, G = 1) and Nemotron-4-340B's (Dv =
    192, G = 12), against their plain versions."""
    b, n, d = 3, 200, 192
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=128)
    q = torch.randn((b, hkv * g, n, d), generator=gen, device="cuda")
    k = torch.randn((b, hkv, n, d), generator=gen, device="cuda")
    v = torch.randn((b, hkv, n, dv), generator=gen, device="cuda")
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    lengths = torch.tensor([200, 1, 77], dtype=torch.int32, device="cuda")
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    reset_launches()
    out, st = flow_fused_forward(q, k, v, cfg, return_state=True,
                                 lengths=lengths)
    ref, ref_st = fused_causal_forward(q, k, v, cfg, return_state=True,
                                       lengths=lengths)
    assert out.shape == (b, hkv * g, n, dv) and st.s.shape == (b, hkv, d, dv)
    for i, li in enumerate(lengths.tolist()):
        torch.testing.assert_close(out[i, :, :li].float(),
                                   ref[i, :, :li].float(), **tol)
    for a, b_ in zip(st, ref_st):
        torch.testing.assert_close(a, b_, **TOL)
    plain = FlowState(*(x.clone() for x in st))
    for _ in range(8):
        tq = torch.randn((b, hkv * g, 1, d), generator=gen,
                         device="cuda").to(dtype)
        tk = torch.randn((b, hkv, 1, d), generator=gen,
                         device="cuda").to(dtype)
        tv = torch.randn((b, hkv, 1, dv), generator=gen,
                         device="cuda").to(dtype)
        _, got = flow_decode_step(st, tq, tk, tv, cfg)
        plain, want = decode_step(plain, tq, tk, tv, cfg)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    for a, b_ in zip(st, plain):
        torch.testing.assert_close(a, b_, **TOL)
    assert LAUNCHES["flow_fused"] == 1 and LAUNCHES["flow_decode"] == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dv", [(1, 128), (12, 192), (3, 128)])
def test_flow_decode_at_d192_is_deterministic_and_in_split_order(gen, g, dv,
                                                                 dtype):
    """K3 at D = 192: two steps from clones of one pool bitwise equal, and
    the step against ``flow_decode_split`` from a copy of the pool."""
    slots, hkv, d = 5, 2, 192
    bh = slots * hkv
    pool = decode_pool(gen, slots, hkv, d)
    pool = pool._replace(s=torch.randn((slots, hkv, d, dv), generator=gen,
                                       device="cuda"))
    q = torch.randn((bh, g, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((bh, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((bh, dv), generator=gen, device="cuda").to(dtype)
    before = [x.clone() for x in flat_state(pool)]
    pool.t.add_(1)
    runs = []
    for _ in range(2):
        state = [x.clone() for x in before]
        runs.append((flow_decode_call(pool.t, q, k, v, *state, hkv=hkv),
                     state))
    (out_a, st_a), (out_b, st_b) = runs
    assert torch.equal(out_a, out_b)
    assert all(torch.equal(x, y) for x, y in zip(st_a, st_b))
    want, want_st = flow_decode_split(pool.t, q, k, v, *before, hkv=hkv)
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out_a.float(), want.float(), **tol)
    for a, b_ in zip(st_a, want_st):
        torch.testing.assert_close(a, b_, **TOL)


def test_flow_fused_forward_refuses_gradients_at_d192_naming_k2(gen):
    """At D = 192 (MLA's (192, 128), G = 1) gradients run through
    ``FlowFusedDot``: one K1 and one K2, against autograd through the plain
    scan at the stated tolerance.  A group K2's pull-back does not fit (G
    = 24) raises naming K2 before any launch."""
    cfg = FlowConfig(causal=True, strict_causal=True)
    q = torch.randn((2, 2, 96, 192), generator=gen, device="cuda")
    k = torch.randn((2, 2, 96, 192), generator=gen, device="cuda")
    v = torch.randn((2, 2, 96, 128), generator=gen, device="cuda")
    g_out = torch.randn((2, 2, 96, 128), generator=gen, device="cuda")
    grads = {}
    for how in ("kernels", "plain"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        reset_launches()
        fwd = flow_fused_forward if how == "kernels" else fused_causal_forward
        out, _ = fwd(*leaves, cfg, return_state=True)
        torch.autograd.backward(out, g_out)
        if how == "kernels":
            assert LAUNCHES["flow_fused"] == 1
            assert LAUNCHES["flow_fused_bwd"] == 1
        grads[how] = [x.grad for x in leaves]
    for a, b_ in zip(grads["kernels"], grads["plain"]):
        torch.testing.assert_close(a, b_, **TOL)
    wide = torch.randn((1, 24, 32, 192), generator=gen, device="cuda",
                       requires_grad=True)
    kv = torch.randn((1, 1, 32, 192), generator=gen, device="cuda")
    reset_launches()
    with pytest.raises(RuntimeError, match="K2.*G=24 at D=192"):
        flow_fused_forward(wide, kv, kv, cfg)
    assert LAUNCHES["flow_fused"] == 0


#: K2's and K4's wide pairs at the archs' groups: (D, Dv, kv heads, G)
WIDE_PAIRS_AT = [(192, 128, 4, 1), (192, 128, 2, 2), (192, 192, 2, 12),
                 (256, 256, 1, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv,hkv,g", WIDE_PAIRS_AT)
def test_flow_fused_bwd_at_the_wide_pairs(gen, d, dv, hkv, g, dtype):
    """K2 at the wide pairs on ragged lengths, random state cotangents,
    against its plain version (autograd through K1's), zero past each
    row's length; two calls bitwise equal."""
    rows, n = 3, 160
    bh = rows * hkv
    mk = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                device="cuda").to(dtype)
    q, k, v, g_out = mk(bh, g, n, d), mk(bh, n, d), mk(bh, n, dv), \
        mk(bh, g, n, dv)
    lens = torch.tensor([160, 1, 77], dtype=torch.int32,
                        device="cuda").repeat_interleave(hkv)
    _, totals = flow_fused_call(q, k, v, lens, chunk=32)
    g_sums = [torch.randn(x.shape, generator=gen, device="cuda")
              for x in totals]
    reset_launches()
    got = flow_fused_bwd_call(q, k, v, lens, totals, g_out, g_sums, chunk=32)
    again = flow_fused_bwd_call(q, k, v, lens, totals, g_out, g_sums,
                                chunk=32)
    assert LAUNCHES["flow_fused_bwd"] == 2
    want = flow_fused_bwd_ref(q, k, v, lens, g_out, g_sums, chunk=32)
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for a, a2, b_ in zip(got, again, want):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a.float(), b_.float(), **tol)
        for r, li in enumerate(lens.tolist()):
            assert not a[r, ..., li:, :].any()


def wide_int8_pool(gen, slots, hkv, d, dv):
    """``int8_pool`` with S of D x Dv."""
    st = dequantize_state(int8_pool(gen, slots, hkv, d))
    st = st._replace(s=torch.randn((slots, hkv, d, dv), generator=gen,
                                   device="cuda"))
    return quantize_state(st, spec_of("int8"), granularity="head",
                          exempt=("z",))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv,hkv,g", WIDE_PAIRS_AT)
def test_flow_decode_q_at_the_wide_pairs(gen, d, dv, hkv, g, dtype):
    """Four K4 steps at the wide pairs (D = 256 a cluster of four CTAs a
    row, sharing one S scale), each against the plain version from a copy
    of the kernel's pre-step pool, in place; then two steps from clones of
    one pool bitwise equal."""
    slots = 5
    cfg = FlowConfig(causal=True, strict_causal=True)
    pool = wide_int8_pool(gen, slots, hkv, d, dv)
    ptrs = [x.data_ptr() for x in pool.payload + pool.scale]
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)

    def token():
        return (torch.randn((slots, hkv * g, 1, d), generator=gen,
                            device="cuda").to(dtype),
                torch.randn((slots, hkv, 1, d), generator=gen,
                            device="cuda").to(dtype),
                torch.randn((slots, hkv, 1, dv), generator=gen,
                            device="cuda").to(dtype))

    def copy(p):
        return p.with_state(FlowState(*(x.clone() for x in p.payload)),
                            FlowState(*(x.clone() for x in p.scale)))

    reset_launches()
    for _ in range(4):
        q, k, v = token()
        before = copy(pool)
        same, out = flow_decode_q_step(pool, q, k, v, cfg)
        new, ref = decode_step(dequantize_state(before), q, k, v, cfg)
        assert same is pool and out.shape == (slots, hkv * g, 1, dv)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        assert_int8_pool_close(pool, quantize_like(before, new))
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "flow_decode_q": 4}
    assert [x.data_ptr() for x in pool.payload + pool.scale] == ptrs
    q, k, v = token()
    (a, out_a), (b, out_b) = [flow_decode_q_step(copy(pool), q, k, v, cfg)
                              for _ in range(2)]
    assert torch.equal(out_a, out_b)
    for x, y in zip(a.payload + a.scale, b.payload + b.scale):
        assert torch.equal(x, y)


def test_k2_group_limit_matches_the_library(gen):
    """``_lib.k2_group_fits`` (the registry's refusal) against the C
    entry's count on this card: the last group that fits and the first
    that does not, at every head width K2 takes."""
    import ctypes

    from repro_torch.kernels import _lib

    tile = _lib.function("flow_fused_bwd", "flow_fused_bwd_tile",
                         [ctypes.c_int] * 2)
    for d in (24, 32, 64, 128, 192, 256):
        g = next(g for g in range(1, 64) if not _lib.k2_group_fits(d, g))
        assert tile(g - 1, d) > 0 and tile(g, d) == 0, (d, g)


def test_moe_combine_is_bitwise_repeatable_on_cuda(gen):
    """The MoE's fixed-order combine (no atomics): two calls on the card
    bitwise equal, bf16 and fp32, with tokens dropped at capacity."""
    from repro_torch.config import MoEConfig
    from repro_torch.layers import moe

    mcfg = MoEConfig(n_experts=16, n_shared=1, top_k=4, d_ff_expert=96,
                     capacity_factor=0.75)
    params = tree_map(lambda x: x.cuda(), moe.moe_init(
        torch.Generator().manual_seed(0), 128, 96, "swiglu", mcfg))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((4, 200, 128), generator=gen,
                        device="cuda").to(dtype)
        a, aux_a = moe.moe(params, x, "swiglu", mcfg)
        b, aux_b = moe.moe(params, x, "swiglu", mcfg)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
        cpu, _ = moe.moe(tree_map(lambda t: t.cpu(), params), x.cpu().float(),
                         "swiglu", mcfg)
        if dtype == torch.float32:
            torch.testing.assert_close(a.cpu(), cpu, **TOL)


def test_mla_moe_engine_kernels_match_plain_greedy(gen):
    """A one-layer DeepSeek-V2-Lite at its head widths (MLA q and k 192,
    v 128; MoE with shared experts) served in fp32 on the kernels (K1 and
    K3 at (192, 128)) and on the plain path: greedy tokens equal."""
    cfg = get_config("deepseek_v2_lite_16b")
    cfg = dataclasses.replace(
        cfg, n_layers=1, d_model=256, n_heads=2, n_kv_heads=2,
        vocab_size=512, moe=dataclasses.replace(cfg.moe, n_experts=8,
                                                top_k=2, d_ff_expert=128))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    runs = {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        engine = Engine(params, c, slots=2, max_len=64, dtype=torch.float32,
                        device="cuda")
        rng = np.random.default_rng(1)
        for uid, n in enumerate((5, 17, 9)):
            engine.submit(Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=6))
        reset_launches()
        runs[backend] = {r.uid: r.generated for r in engine.run()}
        if backend == "auto":
            assert LAUNCHES["flow_fused"] > 0 and LAUNCHES["flow_decode"] > 0
        else:
            assert max(LAUNCHES.values()) == 0
    assert runs["auto"] == runs["plain"]


# --- K1 and K3 at D = Dv = 256, G = 16: RecurrentGemma-9B's flow heads -------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flow_fused_and_decode_at_d256_g16(gen, dtype):
    """K1 (packed prefill, ragged lengths) and 8 K3 steps (a cluster of
    four CTAs a row) at 16 query heads over one kv head of 256, against
    their plain versions; two calls of each bitwise equal."""
    b, hkv, g, n, d = 3, 1, 16, 200, 256
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=128)
    q = torch.randn((b, hkv * g, n, d), generator=gen,
                    device="cuda").to(dtype)
    k = torch.randn((b, hkv, n, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, hkv, n, d), generator=gen, device="cuda").to(dtype)
    lengths = torch.tensor([200, 1, 77], dtype=torch.int32, device="cuda")
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    reset_launches()
    out, st = flow_fused_forward(q, k, v, cfg, return_state=True,
                                 lengths=lengths)
    again, st2 = flow_fused_forward(q, k, v, cfg, return_state=True,
                                    lengths=lengths)
    assert torch.equal(out, again)
    assert all(torch.equal(x, y) for x, y in zip(st, st2))
    ref, ref_st = fused_causal_forward(q, k, v, cfg, return_state=True,
                                       lengths=lengths)
    for i, li in enumerate(lengths.tolist()):
        torch.testing.assert_close(out[i, :, :li].float(),
                                   ref[i, :, :li].float(), **tol)
    for a, b_ in zip(st, ref_st):
        torch.testing.assert_close(a, b_, **TOL)
    plain = FlowState(*(x.clone() for x in st))
    for _ in range(8):
        tq = torch.randn((b, hkv * g, 1, d), generator=gen,
                         device="cuda").to(dtype)
        tk = torch.randn((b, hkv, 1, d), generator=gen,
                         device="cuda").to(dtype)
        tv = torch.randn((b, hkv, 1, d), generator=gen,
                         device="cuda").to(dtype)
        twin = FlowState(*(x.clone() for x in st))
        _, got = flow_decode_step(st, tq, tk, tv, cfg)
        _, got2 = flow_decode_step(twin, tq, tk, tv, cfg)
        assert torch.equal(got, got2)
        assert all(torch.equal(x, y) for x, y in zip(st, twin))
        plain, want = decode_step(plain, tq, tk, tv, cfg)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    for a, b_ in zip(st, plain):
        torch.testing.assert_close(a, b_, **TOL)
    assert LAUNCHES["flow_fused"] == 2 and LAUNCHES["flow_decode"] == 16


def test_flow_fused_refuses_a_group_whose_flows_do_not_fit_at_d256(gen):
    """At D = 256 the flows of G = 24 do not fit a block's shared memory
    at the smallest super-chunk: the workspace count refuses, naming D and
    G, before any launch."""
    q = torch.randn((1, 24, 16, 256), generator=gen, device="cuda")
    k = torch.randn((1, 16, 256), generator=gen, device="cuda")
    lens = torch.tensor([16], dtype=torch.int32, device="cuda")
    reset_launches()
    with pytest.raises(ValueError, match=r"G=24.*\(256, 256\)"):
        flow_fused_call(q, k, k, lens, chunk=16)
    assert LAUNCHES["flow_fused"] == 0


@pytest.mark.parametrize("kind", ["flow", "softmax"])
def test_hybrid_engine_kernels_match_plain_greedy(gen, kind):
    """The RecurrentGemma smoke stack (rglru, rglru, local) at its kernel
    head dim (D = 32, G = 4) in fp32: flow mode packs (K1, K9 at
    admission, K3 at decode), softmax mode admits per request on window
    rings; on the kernels and pinned plain, greedy tokens equal."""
    cfg = get_smoke_config("recurrentgemma_9b")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    runs = {}
    for backend in ("auto", "plain"):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        engine = Engine(params, c, slots=2, max_len=96, dtype=torch.float32,
                        device="cuda")
        assert engine.worker.packable is (kind == "flow")
        rng = np.random.default_rng(1)
        for uid, n in enumerate((5, 64, 17)):
            engine.submit(Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=8))
        reset_launches()
        runs[backend] = {r.uid: r.generated for r in engine.run()}
        if backend == "auto" and kind == "flow":
            assert LAUNCHES["flow_fused"] > 0 and LAUNCHES["flow_decode"] > 0
            assert LAUNCHES["boundary_gather"] > 0
    assert runs["auto"] == runs["plain"]


@pytest.mark.parametrize("kind,state_dtype", [("flow", None),
                                              ("flow", "int8"),
                                              ("softmax", None)])
def test_bundle_round_trip_on_the_card(gen, kind, state_dtype):
    """Export a slot off one worker on the card, install it into another
    worker's free slot and export it again: the same bytes (fp32 and int8
    flow pools, a paged softmax pool)."""
    from repro_torch.serving.transport import StateTransport
    from repro_torch.serving.worker import Worker

    cfg = get_smoke_config("flowformer_lm")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    paged = PagedSpec(page_size=16) if kind == "softmax" else None
    src, dst = (Worker(params, cfg, slots=3, max_len=96, dtype=torch.float32,
                       paged=paged, state_dtype=state_dtype, device="cuda")
                for _ in range(2))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 13)]
    zeros = np.zeros(2, np.float32)
    src.prefill(prompts, [0, 2], zeros, spans=[60, 30])
    dst.prefill(prompts[::-1], [0, 1], zeros, spans=[30, 60])
    t = StateTransport()
    first = t.export(src, 2, 13)
    t.install(dst, 2, first, span=30)
    again = t.export(dst, 2, 13)
    assert first.nbytes == sum(e.nbytes for e in first.manifest)
    assert first.manifest == again.manifest
    assert np.array_equal(first.buffer, again.buffer)
    # the bundle's leaves unpacked on the host install into the card's
    # pools through the admission scatter as they are
    from repro_torch.serving.worker import _install_layer

    if paged is not None:
        dst.allocator.admit(2, 30)
        pids, offs = (torch.as_tensor(a, dtype=torch.long, device="cuda")
                      for a in dst.allocator.install_indices(
                          [2], [13], first.padded_len))
    else:
        pids = offs = None
    ids = torch.tensor([2], device="cuda")
    with torch.inference_mode():
        for pool, tree in zip(dst.caches, first.unpack()):
            _install_layer(pool, tree, ids, pids, offs)
    assert np.array_equal(t.export(dst, 2, 13).buffer, first.buffer)


def test_fleet_on_the_card_matches_the_engine(gen):
    """``FleetEngine(prefill=1, decode=2)`` on the card in fp32 (the smoke
    flowformer_lm): with a migration mid-stream and then a
    ``kill_worker``, every greedy token equals the single Engine's, and
    admission and decode ran on K1 and K3."""
    from repro_torch.serving.fleet import FleetEngine

    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")

    def traffic():
        rng = np.random.default_rng(3)
        return [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=10)
            for i, n in enumerate((12, 7, 19, 9, 15, 11))]

    engine = Engine(params, cfg, slots=4, max_len=64, dtype=torch.float32,
                    device="cuda")
    for r in traffic():
        engine.submit(r)
    want = {r.uid: r.generated for r in engine.run()}
    fleet = FleetEngine(params, cfg, prefill=1, decode=2, slots=4,
                        max_len=64, dtype=torch.float32)
    reqs = traffic()
    for r in reqs:
        fleet.submit(r)
    reset_launches()
    for _ in range(3):
        fleet.step()
    assert fleet.migrate(1) > 0
    fleet.step()
    victim = max(range(2), key=lambda i: fleet.members[i].load)
    assert fleet.kill_worker(victim)
    fleet.run()
    assert {r.uid: r.generated for r in reqs} == want
    assert fleet.migrations >= 2
    assert LAUNCHES["flow_fused"] > 0 and LAUNCHES["flow_decode"] > 0


def test_checkpoint_round_trip_of_cuda_tensors_is_bitwise(gen, tmp_path):
    """A tree of CUDA tensors (fp32, bf16, int) and Python ints saves
    (sync and async) and restores onto the card bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.utils import tree_leaves

    tree = {"w": torch.randn((64, 32), generator=gen, device="cuda"),
            "h": [torch.randn((8, 5), generator=gen, device="cuda"
                              ).to(torch.bfloat16)],
            "ids": torch.arange(7, device="cuda"), "step": 9}
    like = tree_map(lambda x: torch.zeros_like(x)
                    if isinstance(x, torch.Tensor) else 0, tree)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    mgr.save(2, tree, async_=True)
    tree["w"].add_(1.0)  # after the host copy: not in step 2
    mgr.wait()
    for step in (1, 2):
        back, _ = mgr.restore(step, like)
        for a, b in zip(tree_leaves(back), tree_leaves(like)):
            if isinstance(b, torch.Tensor):
                assert a.device == b.device and a.dtype == b.dtype
        assert back["step"] == 9
        assert torch.equal(back["w"] + 1.0, tree["w"])
        assert torch.equal(back["h"][0].view(torch.int16),
                           tree["h"][0].view(torch.int16))


def test_linear_training_resolves_to_k5a_and_k5b(gen):
    """``--attn linear`` on the card under ``auto``: every causal dot runs
    K5a (forward, remat recompute, dq) and K5b (dk, dv), never a plain
    version; ``softmax`` launches no kernel."""
    base = get_smoke_config("flowformer_lm")
    for kind, per_layer in (("linear", {"flow_chunk": 3,
                                        "flow_chunk_dkv": 1}),
                            ("softmax", {})):
        cfg = dataclasses.replace(base, attention=dataclasses.replace(
            base.attention, kind=kind))
        reset_launches()
        out = train(cfg, steps=2, batch=2, seq=64, device="cuda")
        assert all(np.isfinite(out["history"]))
        want = {k: 0 for k in KERNELS}
        want.update({k: v * cfg.n_layers * 2 for k, v in per_layer.items()})
        assert dict(LAUNCHES) == want, kind


# --- distribution and context parallelism (one card, single controller) ------

def test_cp_causal_resolves_k5a_on_cuda_and_names_it_where_none_applies(gen):
    """On the card ``cp_causal``'s ``auto`` inner is ``cuda_chunk`` (K5a);
    at a head width no kernel takes it raises naming K5a rather than run
    a plain dot; a pinned plain inner runs."""
    from repro_torch.attention import ExecutionPlan, ShapeInfo, ShardSpec
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("seq",))
    assert {str(d) for d in mesh.devices.flat} == {"cuda:0"}
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=128)
    plan = ExecutionPlan(flow=cfg, shard=ShardSpec(axis="seq", mesh=mesh))
    q = torch.randn(2, 8, 1024, 64, generator=gen, device="cuda")
    k, v = torch.randn(2, 2, 8, 1024, 64, generator=gen, device="cuda")
    shapes = ShapeInfo.from_qkv(q, k, v)
    rows = dict((n, w) for n, ok, w in attention.explain(
        plan, shapes, platform="cuda", op="forward").sections[0][1])
    assert "inner=cuda_chunk" in rows["cp_causal"]
    reset_launches()
    with torch.no_grad():
        out = attention.resolve(plan).forward(q, k, v)
        want = attention.resolve(ExecutionPlan(flow=cfg)).forward(q, k, v)
    assert LAUNCHES["flow_chunk"] == 4
    scale = float(want.abs().max())
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4 + 1e-4 * scale)
    odd = dataclasses.replace(shapes, d=16, dv=16)
    with pytest.raises(attention.ResolutionError) as ei:
        attention.resolve(plan).backend("forward", odd, "cuda")
    why = dict(ei.value.rejections)["cp_causal"]
    assert "K5a" in why and "cuda_chunk" in why
    pinned = dataclasses.replace(plan, shard=ShardSpec(
        axis="seq", mesh=mesh, inner="chunked"))
    assert attention.resolve(pinned).backend("forward", odd,
                                             "cuda").name == "cp_causal"


@pytest.mark.parametrize("g,d,n", [(1, 64, 1024), (1, 64, 512),
                                   (4, 128, 1024), (4, 128, 512)])
def test_k5a_at_the_cp_shard_local_shapes(gen, g, d, n):
    """K5a and K5b against their plain versions at phase 36's shard-local
    shapes: flowformer_lm's (B 4 x 8 kv heads, G = 1, D = 64) and
    granite_8b's (B 2 x 8 kv heads, G = 4, D = 128), local N 1,024 and
    512."""
    from repro_torch.kernels.flow_chunk import (flow_chunk_call,
                                                flow_chunk_dkv_call,
                                                flow_chunk_dkv_ref,
                                                flow_chunk_ref)

    bh = (4 if g == 1 else 2) * 8
    pq = torch.sigmoid(torch.randn(bh, g, n, d, generator=gen, device="cuda"))
    pk = torch.sigmoid(torch.randn(bh, n, d, generator=gen, device="cuda"))
    pos = torch.arange(1, n + 1, device="cuda", dtype=torch.float32)
    q = pq * (pos / torch.einsum("bgnd,bnd->bgn", pq, torch.cumsum(pk, 1))
              )[..., None]
    v = torch.randn(bh, n, d, generator=gen, device="cuda")
    cot = torch.randn(bh, g, n, d, generator=gen, device="cuda")

    def close(got, want):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 + 1e-4 * scale)

    with torch.no_grad():
        close(flow_chunk_call(q.contiguous(), pk, v),
              flow_chunk_ref(q, pk, v))
        for a, b in zip(flow_chunk_dkv_call(q.contiguous(), pk, v, cot),
                        flow_chunk_dkv_ref(q, pk, v, cot)):
            close(a, b)


def test_sharded_train_step_on_a_2x1_mesh_of_the_card(gen):
    """One fp32 step of ``build_train_step`` on a (2, 1) mesh of cuda:0
    against the (1, 1) step: the same loss, gradient norm and update,
    and 2 K1 (the metrics pass and the gradient pass) and 1 K2 a layer
    per data-parallel position."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import RunPlan, build_train_step
    from repro_torch.training.train_state import gather_state
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(get_smoke_config("flowformer_lm"), remat=False)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    batch = {k: torch.randint(0, cfg.vocab_size, (8, 64), generator=gen,
                              device="cuda") for k in ("inputs", "targets")}
    shape = ShapeSpec("t", 64, 8, "train")
    outs = {}
    for ms in ((1, 1), (2, 1)):
        step, init_state, _, _ = build_train_step(
            cfg, shape, make_mesh(ms, ("data", "model")), RunPlan(),
            {"compute_dtype": torch.float32, "warmup": 0})
        reset_launches()
        new, m = step(init_state(params), batch)
        outs[ms] = (float(m["loss"]), float(m["grad_norm"]),
                    gather_state(new, cfg).master, dict(LAUNCHES))
    (l1, g1, w1, la1), (l2, g2, w2, la2) = outs[(1, 1)], outs[(2, 1)]
    assert abs(l2 - l1) <= 1e-5 * l1 and abs(g2 - g1) <= 1e-4 * g1
    for a, b in zip(tree_leaves(w2), tree_leaves(w1)):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-5)
    assert la1["flow_fused"] == 2 * cfg.n_layers
    assert la2["flow_fused"] == 2 * la1["flow_fused"]
    assert la2["flow_fused_bwd"] == 2 * la1["flow_fused_bwd"] > 0


# --- K5a and K5b at the wide pairs: DeepSeek-V2-Lite's MLA heads (192, 128)
# and their dq call (128, 192), Nemotron-4-340B's (192, 192), G = 12, and
# RecurrentGemma-9B's (256, 256), G = 16 ----------------------------------

@pytest.mark.parametrize("g,n,d,dv", [
    (1, 512, 192, 128), (2, 200, 192, 128), (1, 97, 128, 192),
    (2, 70, 128, 192), (12, 130, 192, 192), (1, 33, 192, 192),
    (16, 200, 256, 256), (3, 1, 256, 256)])
def test_flow_chunk_kernels_at_the_wide_pairs(gen, g, n, d, dv):
    """K5a (forward and the dq operands) and K5b at the wide pairs against
    their plain versions and their decompositions at the kernels' chunk of
    32: G up to 16, N ragged against the chunk and N = 1; one count a call,
    and one at the pair the call ran at; two calls bitwise equal."""
    q, k, v, cot = dot_operands(gen, 4, g, n, d, dv)
    reset_launches()
    out = flow_chunk_call(q, k, v)
    dq = flow_chunk_call(cot, v, k)
    dk, dvv = flow_chunk_dkv_call(q, k, v, cot)
    assert LAUNCHES == {**dict.fromkeys(KERNELS, 0), "flow_chunk": 2,
                        "flow_chunk_dkv": 1}
    assert PAIR_LAUNCHES == collections.Counter([
        f"flow_chunk_{d}x{dv}", f"flow_chunk_{dv}x{d}",
        f"flow_chunk_dkv_{d}x{dv}"])
    for got, want in ((out, flow_chunk_ref(q, k, v)),
                      (out, flow_chunk_parallel(q, k, v, 32)),
                      (dq, flow_chunk_ref(cot, v, k)),
                      (dq, flow_chunk_parallel(cot, v, k, 32))):
        assert_dot_close(got, want)
    for want in (flow_chunk_dkv_ref(q, k, v, cot),
                 flow_chunk_dkv_parallel(q, k, v, cot, 32)):
        for a, b_ in zip((dk, dvv), want):
            assert_dot_close(a, b_)
    assert torch.equal(flow_chunk_call(q, k, v), out)
    assert all(torch.equal(a, b_) for a, b_ in zip(
        flow_chunk_dkv_call(q, k, v, cot), (dk, dvv)))


def test_chunk_pairs_are_the_pairs_the_c_side_takes(gen):
    """``_lib.CHUNK_PAIRS`` is the set of (D, Dv) at which the C
    ``flow_chunk_workspace`` and ``flow_chunk_dkv_workspace`` count a
    workspace (``pair_ok``); each library's launch entry refuses the
    other's pairs without launching."""
    import ctypes

    from repro_torch.kernels import _lib

    widths = (16, 24, 32, 48, 64, 96, 128, 160, 192, 224, 256, 320)
    for source, symbol in (("flow_chunk", "flow_chunk_workspace"),
                           ("flow_chunk_bwd", "flow_chunk_dkv_workspace")):
        count = _lib.function(source, symbol, [ctypes.c_int] * 5,
                              ctypes.c_longlong)
        assert {(d, dv) for d in widths for dv in widths
                if count(4, 3, 100, d, dv) >= 0} == set(_lib.CHUNK_PAIRS)
    p, i = ctypes.c_void_p, ctypes.c_int
    for source, symbol, ptrs in (
            ("flow_chunk", "flow_chunk_fwd", 5),
            ("flow_chunk_wide", "flow_chunk_wide_fwd", 5),
            ("flow_chunk_bwd", "flow_chunk_dkv", 7),
            ("flow_chunk_bwd_wide", "flow_chunk_dkv_wide", 7)):
        fn = _lib.function(source, symbol, [p] * ptrs + [i] * 5 + [p])
        other = (192, 128) if "wide" not in source else (64, 64)
        assert fn(*([None] * ptrs), 4, 1, 64, *other, None) != 0
