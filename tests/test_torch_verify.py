"""Port vs reference: speculative decoding (verify op, drafts, rollback).

The same numpy inputs and the same smoke weights (``interop``) go through
``repro`` and ``repro_torch`` in fp32 on the CPU:

  * ``pipeline.causal_verify``: every window output and every boundary
    ``select_state`` gathers, against the reference's ``causal_verify``
    and against the port's own sequential ``decode_step`` calls;
  * ``lm.verify`` + ``lm.select_verified`` for the flow, softmax and
    mamba2 (SSD) stacks at every accepted index, against the reference's;
  * ``Worker.verify`` accepting every draft and none, the registry's
    ``verify`` triage, ``explain``'s verify section, the named refusal of
    ``local`` rings;
  * the speculative ``Engine``'s greedy tokens against the plain Engine's
    and the JAX ``Engine``'s, for flow, paged softmax and mamba2 with
    ``SelfDraft`` and ``tiny_draft``, int8 flow against fp32 plain, the
    mid-window EOS retirement and the paged lookahead reservation;
  * the temperature rejection sampling, held to the distribution.

Tolerances: window outputs, trajectory states and logits rtol 1e-5 and
atol 1e-5 (x max |logit| for logits): the same fp32 terms summed in
another order (the window's cumsums against the sequential sums, one
framework against the other); greedy tokens: exact.  Temperature: the
total variation of 1,200 draws against softmax(logits / T) stays under
0.13, the pattern of ``tests/test_torch_serving.py``, whose
``check_tv_power`` shows the bound rejects a greedy sampler and draws at a
wrong temperature; here it is also shown to reject the two wrong
rejection samplers (always accepting the draft, and a correction that may
re-emit the rejected draft).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.attention import pipeline as jpipe  # noqa: E402
from repro.attention import recurrent as jrec  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.flow_attention import FlowConfig as JFlowConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import quant as jquant  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.paged import PagedSpec as JPagedSpec  # noqa: E402
from repro_torch import attention  # noqa: E402
from repro_torch.attention import backends, pipeline  # noqa: E402
from repro_torch.attention import recurrent as trec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.flow_attention import FlowConfig  # noqa: E402
from repro_torch.interop import (flow_pool_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.layers import mixer as mixer_lib  # noqa: E402
from repro_torch.layers.attention import plan_of  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import quant  # noqa: E402
from repro_torch.serving.draft import SelfDraft, tiny_draft  # noqa: E402
from repro_torch.serving.engine import Engine, PagedSpec, Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.serving.worker import Worker  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("t", "q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s")


def close(a, b, what="", **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=what,
                               **(tol or TOL))


def spec_plan(cfg, k):
    """A serving plan with a verify window of ``k`` drafts, as the Engine
    builds it."""
    return dataclasses.replace(plan_of(cfg), speculate_k=k)


def with_kind(cfg, kind):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind))


def both_models(arch, kind=None):
    jcfg, cfg = j_smoke_config(arch), get_smoke_config(arch)
    if kind is not None:
        jcfg, cfg = with_kind(jcfg, kind), with_kind(cfg, kind)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


VARIANTS = {"flow": ("flowformer_lm", None),
            "softmax": ("flowformer_lm", "softmax"),
            "mamba2": ("mamba2_1p3b", None)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    return (request.param, *both_models(*VARIANTS[request.param]))


# ---------------------------------------------------------------------------
# The registry's verify op
# ---------------------------------------------------------------------------
def qkv(rng, b, hq, hkv, n, d):
    return (rng.standard_normal((b, hq, n, d)).astype(np.float32),
            rng.standard_normal((b, hkv, n, d)).astype(np.float32),
            rng.standard_normal((b, hkv, n, d)).astype(np.float32))


@pytest.mark.parametrize("phi", ["sigmoid", "elu1", "relu"])
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_causal_verify_matches_reference_and_sequential_decode(phi, hkv,
                                                                quantized):
    """A window of n = 5 from a state that consumed 7 positions (rows of
    B = 3 at their own depths: the state comes from ``forward_by_scan``,
    itself held against the reference's), G = 4 / hkv, shared GQA."""
    b, hq, d, n = 3, 4, 16, 5
    rng = np.random.default_rng(3)
    cfg = FlowConfig(phi=phi, causal=True, strict_causal=True)
    jcfg = JFlowConfig(phi=phi, causal=True, strict_causal=True)
    pre = qkv(rng, b, hq, hkv, 7, d)
    out0, state = trec.forward_by_scan(*map(torch.from_numpy, pre), cfg,
                                       return_state=True)
    jout0, jstate = jrec.forward_by_scan(*map(jnp.asarray, pre), jcfg,
                                         return_state=True)
    close(out0, jout0, "forward_by_scan out")
    state = state._replace(t=torch.tensor([7, 3, 11], dtype=torch.int32))
    jstate = jstate._replace(t=jnp.asarray([7, 3, 11], jnp.int32))
    for f in FIELDS:
        close(getattr(state, f), getattr(jstate, f), f"prefill {f}")
    if quantized:
        # the reference quantizes its state; the port's pool is carried
        # across (``interop.flow_pool_from_numpy``), so both verify from
        # the same payloads and scales
        jstate = jquant.quantize_state(jstate, jquant.spec_of("int8"),
                                       granularity="head", exempt=("z",))
        state = flow_pool_from_numpy(jax.tree.map(np.asarray, jstate.payload),
                                     jax.tree.map(np.asarray, jstate.scale))
    win = qkv(rng, b, hq, hkv, n, d)
    q, k, v = map(torch.from_numpy, win)
    out, traj = pipeline.causal_verify(state, q, k, v, cfg)
    jout, jtraj = jpipe.causal_verify(jstate, *map(jnp.asarray, win), jcfg)
    close(out, jout, "verify out")
    for f in FIELDS:
        assert getattr(traj, f).shape[:2] == (b, n), f
        close(getattr(traj, f), getattr(jtraj, f), f"trajectory {f}")
    # against the port's own sequential decode steps, at every boundary
    st = quant.dequantize_state(state) if quantized else state
    for j in range(n):
        st, step = trec.decode_step(st, q[:, :, j:j + 1], k[:, :, j:j + 1],
                                    v[:, :, j:j + 1], cfg)
        close(out[:, :, j:j + 1], step, f"position {j}")
        sel = trec.select_state(traj, torch.full((b,), j))
        jsel = jrec.select_state(jtraj, jnp.full((b,), j))
        for f in FIELDS:
            close(getattr(sel, f), getattr(st, f), f"boundary {j} {f}")
            close(getattr(sel, f), getattr(jsel, f), f"boundary {j} {f}")
            assert getattr(sel, f).is_contiguous()


def test_verify_resolution_and_triage():
    cfg = FlowConfig(causal=True, strict_causal=True)
    shapes = attention.ShapeInfo(b=16, hq=8, hkv=8, n=5, m=5, d=64, dv=64)
    pick = lambda c, platform, **kw: attention.registry.resolve(  # noqa: E731
        c, shapes, platform, op="verify", **kw).name
    # the reference resolves xla_chunked on the CPU: the port's chunked,
    # whose chunk check a window of 5 never meets; on the card K1's
    # backend, whose kernel check is the only one a window meets
    assert pick(cfg, "cpu") == "chunked"
    assert pick(cfg, "cuda") == "cuda_fused"
    assert pick(cfg, "cpu", quant="int8") == "chunked"
    assert pick(cfg, "cuda", quant="int8") == "cuda_fused"
    def rows(platform):
        return {name: (ok, why) for name, ok, why in
                attention.registry.explain(cfg, shapes, platform,
                                           op="verify")}

    cpu = rows("cpu")
    assert cpu["chunked"][0] and cpu["cumsum"][0]
    assert not cpu["recurrent"][0] and "verify" in cpu["recurrent"][1]
    assert not cpu["fused_causal"][0]
    # no plain backend runs unpinned on the card; a pin reaches it
    cuda = rows("cuda")
    assert "pinned" in cuda["chunked"][1] and "pinned" in cuda["cumsum"][1]
    # verify launches no kernel, so K1's and K5a's backends say so, and
    # K1's refuses no shape its kernel alone would refuse
    verdict = ("pipeline.causal_verify: plain PyTorch carry-in verify "
               "(no kernel)")
    assert cuda["cuda_fused"] == (True, verdict)
    assert cuda["cuda_chunk"] == (True, verdict)
    assert cpu["chunked"] == (True, verdict)
    odd = dataclasses.replace(shapes, d=24, dv=40)
    assert attention.registry.resolve(cfg, odd, "cuda",
                                      op="verify").name == "cuda_fused"
    assert pick(dataclasses.replace(cfg, backend="plain"), "cuda") == "chunked"
    assert pick(dataclasses.replace(cfg, backend="cuda_chunk"),
                "cuda") == "cuda_chunk"
    with pytest.raises(attention.ResolutionError, match="competition"):
        pick(dataclasses.replace(cfg, use_competition=False), "cpu")
    with pytest.raises(attention.ResolutionError, match="TPU-only"):
        pick(cfg, "cuda", quant="fp8")


def test_explain_plan_reports_the_verify_section():
    shapes = attention.ShapeInfo(b=2, hq=4, hkv=4, n=5, m=5, d=16, dv=16)
    plan = attention.ExecutionPlan(flow=FlowConfig(), speculate_k=4)
    assert "speculate_k=4" in plan.describe()
    text = str(attention.explain(plan, shapes, platform="cpu"))
    assert "op='verify'" in text and "op='decode'" in text
    assert ("OK  chunked: pipeline.causal_verify: plain PyTorch carry-in "
            "verify (no kernel)") in text
    assert "no  recurrent: no verify_step" in text
    plain = str(attention.explain(dataclasses.replace(plan, speculate_k=0),
                                  shapes, platform="cpu"))
    assert "op='verify'" not in plain


def test_local_rings_are_refused_by_name():
    cfg = with_kind(get_smoke_config("flowformer_lm"), "local")
    plan = spec_plan(get_smoke_config("flowformer_lm"), 4)
    with pytest.raises(mixer_lib.MixerResolutionError,
                       match="missing verify_capable: ring buffer") as err:
        mixer_lib.resolve_mixer("attn", cfg, plan, "cpu")
    assert err.value.rejections[0][:2] == ("attn", "verify_capable")
    mx = mixer_lib.get_mixer("attn")
    with pytest.raises(mixer_lib.MixerResolutionError,
                       match="verify_capable"):
        mx.verify_step({}, torch.zeros((1, 2, 8)), None, cfg)
    assert mx.verify_capable(with_kind(cfg, "linear")) == (
        True, "trajectory rollback over scanned decode")
    for arch, kind in VARIANTS.values():
        c = get_smoke_config(arch)
        caps = mixer_lib.stack_capabilities(
            with_kind(c, kind) if kind else c, "cpu")
        assert caps["verify_capable"][0], arch


# ---------------------------------------------------------------------------
# lm.verify + lm.select_verified
# ---------------------------------------------------------------------------
#: logits against the reference, x max |logit|: the mamba2 stack stores
#: its conv histories in bf16 on both sides (``layers/ssd.py::CONV_DTYPE``),
#: and an element of layer 1's history that the two frameworks' fp32
#: inputs put on either side of a bf16 rounding boundary moves the logits:
#: one plain decode step here differs by 3.2e-4 of max |logit| (6e-7 with
#: fp32 histories on both sides), so its bound is 1e-3; the port against
#: its own sequential decodes stays at 1e-5
REF_RTOL = {"flow": 1e-5, "softmax": 1e-5, "mamba2": 1e-3}


def rows_of(caches, r):
    return [tree_map(lambda x: x[r:r + 1], c) for c in caches]


def test_lm_verify_and_rollback_match_reference(model):
    """Logits of a window of n = 4 from packed prompts of 6 and 9 tokens,
    then for every accepted index a of row 0 (row 1 at n - 1) the next
    decode's logits after ``select_verified``: against the port's own
    sequential decodes of the accepted tokens, and against the
    reference's verify and rollback."""
    name, jcfg, jparams, cfg, params = model
    b, n, max_len = 2, 4, 48
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (b, 9)).astype(np.int32)
    lens = np.array([6, 9], np.int32)
    win = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    t = torch.from_numpy

    def port_caches():
        with torch.no_grad():
            return lm.prefill(params, t(prompt), cfg, max_len, dtype=F32,
                              lengths=t(lens))[1]

    jcaches = jlm.prefill(jparams, jnp.asarray(prompt), jcfg, max_len,
                          dtype=jnp.float32, lengths=jnp.asarray(lens))[1]
    jlog, jpend = jlm.verify(jparams, jnp.asarray(win), jcaches, jcfg,
                             jnp.asarray(lens), dtype=jnp.float32)
    scale = float(np.abs(np.asarray(jlog)).max())
    tight = dict(rtol=1e-5, atol=1e-5 * scale)
    ref = dict(rtol=REF_RTOL[name], atol=REF_RTOL[name] * scale)
    with torch.no_grad():
        log, _ = lm.verify(params, t(win), port_caches(), cfg, t(lens),
                           dtype=F32)
        close(log, jlog, f"{name} verify logits", **ref)
        seq = port_caches()
        for j in range(n):
            lg, seq = lm.decode(params, t(win[:, j:j + 1]), seq, cfg,
                                t(lens + j), dtype=F32)
            close(log[:, j:j + 1], lg, f"{name} sequential {j}", **tight)
    for a in range(n):
        acc = np.array([a, n - 1])
        with torch.no_grad():
            _, pend = lm.verify(params, t(win), port_caches(), cfg, t(lens),
                                dtype=F32)
            sel = lm.select_verified(pend, t(acc), n, cfg)
            got, _ = lm.decode(params, t(nxt), sel, cfg, t(lens + acc + 1),
                               dtype=F32)
            for r in range(b):  # each row's accepted tokens, one by one
                c = rows_of(port_caches(), r)
                for j in range(acc[r] + 1):
                    _, c = lm.decode(params, t(win[r:r + 1, j:j + 1]), c,
                                     cfg, t(lens[r:r + 1] + j), dtype=F32)
                want, _ = lm.decode(params, t(nxt[r:r + 1]), c, cfg,
                                    t(lens[r:r + 1] + acc[r] + 1), dtype=F32)
                close(got[r:r + 1], want, f"{name} row {r} rollback to "
                      f"{acc[r]}", **tight)
        jsel = jlm.select_verified(jpend, jnp.asarray(acc), n, jcfg)
        jwant, _ = jlm.decode(jparams, jnp.asarray(nxt), jsel, jcfg,
                              jnp.asarray(lens + acc + 1), dtype=jnp.float32)
        close(got, jwant, f"{name} rollback to {a} vs reference", **ref)


# ---------------------------------------------------------------------------
# Worker.verify
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def flow_model():
    return both_models("flowformer_lm")


def admitted_worker(params, cfg, **kw):
    w = Worker(params, cfg, slots=2, max_len=64, dtype=F32, device="cpu",
               **kw)
    first = w.prefill([np.arange(1, 6, dtype=np.int32),
                       np.arange(2, 9, dtype=np.int32)], [0, 1],
                      np.zeros(2, np.float32))
    return w, first, np.array([5, 7])


def test_worker_verify_accepts_all_and_none(flow_model):
    _, _, cfg, params = flow_model
    temps, live, k = np.zeros(2, np.float32), np.array([True, True]), 3
    w, first, pos = admitted_worker(params, cfg)
    oracle_w, tok, p = admitted_worker(params, cfg)
    oracle = []
    for _ in range(k + 1):
        tok = oracle_w.step(tok, p, temps, live)
        oracle.append(tok)
        p = p + 1
    oracle = np.stack(oracle, axis=1)  # (2, k + 1)
    wrong = cfg.vocab_size - 1
    assert not np.any(oracle[1, :k] == wrong)
    drafts = np.stack([oracle[0, :k], np.full(k, wrong, np.int32)])
    emitted, accepted = w.verify(first, drafts, pos, temps, live)
    assert list(accepted) == [k, 0] and w.verify_windows == 1
    np.testing.assert_array_equal(emitted[0], oracle[0])  # k drafts + bonus
    assert emitted[1, 0] == oracle[1, 0] and not emitted[1, 1:].any()
    # ragged continuation in one batched step, each at its own offset
    cont = w.step(np.array([emitted[0, k], emitted[1, 0]], np.int32),
                  pos + accepted + 1, temps, live)
    assert cont[0] == oracle_w.step(tok, p, temps, live)[0]
    assert cont[1] == oracle[1, 1], "an accept-0 slot redoes pos + 1"
    # a dead slot emits zeros and accepts nothing it did not draft
    emitted, _ = w.verify(cont, drafts, pos + accepted + 2, temps,
                          np.array([True, False]))
    assert not emitted[1].any()


def test_scheduler_record_verify_truncates_at_eos_and_budget():
    sched = Scheduler(slots=2)
    r0 = Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                 max_new_tokens=10, eos_id=9)
    r1 = Request(uid=1, prompt=np.arange(4, dtype=np.int32),
                 max_new_tokens=3)
    for slot, r in ((0, r0), (1, r1)):
        r.generated.append(5)
        sched.activate(slot, r)
    freed = sched.record_verify(np.array([[7, 9, 8, 0], [6, 6, 6, 6]]),
                                np.array([2, 3]), np.array([True, True]))
    assert sorted(freed) == [0, 1]
    assert r0.generated == [5, 7, 9] and r1.generated == [5, 6, 6]
    assert r0.done and r1.done
    assert sched.pos[0] == 4 + 3 and sched.pos[1] == 4 + 4


# ---------------------------------------------------------------------------
# The Engine: speculative greedy == plain greedy == the JAX Engine
# ---------------------------------------------------------------------------
def generate(engine_cls, req_cls, params, cfg, *, eos=None, n_req=5, **kw):
    """The reference test's traffic (``tests/test_verify.py::_generate``):
    3 slots, max_len 96, prompts of 3-8 tokens, budgets 6 + uid."""
    engine = engine_cls(params, cfg, slots=3, max_len=96, **kw)
    rng = np.random.RandomState(0)
    for uid in range(n_req):
        prompt = rng.randint(1, cfg.vocab_size,
                             size=rng.randint(3, 9)).astype(np.int32)
        engine.submit(req_cls(uid=uid, prompt=prompt, max_new_tokens=6 + uid,
                              eos_id=eos))
    return {r.uid: r.generated for r in engine.run()}, engine


def port(params, cfg, **kw):
    return generate(Engine, Request, params, cfg, dtype=F32, device="cpu",
                    **kw)


ENGINE_VARIANTS = {"flow": ("flowformer_lm", None, None),
                   "paged": ("flowformer_lm", "softmax", 8),
                   "mamba2": ("mamba2_1p3b", None, None)}


@pytest.mark.parametrize("variant", list(ENGINE_VARIANTS))
def test_speculative_greedy_equals_plain_and_reference(variant):
    arch, kind, page = ENGINE_VARIANTS[variant]
    jcfg, jparams, cfg, params = both_models(arch, kind)
    paged = None if page is None else PagedSpec(page_size=page)
    want, _ = generate(JEngine, JRequest, jparams, jcfg, dtype=jnp.float32,
                       paged=None if page is None else JPagedSpec(page))
    plain, _ = port(params, cfg, paged=paged)
    assert plain == want, f"{variant}: plain port vs JAX"
    spec, engine = port(params, cfg, paged=paged, draft=SelfDraft(),
                        speculate_k=3)
    assert spec == want, f"{variant}: self-speculation diverged"
    windows = engine.worker.verify_windows
    assert engine.worker.decode_steps == 0 and windows > 0
    # greedy self-drafts are accepted whole: k + 1 tokens a live window,
    # so far fewer windows than decoded tokens
    assert windows * 2 < sum(len(g) - 1 for g in want.values())
    model, engine = port(params, cfg, paged=paged, draft=tiny_draft(cfg),
                         speculate_k=2)
    assert model == want, f"{variant}: model draft diverged"
    assert engine.draft.pool.admission_rounds == \
        engine.worker.admission_rounds


def test_int8_speculative_equals_fp32_plain(flow_model):
    """The reference's ``test_engine_int8_speculative_matches_fp32_plain``
    traffic (2 slots, 4 requests of 6 + 3 i tokens, 6 new): the int8
    verify windows roll back through ``QuantTraj``."""
    _, _, cfg, params = flow_model

    def run(state_dtype, k):
        engine = Engine(params, cfg, slots=2, max_len=96, dtype=F32,
                        state_dtype=state_dtype, speculate_k=k, device="cpu")
        rng = np.random.default_rng(1)
        for i in range(4):
            engine.submit(Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size, 6 + 3 * i).astype(np.int32),
                max_new_tokens=6))
        return [r.generated for r in sorted(engine.run(),
                                            key=lambda r: r.uid)], engine

    spec, engine = run("int8", 3)
    assert isinstance(engine.draft, SelfDraft)
    assert all(isinstance(c, quant.QuantizedPool)
               for c in engine.worker.caches)
    assert spec == run(None, 0)[0]


def test_rollback_quantizes_the_gathered_boundary_once(flow_model,
                                                       monkeypatch):
    _, _, cfg, params = flow_model
    w, first, pos = admitted_worker(params, cfg, state_dtype="int8",
                                    plan=spec_plan(cfg, 2))
    seen = []
    real = quant.quantize_state
    monkeypatch.setattr(quant, "quantize_state",
                        lambda s, *a, **kw: seen.append(s.s.shape)
                        or real(s, *a, **kw))
    w.verify(first, np.zeros((2, 2), np.int32), pos, np.zeros(2, np.float32),
             np.array([True, True]))
    # one quantization per layer, of the (slots, Hkv, D, Dv) boundary
    assert seen == [(2, cfg.kv_heads, cfg.dim_head, cfg.dim_head)] * \
        cfg.n_layers


def test_speculative_eos_retirement_matches_plain(flow_model):
    _, _, cfg, params = flow_model
    plain, _ = port(params, cfg)
    # an eos that occurs mid-stream, so the window's truncation runs
    eos = next(t for g in plain.values() for t in g[1:])
    want, _ = port(params, cfg, eos=eos)
    got, _ = port(params, cfg, eos=eos, draft="self", speculate_k=3)
    assert got == want
    assert any(g[-1] == eos and len(g) < 6 + uid for uid, g in got.items())


def test_paged_verify_reserves_the_draft_lookahead():
    cfg = with_kind(get_smoke_config("flowformer_lm"), "softmax")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = Engine(params, cfg, slots=2, max_len=64,
                    paged=PagedSpec(page_size=8), dtype=F32, draft="self",
                    speculate_k=4, device="cpu")
    alloc = engine.worker.allocator
    spans, real = [], alloc.admit
    alloc.admit = lambda slot, span: spans.append(span) or real(slot, span)
    ensured, real_ensure = [], alloc.ensure
    alloc.ensure = lambda slot, p: ensured.append(p) or real_ensure(slot, p)
    engine.submit(Request(uid=0, prompt=np.arange(1, 7, dtype=np.int32),
                          max_new_tokens=9))
    (done,) = engine.run()
    assert len(done.generated) == 9
    # 6 prompt + 9 budget - 1 + 4 lookahead = 18 tokens: 3 pages of 8,
    # mapped at admission, so no window maps a page past them
    assert spans == [18] and max(ensured) < 24
    assert alloc.free_pages == alloc.num_pages


def test_engine_speculative_options():
    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(slots=2, max_len=32, device="cpu")
    assert Engine(params, cfg, draft="self", **kw).speculate_k == 4
    e = Engine(params, cfg, speculate_k=2, **kw)
    assert isinstance(e.draft, SelfDraft) and e.speculate_k == 2
    assert e.worker.plan.speculate_k == 2
    assert Engine(params, cfg, **kw).draft is None
    with pytest.raises(ValueError, match="unknown draft source"):
        Engine(params, cfg, draft="big", **kw)


# ---------------------------------------------------------------------------
# The propose leaves the target's pools alone, also where decode writes
# them in place (the card's kernels; their CPU wrappers copy in place too)
# ---------------------------------------------------------------------------
@pytest.fixture
def kernel_routes_on_cpu(monkeypatch):
    """Let the kernel backends take the CPU: their wrappers then run the
    plain versions and copy the results into the pools in place, as the
    kernels update them on the card.  Launches on the CPU are not counted
    as kernel launches, so the count stays 0.  Verify, which runs no
    kernel, resolves K1's backend by the device check alone."""
    real = backends._check_kernel
    monkeypatch.setattr(backends, "_check_kernel",
                        lambda s, p: real(s, "cuda"))
    device = backends._check_device
    monkeypatch.setattr(backends, "_check_device", lambda p: device("cuda"))


@pytest.mark.parametrize("state_dtype", [None, "int8"])
def test_propose_leaves_in_place_pools_unchanged(flow_model, state_dtype,
                                                 kernel_routes_on_cpu):
    _, _, cfg, params = flow_model
    w, first, pos = admitted_worker(params, cfg, state_dtype=state_dtype)
    assert w.executor.backend("decode", attention.ShapeInfo(
        b=2, hq=4, hkv=4, n=1, m=1, d=32, dv=32), "cpu").name == \
        "cuda_decode"
    before = [t.clone() for t in quant._leaves(w.caches)]
    draft = SelfDraft()
    draft.install(w, 4)
    drafts = draft.propose(first, pos, np.array([True, True]))
    assert drafts.shape == (2, 4)
    for a, b in zip(quant._leaves(w.caches), before):
        assert torch.equal(a, b)
    # the copy is what advanced: a decode from the real pools reproduces
    # the first draft
    tok = w.step(first, pos, np.zeros(2, np.float32), np.array([True, True]))
    np.testing.assert_array_equal(tok, drafts[:, 0])


@pytest.mark.parametrize("state_dtype,draft", [(None, "self"),
                                               ("int8", "self"),
                                               (None, "tiny")])
def test_speculative_greedy_on_in_place_routes(flow_model, state_dtype, draft,
                                               kernel_routes_on_cpu):
    """As on the card: K1's and K3's (K4's) routes, their wrappers running
    the plain versions in place.  int8 speculation is held to fp32 plain
    decoding, as the reference holds it: a window rounds the pool once,
    at its accepted boundary, where int8 decoding rounds it every
    token."""
    _, _, cfg, params = flow_model
    reset_launches()
    plain, _ = port(params, cfg)
    spec, engine = port(params, cfg, state_dtype=state_dtype, draft=draft,
                        speculate_k=3)
    assert spec == plain
    assert engine.worker.executor.backend(
        "verify", attention.ShapeInfo(b=3, hq=4, hkv=4, n=4, m=4, d=32,
                                      dv=32), "cpu").name == "cuda_fused"
    assert not any(LAUNCHES.values())


# ---------------------------------------------------------------------------
# Temperature: rejection sampling, held to the distribution (the pattern
# and helpers of ``tests/test_torch_serving.py``)
# ---------------------------------------------------------------------------
TRIALS, TEMP, TV_BOUND = 1200, 0.05, 0.13


def total_variation(tokens, p_exact) -> float:
    counts = np.bincount(np.asarray(tokens), minlength=p_exact.size)
    return 0.5 * float(np.abs(counts / len(tokens) - p_exact).sum())


def tempered(logits, temp):
    return torch.softmax(logits.double() / temp, -1).numpy()


def draws_tv_percentile(p_draw, p_exact, q, runs=200) -> float:
    """The q-th percentile of the TV against ``p_exact`` of TRIALS numpy
    draws from ``p_draw``."""
    rng = np.random.default_rng(0)
    return float(np.percentile([total_variation(rng.choice(
        p_draw.size, TRIALS, p=p_draw / p_draw.sum()), p_exact)
        for _ in range(runs)], q))


def check_tv_power(logits):
    """Exact draws pass the bound (99th percentile); a greedy sampler and
    draws at a wrong temperature fail it (1st percentile)."""
    p_exact = tempered(logits, TEMP)
    assert draws_tv_percentile(p_exact, p_exact, 99) < TV_BOUND
    assert 1.0 - p_exact.max() > TV_BOUND  # the TV of a greedy sampler
    for wrong in (2 * TEMP, TEMP / 2, 1.0):
        assert draws_tv_percentile(tempered(logits, wrong), p_exact,
                                   1) > TV_BOUND, f"T = {wrong}"
    return p_exact

def test_rejection_sampling_draws_the_tempered_softmax(flow_model):
    """TRIALS slots with one prompt verify one self-drafted window at
    T = TEMP: each emitted first token is one draw.  Accepting the draft
    must happen at rate p(d0), a rejecting slot must never re-emit d0,
    and the TV of the draws against softmax(logits / T) stays under the
    bound, which the two wrong samplers exceed: always accepting (TV
    1 - p(d0)) and a correction that may re-emit the rejected draft
    (drawn from p unmasked: TV p(d0) (1 - p(d0)))."""
    _, _, cfg, params = flow_model
    prompt = np.arange(1, 8, dtype=np.int32)
    w = Worker(params, cfg, slots=TRIALS, max_len=64, seed=5, dtype=F32,
               device="cpu", plan=spec_plan(cfg, 2))
    live = np.ones(TRIALS, bool)
    first = w.prefill([prompt] * TRIALS, list(range(TRIALS)),
                      np.zeros(TRIALS, np.float32))
    pos = np.full(TRIALS, len(prompt))
    with torch.no_grad():  # the next token's logits, by a plain prefill
        logits, _ = lm.prefill(w.params, torch.from_numpy(
            np.append(prompt, first[0]))[None], cfg, 64, dtype=F32)
    p_exact = check_tv_power(logits[0, -1])
    draft = SelfDraft()
    draft.install(w, 2)
    drafts = draft.propose(first, pos, live)
    d0 = int(drafts[0, 0])
    assert (drafts[:, 0] == d0).all() and d0 == int(p_exact.argmax())
    p0 = float(p_exact[d0])
    assert 1.0 - p0 > TV_BOUND and p0 * (1.0 - p0) > TV_BOUND
    wrong = p_exact * (1.0 - p0)
    wrong[d0] += p0
    assert draws_tv_percentile(wrong, p_exact, 1) > TV_BOUND
    emitted, accepted = w.verify(first, drafts, pos,
                                 np.full(TRIALS, TEMP, np.float32), live)
    tok = emitted[:, 0]
    assert (tok[accepted > 0] == d0).all()
    assert (tok[accepted == 0] != d0).all()
    assert abs((accepted > 0).mean() - p0) < 0.06
    tv = total_variation(tok, p_exact)
    assert tv < TV_BOUND, f"rejection sampling TV {tv:.3f}"


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [["--draft", "self", "--speculate-k", "4"],
                                  ["--speculate-k", "2"],
                                  ["--draft", "tiny", "--state-dtype",
                                   "int8"]])
def test_serve_cli_runs_speculative_decoding(argv, capsys):
    res = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                      "--max-new", "5", "--prompt-len", "8", *argv])
    assert all(r.done and len(r.generated) == 5 for r in res["requests"])
    k = 2 if "2" in argv else 4
    assert res["plan"].speculate_k == k
    text = capsys.readouterr().out
    assert f"speculate_k={k}" in text and f"speculative: k={k}" in text
    assert type(res["draft"]).__name__ in text

