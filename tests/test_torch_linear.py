"""Port vs reference: the linear-attention branch (``attention.kind =
"linear"``, Katharopoulos et al., the paper's ablation baseline).

The same numpy inputs and the same parameters (``repro`` inits carried
across with ``interop.params_from_numpy``) go through the JAX package and
the port on the CPU, in fp32:

* ``_linear_attn`` causal (the chunked scan at chunk 16 and the cumsum at
  ``chunk_size=0``) and non-causal, at G = 1 and 2, against
  ``repro.layers.attention._linear_attn``; the K5a glue's padded routes
  (``chunk_size=0`` at K5a's own chunk, D = Dv = 24 padded to 32) with
  gradients against the plain cumsum dot; all at rtol 2e-4, atol 2e-5;
* a packed prefill's ``LinearState`` (``lengths``) and ten decode steps
  from it, against the reference's layer, at rtol = atol = 1e-4;
* the fp32 ``Engine`` at the ``flowformer_lm`` smoke config with
  ``kind="linear"``, token-exact against the JAX ``Engine``;
* speculative verify and rollback of a linear model (``lm.verify``,
  ``select_verified`` at every accepted index) against sequential decode,
  at 1e-5 of max |logit|, and against the reference's at 1e-4;
* int8 ``LinearState`` pools: one decode step from the same int8 pool
  (payload and scales carried across) against the reference's layer, at
  rtol = atol = 1e-4 on the output and within one int8 step of each
  payload (the requantized scales at rtol 1e-5); the int8 Engine against
  the port's fp32 Engine, its first generated token per request equal and
  every greedy token's fp32 logit within 5e-2 of max |logit| of the fp32
  path's teacher-forced logit.  The reference's own Engine comparison
  (``test_quant_pools.py::test_engine_int8_positional_pools_match_fp32
  [linear]``) fails under this sandbox's jax 0.9.0, so the port's int8
  Engine is held to its own fp32 path, and to the reference only at the
  layer's decode step, which the reference runs here;
* the mixer's verdicts, string for string the reference's;
* the serve CLI with ``--attn linear`` on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import mixer as jmixer  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import quant as jquant  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.attention._cuda import chunked_causal_dot_cuda  # noqa: E402
from repro_torch.attention.dots import causal_dot_grouped  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels._lib import kernel_chunk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.layers import attention as attn  # noqa: E402
from repro_torch.layers import mixer as mixer_lib  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import quant  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

F32 = torch.float32
RTOL, ATOL = 2e-4, 2e-5
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)


def close(a, b, what="", **tol):
    tol = tol or dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=what, **tol)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def with_kind(cfg, kind="linear"):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind))


@pytest.fixture(scope="module")
def layer():
    """A linear attention layer of the smoke LM at G = 2 (4 query heads
    over 2 kv heads of 16), both sides' parameters."""
    over = dict(d_model=64, n_heads=4, n_kv_heads=2)
    jcfg = dataclasses.replace(with_kind(j_smoke_config("flowformer_lm")),
                               **over)
    cfg = dataclasses.replace(with_kind(get_smoke_config("flowformer_lm")),
                              **over)
    jp = jax.tree.map(np.asarray, jattn.attn_init(jax.random.PRNGKey(3),
                                                  jcfg))
    return jcfg, jp, cfg, tree_map(t, jp)


@pytest.fixture(scope="module")
def weights():
    jcfg = with_kind(j_smoke_config("flowformer_lm"))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    cfg = with_kind(get_smoke_config("flowformer_lm"))
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("causal,chunk", [(True, 16), (True, 0),
                                          (False, 16)])
def test_linear_attn_matches_reference(g, causal, chunk):
    rng = np.random.default_rng(g + chunk + int(causal))
    b, hkv, n, d = 2, 2, 64, 16
    q = rng.standard_normal((b, hkv * g, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, n, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, n, d)).astype(np.float32)
    want = jattn._linear_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, chunk_size=chunk)
    before = dict(LAUNCHES)
    got = attn._linear_attn(t(q), t(k), t(v), causal=causal, chunk_size=chunk)
    assert dict(LAUNCHES) == before
    close(got, want, f"causal={causal} chunk={chunk} G={g}")


@pytest.mark.parametrize("d,dv,chunk", [(24, 24, 0), (24, 24, 16),
                                        (32, 24, 0), (64, 64, 0)])
def test_k5_glue_padded_routes_match_the_cumsum_dot(d, dv, chunk):
    """``chunked_causal_dot_cuda`` (``FlowChunkDot``, whose K5a and K5b run
    their plain versions on the CPU) at ``chunk_size=0`` and at D or Dv =
    24, forward and gradients, against the plain cumsum dot."""
    assert kernel_chunk(50, 0, d, dv) == 64
    assert kernel_chunk(50, 0, 128, 24) == 32
    assert kernel_chunk(50, 16, d, dv) == 16
    assert kernel_chunk(8, 16, d, dv) == 8
    rng = np.random.default_rng(d + dv + chunk)
    b, h, g, n = 2, 2, 2, 50
    qg = torch.sigmoid(t(rng.standard_normal((b, h, g, n, d))).float())
    k = torch.sigmoid(t(rng.standard_normal((b, h, n, d))).float())
    v = t(rng.standard_normal((b, h, n, dv))).float()
    cot = t(rng.standard_normal((b, h, g, n, dv))).float()
    leaves = [x.clone().requires_grad_(True) for x in (qg, k, v)]
    plain = [x.clone().requires_grad_(True) for x in (qg, k, v)]
    out = chunked_causal_dot_cuda(*leaves, chunk=chunk)
    want = causal_dot_grouped(*plain, chunk_size=0, use_kernel=False)
    assert out.shape == want.shape
    close(out.detach(), want.detach(), "out")
    for x, a, w in zip("qkv", torch.autograd.grad(out, leaves, cot),
                       torch.autograd.grad(want, plain, cot)):
        close(a, w, f"d{x}")


def test_prefill_state_and_ten_decode_steps_match_reference(layer):
    jcfg, jp, cfg, p = layer
    rng = np.random.default_rng(11)
    b, n = 3, 12
    x = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
    lengths = np.array([12, 5, 1], np.int32)
    jout, jst = jattn._attention_prefill(jp, jnp.asarray(x), jcfg, 32,
                                         lengths=jnp.asarray(lengths))
    out, st = attn._attention_prefill(p, t(x), cfg, 32, lengths=t(lengths))
    assert isinstance(st, attn.LinearState)
    assert st.s.shape == (b, 4, 16, 16) and st.z.shape == (b, 4, 16)
    for i, li in enumerate(lengths):
        close(out[i, :li], np.asarray(jout)[i, :li], f"row {i}", **LAYER_TOL)
    for name in ("s", "z", "pos"):
        close(getattr(st, name), np.asarray(getattr(jst, name)), name,
              **LAYER_TOL)
    for step in range(10):
        tok = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jy, jst = jattn._attention_decode(jp, jnp.asarray(tok), jst, jcfg)
        y, st = attn._attention_decode(p, t(tok), st, cfg)
        close(y, jy, f"decode {step}", **LAYER_TOL)
        for name in ("s", "z", "pos"):
            close(getattr(st, name), np.asarray(getattr(jst, name)),
                  f"decode {step} {name}", **LAYER_TOL)
    fresh = attn._attn_cache_init(cfg, 2, 32, device="cpu")
    jfresh = jattn._attn_cache_init(jcfg, 2, 32)
    for a, w in zip(fresh, jfresh):
        assert a.shape == w.shape and not a.any()


def linear_pool(jpool):
    """The port's ``QuantizedPool`` of a reference int8 LinearState pool,
    payload and scales copied bit for bit."""
    state = lambda tree: attn.LinearState(*(t(np.asarray(x))  # noqa: E731
                                            for x in tree))
    return quant.QuantizedPool(state(jpool.payload), state(jpool.scale),
                               quant.spec_of("int8"), "head", ())


def test_int8_decode_step_matches_reference_layer(layer):
    """One decode step from the same int8 LinearState pool: dequantize,
    fp32 update, requantize with a fresh per-(slot, head) amax."""
    jcfg, jp, cfg, p = layer
    rng = np.random.default_rng(12)
    b = 3
    x = rng.standard_normal((b, 9, cfg.d_model)).astype(np.float32)
    _, jst = jattn._attention_prefill(jp, jnp.asarray(x), jcfg, 32)
    plan = attn.plan_of(cfg, state_dtype="int8")
    jpool = jquant.quantize_state(jst, jquant.spec_of("int8"))
    pool = linear_pool(jpool)
    assert isinstance(quant.maybe_quantize(attn.LinearState(
        *(t(np.asarray(v)) for v in jst)), plan), quant.QuantizedPool)
    for step in range(3):
        tok = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jy, jpool = jattn._attention_decode(jp, jnp.asarray(tok), jpool, jcfg)
        y, pool = attn._attention_decode(p, t(tok), pool, cfg)
        assert isinstance(pool, quant.QuantizedPool)
        close(y, jy, f"step {step} out", **LAYER_TOL)
        for name in ("s", "z"):
            a = getattr(pool.payload, name).int()
            w = np.asarray(getattr(jpool.payload, name)).astype(np.int32)
            assert a.dtype == torch.int32 and np.abs(a.numpy() - w).max() <= 1
            close(getattr(pool.scale, name),
                  np.asarray(getattr(jpool.scale, name)), f"{name} scale",
                  rtol=1e-5, atol=0)
        assert torch.equal(pool.payload.pos, t(jpool.payload.pos))
        pool = linear_pool(jpool)  # teacher-forced from the reference's pool


PROMPT_LENS = (5, 17, 9, 30, 3, 12)
BUDGETS = (4, 7, 1, 5, 6, 3)


def prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def serve_all(engine, request_cls, vocab):
    for uid, (prompt, budget) in enumerate(zip(prompts(vocab), BUDGETS)):
        engine.submit(request_cls(uid=uid, prompt=prompt,
                                  max_new_tokens=budget))
    return engine.run()


def test_fp32_engine_is_token_exact_against_the_jax_engine(weights):
    jcfg, jparams, cfg, params = weights
    j_done = serve_all(JEngine(jparams, jcfg, slots=2, max_len=64,
                               dtype=jnp.float32), JRequest, cfg.vocab_size)
    engine = Engine(params, cfg, slots=2, max_len=64, dtype=F32, device="cpu")
    assert isinstance(engine.worker.caches[0], attn.LinearState)
    done = serve_all(engine, Request, cfg.vocab_size)
    assert [r.uid for r in done] == [r.uid for r in j_done]
    for r, jr in zip(done, j_done):
        assert r.done and len(r.generated) == BUDGETS[r.uid]
        assert r.generated == jr.generated, f"request {r.uid}"
    assert engine.worker.admission_rounds >= 3


def test_int8_engine_against_the_fp32_path(weights):
    """The int8 Engine's generations, each teacher-forced through the fp32
    path: every greedy token's fp32 logit within 5e-2 of max |logit| of
    that step's maximum (int8 rounding of s and z moves the logits by
    ~1e-3 of their size at this scale), and the first token, which the
    packed prefill gives before any requantization, equal."""
    _, _, cfg, params = weights
    engine = Engine(params, cfg, slots=2, max_len=64, dtype=F32,
                    device="cpu", state_dtype="int8")
    assert isinstance(engine.worker.caches[0], quant.QuantizedPool)
    assert engine.worker.caches[0].payload.s.dtype == torch.int8
    done = serve_all(engine, Request, cfg.vocab_size)
    fp32 = {r.uid: r.generated for r in serve_all(
        Engine(params, cfg, slots=2, max_len=64, dtype=F32, device="cpu"),
        Request, cfg.vocab_size)}
    for r in done:
        assert r.done and len(r.generated) == BUDGETS[r.uid]
        assert r.generated[0] == fp32[r.uid][0], f"request {r.uid}"
        seq = np.concatenate([prompts(cfg.vocab_size)[r.uid],
                              np.array(r.generated[:-1], np.int32)])
        with torch.no_grad():
            logits, _ = lm.forward(params, t(seq)[None], cfg, dtype=F32)
        n0 = len(prompts(cfg.vocab_size)[r.uid]) - 1
        for j, tok in enumerate(r.generated):
            row = logits[0, n0 + j]
            gap = float(row.max() - row[tok])
            assert gap <= 5e-2 * float(row.abs().max()), (r.uid, j, gap)


def rows_of(caches, r):
    def row(c):
        if isinstance(c, quant.QuantizedPool):
            return c.with_state(row(c.payload), row(c.scale))
        return tree_map(lambda x: x[r:r + 1], c)

    return [row(c) for c in caches]


@pytest.mark.parametrize("state_dtype", [None, "int8"])
def test_verify_and_rollback_match_sequential_decode(weights, state_dtype):
    """``lm.verify`` of a window of n = 4 after packed prompts of 6 and 9
    tokens (the generic scanned-decode trajectory), then for every
    accepted index the next decode after ``select_verified``: against the
    port's own sequential decodes (the same int8 requantizations in the
    same order), and for fp32 against the reference's verify and
    rollback."""
    jcfg, jparams, cfg, params = weights
    b, n, max_len = 2, 4, 48
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (b, 9)).astype(np.int32)
    lens = np.array([6, 9], np.int32)
    win = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    plan = attn.plan_of(cfg, state_dtype=state_dtype)
    assert mixer_lib.stack_capabilities(cfg, "cpu")["verify_capable"][0]

    def caches():
        with torch.no_grad():
            cs = lm.prefill(params, t(prompt), cfg, max_len, dtype=F32,
                            lengths=t(lens))[1]
        return [quant.maybe_quantize(c, plan) for c in cs]

    jcaches = jlm.prefill(jparams, jnp.asarray(prompt), jcfg, max_len,
                          dtype=jnp.float32, lengths=jnp.asarray(lens))[1]
    jlog, jpend = jlm.verify(jparams, jnp.asarray(win), jcaches, jcfg,
                             jnp.asarray(lens), dtype=jnp.float32)
    scale = float(np.abs(np.asarray(jlog)).max())
    tight = dict(rtol=1e-5, atol=1e-5 * scale)
    ref = dict(rtol=1e-4, atol=1e-4 * scale)
    with torch.no_grad():
        log, pend = lm.verify(params, t(win), caches(), cfg, t(lens),
                              dtype=F32)
        if state_dtype is None:
            close(log, jlog, "verify logits", **ref)
        else:
            assert isinstance(pend[0], quant.QuantizedPool)
            assert pend[0].payload.s.shape[1] == n  # the window axis
        seq = caches()
        for j in range(n):
            lg, seq = lm.decode(params, t(win[:, j:j + 1]), seq, cfg,
                                t(lens + j), dtype=F32)
            close(log[:, j:j + 1], lg, f"sequential {j}", **tight)
    for a in range(n):
        acc = np.array([a, n - 1])
        with torch.no_grad():
            _, pend = lm.verify(params, t(win), caches(), cfg, t(lens),
                                dtype=F32)
            sel = lm.select_verified(pend, t(acc), n, cfg)
            got, _ = lm.decode(params, t(nxt), sel, cfg, t(lens + acc + 1),
                               dtype=F32)
            for r in range(b):
                c = rows_of(caches(), r)
                for j in range(acc[r] + 1):
                    _, c = lm.decode(params, t(win[r:r + 1, j:j + 1]), c,
                                     cfg, t(lens[r:r + 1] + j), dtype=F32)
                want, _ = lm.decode(params, t(nxt[r:r + 1]), c, cfg,
                                    t(lens[r:r + 1] + acc[r] + 1), dtype=F32)
                close(got[r:r + 1], want, f"row {r} rollback to {acc[r]}",
                      **tight)
        if state_dtype is None:
            jsel = jlm.select_verified(jpend, jnp.asarray(acc), n, jcfg)
            jwant, _ = jlm.decode(jparams, jnp.asarray(nxt), jsel, jcfg,
                                  jnp.asarray(lens + acc + 1),
                                  dtype=jnp.float32)
            close(got, jwant, f"rollback to {a} vs reference", **ref)


def test_mixer_verdicts_match_the_references_strings():
    """``verify_capable`` and ``quant_capable`` per kind, string for string
    the reference's (``repro/layers/attention.py:755-776``)."""
    jmx = jmixer.get_mixer("attn")
    mx = mixer_lib.get_mixer("attn")
    for kind in ("flow", "softmax", "linear", "local"):
        jcfg = with_kind(j_smoke_config("flowformer_lm"), kind)
        cfg = with_kind(get_smoke_config("flowformer_lm"), kind)
        for dtype in ("int8", "fp8"):
            assert mx.quant_capable(cfg, "cuda", dtype) == \
                jmx.quant_capable(jcfg, "cuda", dtype), (kind, dtype)
        if kind in ("local", "linear"):
            assert mx.verify_capable(cfg) == jmx.verify_capable(jcfg), kind
    linear = with_kind(get_smoke_config("flowformer_lm"))
    assert mx.quant_capable(linear, "cuda", "int8") == (
        True, "dequantize/requantize around the O(d^2) update (int8 payload "
        "+ fp32 scales)")
    assert mx.verify_capable(linear) == (
        True, "trajectory rollback over scanned decode")


@pytest.mark.parametrize("backend,use_kernel", [
    ("auto", None), ("cuda_chunk", None), ("cuda_fused", None),
    ("plain", False), ("cumsum", False), ("chunked", False)])
def test_linear_dot_follows_the_plans_plain_pin(monkeypatch, layer, backend,
                                                use_kernel):
    """The linear branch's causal dot takes its choice from the plan: a
    plan that pins plain PyTorch (``"plain"`` or a plain backend by name)
    keeps to the plain dot, any other leaves it to the tensor's device
    (K5a on the card); the same for a plan bound once and passed along."""
    _, _, cfg, params = layer
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend=backend))
    seen = []

    def spy(*args, use_kernel=None):
        seen.append(use_kernel)
        return causal_dot_grouped(*args, use_kernel=use_kernel)

    monkeypatch.setattr(attn, "causal_dot_grouped", spy)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    for plan in (None, attn.executor_of(cfg, attn.plan_of(cfg))):
        attn.attention(params, x, cfg, causal=True, plan=plan)
        attn._attention_prefill(params, x, cfg, 16, plan=plan)
    assert seen == [use_kernel] * 4


@pytest.mark.parametrize("state_dtype", [None, "int8"])
def test_serve_cli_serves_linear_on_the_cpu(capsys, state_dtype):
    extra = ["--state-dtype", state_dtype] if state_dtype else []
    res = serve.main(["--attn", "linear", "--smoke", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--max-new", "3",
                      "--prompt-len", "10", *extra])
    assert all(r.done and len(r.generated) == 3 for r in res["requests"])
    assert "[serve] mixers: attn" in capsys.readouterr().out
