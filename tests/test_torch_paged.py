"""Port vs reference: the softmax baseline served from paged KV pools.

The same numpy inputs go through ``repro`` (the reference: its page-table
gathers as Pallas kernels in interpret mode and as the off-TPU XLA gather,
its softmax attention, LM and ``Engine``) and through their counterparts
in ``repro_torch``, in fp32 on the CPU.

Tolerances:
  * the plain page-table gathers (K8a, K8b): exact -- a copy, and one
    fp32 product rounded once;
  * ``PageAllocator`` tables, free lists and install indices: exact;
  * ``_softmax_attn``: rtol 1e-5, atol 1e-6 -- the same fp32 products and
    softmax, summed in another order;
  * LM logits, and K/V caches written from the projections: rtol and atol
    1e-4, as ``tests/test_torch_lm.py`` (the fp32 residual stream of two
    layers, summed in another order);
  * int8 caches: payloads within one LSB with at most a share of 1e-3 of
    the entries differing, scales rtol 1e-5, as
    ``tests/test_torch_quant.py``;
  * greedy Engine tokens: exact.

The port's paged pools hold one page more than the reference's: a trash
page at index P that takes the sentinel's writes (``serving/paged.py``).
Pools are compared on their first P pages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.kernels.gather import paged_gather as j_paged_gather  # noqa: E402
from repro.kernels.gather import paged_gather_quant as j_paged_gather_quant  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers.attention import plan_of as j_plan_of  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import quant as jquant  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.paged import PageAllocator as JPageAllocator  # noqa: E402
from repro.serving.paged import PagedSpec as JPagedSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import (kv_pool_from_numpy,  # noqa: E402
                                 params_from_numpy, params_to_numpy)
from repro_torch.kernels.gather import (paged_gather_quant_ref,  # noqa: E402
                                        paged_gather_ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.layers import attention as attn  # noqa: E402
from repro_torch.layers import mixer as mixer_lib  # noqa: E402
from repro_torch.layers.attention import KVCache, plan_of  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import quant  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.paged import (PageAllocator, PagedKVCache,  # noqa: E402
                                       PagedSpec)

F32 = torch.float32
TOL = dict(rtol=1e-4, atol=1e-4)


def softmax_cfg(cfg, **attn_over):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind="softmax", **attn_over))


def close(a, b, what="", **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=what,
                               **(tol or TOL))


def as_np(x):
    """A torch tensor or a jax array as a float32 (or integer) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)
    return x


# ---------------------------------------------------------------------------
# K8a, K8b: the plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------
# D = Dv, D != Dv, and a page size that is not a multiple of 4 with widths
# that are not multiples of 16 (runs K8b's copy engine does not take)
GEOMETRIES = [(6, 2, 4, 8, 8, 3, 3), (5, 1, 8, 16, 32, 2, 4),
              (7, 2, 5, 24, 40, 3, 3)]
J_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def gather_case(seed, p, hkv, page, d, dv, b, mp):
    """Pools of P pages and a shuffled, partly mapped table: a row of
    sentinels (a dead slot) and sentinels at the tail of the others."""
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((p, hkv, page, d)).astype(np.float32)
    vc = rng.standard_normal((p, hkv, page, dv)).astype(np.float32)
    table = np.stack([rng.permutation(p)[:mp] for _ in range(b)]).astype(
        np.int32)
    table[0, mp - 1:] = p  # an unmapped tail
    table[-1, :] = p  # a dead slot
    return kc, vc, table


@pytest.mark.parametrize("interpret", [True, None], ids=["pallas", "xla"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=["d_eq_dv", "d_ne_dv", "odd"])
def test_paged_gather_ref_matches_reference(geom, dtype, interpret):
    kc, vc, table = gather_case(1, *geom)
    jd = J_DTYPES[dtype]
    jk, jv = j_paged_gather(jnp.asarray(kc, jd), jnp.asarray(vc, jd),
                            jnp.asarray(table), interpret=interpret)
    k, v = paged_gather_ref(torch.from_numpy(kc).to(dtype),
                            torch.from_numpy(vc).to(dtype),
                            torch.from_numpy(table))
    assert k.dtype == dtype and k.shape == jk.shape and v.shape == jv.shape
    np.testing.assert_array_equal(as_np(k), as_np(jk))
    np.testing.assert_array_equal(as_np(v), as_np(jv))


@pytest.mark.parametrize("interpret", [True, None], ids=["pallas", "xla"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=["d_eq_dv", "d_ne_dv", "odd"])
def test_paged_gather_quant_ref_matches_reference(geom, out_dtype, interpret):
    kc, vc, table = gather_case(2, *geom)
    rng = np.random.default_rng(3)
    kq = rng.integers(-127, 128, kc.shape).astype(np.int8)
    vq = rng.integers(-127, 128, vc.shape).astype(np.int8)
    ks = rng.uniform(1e-3, 1e-1, kc.shape[:3] + (1,)).astype(np.float32)
    vs = rng.uniform(1e-3, 1e-1, vc.shape[:3] + (1,)).astype(np.float32)
    jk, jv = j_paged_gather_quant(
        *(jnp.asarray(x) for x in (kq, vq, ks, vs, table)),
        out_dtype=J_DTYPES[out_dtype], interpret=interpret)
    k, v = paged_gather_quant_ref(
        *(torch.from_numpy(x) for x in (kq, vq, ks, vs, table)),
        out_dtype=out_dtype)
    assert k.dtype == out_dtype and k.shape == jk.shape
    np.testing.assert_array_equal(as_np(k), as_np(jk))
    np.testing.assert_array_equal(as_np(v), as_np(jv))


# ---------------------------------------------------------------------------
# The allocator
# ---------------------------------------------------------------------------
def test_page_allocator_matches_reference():
    spec, jspec = PagedSpec(page_size=4, num_pages=9), JPagedSpec(4, 9)
    ours, ref = PageAllocator(spec, 3, 14), JPageAllocator(jspec, 3, 14)
    script = [("admit", 0, 7), ("admit", 1, 1), ("ensure", 1, 4),
              ("install", [0, 1], [7, 1], 8), ("release", 0),
              ("admit", 2, 13), ("ensure", 2, 13), ("ensure", 2, 40),
              ("admit", 0, 3), ("ensure", 0, 3), ("install", [2, 0], [13, 3],
                                                  16),
              ("release", 1), ("release", 2), ("release", 0)]
    for op, *args in script:
        if op == "install":
            for got, want in zip(ours.install_indices(*args),
                                 ref.install_indices(*args)):
                np.testing.assert_array_equal(got, want)
        else:
            getattr(ours, op)(*args)
            getattr(ref, op)(*args)
        np.testing.assert_array_equal(ours.table, ref.table)
        assert ours.free == ref.free and ours.free_pages == ref.free_pages
        np.testing.assert_array_equal(ours.mapped, ref.mapped)
        assert ours.can_admit(17) == ref.can_admit(17)
    assert ours.free_pages == ours.num_pages == 9
    with pytest.raises(RuntimeError, match="exhausted"):
        ours.admit(0, 37)


# ---------------------------------------------------------------------------
# The softmax branch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hq,hkv,n,m,causal,softcap,q_offset,masked", [
    (4, 4, 9, 9, True, 0.0, 0, False),
    (4, 2, 9, 9, True, 0.0, 0, False),  # G = 2
    (4, 2, 5, 12, True, 5.0, 7, False),  # softcap, a query offset
    (2, 2, 1, 16, False, 0.0, 0, True),  # decode: kv_len masks the tail
    (4, 2, 3, 16, False, 3.0, 0, True),
])
def test_softmax_attn_matches_reference(hq, hkv, n, m, causal, softcap,
                                        q_offset, masked):
    rng = np.random.default_rng(5)
    b, d = 3, 16
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, m, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, m, 24)).astype(np.float32)
    kv_len = np.array([[m], [1], [m // 2]], np.int32) if masked else None
    want = jattn._softmax_attn(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, softcap=softcap,
        q_offset=q_offset,
        kv_len=None if kv_len is None else jnp.asarray(kv_len))
    got = attn._softmax_attn(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        softcap=softcap, q_offset=q_offset,
        kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    assert got.shape == want.shape
    close(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=[0, 2], ids=["mha", "gqa"])
def model(request):
    """The smoke softmax LM on both sides, same weights (n_kv_heads 2 of
    4 query heads for GQA)."""
    over = {"n_kv_heads": request.param} if request.param else {}
    jcfg = softmax_cfg(dataclasses.replace(j_smoke_config("flowformer_lm"),
                                           **over))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    cfg = softmax_cfg(dataclasses.replace(get_smoke_config("flowformer_lm"),
                                          **over))
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


def ids(rng, cfg, *shape):
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_softmax_params_carry_across_unchanged(model):
    jcfg, jparams, cfg, params = model
    tree = jax.tree.map(np.asarray, jparams)
    assert set(params["blocks"][0]["attn"]) == {"wq", "wk", "wv", "wo"}
    back = params_to_numpy(params, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_softmax_forward_matches_reference(model):
    jcfg, jparams, cfg, params = model
    seq = ids(np.random.default_rng(1), cfg, 2, 37)
    want, _ = jlm.forward(jparams, jnp.asarray(seq), jcfg, dtype=jnp.float32)
    got, _ = lm.forward(params, torch.from_numpy(seq), cfg, dtype=F32)
    close(got, want, "forward logits")


def packed_prompts(rng, cfg, lengths, n):
    toks = ids(rng, cfg, len(lengths), n)
    for i, li in enumerate(lengths):
        toks[i, li:] = 0
    return toks


def test_packed_prefill_and_dense_decode_match_reference(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(2)
    n, max_len = 16, 24
    lengths = np.array([16, 5, 11], np.int32)
    toks = packed_prompts(rng, cfg, lengths, n)
    j_logits, j_caches = jlm.prefill(jparams, jnp.asarray(toks), jcfg,
                                     max_len=max_len, dtype=jnp.float32,
                                     lengths=jnp.asarray(lengths))
    logits, caches = lm.prefill(params, torch.from_numpy(toks), cfg,
                                max_len=max_len, dtype=F32,
                                lengths=torch.from_numpy(lengths))
    close(logits, j_logits, "prefill logits")
    for c, jc in zip(caches, j_caches):
        assert isinstance(c, KVCache) and c.k.shape == jc.k.shape
        close(c.k, jc.k, "prefill k")
        close(c.v, jc.v, "prefill v")
        np.testing.assert_array_equal(as_np(c.pos), lengths)
    # decode 10 steps: the longest row reaches the cache's end and clamps
    pos = lengths.copy()
    for s in range(10):
        tok = ids(rng, cfg, 3, 1)
        j_logits, j_caches = jlm.decode(jparams, jnp.asarray(tok), j_caches,
                                        jcfg, jnp.asarray(pos),
                                        dtype=jnp.float32)
        logits, caches = lm.decode(params, torch.from_numpy(tok), caches,
                                   cfg, torch.from_numpy(pos), dtype=F32)
        close(logits, j_logits, f"decode logits step {s}")
        pos = pos + 1
    for c, jc in zip(caches, j_caches):
        close(c.k, jc.k, "decoded k")
        np.testing.assert_array_equal(as_np(c.pos), as_np(jc.pos))


def random_pages(seed, jcfg, slots, max_len, page, num_pages, state_dtype):
    """A reference paged pool per layer, filled with random K/V (and for
    int8 quantized with the serving recipe), a table with a dead slot and
    a slot at its row's capacity, and per-slot positions."""
    rng = np.random.default_rng(seed)
    spec = JPagedSpec(page, num_pages)
    alloc = JPageAllocator(spec, slots, max_len)
    pos = np.array([5, 0, max_len + 3, 17][:slots], np.int32)
    for slot, p in enumerate(pos):
        if slot != 1:  # slot 1 is dead: its row stays all sentinel
            alloc.admit(slot, min(int(p) + 1, max_len))
    plan = j_plan_of(jcfg, paged=spec, state_dtype=state_dtype)
    caches = []
    for c in jlm.init_caches(jcfg, slots, max_len, plan=plan,
                             dtype=jnp.float32):
        store = c.payload if isinstance(c, jquant.QuantizedPool) else c
        k = rng.standard_normal(store.k.shape).astype(np.float32)
        v = rng.standard_normal(store.v.shape).astype(np.float32)
        full = type(store)(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        caches.append(jquant.maybe_quantize(full, plan))
    return caches, alloc.table.copy(), pos


def port_pool(jc):
    tree = lambda t: [np.asarray(x) for x in t]  # noqa: E731
    if isinstance(jc, jquant.QuantizedPool):
        return kv_pool_from_numpy(tree(jc.payload), tree(jc.scale),
                                  paged=True)
    return kv_pool_from_numpy(tree(jc), paged=True)


def assert_int8_close(got, want, what):
    got, want = as_np(got).astype(np.int32), as_np(want).astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, what


@pytest.mark.parametrize("state_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_paged_decode_matches_reference(model, state_dtype):
    jcfg, jparams, cfg, params = model
    slots, max_len, page, num_pages = 4, 20, 4, 14
    j_caches, table, pos = random_pages(6, jcfg, slots, max_len, page,
                                        num_pages, state_dtype)
    caches = [port_pool(c) for c in j_caches]
    jplan = j_plan_of(jcfg, paged=JPagedSpec(page, num_pages),
                      state_dtype=state_dtype)
    rng = np.random.default_rng(7)
    for s in range(3):
        tok = ids(rng, cfg, slots, 1)
        j_logits, j_caches = jlm.decode(
            jparams, jnp.asarray(tok), j_caches, jcfg, jnp.asarray(pos),
            dtype=jnp.float32, page_table=jnp.asarray(table), plan=jplan)
        logits, caches = lm.decode(
            params, torch.from_numpy(tok), caches, cfg,
            torch.from_numpy(pos), dtype=F32,
            page_table=torch.from_numpy(table))
        close(logits, j_logits, f"paged decode logits step {s}")
        pos = pos + 1
    for c, jc in zip(caches, j_caches):
        if state_dtype is None:
            assert isinstance(c, PagedKVCache)
            assert c.k.shape[0] == jc.k.shape[0] + 1  # the trash page
            close(c.k[:num_pages], jc.k, "paged k")
            close(c.v[:num_pages], jc.v, "paged v")
            np.testing.assert_array_equal(as_np(c.pos), as_np(jc.pos))
        else:
            for name in ("k", "v"):
                assert_int8_close(getattr(c.payload, name)[:num_pages],
                                  getattr(jc.payload, name), f"int8 {name}")
                close(getattr(c.scale, name)[:num_pages],
                      getattr(jc.scale, name), f"scale {name}",
                      rtol=1e-5, atol=0)
            np.testing.assert_array_equal(as_np(c.payload.pos),
                                          as_np(jc.payload.pos))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kv_caches_quantize_like_the_reference(model, paged):
    jcfg, _, cfg, _ = model
    spec = PagedSpec(4, 6) if paged else None
    jplan = j_plan_of(jcfg, paged=JPagedSpec(4, 6) if paged else None,
                      state_dtype="int8")
    jc = jlm.init_caches(jcfg, 3, 12, plan=jplan, dtype=jnp.float32)[0]
    rng = np.random.default_rng(8)
    k = rng.standard_normal(jc.payload.k.shape).astype(np.float32)
    v = rng.standard_normal(jc.payload.v.shape).astype(np.float32)
    pos = np.array([3, 0, 7], np.int32)
    jpool = jquant.maybe_quantize(type(jc.payload)(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)), jplan)
    ours_cls = PagedKVCache if paged else KVCache
    pool = quant.maybe_quantize(ours_cls(torch.from_numpy(k),
                                         torch.from_numpy(v),
                                         torch.from_numpy(pos)),
                                plan_of(cfg, paged=spec, state_dtype="int8"))
    assert isinstance(pool, quant.QuantizedPool)
    assert pool.granularity == jpool.granularity == "token"
    for name in ("k", "v"):
        assert_int8_close(getattr(pool.payload, name),
                          getattr(jpool.payload, name), name)
        close(getattr(pool.scale, name), getattr(jpool.scale, name),
              rtol=1e-5, atol=0)
    assert pool.payload.pos.dtype == torch.int32
    np.testing.assert_array_equal(as_np(pool.payload.pos), pos)
    # dequantize and requantize: the round trip is stable
    again = quant.quantize_like(pool, quant.dequantize_state(pool))
    assert torch.equal(again.payload.k, pool.payload.k)


@pytest.mark.parametrize("state_dtype", [None, "fp32", "int8"])
def test_pool_bytes_match_reference_with_the_trash_page_apart(state_dtype):
    jcfg = softmax_cfg(j_smoke_config("flowformer_lm"))
    cfg = softmax_cfg(get_smoke_config("flowformer_lm"))
    for spec, jspec in ((None, None), (PagedSpec(8, 10), JPagedSpec(8, 10))):
        caches = lm.init_caches(cfg, 4, 64, plan=plan_of(
            cfg, paged=spec, state_dtype=state_dtype), device="cpu")
        jcaches = jlm.init_caches(jcfg, 4, 64, dtype=jnp.bfloat16,
                                  plan=j_plan_of(jcfg, paged=jspec,
                                                 state_dtype=state_dtype))
        assert quant.pool_bytes(caches) == jquant.pool_bytes(jcaches)
        page = 8 * cfg.kv_heads * cfg.dim_head
        width = {None: 2, "fp32": 4, "int8": 1 + 4 / cfg.dim_head}[
            state_dtype]
        want_trash = 0 if spec is None else int(
            cfg.n_layers * 2 * page * width)
        assert quant.trash_bytes(caches) == want_trash


# ---------------------------------------------------------------------------
# The Engine, token for token against the reference's
# ---------------------------------------------------------------------------
PROMPT_LENS = (9, 17, 5, 23, 12)


def engine_prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def generate(engine, request_cls, vocab, max_new=6):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=max_new + i % 3 - 1)
            for i, p in enumerate(engine_prompts(vocab))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("paged,state_dtype", [
    (None, None), ((8, 10), None), ((8, 10), "int8"), ((8, 0), None),
    (None, "int8")], ids=["dense", "paged", "paged-int8", "paged-full",
                          "dense-int8"])
def test_engine_matches_reference_engine(model, paged, state_dtype):
    jcfg, jparams, cfg, params = model
    spec = None if paged is None else PagedSpec(*paged)
    jspec = None if paged is None else JPagedSpec(*paged)
    want = generate(JEngine(jparams, jcfg, slots=2, max_len=64, paged=jspec,
                            dtype=jnp.float32, state_dtype=state_dtype),
                    JRequest, cfg.vocab_size)
    engine = Engine(params, cfg, slots=2, max_len=64, paged=spec,
                    dtype=F32, state_dtype=state_dtype, device="cpu")
    got = generate(engine, Request, cfg.vocab_size)
    assert got == want
    worker = engine.worker
    assert worker.admission_rounds >= 3  # slot churn
    if spec is not None:
        alloc = worker.allocator
        assert alloc.free_pages == alloc.num_pages
        assert (alloc.table == alloc.sentinel).all()
        assert worker.plan.paged == spec


def test_paged_engine_generates_what_the_dense_one_does(model):
    _, _, cfg, params = model
    runs = {}
    for name, paged in (("dense", None), ("paged", PagedSpec(8, 10)),
                        ("default", True)):
        engine = Engine(params, cfg, slots=2, max_len=64, paged=paged,
                        dtype=F32, device="cpu")
        runs[name] = generate(engine, Request, cfg.vocab_size)
        assert (engine.worker.allocator is None) == (paged is None)
    assert runs["paged"] == runs["dense"] == runs["default"]


# ---------------------------------------------------------------------------
# The reference's paged admission scenarios (tests/test_serving.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke():
    cfg = softmax_cfg(get_smoke_config("flowformer_lm"))
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def req(rng, cfg, uid, n, budget):
    return Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, n)
                   .astype(np.int32), max_new_tokens=budget)


def test_paged_admission_waits_for_pages(smoke):
    cfg, params = smoke
    rng = np.random.default_rng(8)
    # 4 pages of 8 = one 20-token context at a time (+1 page headroom)
    engine = Engine(params, cfg, slots=2, max_len=40,
                    paged=PagedSpec(page_size=8, num_pages=4), device="cpu")
    reqs = [req(rng, cfg, i, 20, 3) for i in range(3)]
    for r in reqs:
        engine.submit(r)
    engine.step()
    assert len(engine.queue) == 2  # only one fits the pool at a time
    done = engine.run()
    assert len(done) == 3 and all(len(r.generated) == 3 for r in reqs)
    # a request that can never fit fails fast and is dequeued, so the
    # engine is not wedged for the requests behind it
    big, ok = req(rng, cfg, 99, 40, 2), req(rng, cfg, 100, 10, 2)
    engine.submit(big)
    engine.submit(ok)
    with pytest.raises(ValueError, match="pool holds"):
        engine.step()
    assert big.done and big.generated == []
    assert {r.uid for r in engine.run()} == {99, 100}
    assert len(ok.generated) == 2
    assert engine.worker.allocator.free_pages == 4


def test_paged_never_fits_does_not_lose_batched_requests(smoke):
    cfg, params = smoke
    rng = np.random.default_rng(10)
    engine = Engine(params, cfg, slots=2, max_len=32,
                    paged=PagedSpec(page_size=8, num_pages=3), device="cpu")
    good, bad = req(rng, cfg, 1, 8, 3), req(rng, cfg, 2, 30, 30)  # 4 > 3
    engine.submit(good)
    engine.submit(bad)
    with pytest.raises(ValueError, match="pool holds"):
        engine.step()
    assert bad.done and bad.generated == []
    assert not good.done and len(good.generated) >= 1  # admitted, not lost
    engine.run()
    assert good.done and len(good.generated) == 3


def test_paged_decode_past_max_len_clamps_like_dense(smoke):
    cfg, params = smoke
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, 8).astype(
        np.int32)
    generated = {}
    for name, paged in (("dense", None), ("paged", PagedSpec(page_size=16))):
        engine = Engine(params, cfg, slots=1, max_len=16, paged=paged,
                        dtype=F32, device="cpu")
        r = Request(uid=0, prompt=prompt.copy(), max_new_tokens=16)
        engine.submit(r)
        engine.run()
        assert r.done and len(r.generated) == 16
        generated[name] = r.generated
    assert generated["paged"] == generated["dense"]


def test_paged_admission_reserves_decode_budget(smoke):
    cfg, params = smoke
    rng = np.random.default_rng(9)
    # 12-token prompts + 8 budget = 19-token spans = 3 pages each; the pool
    # holds 4: both prompts alone would fit, their decode growth would not
    engine = Engine(params, cfg, slots=2, max_len=40,
                    paged=PagedSpec(page_size=8, num_pages=4), device="cpu")
    reqs = [req(rng, cfg, i, 12, 8) for i in range(2)]
    for r in reqs:
        engine.submit(r)
    engine.step()
    assert len(engine.queue) == 1  # the second waits on the reservation
    assert len(engine.run()) == 2 and all(len(r.generated) == 8 for r in reqs)


def test_budget_met_at_admission_returns_its_pages(smoke):
    cfg, params = smoke
    rng = np.random.default_rng(12)
    engine = Engine(params, cfg, slots=2, max_len=32,
                    paged=PagedSpec(page_size=8, num_pages=4), device="cpu")
    for uid in range(5):
        engine.submit(req(rng, cfg, uid, 9, 1))  # retires at admission
    engine.step()
    assert not engine.queue and engine.worker.allocator.free_pages == 4
    assert all(len(r.generated) == 1 for r in engine.take_finished())


# ---------------------------------------------------------------------------
# Stacks that cannot page, and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2_1p3b", "flowformer_lm"])
def test_a_stack_that_cannot_page_serves_unpaged(arch):
    cfg = get_smoke_config(arch)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = Engine(params, cfg, slots=2, max_len=32,
                    paged=PagedSpec(page_size=8), device="cpu")
    assert engine.worker.paged is None and engine.worker.allocator is None
    assert engine.worker.plan.paged is None
    rng = np.random.default_rng(0)
    for uid in range(3):
        engine.submit(req(rng, cfg, uid, 6 + uid, 3))
    assert len(engine.run()) == 3
    caps = mixer_lib.stack_capabilities(cfg, "cpu")
    assert caps["paged_capable"][0] is False
    assert caps["paged_capable"][2] == {
        "mamba2_1p3b": "constant-size decode state (nothing to page)",
        "flowformer_lm": "constant-size O(d^2) recurrent state (nothing to "
                         "page)"}[arch]


def test_a_paged_plan_bound_to_ssd_names_paged_capable():
    cfg = get_smoke_config("mamba2_1p3b")
    plan = plan_of(cfg, paged=PagedSpec())
    assert "paged[64]" in plan.describe()
    with pytest.raises(mixer_lib.MixerResolutionError,
                       match="missing paged_capable") as err:
        mixer_lib.resolve_mixer("ssd", cfg, plan, "cpu")
    assert err.value.rejections == (
        ("ssd", "paged_capable",
         "constant-size decode state (nothing to page)"),)
    # the stack-level resolution narrows the plan instead
    assert len(mixer_lib.resolve_mixers(cfg, plan, "cpu")) == cfg.n_layers
    caches = lm.init_caches(cfg, 2, 32, plan=plan, device="cpu")
    assert not any(isinstance(c, PagedKVCache) for c in caches)


@pytest.mark.parametrize("extra", [[], ["--state-dtype", "int8"]],
                         ids=["bf16", "int8"])
def test_serve_cli_softmax_paged_on_the_cpu(capsys, extra):
    res = serve.main(["--attn", "softmax", "--paged", "--smoke", "--device",
                      "cpu", "--page-size", "8", "--num-pages", "12",
                      "--requests", "5", "--slots", "2", "--max-new", "4",
                      "--prompt-len", "12", *extra])
    assert all(r.done and len(r.generated) == 4 for r in res["requests"])
    assert res["plan"].paged == PagedSpec(8, 12)
    alloc = res["allocator"]
    assert alloc.free_pages == alloc.num_pages == 12
    text = capsys.readouterr().out
    assert "paged[8]" in text
    assert "[serve] paged KV: page_size=8 pool=12 pages, 12 free after " \
        "drain" in text


@pytest.mark.parametrize("kind", ["mla"])
def test_serve_cli_still_refuses_the_other_branches(kind):
    """MLA is an arch's own attention, not a kind: refused by name (local,
    once refused here too, serves since the hybrid stack's port)."""
    with pytest.raises(SystemExit, match="attention branches.*MLA"):
        serve.main(["--attn", kind, "--smoke", "--device", "cpu"])


def test_serve_cli_paged_flow_stack_serves_unpaged(capsys):
    res = serve.main(["--paged", "--smoke", "--device", "cpu", "--requests",
                      "3", "--slots", "2", "--max-new", "3"])
    assert res["allocator"] is None and res["plan"].paged is None
    assert all(r.done for r in res["requests"])
    assert "paged KV" not in capsys.readouterr().out
