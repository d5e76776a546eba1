"""Port vs reference: int8 FlowState serving pools and the quantized decode.

The same numpy inputs go through ``repro.serving.quant`` /
``repro.kernels.flow_decode`` (Pallas in interpret mode) / the reference
``Engine`` and through their counterparts in ``repro_torch``, in fp32.

Tolerances:
  * payloads: |port - reference| <= 1 LSB everywhere, and at most a share
    of 1e-3 of the entries differ -- both sides compute the same fp32
    values in another order, so a value within ~1e-5 of a half-integer
    can round the other way (a few in 1e5); truncation instead of
    rounding differs in about half of the entries;
  * scales: rtol 1e-5 (the amax is exact, the values are not);
  * decode outputs: rtol 1e-4, atol 1e-4 (K3's); z: rtol 1e-5, atol
    1e-5; t: exact;
  * dequantized states against the fp32 oracle: within one LSB of the new
    scale, plus 1e-5 (the reference's own bound,
    ``tests/test_quant_pools.py``);
  * greedy Engine tokens: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.attention import recurrent as jrec  # noqa: E402
from repro.attention.registry import ShapeInfo as JShapeInfo  # noqa: E402
from repro.attention.registry import resolve as jresolve  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.flow_attention import FlowConfig as JFlowConfig  # noqa: E402
from repro.kernels.flow_decode import flow_decode_q_step as j_decode_q_step  # noqa: E402
from repro.kernels.flow_decode.quant import flow_decode_q_call as j_decode_q_call  # noqa: E402
from repro.layers.attention import plan_of as j_plan_of  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import quant as jquant  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch import attention  # noqa: E402
from repro_torch.attention.recurrent import FlowState  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.flow_attention import FlowConfig  # noqa: E402
from repro_torch.interop import flow_pool_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.flow_decode import (flow_decode_q_ref,  # noqa: E402
                                             flow_decode_q_split,
                                             flow_decode_q_step)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.layers.attention import plan_of  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import quant  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

SUMS = ("q_sum", "k_sum", "ko_sum", "qi_sum")
FIELDS = ("t",) + SUMS + ("z", "s")


def payloads_close(pairs):
    """Every (port, reference) payload pair within one LSB, and at most a
    share of 1e-3 of all their entries different."""
    n = differ = 0
    for name, got, want in pairs:
        diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
        assert diff.max() <= 1, f"{name}: payload off by {diff.max()} LSB"
        n, differ = n + diff.size, differ + int((diff > 0).sum())
    assert differ <= 1e-3 * n, f"{differ} of {n} payload entries differ"


def assert_pool_close(pool, jpool):
    """The port's pool against the reference's, with the stated tolerances."""
    p, jp = pool.payload, jpool.payload
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(jp.t))
    np.testing.assert_allclose(p.z.numpy(), np.asarray(jp.z), rtol=1e-5,
                               atol=1e-5)
    payloads_close([(n, getattr(p, n).numpy(), np.asarray(getattr(jp, n)))
                    for n in SUMS + ("s",)])
    for n in SUMS + ("s",):
        np.testing.assert_allclose(getattr(pool.scale, n).numpy(),
                                   np.asarray(getattr(jpool.scale, n)),
                                   rtol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# Leaves and states
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gran", ["head", "token"])
def test_quantize_leaf_matches_reference(gran):
    x = (np.random.default_rng(0).standard_normal((4, 2, 32)) * 5).astype(
        np.float32)
    payload, scale = quant.quantize_leaf(torch.from_numpy(x),
                                         quant.spec_of("int8"), gran)
    jpay, jscale = jquant.quantize_leaf(jnp.asarray(x), jquant.spec_of("int8"),
                                        gran)
    assert payload.dtype == torch.int8 and scale.shape == jscale.shape
    payloads_close([("leaf", payload.numpy(), np.asarray(jpay))])
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-5)
    # rint: within half an LSB of the group's amax
    deq = payload.float() * scale
    assert ((deq - torch.from_numpy(x)).abs() <= scale * 0.5 + 1e-6).all()


def random_flow_state(seed, b=3, hkv=2, d=16, dv=16):
    """A non-zero FlowState as numpy arrays (t int32, z positive)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(t=np.array([3, 1, 5][:b], np.int32), q_sum=f(b, hkv, d) * 2,
                k_sum=f(b, hkv, d) * 2, ko_sum=f(b, hkv, d),
                qi_sum=f(b, hkv, d), z=np.abs(f(b, hkv)) + 1.0,
                s=f(b, hkv, d, dv) * 3)


def test_flow_state_recipe_matches_reference():
    """z exempt (raw fp32), t passed through, unit scales of shape
    ``x.shape[:1] + (1,) * (ndim - 1)`` for both; dequantize back."""
    st = random_flow_state(1)
    pool = quant.quantize_state(
        FlowState(**{k: torch.from_numpy(v) for k, v in st.items()}),
        quant.spec_of("int8"), granularity="head", exempt=("z",))
    jpool = jquant.quantize_state(
        jrec.FlowState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jquant.spec_of("int8"), granularity="head", exempt=("z",))
    assert pool.payload.t.dtype == torch.int32
    assert pool.payload.z.dtype == torch.float32
    assert pool.payload.s.dtype == torch.int8
    for name in FIELDS:
        assert (tuple(getattr(pool.scale, name).shape)
                == np.shape(getattr(jpool.scale, name))), name
    assert tuple(pool.scale.t.shape) == (3,) and \
        tuple(pool.scale.z.shape) == (3, 1)
    assert (pool.scale.t == 1).all() and (pool.scale.z == 1).all()
    assert_pool_close(pool, jpool)
    deq, jdeq = quant.dequantize_state(pool), jquant.dequantize_state(jpool)
    np.testing.assert_array_equal(deq.t.numpy(), st["t"])
    np.testing.assert_array_equal(deq.z.numpy(), st["z"])
    for name in SUMS + ("s",):
        sc = getattr(pool.scale, name).numpy()
        np.testing.assert_allclose(getattr(deq, name).numpy(),
                                   np.asarray(getattr(jdeq, name)),
                                   atol=float(sc.max()) + 1e-6, rtol=0)


def test_maybe_quantize_follows_the_plan():
    cfg = get_smoke_config("flowformer_lm")
    st = attention.init_state(2, 2, 8)
    assert quant.maybe_quantize(st, plan_of(cfg)) is st
    assert quant.maybe_quantize(st, None) is st
    assert quant.maybe_quantize(st, plan_of(cfg, state_dtype="fp32")) is st
    pool = quant.maybe_quantize(st, plan_of(cfg, state_dtype="int8"))
    assert isinstance(pool, quant.QuantizedPool) and pool.exempt == ("z",)
    assert pool.granularity == "head" and pool.spec.dtype == torch.int8
    bound = attention.resolve(plan_of(cfg, state_dtype="int8"))
    assert isinstance(quant.maybe_quantize(st, bound), quant.QuantizedPool)


# ---------------------------------------------------------------------------
# The quantized decode step (K4's plain version) against the Pallas kernel
# ---------------------------------------------------------------------------
def decode_case(hq, hkv, seed=0, b=3, d=16):
    """The pool of ``tests/test_quant_pools.py:185-222`` (b=3, d=16,
    counts 3, 1, 5) with ``hkv`` kv heads and ``hq`` query heads, and one
    token; numpy."""
    st = random_flow_state(seed, b=b, hkv=hkv, d=d, dv=d)
    rng = np.random.default_rng(seed + 100)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    return st, q, k, v


def both_pools(st):
    jpool = jquant.quantize_state(
        jrec.FlowState(**{k: jnp.asarray(x) for k, x in st.items()}),
        jquant.spec_of("int8"), granularity="head", exempt=("z",))
    pool = flow_pool_from_numpy(jax.tree.map(np.asarray, jpool.payload),
                                jax.tree.map(np.asarray, jpool.scale))
    return pool, jpool


CASES = [(phi, hq, hkv) for phi in ("sigmoid", "elu1", "relu")
         for hq, hkv in ((2, 2), (4, 2))]  # G = 1 and G = 2


@pytest.mark.parametrize("phi,hq,hkv", CASES)
def test_flow_decode_q_step_matches_reference_kernel(phi, hq, hkv):
    st, q, k, v = decode_case(hq, hkv)
    pool, jpool = both_pools(st)
    ptrs = [x.data_ptr() for x in pool.payload + pool.scale]
    same, out = flow_decode_q_step(pool, *map(torch.from_numpy, (q, k, v)),
                                   FlowConfig(phi=phi, causal=True,
                                              strict_causal=True))
    jcfg = JFlowConfig(phi=phi, causal=True, strict_causal=True)
    jnew, jout = j_decode_q_step(jpool, *map(jnp.asarray, (q, k, v)), jcfg,
                                 interpret=True)
    assert same is pool  # updated in place
    assert [x.data_ptr() for x in pool.payload + pool.scale] == ptrs
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    assert_pool_close(pool, jnew)
    # and the fp32 oracle of the reference test: one LSB of the new scale
    ref_state, _ = jrec.decode_step(jquant.dequantize_state(jpool),
                                    *map(jnp.asarray, (q, k, v)), jcfg)
    deq = quant.dequantize_state(pool)
    for name in SUMS + ("s",):
        sc = getattr(pool.scale, name).numpy()
        err = np.abs(getattr(deq, name).numpy()
                     - np.asarray(getattr(ref_state, name)))
        assert (err <= np.broadcast_to(sc + 1e-5, err.shape)).all(), name


def flat_reference_step(phi, hq, hkv, seed, d, port_fn):
    """One step at the kernel's flat (BH, ...) shapes through ``port_fn``
    (``flow_decode_q_ref`` or ``flow_decode_q_split``) and through the
    reference's ``flow_decode_q_call`` (interpret mode), held together with
    the module's tolerances."""
    st, q, k, v = decode_case(hq, hkv, seed=seed, d=d)
    _, jpool = both_pools(st)
    p, sc = jpool.payload, jpool.scale
    b = q.shape[0]
    bh, g = b * hkv, hq // hkv
    t = st["t"] + 1
    flat = lambda x, *s: np.asarray(x).reshape(bh, *s)  # noqa: E731
    pays = [flat(getattr(p, n), d) for n in ("k_sum", "q_sum", "ko_sum",
                                              "qi_sum")]
    scs = [flat(getattr(sc, n), 1) for n in ("k_sum", "q_sum", "ko_sum",
                                            "qi_sum")]
    qf, kf, vf = q.reshape(bh, g, d), k.reshape(bh, d), v.reshape(bh, d)
    tf = np.repeat(t, hkv).astype(np.float32).reshape(bh, 1)
    jres = j_decode_q_call(
        jnp.asarray(tf), *map(jnp.asarray, (qf, kf, vf)),
        tuple(map(jnp.asarray, pays)), jnp.asarray(flat(p.s, d, d)),
        tuple(map(jnp.asarray, scs)), jnp.asarray(flat(sc.s, 1)),
        jnp.asarray(flat(p.z, 1)), eps=1e-6, phi=phi, use_allocation=True,
        qmax=127.0, is_int=True, interpret=True)
    tt = lambda x: torch.from_numpy(np.array(x))  # noqa: E731  writable
    out, new_pays, s_pay, new_scs, s_sc, z = port_fn(
        tt(t), tt(qf), tt(kf), tt(vf), tuple(map(tt, pays)),
        tt(flat(p.s, d, d)), tuple(map(tt, scs)), tt(flat(sc.s, 1)),
        tt(flat(p.z)), hkv=hkv, phi=phi)
    np.testing.assert_allclose(out.numpy(), np.asarray(jres[0]), rtol=1e-4,
                               atol=1e-4)
    payloads_close(list(zip("kqoiS", [*new_pays, s_pay],
                            [*jres[1], jres[2]])))
    for a, b_ in zip([*new_scs, s_sc], [*jres[3], jres[4]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jres[5])[:, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("phi,hq,hkv", CASES[:2] + CASES[-1:])
def test_flow_decode_q_ref_matches_reference_call(phi, hq, hkv):
    """At the kernel's flat (BH, ...) shapes, against the reference's
    ``flow_decode_q_call`` (interpret mode)."""
    flat_reference_step(phi, hq, hkv, 3, 16, flow_decode_q_ref)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("phi,hq,hkv", CASES)
def test_flow_decode_q_split_matches_reference_call(phi, hq, hkv, d):
    """K4's reordered algebra (``flow_decode_q_split``: the output from
    deq(S) and phi(q) . phi(k) instead of the new S) against the
    reference's ``flow_decode_q_call`` (interpret mode), G = 1 and 2."""
    flat_reference_step(phi, hq, hkv, 5 + d, d, flow_decode_q_split)


@pytest.mark.parametrize("phi", ["sigmoid", "relu"])
def test_recurrent_quantized_decode_matches_reference(phi):
    """The plain ``recurrent`` backend on a QuantizedPool (dequantize ->
    fp32 step -> requantize) against the reference's on the same pool."""
    st, q, k, v = decode_case(4, 2, seed=5)
    pool, jpool = both_pools(st)
    cfg = FlowConfig(phi=phi, causal=True, strict_causal=True)
    shapes = attention.ShapeInfo(b=3, hq=4, hkv=2, n=1, m=1, d=16, dv=16)
    be = attention.registry.resolve(cfg, shapes, "cpu", op="decode",
                                    quant="int8")
    assert be.name == "recurrent"
    new, out = be.decode_step(pool, *map(torch.from_numpy, (q, k, v)), cfg)
    jcfg = JFlowConfig(phi=phi, causal=True, strict_causal=True)
    jbe = jresolve(jcfg, JShapeInfo(b=3, hq=4, hkv=2, n=1, m=1, d=16, dv=16),
                   "cpu", op="decode", quant="int8")
    jnew, jout = jbe.decode_step(jpool, *map(jnp.asarray, (q, k, v)), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    assert_pool_close(new, jnew)


# ---------------------------------------------------------------------------
# The Engine on int8 pools
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jcfg = j_smoke_config("flowformer_lm")
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("flowformer_lm")
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


def generate(engine, request_cls, vocab, n_req=4, max_new=6, seed=1):
    """The reference test's requests (``tests/test_quant_pools.py:
    _generate``): prompts of 6 + 3 i tokens from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for i in range(n_req):
        engine.submit(request_cls(
            uid=i, prompt=rng.integers(0, vocab, 6 + 3 * i).astype(np.int32),
            max_new_tokens=max_new))
    done = engine.run()
    assert len(done) == n_req
    return [r.generated for r in sorted(done, key=lambda r: r.uid)]


def test_int8_engine_matches_reference_int8_engine(weights):
    """2 slots, 4 requests: packed install, decode, retirement and
    re-admission into a used slot; greedy tokens exact, then equal to the
    port's own fp32-pool Engine, as the reference test asserts."""
    jcfg, jparams, cfg, params = weights
    jeng = JEngine(jparams, jcfg, slots=2, max_len=96, dtype=jnp.float32,
                   plan=j_plan_of(jcfg, packed=True, state_dtype="int8"))
    want = generate(jeng, JRequest, cfg.vocab_size)
    engine = Engine(params, cfg, slots=2, max_len=96, dtype=torch.float32,
                    plan=plan_of(cfg, packed=True, state_dtype="int8"),
                    device="cpu")
    got = generate(engine, Request, cfg.vocab_size)
    assert got == want
    assert all(isinstance(c, quant.QuantizedPool) for c in engine.worker.caches)
    assert engine.worker.admission_rounds >= 2
    fp32 = Engine(params, cfg, slots=2, max_len=96, dtype=torch.float32,
                  device="cpu")
    assert generate(fp32, Request, cfg.vocab_size) == got


def test_worker_installs_into_the_pool_in_place(weights):
    _, _, cfg, params = weights
    engine = Engine(params, cfg, slots=2, max_len=64, dtype=torch.float32,
                    state_dtype="int8", device="cpu")
    pool = engine.worker.caches[0]
    ptrs = [x.data_ptr() for x in pool.payload + pool.scale]
    prompts = [np.arange(5, dtype=np.int32), np.arange(9, dtype=np.int32)]
    engine.worker.prefill(prompts, [1, 0], np.zeros(2, np.float32))
    assert engine.worker.caches[0] is pool
    assert [x.data_ptr() for x in pool.payload + pool.scale] == ptrs
    assert pool.payload.t.tolist() == [9, 5]
    assert (pool.scale.s > 1e-6).all() and pool.payload.s.abs().max() == 127
    assert "state_dtype=int8" in engine.worker.plan.describe()


# ---------------------------------------------------------------------------
# Bytes and the CLI
# ---------------------------------------------------------------------------
def test_pool_bytes_match_reference_and_int8_is_3x_smaller():
    jcfg, cfg = j_smoke_config("flowformer_lm"), get_smoke_config(
        "flowformer_lm")
    sizes = {}
    for sd in (None, "fp32", "int8"):
        caches = lm.init_caches(cfg, 8, 256, plan=plan_of(cfg, state_dtype=sd),
                                device="cpu")
        jcaches = jlm.init_caches(jcfg, 8, 256, dtype=jnp.bfloat16,
                                  plan=j_plan_of(jcfg, state_dtype=sd))
        sizes[sd] = quant.pool_bytes(caches)
        assert sizes[sd] == jquant.pool_bytes(jcaches), sd
    assert sizes[None] == sizes["fp32"] >= 3 * sizes["int8"], sizes


def test_serve_cli_int8_on_the_cpu_retires_every_request(capsys):
    res = serve.main(["--smoke", "--device", "cpu", "--state-dtype", "int8",
                      "--requests", "5", "--slots", "2", "--max-new", "4",
                      "--prompt-len", "12"])
    assert all(r.done and len(r.generated) == 4 for r in res["requests"])
    assert res["plan"].state_dtype == "int8"
    text = capsys.readouterr().out
    assert "state_dtype=int8" in text and "state_pools=int8" in text
    assert f"state pools: {res['pool_bytes']} bytes" in text


@pytest.mark.parametrize("argv,needs", [
    (["--attn", "linear"], "attention branches"),
    (["--attn", "local"], "attention branches"),
    (["--attn", "mla"], "attention branches"),
    (["--fleet", "prefill:1,decode:1", "--speculate-k", "4"],
     "plain decode only"),
    (["--fleet", "prefill:1,decode:1"], "fleet serving")])
def test_serve_cli_refuses_unported_paths_by_name(argv, needs):
    with pytest.raises(SystemExit, match=needs):
        serve.main(["--smoke", "--device", "cpu", *argv])


def test_state_dtype_is_checked():
    cfg = get_smoke_config("flowformer_lm")
    with pytest.raises(ValueError, match="unknown state_dtype"):
        plan_of(cfg, state_dtype="int4")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="unknown state_dtype"):
        Engine(params, cfg, slots=2, max_len=32, state_dtype="int4",
               device="cpu")
    assert dataclasses.replace(plan_of(cfg), state_dtype="int8").describe() \
        .endswith("state_dtype=int8)")
