"""Port vs reference: fleet serving (StateTransport bundles, FleetEngine).

The reference's small fleet config (``tests/test_fleet.py``: 2 layers, d
32, vocab 64) in five variants: flow, flow with int8 pools, the hybrid
RG-LRU stack (rglru, attn) with fp32 and int8 pools, and paged softmax.
The reference's weights are carried across with ``interop``; both fleets
run in fp32 on the CPU (``devices=["cpu"]``), where every port wrapper
runs its plain version.  Held equal, with tolerance zero:

* the reference ``FleetEngine`` against the port's, on the same requests
  and the same scenario (admission then an explicit ``migrate``,
  rebalancing under skew, ``kill_worker`` with and without retained
  bundles): every request's greedy tokens, the counters ``migrations``,
  ``recoveries``, ``bytes_migrated`` and ``kb_by_uid``, and ``loads()``
  after each stage;
* each exported bundle's manifest (layer, dtype, shape, nbytes, in
  order) against the reference's for the same slot and length.  The
  leaf paths are each package's own and are not compared;
* the reference's own fleet tests, ported against the port's single
  ``Engine`` under the same names with a ``torch_`` prefix;
* export, install elsewhere and export again: the same bytes, for every
  variant (the RG-LRU's bf16 conv histories included), and an int8 slot
  migrating with payload and scales unrequantized.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import RGLRUConfig as JRGLRUConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import PagedSpec as JPagedSpec  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.fleet import FleetEngine as JFleetEngine  # noqa: E402
from repro.serving.transport import StateTransport as JStateTransport  # noqa: E402
from repro.serving.worker import Worker as JWorker  # noqa: E402
from repro_torch.config import ModelConfig, RGLRUConfig  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_fleet_meshes  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, PagedSpec, Request  # noqa: E402
from repro_torch.serving.fleet import FleetEngine  # noqa: E402
from repro_torch.serving.quant import QuantizedPool, quantize_like  # noqa: E402
from repro_torch.serving.transport import StateTransport  # noqa: E402
from repro_torch.serving.worker import Worker, _install_layer  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

F32 = torch.float32
VARIANTS = [("flow", None), ("flow", "int8"), ("hybrid_rg", None),
            ("hybrid_rg", "int8"), ("paged", None)]
VARIANT_IDS = [v if sd is None else f"{v}-{sd}" for v, sd in VARIANTS]


def _small_cfg(mc, rg, variant):
    cfg = mc(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq_len=128, remat=False, scan_layers=False)
    if variant == "hybrid_rg":
        return dataclasses.replace(cfg, pattern=("rglru", "attn"), rglru=rg())
    if variant == "paged":
        return dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, kind="softmax"))
    return cfg


_WEIGHTS: dict = {}


def weights(variant):
    """(reference cfg, reference params, port cfg, port params) of a
    variant, the reference's drawn once and carried across."""
    if variant not in _WEIGHTS:
        jcfg = _small_cfg(JModelConfig, JRGLRUConfig, variant)
        jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
        cfg = _small_cfg(ModelConfig, RGLRUConfig, variant)
        _WEIGHTS[variant] = (jcfg, jparams, cfg, params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg))
    return _WEIGHTS[variant]


def _requests(vocab, req_cls=Request, *, n=6, max_new=10, seed=3):
    rng = np.random.default_rng(seed)
    lens = [12, 7, 19, 9, 15, 11, 5, 14][:n]
    return [req_cls(uid=i, prompt=rng.integers(1, vocab, ln).astype(np.int32),
                    max_new_tokens=max_new)
            for i, ln in enumerate(lens)]


def _skewed_requests(vocab, req_cls=Request):
    """The reference's rebalancing traffic: evens (budget 16) land on
    worker 0, odds (budget 3) on worker 1; when the odds retire the skew
    exceeds 1 and evens migrate."""
    rng = np.random.default_rng(5)
    return [req_cls(uid=i, prompt=rng.integers(1, vocab, int(ln)).astype(
        np.int32), max_new_tokens=16 if i % 2 == 0 else 3)
        for i, ln in enumerate([9, 11, 7, 13, 8, 10, 12, 6, 9, 10])]


def _oracle(cfg, params, reqs, *, paged=None, state_dtype=None, slots=4):
    """The port's single-worker Engine generations for the same requests."""
    eng = Engine(params, cfg, slots=slots, max_len=128, dtype=F32,
                 paged=paged, state_dtype=state_dtype, device="cpu")
    for r in reqs:
        eng.submit(dataclasses.replace(r, generated=[]))
    return {r.uid: list(r.generated) for r in eng.run()}


def _fleet(params, cfg, *, paged=None, state_dtype=None, **kw):
    kw = {"prefill": 1, "decode": 2, "slots": 4, "devices": ["cpu"], **kw}
    return FleetEngine(params, cfg, max_len=128, dtype=F32, paged=paged,
                       state_dtype=state_dtype, **kw)


# ---------------------------------------------------------------------------
# The port's fleet against the reference's, scenario by scenario
# ---------------------------------------------------------------------------
SCENARIOS = ("migrate", "rebalance", "kill_replicate", "kill_reprefill")


def _run_scenario(side, variant, state_dtype, scenario):
    """One fleet of ``side`` ("ref" or "port") through ``scenario``:
    returns (tokens by uid, the snapshots of loads and counters taken
    after each stage)."""
    jcfg, jparams, cfg, params = weights(variant)
    if side == "ref":
        fleet_cls, req_cls, p, c = JFleetEngine, JRequest, jparams, jcfg
        kw = {"dtype": jnp.float32,
              "paged": JPagedSpec(page_size=16) if variant == "paged"
              else None}
    else:
        fleet_cls, req_cls, p, c = FleetEngine, Request, params, cfg
        kw = {"dtype": F32, "devices": ["cpu"],
              "paged": PagedSpec(page_size=16) if variant == "paged"
              else None}
    if scenario == "rebalance":
        reqs = _skewed_requests(cfg.vocab_size, req_cls)
        kw.update(rebalance_skew=1, rebalance_max=2)
    else:
        reqs = _requests(cfg.vocab_size, req_cls)
    fleet = fleet_cls(p, c, prefill=1, decode=2, slots=4, max_len=128,
                      state_dtype=state_dtype,
                      replicate=scenario != "kill_reprefill", **kw)
    for r in reqs:
        fleet.submit(r)
    snaps = []

    def snap(stage):
        snaps.append((stage, fleet.loads(), fleet.migrations,
                      fleet.recoveries, fleet.bytes_migrated,
                      dict(fleet.kb_by_uid)))

    fleet.step()
    snap("admitted")
    if scenario == "migrate":
        fleet.step()
        fleet.step()
        moved = [u for u in (0, 1) if fleet.locate(u) is not None]
        for uid in moved:
            fleet.migrate(uid)
        fleet.migrate(moved[0])
        snap("migrated")
    elif scenario == "rebalance":
        for _ in range(300):
            n = fleet.step()
            snap("step")
            if n == 0 and not fleet.queue:
                break
    else:
        for _ in range(3):
            fleet.step()
        victim = next(i for i, m in enumerate(fleet.members)
                      if m.alive and m.load > 0)
        snaps.append(("orphans", fleet.kill_worker(victim)))
        snap("killed")
    fleet.run(max_steps=300)
    snap("drained")
    assert all(r.done for r in reqs)
    return {r.uid: list(r.generated) for r in reqs}, snaps


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("variant,state_dtype", VARIANTS, ids=VARIANT_IDS)
def test_fleet_matches_reference_fleet(variant, state_dtype, scenario):
    want_tokens, want_snaps = _run_scenario("ref", variant, state_dtype,
                                            scenario)
    got_tokens, got_snaps = _run_scenario("port", variant, state_dtype,
                                          scenario)
    assert got_tokens == want_tokens
    assert len(got_snaps) == len(want_snaps)
    for got, want in zip(got_snaps, want_snaps):
        assert got == want, f"after {want[0]}"
    # the scenario did what it is named for
    final = got_snaps[-1]
    if scenario in ("migrate", "rebalance"):
        assert final[2] > 0 and final[4] > 0
    if scenario.startswith("kill"):
        assert final[1].count(-1) == 1 and final[3] > 0


@pytest.mark.parametrize("variant,state_dtype", VARIANTS, ids=VARIANT_IDS)
def test_bundle_manifest_matches_reference(variant, state_dtype):
    jcfg, jparams, cfg, params = weights(variant)
    prompt = np.arange(1, 14, dtype=np.int32)
    jw = JWorker(jparams, jcfg, slots=2, max_len=128, dtype=jnp.float32,
                 state_dtype=state_dtype,
                 paged=JPagedSpec(page_size=16) if variant == "paged"
                 else None)
    jw.prefill([prompt], [1], np.zeros(1, np.float32), spans=[32])
    w = Worker(params, cfg, slots=2, max_len=128, dtype=F32,
               state_dtype=state_dtype, device="cpu",
               paged=PagedSpec(page_size=16) if variant == "paged" else None)
    w.prefill([prompt], [1], np.zeros(1, np.float32), spans=[32])
    want = JStateTransport().export(jw, 1, len(prompt))
    got = StateTransport().export(w, 1, len(prompt))

    def rows(bundle):
        return [(e.layer, e.dtype, tuple(e.shape), e.nbytes)
                for e in bundle.manifest]

    assert rows(got) == rows(want)
    assert (got.nbytes, got.length, got.padded_len) == (
        want.nbytes, want.length, want.padded_len)
    assert got.describe().splitlines()[0] == want.describe().splitlines()[0]


# ---------------------------------------------------------------------------
# The reference's fleet tests, against the port's single Engine
# ---------------------------------------------------------------------------
def test_torch_fleet_admission_matches_single_worker():
    _, _, cfg, params = weights("flow")
    reqs = _requests(cfg.vocab_size)
    want = _oracle(cfg, params, reqs)
    fleet = _fleet(params, cfg)
    for r in reqs:
        fleet.submit(r)
    done = fleet.run()
    assert {r.uid: list(r.generated) for r in done} == want
    assert all(kb > 0 for kb in fleet.kb_by_uid.values())
    assert len(fleet.kb_by_uid) == len(reqs)
    # admission routed across both decode workers
    assert all(w.decode_steps > 0 for w in fleet.workers)


@pytest.mark.parametrize("variant,state_dtype", VARIANTS, ids=VARIANT_IDS)
def test_torch_fleet_migration_token_exact(variant, state_dtype):
    _, _, cfg, params = weights(variant)
    paged = PagedSpec(page_size=16) if variant == "paged" else None
    reqs = _requests(cfg.vocab_size)
    want = _oracle(cfg, params, reqs, paged=paged, state_dtype=state_dtype)
    fleet = _fleet(params, cfg, paged=paged, state_dtype=state_dtype)
    for r in reqs:
        fleet.submit(r)
    for _ in range(3):
        fleet.step()
    # migrate two live requests mid-stream, then bounce one straight back
    moved = [u for u in (0, 1) if fleet.locate(u) is not None]
    for uid in moved:
        assert fleet.migrate(uid) > 0
    if moved:
        fleet.migrate(moved[0])
    fleet.run()
    assert {r.uid: list(r.generated) for r in reqs} == want
    assert fleet.migrations >= len(moved) + 1
    assert fleet.bytes_migrated > 0


@pytest.mark.parametrize("replicate", [True, False])
def test_torch_fleet_failover_token_exact(replicate):
    """Kill a decode worker mid-stream: every orphan retires with the
    single Engine's greedy tokens, by retained-bundle replay
    (replicate=True) or by a prefill of the committed stream."""
    _, _, cfg, params = weights("flow")
    reqs = _requests(cfg.vocab_size)
    want = _oracle(cfg, params, reqs)
    fleet = _fleet(params, cfg, replicate=replicate)
    for r in reqs:
        fleet.submit(r)
    for _ in range(4):
        fleet.step()
    victim = next(i for i, m in enumerate(fleet.members)
                  if m.alive and m.load > 0)
    orphans = fleet.kill_worker(victim)
    assert orphans, "the killed worker should have held live requests"
    assert not fleet.members[victim].alive
    # the dead worker's pools are dropped with it
    assert fleet.workers[victim] is None and fleet.loads()[victim] == -1
    fleet.run(max_steps=200)
    assert all(r.done for r in reqs), "killed-worker requests must retire"
    assert {r.uid: list(r.generated) for r in reqs} == want
    if replicate:
        assert fleet.recoveries > 0
    assert not fleet.replicas  # every retired request's bundle let go


def test_torch_fleet_failover_with_quantized_pools():
    _, _, cfg, params = weights("flow")
    reqs = _requests(cfg.vocab_size, n=4)
    want = _oracle(cfg, params, reqs, state_dtype="int8")
    fleet = _fleet(params, cfg, state_dtype="int8")
    for r in reqs:
        fleet.submit(r)
    for _ in range(3):
        fleet.step()
    victim = next(i for i, m in enumerate(fleet.members)
                  if m.alive and m.load > 0)
    fleet.kill_worker(victim)
    fleet.run(max_steps=200)
    assert {r.uid: list(r.generated) for r in reqs} == want


def test_torch_fleet_rebalancing_fifo_fairness():
    """Churn skews load (odd uids retire early), rebalancing migrates the
    most recent admits off the hot worker, and neither reorders the
    stream: outputs equal the single Engine's and equal-budget requests
    retire in submission order (a migrated request loses no step)."""
    _, _, cfg, params = weights("flow")
    reqs = _skewed_requests(cfg.vocab_size)
    want = _oracle(cfg, params, reqs, slots=4)
    fleet = _fleet(params, cfg, rebalance_skew=1, rebalance_max=2)
    for r in reqs:
        fleet.submit(r)
    retire_step: dict[int, int] = {}
    for step in range(300):
        n = fleet.step()
        for r in fleet.take_finished():
            retire_step[r.uid] = step
        if n == 0 and not fleet.queue:
            break
    assert all(r.done for r in reqs)
    assert {r.uid: list(r.generated) for r in reqs} == want
    assert fleet.migrations > 0, "the skew policy should have rebalanced"
    for cohort in ([u for u in retire_step if u % 2 == 0],
                   [u for u in retire_step if u % 2 == 1]):
        steps = [retire_step[u] for u in sorted(cohort)]
        assert steps == sorted(steps), (
            f"equal-budget requests retired out of order: {retire_step}")


def test_torch_bundle_roundtrip_and_byte_accounting():
    _, _, cfg, params = weights("flow")
    w = Worker(params, cfg, slots=2, max_len=128, dtype=F32, device="cpu")
    prompt = np.arange(1, 14, dtype=np.int32)
    w.prefill([prompt], [1], np.zeros(1, np.float32))
    t = StateTransport()
    bundle = t.export(w, 1, len(prompt))
    # the manifest accounts for the whole buffer, offsets dense and ordered
    assert bundle.nbytes == sum(e.nbytes for e in bundle.manifest)
    assert [e.offset for e in bundle.manifest] == list(np.cumsum(
        [0] + [e.nbytes for e in bundle.manifest])[:-1])
    assert f"{len(prompt)} tokens" in bundle.describe()
    # install into a fresh worker's OTHER slot, decode one token on both
    w2 = Worker(params, cfg, slots=2, max_len=128, dtype=F32, device="cpu")
    t.install(w2, 0, bundle, span=32)
    assert t.bundles_moved == 1 and t.bytes_moved == bundle.nbytes
    pos = np.full(2, len(prompt), np.int64)
    tok = np.full(2, 7, np.int32)
    temps = np.zeros(2, np.float32)
    got = w2.step(tok, pos, temps, np.array([True, False]))
    want = w.step(tok, pos, temps, np.array([False, True]))
    assert got[0] == want[1]


def test_torch_flow_bundle_is_order_of_magnitude_smaller_than_paged_kv():
    """At a 180-token context a flow bundle (O(d^2) a layer) is already
    more than 10x smaller than the softmax request's paged KV prefix."""
    _, _, cfg, params = weights("flow")
    prompt = np.arange(1, 181, dtype=np.int32) % (cfg.vocab_size - 1) + 1
    t = StateTransport()
    wf = Worker(params, cfg, slots=1, max_len=256, dtype=F32, device="cpu")
    wf.prefill([prompt], [0], np.zeros(1, np.float32))
    flow_bytes = t.export(wf, 0, len(prompt)).nbytes
    _, _, scfg, sparams = weights("paged")
    ws = Worker(sparams, scfg, slots=1, max_len=256, dtype=F32,
                paged=PagedSpec(page_size=16), device="cpu")
    ws.prefill([prompt], [0], np.zeros(1, np.float32), spans=[len(prompt)])
    kv_bytes = t.export(ws, 0, len(prompt)).nbytes
    assert kv_bytes >= 10 * flow_bytes, (
        f"paged KV bundle {kv_bytes}B vs flow bundle {flow_bytes}B")


@pytest.mark.parametrize("n", [8, 2, 1])
def test_torch_make_fleet_meshes_grouping(n):
    names = [f"cuda:{i}" for i in range(n)]
    pdev, ddev = make_fleet_meshes(1, 2, devices=names)
    if n >= 3:  # enough devices: disjoint groups, in order
        assert pdev == [torch.device("cuda:0")]
        assert ddev == [torch.device("cuda:1"), torch.device("cuda:2")]
    elif n == 2:  # prefill on the first, decode on the rest
        assert (pdev, ddev) == ([torch.device("cuda:0")],
                                [torch.device("cuda:1")])
    else:  # one device: shared
        assert pdev == ddev == [torch.device("cuda:0")]
    pm, dm = make_fleet_meshes(2, 4, devices=names)
    assert (len(pm), len(dm)) == {8: (2, 4), 2: (1, 1), 1: (1, 1)}[n]
    assert all(d.type == "cuda" for d in pm + dm)


def test_torch_fleet_on_forced_device_groups():
    """Workers spread over their groups' devices still serve exactly."""
    _, _, cfg, params = weights("flow")
    reqs = _requests(cfg.vocab_size, n=4)
    want = _oracle(cfg, params, reqs)
    fleet = _fleet(params, cfg, prefill=2, decode=3, slots=2,
                   devices=["cpu"] * 8)
    assert (len(fleet.prefill_devices), len(fleet.decode_devices)) == (2, 3)
    for r in reqs:
        fleet.submit(r)
    fleet.run()
    assert {r.uid: list(r.generated) for r in reqs} == want
    # the workers of a device share one serving copy of the weights
    ptrs = {tuple(x.data_ptr() for x in tree_leaves(w.params))
            for w in fleet.workers + fleet.prefills}
    assert len(ptrs) == 1


# ---------------------------------------------------------------------------
# The port's own: bytes round trips, verbatim int8, the install repair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant,state_dtype", VARIANTS, ids=VARIANT_IDS)
def test_bundle_round_trip_is_bitwise(variant, state_dtype):
    """Export, install into another worker's free slot, export again: the
    same bytes (the RG-LRU's bf16 conv histories included), and the
    unpacked leaves equal the source pool's rows."""
    _, _, cfg, params = weights(variant)
    paged = PagedSpec(page_size=16) if variant == "paged" else None

    def worker():
        return Worker(params, cfg, slots=3, max_len=128, dtype=F32,
                      paged=paged, state_dtype=state_dtype, device="cpu")

    src, dst = worker(), worker()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (21, 9, 48)]
    one = np.zeros(1, np.float32)
    src.prefill(prompts[:1], [0], one, spans=[40])
    # slot 2 held a longer request first: the pages it gets back keep
    # that request's rows past the new one's length
    src.prefill(prompts[2:], [2], one, spans=[48])
    src.release_slot(2)
    src.prefill(prompts[1:2], [2], one, spans=[30])
    dst.prefill(prompts[1::-1], [0, 1], np.zeros(2, np.float32),
                spans=[30, 40])
    t = StateTransport()
    first = t.export(src, 2, 9)
    t.install(dst, 2, first, span=30)
    again = t.export(dst, 2, 9)
    assert first.manifest == again.manifest
    assert np.array_equal(first.buffer, again.buffer)
    dtypes = {e.dtype for e in first.manifest}
    if variant == "hybrid_rg" and state_dtype is None:
        assert "bfloat16" in dtypes  # the RG-LRU conv histories
    if state_dtype == "int8":
        assert "int8" in dtypes
    # the unpacked leaves are the source pool's slot rows, bit for bit
    if variant != "paged":
        for tree, pool in zip(first.unpack(), src.caches):
            for got, want in zip(tree_leaves(_as_tree(tree)),
                                 tree_leaves(_as_tree(pool))):
                assert got.dtype == want.dtype
                assert torch.equal(got[0], want[2])


def _as_tree(x):
    """A pool's tensors as a tuple tree (a QuantizedPool's payload then
    scale)."""
    if isinstance(x, QuantizedPool):
        return (x.payload, x.scale)
    return x


def test_int8_slot_migrates_verbatim():
    """An int8 slot migrates with its payload and scales bitwise equal to
    its source's: no requantization round trip."""
    _, _, cfg, params = weights("flow")
    fleet = _fleet(params, cfg, state_dtype="int8")
    for r in _requests(cfg.vocab_size):
        fleet.submit(r)
    for _ in range(3):
        fleet.step()
    src, slot = fleet.locate(0)
    before = [(tuple(t[slot].clone() for t in tree_leaves(c.payload)),
               tuple(t[slot].clone() for t in tree_leaves(c.scale)))
              for c in fleet.members[src].worker.caches]
    assert fleet.migrate(0) > 0
    dst, dslot = fleet.locate(0)
    assert dst != src
    for (payload, scale), c in zip(before,
                                   fleet.members[dst].worker.caches):
        assert isinstance(c, QuantizedPool)
        for want, got in zip(payload, tree_leaves(c.payload)):
            assert got.dtype == want.dtype and torch.equal(got[dslot], want)
        for want, got in zip(scale, tree_leaves(c.scale)):
            assert torch.equal(got[dslot], want)


def test_install_takes_a_quantized_source_verbatim():
    """``_install_layer``: a ``QuantizedPool`` source is scattered as it
    is (payload and scale bitwise equal to the source's), and an fp32
    source is quantized once with the pool's recipe, as before."""
    _, _, cfg, params = weights("flow")
    w = Worker(params, cfg, slots=3, max_len=64, dtype=F32,
               state_dtype="int8", device="cpu")
    gen = torch.Generator().manual_seed(3)
    pool = w.caches[0]
    state = type(pool.payload)(*[
        torch.randn(t.shape, generator=gen) if t.is_floating_point()
        else torch.randint(0, 9, t.shape, generator=gen, dtype=t.dtype)
        for t in lm.init_caches(cfg, 2, 64, dtype=F32, device="cpu")[0]])
    src = quantize_like(pool, state)
    # a source quantized with another amax: verbatim means these scales
    src = src.with_state(src.payload, type(src.scale)(
        *[s * 1.5 for s in src.scale]))
    ids = torch.tensor([2, 0])
    with torch.inference_mode():
        _install_layer(pool, src, ids)
    for got, want in zip(tree_leaves(pool.payload) + tree_leaves(pool.scale),
                         tree_leaves(src.payload) + tree_leaves(src.scale)):
        assert torch.equal(got[ids], want.to(got.dtype))
    # fp32 prefill caches: quantized once at the boundary, as before
    with torch.inference_mode():
        _install_layer(pool, state, ids)
    fresh = quantize_like(pool, state)
    for got, want in zip(tree_leaves(pool.payload) + tree_leaves(pool.scale),
                         tree_leaves(fresh.payload)
                         + tree_leaves(fresh.scale)):
        assert torch.equal(got[ids], want.to(got.dtype))


# ---------------------------------------------------------------------------
# The serve CLI and the device rule
# ---------------------------------------------------------------------------
def test_serve_cli_fleet_on_the_cpu(capsys):
    res = serve.main(["--smoke", "--device", "cpu", "--fleet",
                      "prefill:1,decode:2", "--requests", "6",
                      "--max-new", "5", "--prompt-len", "12"])
    assert all(r.done and len(r.generated) == 5 for r in res["requests"])
    text = capsys.readouterr().out
    assert "[serve] fleet: 1 prefill + 2 decode workers" in text
    assert "decode group: ['cpu'])" in text
    assert "KiB of state moved per request" in text
    assert f"loads={res['fleet'].loads()}" in text


@pytest.mark.parametrize("spec", ["prefill:1", "decode:3,prefill:2"])
def test_serve_cli_parses_the_fleet(spec):
    assert serve._parse_fleet(spec) == {"prefill:1": (1, 2),
                                        "decode:3,prefill:2": (2, 3)}[spec]


@pytest.mark.parametrize("argv,needs", [
    (["--fleet", "prefill:1,decode:2", "--speculate-k", "4"],
     "plain decode only"),
    (["--fleet", "prefill:0,decode:2"], "expects 'prefill:N,decode:M'"),
    (["--fleet", "prefill:1,encode:2"], "expects 'prefill:N,decode:M'")])
def test_serve_cli_fleet_refusals(argv, needs):
    with pytest.raises(SystemExit, match=needs):
        serve.main(["--smoke", "--device", "cpu", *argv])


def test_fleet_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, _, cfg, params = weights("flow")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fleet_meshes(1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetEngine(params, cfg, slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--fleet", "prefill:1,decode:2"])
