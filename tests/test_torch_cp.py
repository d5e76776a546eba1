"""Port vs reference: context parallelism (``attention/cp.py``).

The port's ``cp_nc`` and ``cp_causal`` run every position of a 4-way CPU
mesh from one process; the reference's run under ``jax.shard_map`` on a
4-device CPU mesh in a subprocess (``XLA_FLAGS=
--xla_force_host_platform_device_count=4``), with an Auto-axis
``jax.sharding.Mesh`` and every call under ``jax.jit`` (``jax.make_mesh``
gives Explicit axes in jax 0.9, where the reference's own cp tests fail).
Both sides take the same numpy inputs: B = 2, H = 4, Hkv = 2, N = 128,
D = 16, chunk 8.  Bounds: 1e-4 for outputs and FlowStates, 5e-3 for the
gradients of sum(out^2) (the reference's own test holds 1e-3 and 5e-3).
The port's cp is also held against its own unsharded pinned ``cumsum`` /
``nc`` oracle, and its registry triage against the reference's rules.
"""
import dataclasses
import json
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import attention  # noqa: E402
from repro_torch.attention import (ExecutionPlan, FlowConfig,  # noqa: E402
                                   ShapeInfo, ShardSpec)
from repro_torch.launch.mesh import make_mesh  # noqa: E402

from test_sharding import run_with_devices  # noqa: E402

B, H, HKV, N, D = 2, 4, 2, 128, 16
LENS = (37, 128)
NC = FlowConfig()
CAUSAL = FlowConfig(causal=True, strict_causal=True, chunk_size=8)
OUT_TOL, GRAD_TOL = 1e-4, 5e-3


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((B, H, N, D)).astype(np.float32),
            "k": rng.standard_normal((B, HKV, N, D)).astype(np.float32),
            "v": rng.standard_normal((B, HKV, N, D)).astype(np.float32)}


def mesh4():
    return make_mesh((4,), ("seq",), devices=["cpu"])


def err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's cp_nc / cp_causal results on a 4-device CPU mesh."""
    d = tmp_path_factory.mktemp("cp")
    np.savez(d / "in.npz", **inputs(), lens=np.asarray(LENS, np.int32))
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro import attention
        from repro.attention import ExecutionPlan, FlowConfig, ShardSpec

        x = np.load({str(d / "in.npz")!r})
        q, k, v = (jnp.asarray(x[n]) for n in "qkv")
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        shard = ShardSpec(axis="seq", mesh=mesh)
        out = {{}}
        for name, cfg in (("nc", FlowConfig()),
                          ("causal", FlowConfig(causal=True,
                                                strict_causal=True,
                                                chunk_size=8))):
            ex = attention.resolve(ExecutionPlan(flow=cfg, shard=shard))
            out[name + "_fwd"] = jax.jit(ex.forward)(q, k, v)

            def sq(q, k, v, ex=ex):
                return (ex.forward(q, k, v).astype(jnp.float32) ** 2).sum()
            grads = jax.jit(jax.grad(sq, argnums=(0, 1, 2)))(q, k, v)
            for n, g in zip("qkv", grads):
                out[f"{{name}}_d{{n}}"] = g
            if name == "causal":
                o, st = jax.jit(ex.prefill)(q, k, v)
                out["pf_out"] = o
                for f in st._fields:
                    out["pf_" + f] = getattr(st, f)
                o, st = jax.jit(lambda q, k, v, l: ex.prefill(
                    q, k, v, lengths=l))(q, k, v, jnp.asarray(x["lens"]))
                out["pk_out"] = o
                for f in st._fields:
                    out["pk_" + f] = getattr(st, f)
        np.savez({str(d / "out.npz")!r},
                 **{{k: np.asarray(v) for k, v in out.items()}})
        print("done")
    """)
    run_with_devices(code, 4)
    return dict(np.load(d / "out.npz"))


def port_qkv(grad=False):
    x = inputs()
    return tuple(torch.tensor(x[n], requires_grad=grad) for n in "qkv")


def executors(cfg, mesh=None, **shard_kw):
    shard = ShardSpec(axis="seq", mesh=mesh or mesh4(), **shard_kw)
    ex = attention.resolve(ExecutionPlan(flow=cfg, shard=shard))
    pin = "cumsum" if cfg.causal else "nc"
    oracle = attention.resolve(ExecutionPlan(
        flow=dataclasses.replace(cfg, backend=pin)))
    return ex, oracle


def test_sharded_plans_bind_the_cp_backends():
    q, k, v = port_qkv()
    shapes = ShapeInfo.from_qkv(q, k, v)
    for cfg, op, want in ((NC, "forward", "cp_nc"),
                          (CAUSAL, "forward", "cp_causal"),
                          (CAUSAL, "prefill", "cp_causal"),
                          (CAUSAL, "prefill_packed", "cp_causal")):
        ex, _ = executors(cfg)
        assert ex.backend(op, shapes, "cpu").name == want


@pytest.mark.parametrize("name,cfg", [("nc", NC), ("causal", CAUSAL)])
def test_forward_matches_reference(reference, name, cfg):
    ex, _ = executors(cfg)
    with torch.no_grad():
        out = ex.forward(*port_qkv())
    e = err(out, reference[name + "_fwd"])
    print(f"{name} forward vs reference: {e:.3e}")
    assert e < OUT_TOL


@pytest.mark.parametrize("name,cfg", [("nc", NC), ("causal", CAUSAL)])
def test_gradients_match_reference(reference, name, cfg):
    ex, _ = executors(cfg)
    q, k, v = port_qkv(grad=True)
    grads = torch.autograd.grad((ex.forward(q, k, v) ** 2).sum(), (q, k, v))
    for n, g in zip("qkv", grads):
        e = err(g, reference[f"{name}_d{n}"])
        print(f"{name} d{n} vs reference: {e:.3e}")
        assert e < GRAD_TOL, n


@pytest.mark.parametrize("packed", [False, True])
def test_prefill_states_match_reference(reference, packed):
    ex, _ = executors(CAUSAL)
    lens = torch.tensor(LENS) if packed else None
    with torch.no_grad():
        out, st = ex.prefill(*port_qkv(), lengths=lens)
    key = "pk_" if packed else "pf_"
    errs = {"out": err(out, reference[key + "out"])}
    errs.update({f: err(getattr(st, f), reference[key + f])
                 for f in st._fields})
    print(("packed" if packed else "full") + " prefill vs reference: "
          + json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))
    assert st.t.tolist() == (list(LENS) if packed else [N, N])
    assert max(errs.values()) < OUT_TOL, errs


@pytest.mark.parametrize("mesh_shape,axes,batch_axis", [
    ((4,), ("seq",), None),
    ((2, 2), ("data", "seq"), "data"),
    ((8,), ("seq",), None),
])
def test_cp_matches_unsharded_oracle(mesh_shape, axes, batch_axis):
    """Forward, the gradients and packed prefill against the port's
    unsharded pinned plain backends, with the batch split too."""
    mesh = make_mesh(mesh_shape, axes, devices=["cpu"])
    for cfg in (NC, CAUSAL):
        ex, oracle = executors(cfg, mesh, batch_axis=batch_axis)
        q, k, v = port_qkv(grad=True)
        out, ref = ex.forward(q, k, v), oracle.forward(q, k, v)
        assert err(out.detach(), ref.detach()) < OUT_TOL
        g1 = torch.autograd.grad((out ** 2).sum(), (q, k, v))
        g2 = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
        assert max(err(a, b) for a, b in zip(g1, g2)) < GRAD_TOL
    ex, oracle = executors(CAUSAL, mesh, batch_axis=batch_axis)
    with torch.no_grad():
        o1, s1 = ex.prefill(*port_qkv(), lengths=torch.tensor(LENS))
        o2, s2 = oracle.prefill(*port_qkv(), lengths=torch.tensor(LENS))
    assert err(o1, o2) < OUT_TOL
    assert max(err(a, b) for a, b in zip(s1, s2)) < OUT_TOL


def test_inner_strategy_is_resolvable_and_pinnable():
    """``ShardSpec.inner`` pins the shard-local dot; a pinned inner that
    cannot take the local length (chunk 16 at local N = 16 on an 8-way
    axis) is rejected with its own reason."""
    q, k, v = port_qkv()
    shapes = ShapeInfo.from_qkv(q, k, v)
    mesh = make_mesh((8,), ("seq",), devices=["cpu"])
    cfg = dataclasses.replace(CAUSAL, chunk_size=8)
    with torch.no_grad():
        ref = executors(cfg)[1].forward(q, k, v)
        for inner in ("auto", "chunked", "cumsum"):
            shard = ShardSpec(axis="seq", mesh=mesh, inner=inner)
            plan = ExecutionPlan(flow=cfg, shard=shard)
            why = dict((n, w) for n, ok, w in attention.explain(
                plan, shapes, platform="cpu", op="forward").sections[0][1])
            assert f"inner={'chunked' if inner == 'auto' else inner}" \
                in why["cp_causal"]
            assert err(attention.resolve(plan).forward(q, k, v), ref) < OUT_TOL
    big = dataclasses.replace(CAUSAL, chunk_size=16)
    plan = ExecutionPlan(flow=big, shard=ShardSpec(axis="seq", mesh=mesh,
                                                   inner="chunked"))
    with pytest.raises(attention.ResolutionError) as ei:
        attention.resolve(plan).backend("forward", shapes, "cpu")
    why = dict(ei.value.rejections)["cp_causal"]
    assert "inner" in why and "not chunkable" in why
    plan = ExecutionPlan(flow=CAUSAL, shard=ShardSpec(axis="seq", mesh=mesh,
                                                      inner="recurrent"))
    with pytest.raises(attention.ResolutionError, match="no shard-local "
                       "causal dot"):
        attention.resolve(plan).backend("forward", shapes, "cpu")


def test_cp_nc_takes_no_inner():
    q, k, v = port_qkv()
    plan = ExecutionPlan(flow=NC, shard=ShardSpec(axis="seq", mesh=mesh4(),
                                                  inner="chunked"))
    with pytest.raises(attention.ResolutionError) as ei:
        attention.resolve(plan).backend("forward", ShapeInfo.from_qkv(
            q, k, v), "cpu")
    assert "no injectable inner" in dict(ei.value.rejections)["cp_nc"]


def test_one_position_mesh_and_unsharded_plans_are_refused():
    """The reference's reasons: every single-device backend has no
    collective glue, the glue refuses a 1-way axis, and refuses an
    unsharded plan."""
    shapes = ShapeInfo(b=1, hq=2, hkv=2, n=64, m=64, d=8, dv=8)
    cfg = dataclasses.replace(CAUSAL, chunk_size=16)
    one = ShardSpec(axis="model", mesh=make_mesh((1,), ("model",),
                                                 devices=["cpu"]))
    with pytest.raises(attention.ResolutionError) as ei:
        attention.registry.resolve(cfg, shapes, "cpu", shard=one)
    rej = dict(ei.value.rejections)
    assert "no collective glue" in rej["cumsum"]
    assert "no collective glue" in rej["fused_causal"]
    assert "size 1" in rej["cp_causal"]
    with pytest.raises(attention.ResolutionError, match="sharded"):
        attention.registry.resolve(
            dataclasses.replace(cfg, backend="cp_causal"), shapes, "cpu")
    odd = ShapeInfo(b=1, hq=2, hkv=2, n=66, m=66, d=8, dv=8)
    with pytest.raises(attention.ResolutionError) as ei:
        attention.registry.resolve(cfg, odd, "cpu", shard=ShardSpec(
            axis="seq", mesh=mesh4()))
    assert "N=66 not divisible by the 4-way axis 'seq'" in dict(
        ei.value.rejections)["cp_causal"]


def test_explain_shows_the_axis_and_the_glue():
    q, k, v = port_qkv()
    plan = ExecutionPlan(flow=CAUSAL, shard=ShardSpec(axis="seq",
                                                      mesh=mesh4()))
    report = str(attention.explain(plan, ShapeInfo.from_qkv(q, k, v),
                                   platform="cpu"))
    assert "axis 'seq' (4-way)" in report
    assert "no collective glue" in report and "OK  cp_causal" in report
    assert "shard[axis 'seq' (4-way)]" in plan.describe()
    # decode drops the shard, as in the reference
    assert "op='decode'" in report
    unsharded = str(attention.explain(ExecutionPlan(flow=CAUSAL),
                                      ShapeInfo.from_qkv(q, k, v),
                                      platform="cpu"))
    assert "unsharded" in unsharded


def test_on_cuda_auto_inner_is_k5a_and_plain_dots_need_a_pin():
    """Judged as on the card (no kernel runs): ``auto`` binds cp_causal
    over ``cuda_chunk`` (K5a); a shape K5a does not take raises, naming
    it, instead of running a plain dot; a pinned plain inner applies."""
    shapes = ShapeInfo(b=4, hq=8, hkv=8, n=4096, m=4096, d=64, dv=64)
    cfg = dataclasses.replace(CAUSAL, chunk_size=128)
    plan = ExecutionPlan(flow=cfg, shard=ShardSpec(axis="seq", mesh=mesh4()))
    be = attention.resolve(plan).backend("forward", shapes, "cuda")
    assert be.name == "cp_causal"
    rows = dict((n, w) for n, ok, w in attention.explain(
        plan, shapes, platform="cuda", op="forward").sections[0][1])
    assert "inner=cuda_chunk" in rows["cp_causal"]
    odd = dataclasses.replace(shapes, d=16, dv=16)
    with pytest.raises(attention.ResolutionError) as ei:
        attention.resolve(plan).backend("forward", odd, "cuda")
    why = dict(ei.value.rejections)["cp_causal"]
    assert "cuda_chunk" in why and "kernel takes D" in why
    assert "runs only when pinned" in why
    pinned = ExecutionPlan(flow=cfg, shard=ShardSpec(
        axis="seq", mesh=mesh4(), inner="chunked"))
    assert attention.resolve(pinned).backend("forward", odd,
                                             "cuda").name == "cp_causal"


def test_make_context_parallel_warns_once():
    from repro_torch.core import context_parallel

    context_parallel._WARNED = False
    q, k, v = port_qkv()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn = context_parallel.make_context_parallel(mesh4(), CAUSAL,
                                                    seq_axis="seq")
        context_parallel.make_context_parallel(mesh4(), CAUSAL,
                                               seq_axis="seq")
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 1
    with torch.no_grad():
        assert err(fn(q, k, v), executors(CAUSAL)[1].forward(q, k, v)) \
            < OUT_TOL
