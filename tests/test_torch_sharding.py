"""Port vs reference: the parameter layout, the run plan and the sharded
steps (``distribution/sharding.py``, ``launch/steps.py``).

The spec functions read ``mesh.shape`` alone, so both sides take a stub
with a shape dict for the pod meshes.  The sharded steps run from one
process on a mesh of CPU positions; the reference's run in a subprocess
on a 4-device CPU mesh (``XLA_FLAGS=--xla_force_host_platform_device_
count=4``), an Auto-axis ``jax.sharding.Mesh`` (``jax.make_mesh`` gives
Explicit axes in jax 0.9, where the reference's own sharding tests fail).
Both take the same weights (the reference's init, carried by
``interop``) and the same numpy batch, in fp32.
"""
import dataclasses
import json
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.config import ShapeSpec as JShapeSpec  # noqa: E402
from repro.distribution import sharding as j_sharding  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.launch.specs import params_shape  # noqa: E402
from repro_torch.config import ShapeSpec  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distribution import sharding  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training.train_state import gather_state, place_state  # noqa: E402
from repro_torch.training.train_state import TrainConfig, init_train_state  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

from test_sharding import run_with_devices  # noqa: E402

MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
F32 = torch.float32
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4


def stub(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


def ref_paths(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(s) for kp, s in flat}


def port_tree(name):
    jcfg = j_configs.get_smoke_config(name)
    shapes = params_shape(jcfg)
    cfg = get_smoke_config(name)
    tree = params_from_numpy(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), cfg)
    return jcfg, shapes, cfg, tree


@pytest.mark.parametrize("name", j_configs.ALL_CONFIGS)
def test_param_and_zero1_specs_match_reference(name):
    jcfg, shapes, cfg, tree = port_tree(name)
    layout = cfg if cfg.family == "lm" else None
    for mesh_name, shape in MESHES.items():
        mesh = stub(shape)
        for ours_fn, ref_fn in ((sharding.tree_param_specs,
                                 j_sharding.tree_param_specs),
                                (sharding.tree_zero1_specs,
                                 j_sharding.tree_zero1_specs)):
            specs = ours_fn(tree, mesh, layout)
            stacked = sharding.stack_layers(tree, layout)
            ours = {p: s for p, _, s in sharding.spec_leaves(stacked, specs)}
            want = ref_paths(ref_fn(shapes, mesh))
            assert ours == want, (mesh_name, ours_fn.__name__)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec_and_dp_axes_match_reference(mesh_name):
    mesh = stub(MESHES[mesh_name])
    assert sharding.dp_axes(mesh) == j_sharding.dp_axes(mesh)
    for b in (1, 2, 3, 8, 16, 32, 48, 512):
        for seq in (False, True):
            assert sharding.batch_spec(mesh, b, seq_sharded=seq) == tuple(
                j_sharding.batch_spec(mesh, b, seq_sharded=seq)), (b, seq)


@pytest.mark.parametrize("name", j_configs.ALL_CONFIGS)
def test_run_plan_choose_matches_reference(name):
    jcfg, cfg = j_configs.get_config(name), get_config(name)
    for shape in MESHES.values():
        for kind, seq, batch in (("train", 4096, 256), ("train", 512, 16),
                                 ("train", 8192, 1), ("prefill", 32768, 8),
                                 ("train", 2048, 3)):
            ours = steps.RunPlan.choose(cfg, ShapeSpec("s", seq, batch, kind),
                                        stub(shape))
            ref = j_steps.RunPlan.choose(jcfg, JShapeSpec("s", seq, batch,
                                                          kind), stub(shape))
            assert (ours.param_mode, ours.microbatch) == (
                ref.param_mode, ref.microbatch), (shape, kind, seq, batch)


def test_one_device_rule_is_choose_on_a_1x1_mesh():
    cfg = get_smoke_config("flowformer_lm")
    one = stub({"data": 1, "model": 1})
    assert steps.RunPlan.choose(cfg, ShapeSpec("s", 65536, 8, "train"),
                                one).microbatch == 2
    assert steps.RunPlan.choose(cfg, ShapeSpec("s", 512, 16, "train"),
                                one).microbatch == 0


def test_meshes_have_the_reference_shapes():
    m = make_production_mesh(devices=["cpu"])
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m = make_production_mesh(multi_pod=True, devices=["cpu", "cpu"])
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    m = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    assert {str(d) for d in m.devices.flat} == {"cpu"}
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((2, 2), ("data",), devices=["cpu"])


@pytest.mark.parametrize("mesh_shape,axes", [
    ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))])
def test_place_and_gather_round_trip_bitwise(mesh_shape, axes):
    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = make_mesh(mesh_shape, axes, devices=["cpu"])
    state = init_train_state(params, TrainConfig(), cfg)
    state = state._replace(opt=state.opt._replace(
        m=lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")))
    placed = place_state(state, mesh, cfg)
    # each position's piece is the leaf divided along every spec entry
    zspecs = sharding.tree_zero1_specs(params, mesh, cfg)
    split = 0
    for (_, x, spec), leaf in zip(sharding.spec_leaves(
            sharding.stack_layers(params, cfg), zspecs),
            tree_leaves(placed.master)):
        spec = tuple(spec) + (None,) * (x.ndim - len(spec))
        want = [n // mesh.axes_size(e) for n, e in zip(x.shape, spec)]
        assert all(list(p.shape) == want for p in leaf.pieces)
        split += want != list(x.shape)
    assert split > 0
    back = gather_state(placed, cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert back.step == state.step


# ---------------------------------------------------------------------------
# The sharded train and prefill steps against the reference's
# ---------------------------------------------------------------------------
TRAIN_PLANS = {"replicated": dict(param_mode="replicated", microbatch=0),
               "fsdp": dict(param_mode="fsdp", microbatch=0),
               "micro": dict(param_mode="replicated", microbatch=4)}
SEQ, BATCH = 64, 8
PREFILL_SEQ, PREFILL_BATCH = 128, 4


@pytest.fixture(scope="module")
def reference_steps(tmp_path_factory):
    """The reference's ``build_train_step`` on a (2, 2) mesh (one AdamW
    step, three plans) and ``build_prefill_step(seq_shard=True)`` on a
    (1, 4) mesh, from ``lm.init(PRNGKey(0))``."""
    d = tmp_path_factory.mktemp("steps")
    rng = np.random.default_rng(3)
    np.savez(d / "in.npz",
             inputs=rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
             targets=rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
             prompt=rng.integers(0, 512, (PREFILL_BATCH, PREFILL_SEQ))
             .astype(np.int32))
    code = textwrap.dedent(f"""
        import dataclasses, functools, json
        import jax, jax.numpy as jnp, numpy as np
        from repro.config import ShapeSpec
        from repro.configs import get_smoke_config
        from repro.launch.steps import RunPlan, build_prefill_step, \\
            build_train_step
        from repro.models import lm
        from repro.training import optimizer as opt_lib
        from repro.training.train_state import TrainState

        x = np.load({str(d / "in.npz")!r})
        # fp32 activations as well as fp32 parameters on both sides
        lm.loss_fn = functools.partial(lm.loss_fn, dtype=jnp.float32)
        lm.prefill = functools.partial(lm.prefill, dtype=jnp.float32)
        cfg = dataclasses.replace(get_smoke_config("flowformer_lm"),
                                  remat=False)
        params = lm.init(jax.random.PRNGKey(0), cfg)
        out = {{"params": jax.tree.map(np.asarray, params)}}
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                                 ("data", "model"))
        batch = {{"inputs": jnp.asarray(x["inputs"]),
                  "targets": jnp.asarray(x["targets"])}}
        shape = ShapeSpec("t", {SEQ}, {BATCH}, "train")
        for name, kw in {TRAIN_PLANS!r}.items():
            state = TrainState(master=jax.tree.map(jnp.copy, params),
                               opt=opt_lib.adamw_init(params),
                               step=jnp.zeros((), jnp.int32))
            step, _, _, _ = build_train_step(
                cfg, shape, mesh, RunPlan(**kw),
                train_overrides={{"compute_dtype": jnp.float32,
                                  "warmup": 0}})
            new, m = step(state, batch)
            out[name] = {{"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "master": jax.tree.map(np.asarray, new.master)}}
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                                 ("data", "model"))
        pshape = ShapeSpec("p", {PREFILL_SEQ}, {PREFILL_BATCH}, "prefill")
        step, _, _, _ = build_prefill_step(cfg, pshape, mesh,
                                           RunPlan(), seq_shard=True)
        logits, caches = jax.jit(step)(params,
                                       {{"inputs": jnp.asarray(x["prompt"])}})
        out["prefill"] = {{"logits": np.asarray(logits),
                           "caches": jax.tree.map(np.asarray, caches)}}
        import pickle
        with open({str(d / "out.pkl")!r}, "wb") as f:
            pickle.dump(out, f)
        print("done")
    """)
    run_with_devices(code, 4)
    import pickle

    with open(d / "out.pkl", "rb") as f:
        out = pickle.load(f)
    out["batch"] = dict(np.load(d / "in.npz"))
    return out


def smoke_lm():
    return dataclasses.replace(get_smoke_config("flowformer_lm"), remat=False)


@pytest.mark.parametrize("name", sorted(TRAIN_PLANS))
def test_train_step_matches_reference(reference_steps, name):
    cfg = smoke_lm()
    ref = reference_steps[name]
    x = reference_steps["batch"]
    params = params_from_numpy(reference_steps["params"], cfg)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    step, init_state, specs, plan = steps.build_train_step(
        cfg, ShapeSpec("t", SEQ, BATCH, "train"), mesh,
        steps.RunPlan(**TRAIN_PLANS[name]),
        {"compute_dtype": F32, "warmup": 0})
    assert specs["inputs"] == ("data", None)
    new, m = step(init_state(params), {
        "inputs": torch.from_numpy(x["inputs"]),
        "targets": torch.from_numpy(x["targets"])})
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    print(f"{name}: loss {loss} vs {ref['loss']}, grad norm {gnorm} vs "
          f"{ref['grad_norm']}")
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert abs(gnorm - ref["grad_norm"]) <= GNORM_RTOL * ref["grad_norm"]
    master = params_to_numpy(gather_state(new, cfg).master, cfg)
    flat_ours = jax.tree_util.tree_leaves(master)
    flat_ref = jax.tree_util.tree_leaves(ref["master"])
    assert len(flat_ours) == len(flat_ref)
    worst = 0.0
    for a, b in zip(flat_ours, flat_ref):
        worst = max(worst, float(np.abs(a - b).max()))
        # one AdamW step moves each weight by at most ~lr: hold the
        # updated master to a small fraction of that
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-5)
    print(f"{name}: updated master max |diff| {worst:.3e}")


def test_sharded_train_plans_agree_with_one_position():
    """(2, 2), fsdp and a microbatch of 4 against the (1, 1) step, all in
    the port: the same loss and gradient norm, the same update."""
    cfg = smoke_lm()
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    batch = {"inputs": torch.from_numpy(rng.integers(0, 512, (8, 64))),
             "targets": torch.from_numpy(rng.integers(0, 512, (8, 64)))}
    shape = ShapeSpec("t", 64, 8, "train")
    outs = {}
    for name, ms, kw in (("one", (1, 1), {}), ("dp2", (2, 2), {}),
                         ("fsdp", (2, 2), {"param_mode": "fsdp"}),
                         ("dp4_act", (4, 1), {"act_shard": True,
                                              "fused_vg": True})):
        mesh = make_mesh(ms, ("data", "model"), devices=["cpu"])
        step, init_state, _, _ = steps.build_train_step(
            cfg, shape, mesh, steps.RunPlan(**kw),
            {"compute_dtype": F32, "warmup": 0})
        new, m = step(init_state(params), batch)
        outs[name] = (float(m["loss"]), float(m["grad_norm"]),
                      gather_state(new, cfg).master)
    base = outs["one"]
    for name, (loss, gnorm, master) in outs.items():
        assert abs(loss - base[0]) <= 1e-6 * base[0], name
        assert abs(gnorm - base[1]) <= 1e-5 * base[1], name
        for a, b in zip(tree_leaves(master), tree_leaves(base[2])):
            torch.testing.assert_close(a, b, rtol=0, atol=3e-5)


def test_seq_sharded_prefill_binds_cp_causal_and_matches(reference_steps,
                                                         capsys):
    cfg = smoke_lm()
    params = params_from_numpy(reference_steps["params"], cfg)
    prompt = torch.from_numpy(reference_steps["batch"]["prompt"])
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"])
    shape = ShapeSpec("p", PREFILL_SEQ, PREFILL_BATCH, "prefill")
    step, pspecs, bspecs, _ = steps.build_prefill_step(
        cfg, shape, mesh, steps.RunPlan(), seq_shard=True, dtype=F32)
    assert bspecs["inputs"] == ("data", "model")
    from repro_torch.attention import cp

    calls = []
    real = cp.ContextParallelCausal.prefill

    def counting(self, *a, **kw):
        calls.append(kw["shard"].describe())
        return real(self, *a, **kw)

    cp.ContextParallelCausal.prefill = counting
    try:
        with torch.no_grad():
            logits, caches = step(params, {"inputs": prompt})
    finally:
        cp.ContextParallelCausal.prefill = real
    assert calls == ["axis 'model' (4-way), batch over 'data'"] * cfg.n_layers
    with torch.no_grad():
        ul, uc = lm.prefill(params, prompt, cfg, PREFILL_SEQ, dtype=F32)
    ref = reference_steps["prefill"]
    errs = {"logits_vs_unsharded": float((logits - ul).abs().max()),
            "logits_vs_reference": float(np.abs(logits.numpy()
                                                - ref["logits"]).max())}
    for i, (a, b) in enumerate(zip(caches, uc)):
        jc = ref["caches"][i]
        for f in a._fields:
            # each field's error over its largest magnitude (at least 1):
            # the (D, Dv) sums s reach ~1e3 here
            x = getattr(a, f).double()
            scale = max(1.0, float(x.abs().max()))
            errs[f"L{i}.{f}_vs_unsharded"] = float(
                (x - getattr(b, f).double()).abs().max()) / scale
            errs[f"L{i}.{f}_vs_reference"] = float(np.abs(
                x.numpy() - np.asarray(getattr(jc, f), np.float64)).max()
            ) / scale
    print(json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))
    bad = {k: v for k, v in errs.items() if v >= 1e-4}
    assert not bad, bad
    assert pspecs(params)["embed"]["table"] == ("model", None)


def test_prefill_falls_back_unsharded_where_n_does_not_divide(capsys):
    cfg = smoke_lm()
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"])
    step, _, _, _ = steps.build_prefill_step(
        cfg, ShapeSpec("p", 66, 2, "prefill"), mesh, steps.RunPlan(),
        seq_shard=True, dtype=F32)
    assert "N=66 not divisible by the 4-way axis 'model'" in \
        capsys.readouterr().out
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, 512, (2, 66), generator=torch.Generator()
                           .manual_seed(1))
    with torch.no_grad():
        lg, _ = step(params, {"inputs": prompt})
        ref, _ = lm.prefill(params, prompt, cfg, 66, dtype=F32)
    assert torch.equal(lg, ref)


def test_decode_step_has_no_shard():
    cfg = smoke_lm()
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    step, _, bspecs, _ = steps.build_decode_step(
        cfg, ShapeSpec("d", 32, 4, "decode"), mesh, dtype=F32)
    assert bspecs["token"] == ("data", None)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches = lm.init_caches(cfg, 4, 32, device="cpu")
    tok = torch.randint(0, 512, (4, 1), generator=torch.Generator()
                        .manual_seed(2))
    with torch.no_grad():
        lg, _ = step(params, {"token": tok, "caches": caches, "pos": 0})
        ref, _ = lm.decode(params, tok, lm.init_caches(cfg, 4, 32,
                                                       device="cpu"),
                           cfg, 0, dtype=F32)
    assert torch.equal(lg, ref)


# ---------------------------------------------------------------------------
# The placed state across steps: checkpoints and train()
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("to_shape", [(1, 1), (4, 1), (2, 2)])
def test_checkpoint_restores_a_placed_state_onto_another_mesh(tmp_path,
                                                               to_shape):
    """A state placed on (2, 2) is saved whole and restored onto
    ``to_shape``'s placement: the pieces take the template's specs and
    the gathered state equals the saved one bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distribution.sharding import Placed
    from repro_torch.utils import tree_map

    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = init_train_state(params, TrainConfig(), cfg)
    state = state._replace(opt=state.opt._replace(
        m=lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")))
    src = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    CheckpointManager(tmp_path).save(3, place_state(state, src, cfg))
    dst = make_mesh(to_shape, ("data", "model"), devices=["cpu"])
    like = place_state(tree_map(lambda x: torch.zeros_like(x) if isinstance(
        x, torch.Tensor) else 0, state), dst, cfg)
    step, back, _ = CheckpointManager(tmp_path).restore_latest(like)
    assert step == 3
    for a, b in zip(tree_leaves(back), tree_leaves(like)):
        if isinstance(b, Placed):
            assert a.mesh is dst and a.spec == b.spec
            assert [p.shape for p in a.pieces] == [p.shape for p in b.pieces]
    for a, b in zip(tree_leaves(gather_state(back, cfg)),
                    tree_leaves(state)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_keeps_the_state_placed_and_resumes_on_another_mesh(tmp_path):
    """``build_train``'s step takes and returns the placed state on every
    mesh, (1, 1) included; ``train()`` returns it whole.  A run on (2, 1)
    checkpointed at step 2 resumes on (1, 1) from that step, and its
    first step there equals a (1, 1) step from the gathered state."""
    from repro_torch.distribution.sharding import Placed
    from repro_torch.launch.train import build_train, train

    cfg = smoke_lm()
    kw = dict(batch=2, seq=32, device="cpu", log_every=100)
    for ms in ((1, 1), (2, 1)):
        mesh = make_mesh(ms, ("data", "model"), devices=["cpu"])
        _, state = build_train(cfg, steps=1, batch=2, seq=32, device="cpu",
                               mesh=mesh)
        assert all(isinstance(x, Placed) for x in tree_leaves(state.master))
    two = train(cfg, steps=2, ckpt_dir=str(tmp_path), ckpt_every=2,
                mesh=make_mesh((2, 1), ("data", "model"), devices=["cpu"]),
                **kw)
    assert all(isinstance(x, torch.Tensor)
               for x in tree_leaves(two["state"].master))
    one = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    resumed = train(cfg, steps=3, ckpt_dir=str(tmp_path), mesh=one, **kw)
    assert resumed["start_step"] == 2 and len(resumed["history"]) == 1
    step_fn, _ = build_train(cfg, steps=3, batch=2, seq=32, device="cpu",
                             mesh=one)
    from repro_torch.data.loader import lm_loader

    b = {k: torch.from_numpy(v) for k, v in next(lm_loader(
        0, batch=2, seq=32, vocab=cfg.vocab_size, start_step=2)).items()}
    direct, m = step_fn(place_state(two["state"], one, cfg), b)
    assert float(m["loss"]) == resumed["history"][0]
    for a, b_ in zip(tree_leaves(gather_state(direct, cfg)),
                     tree_leaves(resumed["state"])):
        if isinstance(b_, torch.Tensor):
            assert torch.equal(a, b_)
