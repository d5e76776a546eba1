"""The port stands alone: no JAX, no reference package, no silent CPU.

``repro_torch`` and ``chip_smoke.py`` import ``torch``, ``numpy`` and the
standard library only; importing the package builds no kernel; entry
points refuse to run on the CPU unless asked; the backend registry
resolves to the CUDA kernels on a CUDA platform, never to a plain version
there unless pinned, and to the plain versions elsewhere; a training
plan (``needs_grad``) admits only backends that differentiate the op; and
a quantized serving plan (``state_dtype``) admits only ``quant_capable``
backends and mixers, refusing fp8 off the TPU by name.
"""
import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import attention  # noqa: E402
from repro_torch.attention import ExecutionPlan, FlowConfig, ShapeInfo  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels._lib import KERNELS  # noqa: E402
from repro_torch.kernels.flow_chunk import flow_chunk_call, flow_chunk_dkv_call  # noqa: E402
from repro_torch.kernels.flow_decode import (flow_decode_q_step,  # noqa: E402
                                             flow_decode_step)
from repro_torch.kernels.flow_fused import flow_fused_call, flow_fused_forward  # noqa: E402
from repro_torch.kernels.flow_nc import (flow_nc_fused_call,  # noqa: E402
                                         flow_nc_qside_bwd_call,
                                         flow_nc_qside_call)
from repro_torch.launch.classify import train_eval_classifier  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.layers import mixer as mixer_lib  # noqa: E402
from repro_torch.layers.attention import plan_of  # noqa: E402
from repro_torch.models import classifier  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.quant import QuantizedPool, maybe_quantize  # noqa: E402
from repro_torch.config import ShapeSpec  # noqa: E402
from repro_torch.kernels.gather import (boundary_gather,  # noqa: E402
                                        paged_gather, paged_gather_quant,
                                        paged_gather_quant_ref,
                                        paged_gather_ref)
from repro_torch.serving.paged import PagedSpec  # noqa: E402
from repro_torch.serving.worker import Worker  # noqa: E402
from repro_torch.kernels.ssd_chunk import (ssd_chunk_bwd_call,  # noqa: E402
                                           ssd_chunk_call, ssd_scan)
from repro_torch.launch.steps import check_flow_trainable  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.serving.engine\n"
        "from repro_torch.kernels import _lib\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert not _lib._FUNCS, 'importing built or loaded a kernel'\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_reference(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_smoke_config("flowformer_lm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(cfg, torch.Generator().manual_seed(0))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg, slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, steps=1, batch=1, seq=8)
    # decode pools: the card unless the caller asks for the CPU
    ssd_cfg = get_smoke_config("mamba2_1p3b")
    for c in (cfg, ssd_cfg):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_caches(c, 2, 32)
        mx = mixer_lib.get_mixer(c.block_kind(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mx.state_init(c, 2, 32)
        pools = lm.init_caches(c, 2, 32, device="cpu")
        assert all(t.device.type == "cpu" for t in tree_leaves(pools))


def test_cpu_wrappers_run_the_plain_version_uncounted():
    reset_launches()
    q = torch.randn((2, 1, 8, 32))
    k, v = torch.randn((2, 8, 32)), torch.randn((2, 8, 32))
    out, sums = flow_fused_call(q, k, v, torch.tensor([8, 3], dtype=torch.int32),
                                chunk=8)
    assert out.shape == (2, 1, 8, 32) and len(sums) == 6
    pool = attention.init_state(2, 1, 32)
    same, out = flow_decode_step(pool, q[:, :, :1], k[:, None, :1],
                                 v[:, None, :1], FlowConfig(causal=True,
                                                            strict_causal=True))
    assert all(a is b for a, b in zip(same, pool)) and pool.t.tolist() == [1, 1]
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


def test_cpu_flow_nc_wrappers_run_the_plain_version_uncounted():
    reset_launches()
    q, k = torch.randn((2, 12, 32)), torch.randn((2, 7, 32))
    assert flow_nc_fused_call(q, k, k).shape == (2, 12, 32)
    sums = torch.rand((2, 32)) * 7
    kv = torch.randn((2, 32, 32))
    assert flow_nc_qside_call(q, sums, sums, kv, n_sinks=12,
                              m_sources=7).shape == (2, 12, 32)
    grads = flow_nc_qside_bwd_call(q, sums, sums, kv, q, n_sinks=12,
                                   m_sources=7)
    assert [tuple(g.shape) for g in grads] == [(2, 12, 32), (2, 32), (2, 32),
                                              (2, 32, 32)]
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


def test_cpu_flow_chunk_wrappers_run_the_plain_version_uncounted():
    reset_launches()
    q, k = torch.randn((2, 2, 12, 32)), torch.randn((2, 12, 32))
    v = torch.randn((2, 12, 64))
    assert flow_chunk_call(q, k, v).shape == (2, 2, 12, 64)
    dk, dv = flow_chunk_dkv_call(q, k, v, torch.randn((2, 2, 12, 64)))
    assert dk.shape == (2, 12, 32) and dv.shape == (2, 12, 64)
    assert {"flow_chunk", "flow_chunk_dkv"} <= set(KERNELS)
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


def test_cpu_serving_counts_no_launch():
    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    engine = Engine(params, cfg, slots=2, max_len=32, device="cpu")
    reset_launches()
    rng = np.random.default_rng(0)
    for uid in range(3):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 6 + uid).astype(np.int32), max_new_tokens=3))
    assert len(engine.run()) == 3
    assert engine.worker.decode_steps > 0
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


SHAPES = {"prefill_packed": ShapeInfo(b=16, hq=8, hkv=8, n=512, m=512, d=64,
                                      dv=64),
          "decode": ShapeInfo(b=16, hq=8, hkv=8, n=1, m=1, d=64, dv=64)}


@pytest.mark.parametrize("backend,platform,want", [
    ("auto", "cuda", {"prefill_packed": "cuda_fused", "decode": "cuda_decode"}),
    ("auto", "cpu", {"prefill_packed": "fused_causal", "decode": "recurrent"}),
    ("plain", "cuda", {"prefill_packed": "fused_causal", "decode": "recurrent"}),
    ("cuda_fused", "cuda", {"prefill_packed": "cuda_fused",
                            "decode": "cuda_decode"}),
    ("fused_causal", "cuda", {"prefill_packed": "fused_causal",
                              "decode": "cuda_decode"}),
])
def test_registry_resolution(backend, platform, want):
    plan = ExecutionPlan(flow=FlowConfig(backend=backend), packed=True)
    ex = attention.resolve(plan)
    for op, name in want.items():
        assert ex.backend(op, SHAPES[op], platform).name == name, op


def test_explain_names_a_reason_per_rejected_backend():
    plan = ExecutionPlan(flow=FlowConfig(), packed=True)
    text = str(attention.explain(plan, SHAPES["decode"], platform="cpu",
                                 op="decode"))
    assert "no  cuda_decode: CUDA kernel needs a CUDA device" in text
    assert "no  cuda_fused: does not provide decode" in text
    assert "OK  recurrent" in text
    bad = ExecutionPlan(flow=FlowConfig(backend="cuda_fused"), packed=True)
    with pytest.raises(attention.ResolutionError, match="CUDA device"):
        attention.resolve(bad).backend("prefill_packed",
                                       SHAPES["prefill_packed"], "cpu")


@pytest.mark.parametrize("op", ["prefill_packed", "decode"])
@pytest.mark.parametrize("d,dv", [(96, 96), (64, 48)])
def test_auto_on_cuda_refuses_a_shape_no_kernel_takes(op, d, dv):
    shapes = dataclasses.replace(SHAPES[op], d=d, dv=dv)
    with pytest.raises(attention.ResolutionError,
                       match="kernel takes D == Dv") as err:
        attention.resolve(ExecutionPlan(flow=FlowConfig())).backend(
            op, shapes, "cuda")
    plain = {"prefill_packed": "fused_causal", "decode": "recurrent"}[op]
    assert "pinned" in dict(err.value.rejections)[plain]
    for pin in ("plain", plain):
        ex = attention.resolve(ExecutionPlan(flow=FlowConfig(backend=pin)))
        assert ex.backend(op, shapes, "cuda").name == plain


def test_executor_resolves_once_per_call_signature(monkeypatch):
    calls = []
    real = attention.registry.resolve
    monkeypatch.setattr(attention.registry, "resolve",
                        lambda *a, **kw: calls.append(kw["op"]) or real(*a, **kw))
    ex = attention.resolve(ExecutionPlan(flow=FlowConfig(chunk_size=8)))
    state = attention.init_state(2, 1, 16)
    q = torch.randn((2, 1, 1, 16))
    for _ in range(3):
        state, _ = ex.decode_step(state, q, q, q)
    ex.prefill(q.expand(2, 1, 8, 16), q.expand(2, 1, 8, 16),
               q.expand(2, 1, 8, 16), lengths=torch.tensor([8, 5]))
    ex.decode_step(state, q[:1], q[:1], q[:1])
    assert calls == ["decode", "prefill_packed", "decode"]


TRAIN = ShapeInfo(b=16, hq=8, hkv=8, n=512, m=512, d=64, dv=64)


@pytest.mark.parametrize("backend,platform,want", [
    ("auto", "cuda", "cuda_fused"), ("auto", "cpu", "fused_causal"),
    ("plain", "cuda", "fused_causal"), ("cuda_fused", "cuda", "cuda_fused")])
def test_training_resolves_a_differentiable_forward(backend, platform, want):
    plan = ExecutionPlan(flow=FlowConfig(causal=True, strict_causal=True,
                                         backend=backend))
    assert attention.resolve_for_training(plan, TRAIN, platform).name == want
    assert "needs_grad" in dataclasses.replace(plan, needs_grad=True).describe()


@pytest.mark.parametrize("pin,op,shapes,reason", [
    ("cuda_decode", "decode", SHAPES["decode"], "no backward for decode"),
    ("cuda_fused", "prefill_packed", SHAPES["prefill_packed"],
     "no backward for prefill_packed")])
def test_needs_grad_refuses_forward_only_ops(pin, op, shapes, reason):
    plan = ExecutionPlan(flow=FlowConfig(backend=pin), packed=True)
    assert attention.resolve(plan).backend(op, shapes, "cuda").name == pin
    ex = attention.resolve(dataclasses.replace(plan, needs_grad=True))
    with pytest.raises(attention.ResolutionError, match=reason) as err:
        ex.backend(op, shapes, "cuda")
    assert "with gradients" in str(err.value)
    assert dict(err.value.rejections)[pin].startswith(reason)
    text = str(attention.explain(dataclasses.replace(plan, needs_grad=True),
                                 shapes, platform="cuda", op=op))
    assert f"no  {pin}: {reason}" in text


def test_packed_prefill_refuses_autograd():
    q = torch.randn((2, 2, 8, 16), requires_grad=True)
    k, v = torch.randn((2, 1, 8, 16)), torch.randn((2, 1, 8, 16))
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=8)
    with pytest.raises(RuntimeError, match="packed prefill .* forward-only"):
        flow_fused_forward(q, k, v, cfg, lengths=torch.tensor([8, 3]))
    with torch.no_grad():
        flow_fused_forward(q, k, v, cfg, lengths=torch.tensor([8, 3]))
    out, _ = flow_fused_forward(q, k, v, cfg)  # dense: FlowFusedDot
    out.sum().backward()
    assert q.grad is not None and q.grad.abs().sum() > 0


def test_classifier_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_smoke_config("flowformer_lra")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classifier.init(cfg, torch.Generator().manual_seed(0), n_classes=3)
    data = {"inputs": np.zeros((2, 8), np.int32),
            "labels": np.zeros((2,), np.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_eval_classifier(cfg, data, data, n_classes=3, steps=1, batch=1)


NC = ShapeInfo(b=32, hq=4, hkv=4, n=4096, m=4096, d=64, dv=64)


@pytest.mark.parametrize("backend,platform,want", [
    ("auto", "cuda", "cuda_nc"), ("auto", "cpu", "nc"), ("plain", "cuda", "nc"),
    ("cuda_nc", "cuda", "cuda_nc"), ("nc", "cuda", "nc")])
def test_non_causal_resolution(backend, platform, want):
    plan = ExecutionPlan(flow=FlowConfig(causal=False, backend=backend))
    assert attention.resolve(plan).backend("forward", NC, platform).name == want
    assert attention.resolve_for_training(plan, NC, platform).name == want


@pytest.mark.parametrize("change,reason", [
    (dict(use_allocation=False), "kernel hard-codes the allocation sigmoid"),
    (dict(phi="elu1"), "kernel hard-codes sigmoid phi"),
    (dict(gqa_mode="expand"), "kernel implements shared-GQA semantics only")])
def test_auto_on_cuda_refuses_what_the_nc_kernel_does_not_take(change, reason):
    cfg = FlowConfig(causal=False, **change)
    shapes = dataclasses.replace(NC, hq=8)
    with pytest.raises(attention.ResolutionError, match=reason) as err:
        attention.resolve(ExecutionPlan(flow=cfg)).backend("forward", shapes,
                                                           "cuda")
    why = dict(err.value.rejections)
    assert why["cuda_nc"].startswith(reason) and "pinned" in why["nc"]
    assert why["cuda_fused"] == "causal-only backend"
    pinned = dataclasses.replace(cfg, backend="plain")
    assert attention.resolve(ExecutionPlan(flow=pinned)).backend(
        "forward", shapes, "cuda").name == "nc"
    text = str(attention.explain(ExecutionPlan(flow=cfg), shapes,
                                 platform="cuda", op="forward"))
    assert f"no  cuda_nc: {reason}" in text


def quant_plan(backend="auto", state_dtype="int8"):
    return ExecutionPlan(flow=FlowConfig(backend=backend), packed=True,
                         state_dtype=state_dtype)


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_fp8_pools_are_refused_off_the_tpu(platform):
    reason = f"fp8 e4m3 state pools are TPU-only (platform={platform})"
    with pytest.raises(attention.ResolutionError, match="TPU-only") as err:
        attention.resolve(quant_plan(state_dtype="fp8")).backend(
            "decode", SHAPES["decode"], platform)
    assert "with fp8 state pools" in str(err.value)
    why = dict(err.value.rejections)
    assert why["cuda_decode"].startswith(reason)
    assert why["recurrent"].startswith(reason)
    with pytest.raises(attention.ResolutionError, match="TPU-only"):
        attention.registry.resolve(FlowConfig(causal=True, strict_causal=True),
                                   SHAPES["decode"], platform, op="decode",
                                   quant="fp8")
    cfg = get_smoke_config("flowformer_lm")
    with pytest.raises(mixer_lib.MixerResolutionError,
                       match=re.escape(f"missing quant_capable: {reason}")
                       ) as err:
        lm.init_caches(cfg, 2, 32, plan=plan_of(cfg, state_dtype="fp8"),
                       device=platform)
    assert err.value.rejections[0][:2] == ("attn", "quant_capable")


@pytest.mark.parametrize("backend,platform,want,prefill", [
    ("auto", "cuda", "cuda_decode", "cuda_fused"),
    ("auto", "cpu", "recurrent", "fused_causal"),
    ("plain", "cuda", "recurrent", "fused_causal"),
    ("recurrent", "cuda", "recurrent", "cuda_fused"),
    ("cuda_decode", "cuda", "cuda_decode", "cuda_fused")])
def test_int8_decode_resolution(backend, platform, want, prefill):
    ex = attention.resolve(quant_plan(backend))
    assert ex.backend("decode", SHAPES["decode"], platform).name == want
    # prefill never sees the pool dtype: it makes fp32 boundary states
    assert ex.backend("prefill_packed", SHAPES["prefill_packed"],
                      platform).name == prefill
    text = str(attention.explain(quant_plan(backend), SHAPES["decode"],
                                 platform=platform, op="decode"))
    assert "state_dtype=int8" in text and f"OK  {want}" in text


def test_plain_recurrent_refuses_an_int8_pool_on_cuda_unless_pinned():
    shapes = dataclasses.replace(SHAPES["decode"], d=96, dv=96)
    with pytest.raises(attention.ResolutionError,
                       match="with int8 state pools") as err:
        attention.resolve(quant_plan()).backend("decode", shapes, "cuda")
    why = dict(err.value.rejections)
    assert "pinned" in why["recurrent"] and "kernel takes" in why["cuda_decode"]
    for pin in ("plain", "recurrent"):
        assert attention.resolve(quant_plan(pin)).backend(
            "decode", shapes, "cuda").name == "recurrent"


def test_a_backend_without_quant_capable_is_rejected_by_name(monkeypatch):
    class BareDecode(attention.Backend):
        provides = frozenset({"decode"})

        def supports(self, cfg, shapes, platform, *, op="forward"):
            return True, "decodes anything"

    impl = BareDecode()
    impl.name = "bare_decode"
    monkeypatch.setitem(attention.registry._REGISTRY, "bare_decode", impl)
    monkeypatch.setattr(attention.registry, "_ORDER",
                        attention.registry._ORDER + ["bare_decode"])
    assert attention.resolve(ExecutionPlan(flow=FlowConfig(
        backend="bare_decode"))).backend("decode", SHAPES["decode"],
                                         "cpu") is impl
    with pytest.raises(attention.ResolutionError) as err:
        attention.resolve(quant_plan("bare_decode")).backend(
            "decode", SHAPES["decode"], "cpu")
    assert dict(err.value.rejections)["bare_decode"] == (
        "no quantized-state path for decode (would silently dequantize the "
        "int8 pool; pick a quant-capable strategy)")
    # the mixer protocol declines the same way by default
    ok, why = mixer_lib.Mixer().quant_capable(get_smoke_config(
        "flowformer_lm"), "cpu", "int8")
    assert not ok and "silently dequantize the int8 pool" in why


def test_serve_cli_refuses_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--state-dtype", "int8"])


def test_cpu_flow_decode_q_wrapper_runs_the_plain_version_uncounted():
    reset_launches()
    cfg = get_smoke_config("flowformer_lm")
    state = attention.init_state(2, 1, 32)
    state = state._replace(s=torch.randn((2, 1, 32, 32)), t=state.t + 3)
    pool = maybe_quantize(state, plan_of(cfg, state_dtype="int8"))
    tensors = list(pool.payload + pool.scale)
    q = torch.randn((2, 2, 1, 32))
    same, out = flow_decode_q_step(pool, q, q[:, :1], q[:, 1:],
                                   FlowConfig(causal=True, strict_causal=True))
    assert isinstance(same, QuantizedPool) and out.shape == (2, 2, 1, 32)
    assert all(a is b for a, b in zip(same.payload + same.scale, tensors))
    assert pool.payload.t.tolist() == [4, 4]
    assert pool.payload.s.dtype == torch.int8 and pool.payload.s.any()
    assert "flow_decode_q" in KERNELS
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


def test_cpu_ssd_wrappers_run_the_plain_version_uncounted():
    reset_launches()
    xb = torch.randn((3, 10, 8))
    assert boundary_gather(xb, torch.tensor([10, 2, 0]), 4).shape == (3, 3, 8)
    x, dta = torch.randn((4, 16, 8)), -torch.rand((4, 16, 1))
    bm = torch.randn((2, 16, 4))[:, None].expand(2, 2, 16, 4)
    y, hins = ssd_chunk_call(x, dta, bm, bm, chunk=8, return_hins=True)
    assert y.shape == (4, 16, 8) and hins.shape == (4, 2, 8, 4)
    grads = ssd_chunk_bwd_call(x, dta, bm, bm, hins, y, chunk=8)
    # db and dc summed over the heads that share b and c: (B, N, S)
    assert [tuple(g.shape) for g in grads] == [(4, 16, 8), (4, 16, 1),
                                              (2, 16, 4), (2, 16, 4)]
    xh = torch.randn((2, 12, 2, 8), requires_grad=True)
    out = ssd_scan(xh, torch.rand((2, 12, 2)), torch.randn((2, 12, 4)),
                   torch.randn((2, 12, 4)), -torch.ones(2), chunk=8)
    out.sum().backward()  # chunk 8 halves to 4 for N = 12
    assert out.shape == (2, 12, 2, 8) and xh.grad.abs().sum() > 0
    assert {"boundary_gather", "ssd_chunk", "ssd_chunk_hins",
            "ssd_chunk_bwd"} <= set(KERNELS)
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_attention_free_stack_resolves_no_attention_backend(platform):
    cfg = get_smoke_config("mamba2_1p3b")
    assert check_flow_trainable(cfg, ShapeSpec("t", 64, 2, "train"),
                                platform) is None
    flow = get_smoke_config("flowformer_lm")
    assert check_flow_trainable(flow, ShapeSpec("t", 512, 16, "train"),
                                platform).name == {
        "cuda": "cuda_fused", "cpu": "fused_causal"}[platform]


def test_serve_refuses_int8_pools_for_an_ssd_stack_by_name():
    with pytest.raises(SystemExit, match="missing quant_capable") as err:
        serve.main(["--arch", "mamba2_1p3b", "--smoke", "--device", "cpu",
                    "--state-dtype", "int8"])
    assert "mixer 'ssd'" in str(err.value)


def test_main_path_never_passes_interpret():
    """``interpret=`` (the plain version on any device) is for tests and
    the card's plain-path checks: no call inside the package passes it."""
    calls = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and any(
                    kw.arg == "interpret" for kw in node.keywords):
                calls.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not calls, calls


def test_cpu_paged_gather_wrappers_run_the_plain_version_uncounted():
    reset_launches()
    gen = torch.Generator().manual_seed(0)
    kc, vc = torch.randn((5, 2, 4, 8), generator=gen), torch.randn(
        (5, 2, 4, 16), generator=gen)
    table = torch.tensor([[3, 0, 5], [5, 5, 5]], dtype=torch.int32)
    kg, vg = paged_gather(kc, vc, table)
    assert kg.shape == (2, 2, 12, 8) and vg.shape == (2, 2, 12, 16)
    for got, want in zip((kg, vg), paged_gather_ref(kc, vc, table)):
        assert torch.equal(got, want)
    kq, vq = (x.mul(20).round().clamp(-127, 127).to(torch.int8)
              for x in (kc, vc))
    ks = torch.rand((5, 2, 4, 1), generator=gen)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = paged_gather_quant(kq, vq, ks, ks, table, out_dtype=out_dtype)
        want = paged_gather_quant_ref(kq, vq, ks, ks, table,
                                      out_dtype=out_dtype)
        assert all(torch.equal(a, b) and a.dtype == out_dtype
                   for a, b in zip(got, want))
    assert {"paged_gather", "paged_gather_quant"} <= set(KERNELS)
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


def test_paged_serving_refuses_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    base = get_smoke_config("flowformer_lm")
    cfg = dataclasses.replace(base, attention=dataclasses.replace(
        base.attention, kind="softmax"))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    spec = PagedSpec(page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg, slots=2, max_len=32, paged=spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker(params, cfg, slots=2, max_len=32, paged=spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_caches(cfg, 2, 32, plan=plan_of(cfg, paged=spec))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--attn", "softmax", "--paged", "--smoke"])
    engine = Engine(params, cfg, slots=2, max_len=32, paged=spec,
                    device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(
        engine.worker.caches))
