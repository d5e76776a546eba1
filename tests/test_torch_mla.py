"""Port vs reference: DeepSeek-V2's multi-head latent attention (MLA) on
the flow branch, and K1's and K3's plain versions at its head widths.

The reference's parameters (``repro.layers.attention.attn_init``) are
carried across leaf for leaf; the same inputs, drawn with numpy from a
fixed seed, go through both packages in fp32 on the CPU.  MLA's q and k
are nope + rope wide (48 at the smoke config, 192 at full width) and v is
its own width (32, 128): K1 and K3 run there at D != Dv, held here through
their plain versions (``flow_fused_ref`` and its chunk-parallel twin, the
wrappers' CPU path; ``flow_decode_ref`` and ``flow_decode_split``) against
the reference's Pallas kernels in interpret mode.

Tolerances: projections at rtol 1e-5 and atol 1e-5 (the same matmuls);
attention outputs and the kernels' outputs and states at rtol 2e-4 and
atol 2e-5, as ``test_torch_flow.py`` holds K1 and K3 (fp32 sums in another
order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import MLAConfig as JMLAConfig  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.kernels.flow_decode.flow_decode import flow_decode_call as j_decode_call  # noqa: E402
from repro.kernels.flow_fused.flow_fused import flow_fused_call as j_fused_call  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers.rope import default_positions as j_positions  # noqa: E402
from repro_torch.config import MLAConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flow_decode import (flow_decode_call,  # noqa: E402
                                             flow_decode_split)
from repro_torch.kernels.flow_fused import (flow_fused_call,  # noqa: E402
                                            flow_fused_parallel)
from repro_torch.layers import attention as attn  # noqa: E402
from repro_torch.layers.rope import default_positions  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5


def close(a, b, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def mla_cfgs(q_lora: int = 0):
    """The DeepSeek-V2-Lite smoke config (4 heads, q and k 48 wide, v 32)
    in both packages, with a query LoRA of rank ``q_lora``."""
    jcfg = j_smoke_config("deepseek_v2_lite_16b")
    cfg = get_smoke_config("deepseek_v2_lite_16b")
    if q_lora:
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(
            jcfg.mla, q_lora_rank=q_lora))
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, q_lora_rank=q_lora))
    return jcfg, cfg


def carried(jcfg, seed=0):
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.tree.map(lambda x: t(np.asarray(x)), jp)


@pytest.mark.parametrize("q_lora", [0, 24], ids=["wq", "q_lora"])
def test_mla_params_match_reference(q_lora):
    jcfg, cfg = mla_cfgs(q_lora)
    jp = jattn.attn_init(jax.random.PRNGKey(0), jcfg)
    ours = attn.attn_init(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v["w"].shape) for k, v in ours.items()} == {
        k: tuple(np.shape(v["w"])) for k, v in jp.items()}
    assert ("q_down" in ours) == bool(q_lora) and ("wq" in ours) != bool(
        q_lora)


@pytest.mark.parametrize("q_lora", [0, 24], ids=["wq", "q_lora"])
def test_mla_projection_matches_reference(q_lora):
    """q and k = [nope | rope] per head, the rope part rotated (k's the one
    shared rope head broadcast), and v, as ``_project_qkv_mla``."""
    jcfg, cfg = mla_cfgs(q_lora)
    jp, params = carried(jcfg, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    jq, jk, jv = jattn._project_qkv(jp, jnp.asarray(x), jcfg,
                                    j_positions(2, 11, 3))
    q, k, v = attn._project_qkv(params, t(x), cfg,
                                default_positions(2, 11, 3))
    m = cfg.mla
    assert q.shape == (2, cfg.n_heads, 11, m.nope_head_dim + m.rope_head_dim)
    assert v.shape == (2, cfg.n_heads, 11, m.v_head_dim)
    for name, a, b in (("q", q, jq), ("k", k, jk), ("v", v, jv)):
        close(a, b, name, rtol=1e-5, atol=1e-5)
    rope = k[..., m.nope_head_dim:]
    assert torch.equal(rope, rope[:, :1].expand_as(rope))


def test_mla_flow_attention_matches_reference():
    jcfg, cfg = mla_cfgs()
    jp, params = carried(jcfg, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    want = jattn.attention(jp, jnp.asarray(x), jcfg, causal=True,
                           positions=j_positions(2, 37))
    got = attn.attention(params, t(x), cfg, causal=True,
                         positions=default_positions(2, 37))
    close(got, want, "attention out")


def test_mla_cache_is_a_flow_state_per_query_head():
    for cfg in (get_smoke_config("deepseek_v2_lite_16b"),
                get_config("deepseek_v2_lite_16b")):
        m = cfg.mla
        st = attn._attn_cache_init(cfg, 2, 64, device="cpu")
        d = m.nope_head_dim + m.rope_head_dim
        assert st.s.shape == (2, cfg.n_heads, d, m.v_head_dim)
        assert st.k_sum.shape == (2, cfg.n_heads, d)
    assert (d, m.v_head_dim) == (192, 128)


def test_mla_mixer_verdicts_match_the_references_strings():
    """MLA on the flow branch: every capability verdict of the attention
    mixer, string for string the reference's
    (``repro/layers/attention.py:718-770``).  MLA with softmax is not
    compared: the port refuses that branch by name at init."""
    from repro.layers import mixer as jmixer
    from repro_torch.layers import mixer as mixer_lib

    jcfg, cfg = mla_cfgs()
    jmx, mx = jmixer.get_mixer("attn"), mixer_lib.get_mixer("attn")
    for cap in ("packable", "paged_capable", "verify_capable"):
        assert getattr(mx, cap)(cfg) == getattr(jmx, cap)(jcfg), cap
    for platform in ("cuda", "cpu"):
        assert mx.differentiable(cfg, platform) == \
            jmx.differentiable(jcfg, platform)
        for dtype in ("int8", "fp8"):
            assert mx.quant_capable(cfg, platform, dtype) == \
                jmx.quant_capable(jcfg, platform, dtype), (platform, dtype)


def test_mla_softmax_stays_refused_by_name():
    cfg = get_smoke_config("deepseek_v2_lite_16b")
    soft = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind="softmax"))
    with pytest.raises(NotImplementedError, match="absorbed"):
        attn.attn_init(torch.Generator().manual_seed(0), soft)
    assert MLAConfig() == MLAConfig(**dataclasses.asdict(JMLAConfig()))


def flat_inputs(rng, bh, g, n, d, dv):
    return (rng.standard_normal((bh, g, n, d)).astype(np.float32),
            rng.standard_normal((bh, n, d)).astype(np.float32),
            rng.standard_normal((bh, n, dv)).astype(np.float32))


# (D, Dv): the DeepSeek smoke heads, and the full-width MLA heads at small N
WIDTHS = [(48, 32), (192, 128)]


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("d,dv", WIDTHS)
def test_flow_fused_plain_and_twin_at_mla_widths(d, dv, g):
    """K1's plain version (the wrapper's CPU path) and its chunk-parallel
    twin against the reference kernel in interpret mode, ragged lengths."""
    rng = np.random.default_rng(d + dv + g)
    bh, n, chunk = 3, 40, 8
    q, k, v = flat_inputs(rng, bh, g, n, d, dv)
    lens = np.array([n, 1, 23], np.int32)
    j_out, j_sums = j_fused_call(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens),
                                 chunk=chunk, interpret=True)
    before = dict(LAUNCHES)
    for tag, (out, sums) in (
            ("plain", flow_fused_call(t(q), t(k), t(v), t(lens),
                                      chunk=chunk)),
            # the kernel's super-chunks at D = 192 are multiples of five
            ("twin", flow_fused_parallel(t(q), t(k), t(v), t(lens),
                                         chunk=chunk,
                                         tile=10 if d == 192 else 16))):
        assert out.shape == (bh, g, n, dv)
        close(out, j_out, f"{tag} out")
        for name, a, b in zip(("q_sum", "k_sum", "ko_sum", "qi_sum", "z",
                               "s"), sums, j_sums):
            close(a, np.reshape(b, a.shape), f"{tag} {name}")
    assert LAUNCHES == before, "the CPU path must not count a launch"


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("d,dv", WIDTHS)
def test_flow_decode_plain_and_split_at_mla_widths(d, dv, g):
    """K3's plain version (the wrapper's CPU path, in place) and its kernel
    order (``flow_decode_split``) against the reference kernel in
    interpret mode, 4 steps from a non-zero state, each on its own
    state."""
    rng = np.random.default_rng(7 * d + dv + g)
    b, hkv, steps = 3, 2, 4
    bh = b * hkv
    t0 = np.array([20, 5, 33], np.int32)
    names = ("k_sum", "q_sum", "ko_sum", "qi_sum", "z", "s")
    st = {n: (rng.random((bh, d)) * 20).astype(np.float32)
          for n in names[:4]}
    st["z"] = (rng.random((bh,)) * 20 + 1).astype(np.float32)
    st["s"] = rng.standard_normal((bh, d, dv)).astype(np.float32)
    j = {n: jnp.asarray(st[n]) for n in names}
    j["z"] = j["z"].reshape(bh, 1)
    pool = [t(st[n]) for n in names]
    split = [t(st[n]) for n in names]
    counts = t(t0)
    for step in range(steps):
        q = rng.standard_normal((bh, g, d)).astype(np.float32)
        k = rng.standard_normal((bh, d)).astype(np.float32)
        v = rng.standard_normal((bh, dv)).astype(np.float32)
        tf = np.repeat(t0 + step + 1, hkv).astype(np.float32)[:, None]
        j_out, *new = j_decode_call(
            jnp.asarray(tf), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            *(j[n] for n in names), eps=1e-6, phi="sigmoid",
            use_allocation=True, interpret=True)
        j.update(zip(names, new))
        counts = counts + 1
        out = flow_decode_call(counts, t(q), t(k), t(v), *pool, hkv=hkv)
        s_out, split = flow_decode_split(counts, t(q), t(k), t(v), *split,
                                         hkv=hkv)
        for tag, o, state in (("plain", out, pool), ("split", s_out, split)):
            close(o, j_out, f"{tag} out step {step}")
            for name, x in zip(names, state):
                close(x, np.reshape(j[name], x.shape),
                      f"{tag} {name} step {step}")
