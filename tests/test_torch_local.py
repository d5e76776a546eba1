"""Port vs reference: local sliding-window attention and its ring cache.

RecurrentGemma's "local" slots in softmax mode: the same numpy inputs (and
the reference's ``attn_init`` parameters, carried across) go through
``repro.layers.attention`` and ``repro_torch.layers.attention`` in fp32 on
the CPU.  Tolerances: attention outputs |port - ref| <= 1e-5 |ref| + 1e-5
max |ref| (fp32 logits and softmax sums in another order); the ring
caches at the same bound (the projections' rows, each a matmul summed in
another order, written by index) and their positions exactly.
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
from repro.layers.rope import default_positions as j_positions  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.layers import attention as attn  # noqa: E402
from repro_torch.layers import mixer as mixer_lib  # noqa: E402
from repro_torch.layers.rope import default_positions  # noqa: E402

ARCH = "recurrentgemma_9b"
W = 64  # the smoke config's window


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def close(name, got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    lim = tol * np.abs(want) + tol * float(np.abs(want).max())
    err = np.abs(got - want)
    assert (err <= lim).all(), f"{name}: max |diff| {float(err.max()):.3e}"


def local_cfgs():
    """The smoke config's local slot in softmax mode, both packages."""
    jcfg, cfg = j_smoke_config(ARCH), get_smoke_config(ARCH)
    jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
        jcfg.attention, kind="softmax"))
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind="softmax"))
    return jattn.dataclass_replace_attn(jcfg, "local"), \
        attn.dataclass_replace_attn(cfg, "local")


@pytest.mark.parametrize("n", [17, W, 2 * W, 3 * W])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_local_attn_matches_reference(n, softcap):
    """Below one window, at one, and past it in two and three blocks; the
    four query heads share one kv head, as RecurrentGemma's MQA."""
    rng = np.random.default_rng(n)
    q = rng.standard_normal((2, 4, n, 32)).astype(np.float32)
    k = rng.standard_normal((2, 1, n, 32)).astype(np.float32)
    v = rng.standard_normal((2, 1, n, 32)).astype(np.float32)
    close(f"local n={n}", attn._local_attn(t(q), t(k), t(v), window=W,
                                           softcap=softcap),
          jattn._local_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            window=W, softcap=softcap))


@pytest.mark.parametrize("n", [W + 1, 2 * W + 7])
def test_local_attn_past_the_window_needs_whole_windows(n):
    z = torch.zeros((1, 4, n, 32))
    with pytest.raises(ValueError, match=f"seq {n} must be divisible by "
                       f"window {W}"):
        attn._local_attn(z, z[:, :1], z[:, :1], window=W)


def ring_close(what, c, jc):
    close(f"{what} ring k", c.k, jc.k)
    close(f"{what} ring v", c.v, jc.v)
    np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jc.pos),
                                  err_msg=f"{what} ring pos")


@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = local_cfgs()
    jp = jattn.attn_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, cfg, jax.tree.map(lambda x: t(np.asarray(x)), jp)


@pytest.mark.parametrize("n,max_len,steps", [(40, 96, 30), (W, 192, 20),
                                             (2 * W, 192, 70), (24, 32, 20)])
def test_ring_prefill_and_decode_match_reference(layer, n, max_len, steps):
    """The ring after a prefill (below, at and past the window; a ring cut
    to max_len < window), then decode on past the window, so the ring
    wraps: every output and the ring itself against the reference's."""
    jcfg, jp, cfg, p = layer
    assert cfg.attention.kind == "local"
    rng = np.random.default_rng(n + max_len)
    x = rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
    jout, jc = jattn._attention_prefill(
        jp, jnp.asarray(x), jcfg, max_len,
        positions=j_positions(2, n))
    out, c = attn._attention_prefill(p, t(x), cfg, max_len,
                                     positions=default_positions(2, n))
    close("prefill out", out, jout)
    assert c.k.shape[2] == min(W, max_len)
    ring_close("prefill", c, jc)
    for step in range(steps):
        tok = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        pos = n + step
        jout, jc = jattn._attention_decode(
            jp, jnp.asarray(tok), jc, jcfg,
            positions=j_positions(2, 1, pos))
        out, c = attn._attention_decode(p, t(tok), c, cfg,
                                        positions=default_positions(2, 1,
                                                                    pos))
        close(f"decode out {step}", out, jout)
        ring_close(f"step {step}", c, jc)


def test_ring_refuses_packed_prefill_by_name(layer):
    _, _, cfg, p = layer
    x = torch.zeros((2, 8, cfg.d_model))
    with pytest.raises(mixer_lib.MixerResolutionError,
                       match="missing capability packable") as err:
        attn._attention_prefill(p, x, cfg, 32, lengths=torch.tensor([8, 3]))
    assert err.value.rejections == (("local", "packable",
                                     "per-row ring alignment"),)


@pytest.mark.parametrize("kind", ["flow", "softmax", "linear"])
def test_local_slot_narrows_the_config(kind):
    """``LocalSlotMixer`` keeps flow mode's config and makes any other kind
    a local ring, as the reference's ``_local_cfg``; a ring refuses a
    speculative window by name."""
    def of(c):
        return dataclasses.replace(c, attention=dataclasses.replace(
            c.attention, kind=kind))

    cfg, jcfg = of(get_smoke_config(ARCH)), of(j_smoke_config(ARCH))
    got = attn.dataclass_replace_attn(cfg, "local").attention.kind
    assert got == jattn.dataclass_replace_attn(jcfg, "local").attention.kind
    assert got == ("flow" if kind == "flow" else "local")
    assert attn.dataclass_replace_attn(cfg, "attn") is cfg
    mx, jmx = mixer_lib.get_mixer("local"), jmixer.get_mixer("local")
    assert mx.verify_capable(cfg) == jmx.verify_capable(jcfg)
    if kind != "flow":
        with pytest.raises(mixer_lib.MixerResolutionError,
                           match="missing capability verify_capable"):
            mx.verify_step({}, torch.zeros((1, 2, cfg.d_model)), None, cfg)
