"""Port vs reference: the plain versions of the flow_fused (K1) and
flow_decode (K3) kernels, and K3's kernel order (``flow_decode_split``).

The same numpy inputs, made from a seed, go through the JAX package (its
Pallas kernels in interpret mode, and its plain XLA functions) and through
the port's kernel wrappers on CPU tensors, which run the plain PyTorch
versions.  Everything is fp32.  Tolerance: rtol 2e-4, atol 2e-5 on every
output and every state piece -- the two sides sum the same fp32 terms in
another order, and the flow sums grow with the position, so the error is
relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.attention import fused as jfused  # noqa: E402
from repro.attention import recurrent as jrec  # noqa: E402
from repro.core.flow_attention import FlowConfig as JFlowConfig  # noqa: E402
from repro.kernels.flow_decode.flow_decode import flow_decode_call as j_decode_call  # noqa: E402
from repro.kernels.flow_fused.flow_fused import flow_fused_call as j_fused_call  # noqa: E402
from repro_torch.attention import fused as tfused  # noqa: E402
from repro_torch.attention import recurrent as trec  # noqa: E402
from repro_torch.core.flow_attention import FlowConfig  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flow_decode import (flow_decode_call,  # noqa: E402
                                             flow_decode_split,
                                             flow_decode_step)
from repro_torch.kernels.flow_fused import (flow_fused_call,  # noqa: E402
                                            flow_fused_parallel)

RTOL, ATOL = 2e-4, 2e-5


def close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def flat_inputs(rng, bh, g, n, d):
    q = rng.standard_normal((bh, g, n, d)).astype(np.float32)
    k = rng.standard_normal((bh, n, d)).astype(np.float32)
    v = rng.standard_normal((bh, n, d)).astype(np.float32)
    return q, k, v


# (phi, G, N, chunk): odd N padded to the chunk, chunks 8/64/128, ragged lens
CASES = [
    ("sigmoid", 1, 37, 8),
    ("sigmoid", 2, 37, 64),
    ("elu1", 1, 67, 64),
    ("elu1", 2, 19, 8),
    ("relu", 1, 131, 128),
    ("relu", 2, 45, 128),
]


@pytest.mark.parametrize("phi,g,n,chunk", CASES)
def test_flow_fused_plain_matches_pallas_interpret(phi, g, n, chunk):
    rng = np.random.default_rng(len(phi) + 10 * g + 100 * n + chunk)
    c = min(chunk, n)
    n_pad = -(-n // c) * c
    bh, d = 3, 16
    q, k, v = flat_inputs(rng, bh, g, n_pad, d)
    lens = np.array([n, 1 + n // 3, max(1, n - 5)], np.int32)
    j_out, j_sums = j_fused_call(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens), chunk=c,
                                 phi=phi, interpret=True)
    before = dict(LAUNCHES)
    out, sums = flow_fused_call(t(q), t(k), t(v), t(lens), chunk=c, phi=phi)
    assert LAUNCHES == before, "the CPU path must not count a launch"
    close(out, j_out, "out")
    names = ("q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s")
    for name, a, b in zip(names, sums, j_sums):
        close(a, np.reshape(b, a.shape), name)


# (phi, G, use_alloc, N, kernel chunk, flows' super-chunk): the kernel's
# decomposition at chunks 8-128, against the reference kernel (chunk 16)
PARALLEL_CASES = [
    ("sigmoid", 1, True, 48, 8, 16),
    ("sigmoid", 4, False, 80, 32, 8),
    ("elu1", 2, True, 144, 64, 32),
    ("elu1", 1, False, 48, 128, 64),
    ("relu", 1, True, 112, 32, 64),
    ("relu", 2, False, 64, 64, 16),
    ("relu", 4, True, 48, 128, 128),
    ("sigmoid", 2, True, 144, 64, 128),
]


@pytest.mark.parametrize("phi,g,use_alloc,n,chunk,tile", PARALLEL_CASES)
def test_flow_fused_parallel_matches_pallas_interpret(phi, g, use_alloc, n,
                                                      chunk, tile):
    rng = np.random.default_rng(len(phi) + 10 * g + n + chunk + tile)
    bh, d = 4, 16
    q, k, v = flat_inputs(rng, bh, g, n, d)
    if phi == "relu":  # rows whose phi is all zero: near-zero denominators
        q[:, :, 3::7] = -np.abs(q[:, :, 3::7])
        k[:, 5::9] = -np.abs(k[:, 5::9])
    lens = np.array([n, 1, 1 + n // 3, n - 5], np.int32)
    j_out, j_sums = j_fused_call(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens), chunk=16,
                                 phi=phi, use_alloc=use_alloc, interpret=True)
    out, sums = flow_fused_parallel(t(q), t(k), t(v), t(lens), chunk=chunk,
                                    tile=tile, phi=phi, use_alloc=use_alloc)
    close(out, j_out, "out")
    for i, li in enumerate(lens):
        assert not out[i, :, li:].any(), f"row {i}: non-zero past lens"
    names = ("q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s")
    for name, a, b in zip(names, sums, j_sums):
        close(a, np.reshape(b, a.shape), name)


@pytest.mark.parametrize("phi,g,n,chunk", CASES[:4])
def test_fused_causal_forward_matches_reference(phi, g, n, chunk):
    rng = np.random.default_rng(7 + n)
    b, hkv, d = 2, 2, 16
    q = rng.standard_normal((b, hkv * g, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, n, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, n, d)).astype(np.float32)
    lengths = np.array([n, max(1, n // 2)], np.int32)
    kw = dict(phi=phi, causal=True, strict_causal=True, chunk_size=chunk)
    j_out, j_st = jfused.fused_causal_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JFlowConfig(**kw),
        return_state=True, lengths=jnp.asarray(lengths))
    out, st = tfused.fused_causal_forward(t(q), t(k), t(v), FlowConfig(**kw),
                                          return_state=True, lengths=t(lengths))
    # outputs past a row's length are never read; compare the valid span
    for i, li in enumerate(lengths):
        close(out[i, :, :li], np.asarray(j_out)[i, :, :li], f"out row {i}")
    for name, a, b_ in zip(trec.FlowState._fields, st, j_st):
        close(a, b_, name)


def random_state(rng, b, hkv, d, t0):
    """A non-zero FlowState with the magnitudes of t0 consumed positions."""
    return dict(
        t=np.full((b,), t0, np.int32),
        q_sum=(rng.random((b, hkv, d)) * t0).astype(np.float32),
        k_sum=(rng.random((b, hkv, d)) * t0).astype(np.float32),
        ko_sum=(rng.random((b, hkv, d)) * t0).astype(np.float32),
        qi_sum=(rng.random((b, hkv, d)) * t0).astype(np.float32),
        z=(rng.random((b, hkv)) * t0 + 1.0).astype(np.float32),
        s=rng.standard_normal((b, hkv, d, d)).astype(np.float32),
    )


@pytest.mark.parametrize("phi,g", [("sigmoid", 1), ("elu1", 2), ("relu", 2)])
def test_flow_decode_plain_matches_pallas_interpret(phi, g):
    rng = np.random.default_rng(3 + g)
    b, hkv, d, steps = 3, 2, 16, 4
    bh = b * hkv
    st = random_state(rng, b, hkv, d, 20)
    st["t"] = np.array([20, 5, 33], np.int32)
    j = {k: jnp.asarray(v).reshape((bh,) + v.shape[2:]) if v.ndim > 1
         else jnp.asarray(v) for k, v in st.items()}
    j["z"] = j["z"].reshape(bh, 1)
    pool = {k: t(v) for k, v in st.items()}
    before = dict(LAUNCHES)
    for step in range(steps):
        q = rng.standard_normal((bh, g, d)).astype(np.float32)
        k = rng.standard_normal((bh, d)).astype(np.float32)
        v = rng.standard_normal((bh, d)).astype(np.float32)
        tf = np.repeat(st["t"] + step + 1, hkv).astype(np.float32)[:, None]
        j_out, *new = j_decode_call(
            jnp.asarray(tf), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            j["k_sum"], j["q_sum"], j["ko_sum"], j["qi_sum"], j["z"], j["s"],
            eps=1e-6, phi=phi, use_allocation=True, interpret=True)
        j.update(zip(("k_sum", "q_sum", "ko_sum", "qi_sum", "z", "s"), new))
        views = [pool[n].view((bh,) + pool[n].shape[2:])
                 for n in ("k_sum", "q_sum", "ko_sum", "qi_sum", "z", "s")]
        ptrs = [x.data_ptr() for x in views]
        pool["t"] += 1
        out = flow_decode_call(pool["t"], t(q), t(k), t(v), *views, hkv=hkv,
                               phi=phi)
        assert [x.data_ptr() for x in views] == ptrs
        close(out, j_out, f"out step {step}")
        for name, x in zip(("k_sum", "q_sum", "ko_sum", "qi_sum", "z", "s"),
                           views):
            close(x, np.reshape(j[name], x.shape), f"{name} step {step}")
    assert LAUNCHES == before, "the CPU path must not count a launch"


@pytest.mark.parametrize("use_alloc", [True, False], ids=["alloc", "no_alloc"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("phi", ["sigmoid", "elu1", "relu"])
def test_flow_decode_split_matches_pallas_interpret(phi, g, d, use_alloc):
    """K3's kernel order (``flow_decode_split``: the output from the old S
    plus the token's own term) against the reference kernel in interpret
    mode, 4 steps from a non-zero state, each side on its own state."""
    rng = np.random.default_rng(30 + 7 * g + d)
    b, hkv, steps = 3, 2, 4
    bh = b * hkv
    st = random_state(rng, b, hkv, d, 20)
    st["t"] = np.array([20, 5, 33], np.int32)
    names = ("k_sum", "q_sum", "ko_sum", "qi_sum", "z", "s")
    j = {n: jnp.asarray(st[n]).reshape((bh,) + st[n].shape[2:]) for n in names}
    j["z"] = j["z"].reshape(bh, 1)
    state = [t(st[n]).reshape((bh,) + st[n].shape[2:]) for n in names]
    counts = t(st["t"])
    for step in range(steps):
        q = rng.standard_normal((bh, g, d)).astype(np.float32)
        k = rng.standard_normal((bh, d)).astype(np.float32)
        v = rng.standard_normal((bh, d)).astype(np.float32)
        tf = np.repeat(st["t"] + step + 1, hkv).astype(np.float32)[:, None]
        j_out, *new = j_decode_call(
            jnp.asarray(tf), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            *(j[n] for n in names), eps=1e-6, phi=phi,
            use_allocation=use_alloc, interpret=True)
        j.update(zip(names, new))
        counts = counts + 1
        out, state = flow_decode_split(counts, t(q), t(k), t(v), *state,
                                       hkv=hkv, phi=phi, use_alloc=use_alloc)
        close(out, j_out, f"out step {step}")
        for name, x in zip(names, state):
            close(x, np.reshape(j[name], x.shape), f"{name} step {step}")


def test_decode_step_matches_reference_and_updates_in_place():
    rng = np.random.default_rng(11)
    b, hkv, g, d = 2, 2, 2, 16
    st = random_state(rng, b, hkv, d, 9)
    cfg = dict(causal=True, strict_causal=True)
    j_state = jrec.FlowState(**{k: jnp.asarray(v) for k, v in st.items()})
    pool = trec.FlowState(**{k: t(v) for k, v in st.items()})
    for step in range(3):
        q = rng.standard_normal((b, hkv * g, 1, d)).astype(np.float32)
        k = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
        v = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
        j_state, j_out = jrec.decode_step(j_state, jnp.asarray(q),
                                          jnp.asarray(k), jnp.asarray(v),
                                          JFlowConfig(**cfg))
        plain, out_plain = trec.decode_step(pool, t(q), t(k), t(v),
                                            FlowConfig(**cfg))
        same, out = flow_decode_step(pool, t(q), t(k), t(v), FlowConfig(**cfg))
        assert all(a is b_ for a, b_ in zip(same, pool))
        close(out_plain, j_out, f"plain out step {step}")
        close(out, j_out, f"wrapper out step {step}")
        for name, a, b_, c in zip(trec.FlowState._fields, pool, j_state,
                                  plain):
            close(a, b_, f"{name} step {step}")
            close(c, b_, f"plain {name} step {step}")


@pytest.mark.parametrize("g", [1, 2])
def test_prefill_state_hands_off_to_decode(g):
    """Packed prefill's boundary state, decoded onward, equals the full
    sequence's outputs (port), and the reference agrees on the state."""
    rng = np.random.default_rng(20 + g)
    b, hkv, d, n, extra = 2, 2, 16, 21, 4
    lengths = np.array([n, 13], np.int32)
    q = rng.standard_normal((b, hkv * g, n + extra, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, n + extra, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, n + extra, d)).astype(np.float32)
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=8)
    _, st = tfused.fused_causal_forward(t(q[:, :, :n]), t(k[:, :, :n]),
                                        t(v[:, :, :n]), cfg,
                                        return_state=True, lengths=t(lengths))
    _, j_st = jfused.fused_causal_forward(
        jnp.asarray(q[:, :, :n]), jnp.asarray(k[:, :, :n]),
        jnp.asarray(v[:, :, :n]),
        JFlowConfig(causal=True, strict_causal=True, chunk_size=8),
        return_state=True, lengths=jnp.asarray(lengths))
    for name, a, b_ in zip(trec.FlowState._fields, st, j_st):
        close(a, b_, f"boundary {name}")
    for i, li in enumerate(lengths):
        full = tfused.fused_causal_forward(
            t(q[i:i + 1, :, :li + extra]), t(k[i:i + 1, :, :li + extra]),
            t(v[i:i + 1, :, :li + extra]), cfg)
        row = trec.FlowState(*(x[i:i + 1].clone() for x in st))
        for s in range(extra):
            p = li + s
            row, out = flow_decode_step(row, t(q[i:i + 1, :, p:p + 1]),
                                        t(k[i:i + 1, :, p:p + 1]),
                                        t(v[i:i + 1, :, p:p + 1]), cfg)
            close(out, full[:, :, p:p + 1], f"row {i} decode {s}")
