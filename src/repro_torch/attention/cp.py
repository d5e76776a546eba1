"""Context-parallel Flow-Attention backends: shard-local strategy + glue.

The counterpart of ``repro/attention/cp.py``.  The only cross-token
coupling in Flow-Attention is through global sums of d-vectors and
(d x dv) matrices, so sharding the sequence axis costs collectives of
O(d^2) bytes, whatever the sequence length.  Two registry backends carry
that glue:

* ``cp_nc``     -- non-causal: the six flow sums become ``psum``s;
* ``cp_causal`` -- strict-causal: each cumulative sum is a local cumsum
  plus the exclusive prefix of the per-position partials, and ``prefill``
  / ``prefill_packed`` return the boundary ``FlowState`` as one masked
  ``psum`` a field.

``cp_causal`` wraps a shard-local inner strategy: the grouped causal dot
of a backend exposing ``causal_dot_fn`` (``cuda_chunk``, ``chunked``,
``cumsum``), resolved at the shard-local shapes by ``ShardSpec.inner``.
``"auto"`` picks ``cuda_chunk`` (K5a forward; K5a and K5b backward
through ``FlowChunkDot``) on a CUDA device, as the reference's picks
``pallas_chunk`` on a TPU, and raises there for a shape no kernel takes:
the plain dots refuse ``cuda`` unless pinned (``inner="chunked"``).  On
the CPU it picks the plain ``chunked`` (or ``cumsum`` where the local
length does not chunk).  ``cp_nc``'s shard-local work is fixed einsums
between the psums, as in the reference, and takes no inner.

Execution model: a single controller.  The reference runs the shard body
under ``jax.shard_map`` on every device at once.  The port splits q, k
and v by the spec -- the sequence over ``ShardSpec.axis``, the batch over
``ShardSpec.batch_axis`` -- runs each position's shard body in rank order
on that position's device, and combines their partials with the
rank-ordered collectives of ``distribution/collectives.py``
(``run_spmd``).  Positions along the mesh's other axes would hold
replicas of the same result, so they run nothing.  Gradients flow through
autograd: the collectives are tensor operations.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.attention import pipeline
from repro_torch.attention.recurrent import FlowState
from repro_torch.attention.registry import (Backend, ResolutionError,
                                            ShapeInfo, ShardSpec,
                                            get_backend, list_backends)
from repro_torch.core.flow_attention import (FlowConfig, _group, _ungroup,
                                             phi_map)
from repro_torch.distribution.collectives import run_spmd
from repro_torch.distribution.mesh import axis_tuple


# ---------------------------------------------------------------------------
# Inner (shard-local) strategy resolution
# ---------------------------------------------------------------------------
def resolve_inner(cfg: FlowConfig, local_shapes: ShapeInfo, platform: str,
                  shard: ShardSpec) -> Backend:
    """The shard-local causal aggregation strategy of ``cp_causal``.

    Candidates are the registered backends exposing ``causal_dot_fn``;
    ``auto`` walks them in registry order against the shard-local shapes
    (under ``backend="plain"`` the plain ones only).  A pinned inner is
    judged as a pin by name, so a plain dot runs on a CUDA device only
    when it is named.
    """
    inner = shard.inner or "auto"
    explicit = inner != "auto"
    if explicit:
        names = [inner]
    else:
        names = [n for n in list_backends()
                 if hasattr(get_backend(n), "causal_dot_fn")
                 and (cfg.backend != "plain" or not n.startswith("cuda_"))]
    rejections = []
    for name in names:
        try:
            be = get_backend(name)
        except ValueError as err:
            raise ResolutionError(str(err), ((name, str(err)),)) from None
        if not hasattr(be, "causal_dot_fn"):
            rejections.append((name, "no shard-local causal dot (cannot be "
                                     "a context-parallel inner strategy)"))
            continue
        judged = dataclasses.replace(cfg, backend=name) if explicit else cfg
        ok, why = be.supports(judged, local_shapes, platform, op="forward")
        if ok:
            return be
        rejections.append((name, why))
    raise ResolutionError(
        f"no shard-local inner strategy for context-parallel causal flow "
        f"(local {local_shapes}):\n  "
        + "\n  ".join(f"{n}: {w}" for n, w in rejections), rejections)


# ---------------------------------------------------------------------------
# Non-causal shard body: psums of the flow sums
# ---------------------------------------------------------------------------
def _nc_shard_body(q, k, v, cfg: FlowConfig, ax):
    """Sequence-parallel non-causal Flow-Attention at one position (a
    generator: ``yield ax.psum(x)`` is the collective).

    q: (B, Hq, Nl, D); k: (B, Hkv, Ml, D); v: (B, Hkv, Ml, Dv), the local
    shards.  Collective volume: 5 psums of (B, Hkv, D), 1 of (B, Hkv, D,
    Dv) and one of (B, Hkv).
    """
    out_dtype = q.dtype
    eps = cfg.eps
    nl, ml = q.shape[2], k.shape[2]
    hkv = k.shape[1]
    n_tot = nl * ax.size
    m_tot = ml * ax.size

    phi_q = phi_map(q.float(), cfg.phi)
    phi_k = phi_map(k.float(), cfg.phi)
    vf = v.float()
    qg = _group(phi_q, hkv)

    k_sum = yield ax.psum(phi_k.sum(dim=2))  # (B, Hkv, D)
    q_sum = yield ax.psum(qg.sum(dim=(2, 3)))
    sink_in = 1.0 / torch.einsum("bhgnd,bhd->bhgn", qg + eps, k_sum + eps)
    src_out = 1.0 / torch.einsum("bhmd,bhd->bhm", phi_k + eps, q_sum + eps)

    ko_sum = yield ax.psum((phi_k * src_out[..., None]).sum(dim=2))
    cons_sink = torch.einsum("bhgnd,bhd->bhgn", qg + eps, ko_sum + eps)
    qi_sum = yield ax.psum((qg * sink_in[..., None]).sum(dim=(2, 3)))
    cons_src = torch.einsum("bhmd,bhd->bhm", phi_k + eps,
                            qi_sum + eps).clamp(-1.0, 1.0)

    n_sinks = qg.shape[2] * n_tot
    if cfg.use_competition:
        # the clamp bounds exp(): a distributed softmax needs no running max
        e = torch.exp(cons_src)
        z = yield ax.psum(e.sum(dim=-1))  # (B, Hkv)
        v_hat = vf * (e / z[..., None] * float(m_tot))[..., None]
    else:
        v_hat = vf
    if cfg.use_allocation:
        alloc = torch.sigmoid(cons_sink * (float(n_sinks) / float(m_tot)))
    else:
        alloc = torch.ones_like(cons_sink)

    # (B, Hkv, D, Dv): THE collective, O(d^2) whatever the sequence length
    kv = yield ax.psum(torch.einsum("bhmd,bhme->bhde", phi_k, v_hat))
    agg = torch.einsum("bhgnd,bhde->bhgne", qg * sink_in[..., None], kv)
    return _ungroup(agg * alloc[..., None]).to(out_dtype)


# ---------------------------------------------------------------------------
# Causal shard body: exclusive prefixes of per-position partials
# ---------------------------------------------------------------------------
def _causal_shard_body(q, k, v, lengths, cfg: FlowConfig, dot_fn, ax,
                       return_state: bool):
    """Sequence-parallel strict-causal Flow-Attention at one position (a
    generator over the collectives).

    Position p holds global positions [p Nl, (p + 1) Nl).  The coupling
    across positions is the exclusive prefix of six small partial sums:
    O(P d^2) bytes, whatever the sequence length.  ``dot_fn`` is the
    shard-local grouped causal dot (the inner strategy).  With
    ``return_state`` it also returns the per-row boundary ``FlowState``
    (at ``lengths[i] - 1``, or the last position without ``lengths``):
    each field is a prefix sum of per-position contributions, so its
    boundary value is one masked local sum and a psum.
    """
    if not cfg.strict_causal:
        raise ValueError("context-parallel causal requires strict_causal")
    out_dtype = q.dtype
    eps = cfg.eps
    b, _, nl, _ = q.shape
    hkv = k.shape[1]
    idx = ax.index
    dev = q.device

    phi_q = phi_map(q.float(), cfg.phi)
    phi_k = phi_map(k.float(), cfg.phi)
    vf = v.float()
    qg = _group(phi_q, hkv)
    g = qg.shape[2]

    # global positions of the local shard
    pos = (idx * nl + torch.arange(1, nl + 1, device=dev)).float()
    normal_q = pos * g
    normal_k = pos

    def dist_cumsum(x):
        """Inclusive cumsum along dim 2 of a sequence-sharded tensor."""
        local = torch.cumsum(x, dim=2)
        prev = yield ax.exclusive_prefix(x.sum(dim=2))
        return local + prev[:, :, None]

    k_csum = yield from dist_cumsum(phi_k)
    q_csum = yield from dist_cumsum(qg.sum(dim=2))
    sink_in = normal_k / torch.einsum("bhgnd,bhnd->bhgn", qg + eps,
                                      k_csum + eps)
    src_out = normal_q / torch.einsum("bhnd,bhnd->bhn", phi_k + eps,
                                      q_csum + eps)

    ko_csum = yield from dist_cumsum(phi_k * src_out[..., None])
    cons_sink = torch.einsum("bhgnd,bhnd->bhgn", qg + eps,
                             ko_csum + eps) / normal_q
    qi_csum = yield from dist_cumsum((qg * sink_in[..., None]).sum(dim=2))
    cons_src = (torch.einsum("bhnd,bhnd->bhn", phi_k + eps, qi_csum + eps)
                / normal_k).clamp(-1.0, 1.0)

    alloc = (torch.sigmoid(cons_sink) if cfg.use_allocation
             else torch.ones_like(cons_sink))
    e = torch.exp(cons_src)
    z_prev = yield ax.exclusive_prefix(e.sum(dim=-1))
    z = torch.cumsum(e, dim=-1) + z_prev[..., None]  # (B, Hkv, Nl)

    v_w = vf * e[..., None]
    # the local causal dot (the inner strategy) + the carried state
    q_in = qg * sink_in[..., None]
    local = dot_fn(q_in, phi_k, v_w)
    s_prev = yield ax.exclusive_prefix(
        torch.einsum("bhnd,bhne->bhde", phi_k, v_w))  # (B, Hkv, D, Dv)
    inter = torch.einsum("bhgnd,bhde->bhgne", q_in, s_prev)
    agg = local + inter

    out = agg * (normal_k / z)[:, :, None, :, None] * alloc[..., None]
    out = _ungroup(out).to(out_dtype)
    if not return_state:
        return out

    # the boundary FlowState: each field the masked sum over global
    # positions < t, one (B, H, ...)-sized psum a field
    if lengths is None:
        t = torch.full((b,), nl * ax.size, dtype=torch.int32, device=dev)
    else:
        t = lengths.to(device=dev, dtype=torch.int32)
    pos0 = idx * nl + torch.arange(nl, device=dev)
    valid = (pos0[None, :] < t[:, None]).float()  # (B, Nl)
    vmask = valid[:, None, :, None]

    def masked_psum(contrib):
        return (yield ax.psum((contrib * vmask).sum(dim=2)))

    q_sum = yield from masked_psum(qg.sum(dim=2))
    k_sum = yield from masked_psum(phi_k)
    ko_sum = yield from masked_psum(phi_k * src_out[..., None])
    qi_sum = yield from masked_psum((qg * sink_in[..., None]).sum(dim=2))
    z_sum = yield ax.psum((e * valid[:, None, :]).sum(dim=-1))
    s = yield ax.psum(torch.einsum("bhnd,bhne->bhde", phi_k * vmask, v_w))
    return out, FlowState(t=t, q_sum=q_sum, k_sum=k_sum, ko_sum=ko_sum,
                          qi_sum=qi_sum, z=z_sum, s=s)


# ---------------------------------------------------------------------------
# Splitting by the spec and joining the positions' results
# ---------------------------------------------------------------------------
def _layout(shard: ShardSpec) -> tuple[tuple, tuple]:
    """(the batch axes, the axes the positions span: batch axes then the
    sequence axis)."""
    baxes = tuple(a for a in axis_tuple(shard.batch_axis) if a != shard.axis)
    return baxes, baxes + (shard.axis,)


def _split(shard: ShardSpec, tensors: list, seq_dims: list) -> list:
    """Per-position argument tuples: each tensor split over the batch axes
    along dim 0 and, where its ``seq_dims`` entry is not None, over the
    sequence axis along that dim, each piece on its position's device."""
    mesh = shard.mesh
    baxes, over = _layout(shard)
    nb = mesh.axes_size(baxes)
    ns = shard.axis_size
    for x in tensors:
        if x is not None and x.shape[0] % nb:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"{nb}-way batch axes {baxes}")
    args = []
    for c in mesh.coords(over):
        bi = 0
        for a in baxes:
            bi = bi * mesh.shape[a] + c[a]
        dev = mesh.device_at(c)
        pieces = []
        for x, sd in zip(tensors, seq_dims):
            if x is None:
                pieces.append(None)
                continue
            piece = x.chunk(nb, dim=0)[bi] if nb > 1 else x
            if sd is not None:
                piece = piece.chunk(ns, dim=sd)[c[shard.axis]]
            pieces.append(piece.to(dev))
        args.append(tuple(pieces))
    return args


def _join(shard: ShardSpec, outs: list, seq_dim) -> torch.Tensor:
    """The positions' pieces joined back: along ``seq_dim`` over the
    sequence axis (or the rank-0 copy where ``seq_dim`` is None: a
    psum'd value every sequence position holds alike), then along dim 0
    over the batch axes, on the first position's device."""
    mesh = shard.mesh
    ns = shard.axis_size
    dev = mesh.device_at(mesh.coords(_layout(shard)[1])[0])
    rows = [outs[i:i + ns] for i in range(0, len(outs), ns)]
    parts = [torch.cat([p.to(dev) for p in row], dim=seq_dim)
             if seq_dim is not None else row[0].to(dev) for row in rows]
    return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------
class _ContextParallel(Backend):
    """Shared shard plumbing for the collective-glue backends."""

    shard_only = True

    def _check_shard(self, op, shard: ShardSpec | None, shapes, platform):
        if shard is None:
            return ("context-parallel glue requires a sharded ExecutionPlan "
                    "(no ShardSpec in this resolution)")
        if shard.mesh is None:
            return ("ShardSpec has no mesh bound (resolution cannot place "
                    "collectives)")
        if shard.axis not in dict(shard.mesh.shape):
            return (f"mesh has no axis {shard.axis!r} "
                    f"(axes: {tuple(dict(shard.mesh.shape))})")
        size = shard.axis_size
        if size < 2:
            return (f"axis {shard.axis!r} has size {size} — nothing to "
                    "shard (resolve without a ShardSpec instead)")
        if shapes is not None:
            if shapes.n % size:
                return (f"N={shapes.n} not divisible by the {size}-way "
                        f"axis {shard.axis!r}")
            if shapes.m % size:
                return (f"M={shapes.m} not divisible by the {size}-way "
                        f"axis {shard.axis!r}")
        return None

    def _shard_shapes(self, q, k, v, cfg, shard):
        """(expanded k, v, local ShapeInfo): kv are expanded for
        ``gqa_mode="expand"`` before sharding, so the shard body always
        runs shared-group math."""
        k, v = pipeline.expand_kv(q, k, v, cfg)
        size = shard.axis_size
        sh = ShapeInfo.from_qkv(q, k, v)
        local = dataclasses.replace(sh, n=sh.n // size, m=sh.m // size)
        return k, v, local


class ContextParallelNC(_ContextParallel):
    """Non-causal Flow-Attention with the sequence axis sharded over a mesh
    axis: the six global flow sums become psums of O(d^2) bytes each."""

    provides = frozenset({"forward"})
    differentiable = frozenset({"forward"})
    shardable = frozenset({"forward"})

    def shard_support(self, op="forward", shard=None, *, cfg=None,
                      shapes=None, platform=None):
        if op not in self.shardable:
            return False, f"does not provide sharded {op}"
        why = self._check_shard(op, shard, shapes, platform)
        if why:
            return False, why
        if shard.inner != "auto":
            return False, (
                "non-causal glue has no injectable inner strategy (the "
                "shard-local work is fixed einsums between psums; "
                f"cuda_nc fuses global sums in-kernel) — got inner="
                f"{shard.inner!r}")
        return True, f"psum glue over {shard.describe()}"

    def supports(self, cfg, shapes, platform, *, op="forward"):
        if cfg.causal:
            return False, "non-causal glue (use cp_causal for causal plans)"
        return True, "sharded non-causal flow"

    def forward(self, q, k, v, cfg, *, shard: ShardSpec):
        k, v, _ = self._shard_shapes(q, k, v, cfg, shard)
        args = _split(shard, [q, k, v], [2, 2, 2])
        outs = run_spmd(lambda ql, kl, vl, ax: _nc_shard_body(
            ql, kl, vl, cfg, ax), args, shard.mesh, shard.axis,
            _layout(shard)[1])
        return _join(shard, outs, 2)


class ContextParallelCausal(_ContextParallel):
    """Strict-causal Flow-Attention with the sequence axis sharded: local
    cumsums plus the exclusive prefix of per-position partials, around a
    resolvable shard-local aggregation strategy (``ShardSpec.inner``).

    Provides ``prefill`` / ``prefill_packed``: the boundary ``FlowState``
    is six masked psums, so sequence-parallel admission is exact."""

    provides = frozenset({"forward", "prefill", "prefill_packed"})
    differentiable = frozenset({"forward", "prefill", "prefill_packed"})
    shardable = frozenset({"forward", "prefill", "prefill_packed"})

    def shard_support(self, op="forward", shard=None, *, cfg=None,
                      shapes=None, platform=None):
        if op not in self.shardable:
            return False, f"does not provide sharded {op}"
        why = self._check_shard(op, shard, shapes, platform)
        if why:
            return False, why
        if cfg is not None and shapes is not None and shard.axis_size:
            hkv = shapes.hq if cfg.gqa_mode == "expand" else shapes.hkv
            local = dataclasses.replace(shapes, hkv=hkv,
                                        n=shapes.n // shard.axis_size,
                                        m=shapes.m // shard.axis_size)
            try:
                inner = resolve_inner(cfg, local, platform, shard)
            except ResolutionError as err:
                return False, ("no shard-local inner strategy (on a CUDA "
                               "device the K5a kernel, cuda_chunk; a plain "
                               f"dot only when pinned): {err.rejections}")
            return True, (f"all_gather+prefix glue over {shard.describe()}, "
                          f"inner={inner.name}")
        return True, f"all_gather+prefix glue over {shard.describe()}"

    def supports(self, cfg, shapes, platform, *, op="forward"):
        if not cfg.causal:
            return False, "causal glue (use cp_nc for non-causal plans)"
        if shapes.n != shapes.m:
            return False, (f"causal requires N == M, got N={shapes.n} "
                           f"M={shapes.m}")
        if not (cfg.strict_causal and cfg.use_competition):
            return False, ("no collective glue for causal: the distributed "
                           "prefix exists for the strict-causal cumulative "
                           "competition only")
        return True, "sharded strict-causal flow"

    def _run(self, q, k, v, cfg, shard: ShardSpec, lengths,
             return_state: bool):
        k, v, local = self._shard_shapes(q, k, v, cfg, shard)
        inner = resolve_inner(cfg, local, q.device.type, shard)
        dot_fn = inner.causal_dot_fn(cfg)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=q.device)
        args = _split(shard, [q, k, v, lengths], [2, 2, 2, None])
        outs = run_spmd(lambda ql, kl, vl, ll, ax: _causal_shard_body(
            ql, kl, vl, ll, cfg, dot_fn, ax, return_state),
            args, shard.mesh, shard.axis, _layout(shard)[1])
        if not return_state:
            return _join(shard, outs, 2)
        out = _join(shard, [o for o, _ in outs], 2)
        state = FlowState(*(_join(shard, [st[i] for _, st in outs], None)
                            for i in range(len(FlowState._fields))))
        return out, state

    def forward(self, q, k, v, cfg, *, shard: ShardSpec):
        return self._run(q, k, v, cfg, shard, None, False)

    def prefill(self, q, k, v, cfg, *, lengths=None, shard: ShardSpec):
        return self._run(q, k, v, cfg, shard, lengths, True)
