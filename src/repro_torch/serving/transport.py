"""StateTransport: byte-accounted serialization of per-request serving state.

The counterpart of ``repro/serving/transport.py``.  Flow attention's
decode state is a constant O(d^2) blob per (layer, head), orders of
magnitude smaller than a softmax KV cache, which turns moving a request
between workers into a cheap, constant-size transfer.
``StateTransport.export`` gathers ONE slot's state out of a ``Worker``'s
slot-batched pools into a :class:`StateBundle`: a single contiguous byte
buffer plus a per-leaf manifest (layer, leaf path, dtype, shape, byte
offset and count).  ``install`` scatters a bundle into any other worker's
pool through ``worker._install_layer``, the scatter packed admission
uses.  The fleet router (``serving/fleet.py``) moves bundles for the
prefill-to-decode hand-off, load rebalancing and failover.

What a bundle carries, per layer:

* constant-size states (``FlowState``, ``LinearState``, the RG-LRU and
  SSD trees): the slot's row of every leaf, verbatim;
* dense KV caches: the live prefix, cut at the power-of-two bucket of
  ``length`` (``worker._bucket_len``);
* paged KV caches: the slot's pages gathered back into dense
  ``(1, Hkv, L, D)`` rows, so a bundle is free of page layout and
  installs into paged and dense pools alike.  Unmapped table entries
  hold the sentinel ``num_pages`` (the port's trash page); the gather
  clamps them into the real pages, as the reference's does;
* ``QuantizedPool`` pools: the int8 payload AND the fp32 scales, through
  the same recursion, so a quantized slot migrates verbatim (no
  requantization) and the byte count is the quantized wire size.

One deliberate difference: the rows of a positional cache at or past
``length`` (the bucket's padding, which no decode reads before writing
it) are zeros in the bundle, where the reference carries whatever the
pool held there.  A bundle is then a function of the request's state
alone, so export, install elsewhere and export again give the same
bytes.  The port has no ``MLACache``: MLA with softmax attention is not
ported, and MLA's flow branch keeps ``FlowState``s.

The manifest is the wire format.  The dtype names are the reference's
(``float32``, ``bfloat16``, ``int8``, ``int32``); bf16 leaves, which
have no numpy dtype, travel as raw bytes and come back through a byte
view.  There are no pytree treedefs here: each layer's container
skeleton (its NamedTuple types and tuple arities, a ``QuantizedPool``'s
recipe, ``None`` where a tensor goes) rides in the bundle, as the
reference's treedefs do; a cross-host transport would rebuild it from
the model config.  The export gathers every leaf on the source device,
concatenates their byte views there and makes ONE device-to-host copy;
``install`` makes one host-to-device copy of the buffer and slices the
leaves out of it on the target worker's device.  ``bundle.nbytes`` is the
honest migration cost.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.layers.attention import KVCache
from repro_torch.serving.paged import PagedKVCache
from repro_torch.serving.quant import QuantizedPool, _rebuild
from repro_torch.serving.worker import _bucket_len, _install_layer

__all__ = ["ManifestEntry", "StateBundle", "StateTransport"]


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    """One serialized leaf: where it lives in the buffer and what it is."""

    layer: int
    path: str  # the leaf's place in the layer's state tree, e.g. ".payload.s"
    dtype: str  # the reference's name: float32, bfloat16, int8, int32, ...
    shape: tuple[int, ...]
    offset: int  # byte offset into the bundle buffer
    nbytes: int


def _flatten(tree, path: str, out: list):
    """Append ``(path, tensor)`` for every leaf of ``tree`` to ``out``, in
    order; return the tree's skeleton (its containers, ``None`` for each
    tensor)."""
    if isinstance(tree, torch.Tensor):
        out.append((path, tree))
        return None
    if isinstance(tree, QuantizedPool):
        return tree.with_state(_flatten(tree.payload, path + ".payload", out),
                               _flatten(tree.scale, path + ".scale", out))
    fields = getattr(tree, "_fields", None)
    names = ([f".{f}" for f in fields] if fields is not None
             else [f"[{i}]" for i in range(len(tree))])
    return _rebuild(tree, [_flatten(child, path + name, out)
                           for child, name in zip(tree, names)])


def _unflatten(skeleton, leaves):
    """The inverse of ``_flatten``: fill ``skeleton`` from the iterator
    ``leaves``."""
    if skeleton is None:
        return next(leaves)
    if isinstance(skeleton, QuantizedPool):
        return skeleton.with_state(_unflatten(skeleton.payload, leaves),
                                   _unflatten(skeleton.scale, leaves))
    return _rebuild(skeleton, [_unflatten(child, leaves)
                               for child in skeleton])


@dataclasses.dataclass(frozen=True)
class StateBundle:
    """A request's whole serving state as one contiguous, accounted buffer.

    ``length`` is the number of tokens the state has consumed (the
    request's absolute position); ``padded_len`` the power-of-two bucket
    positional caches were gathered at.  ``skeletons`` carry each layer's
    container structure (identical on every worker of a fleet).
    """

    manifest: tuple[ManifestEntry, ...]
    buffer: np.ndarray  # (nbytes,) uint8, C-contiguous
    skeletons: tuple
    length: int
    padded_len: int

    @property
    def nbytes(self) -> int:
        """Total wire bytes of the serialized state."""
        return int(self.buffer.nbytes)

    @property
    def kbytes(self) -> float:
        return self.nbytes / 1024.0

    def unpack(self, device="cpu") -> list:
        """Rebuild the per-layer state trees from the manifest and buffer,
        on ``device``: one copy of the buffer there, each leaf a view of
        it (copied first where its offset is not a multiple of its
        element size)."""
        buf = torch.from_numpy(np.require(self.buffer, requirements="W")
                               ).to(device)
        by_layer: dict[int, list[torch.Tensor]] = {}
        for e in self.manifest:
            dtype = getattr(torch, e.dtype)
            seg = buf[e.offset:e.offset + e.nbytes]
            if e.offset % dtype.itemsize:
                seg = seg.clone()
            by_layer.setdefault(e.layer, []).append(
                seg.view(dtype).reshape(e.shape))
        return [_unflatten(sk, iter(by_layer.get(i, [])))
                for i, sk in enumerate(self.skeletons)]

    def describe(self) -> str:
        """Human-readable manifest, in the reference's format."""
        lines = [f"StateBundle: {len(self.skeletons)} layers, "
                 f"{self.length} tokens, {self.kbytes:.1f} KiB"]
        for e in self.manifest:
            lines.append(f"  layer {e.layer:>2} {e.path:<24} "
                         f"{e.dtype:<12} {str(e.shape):<20} "
                         f"@{e.offset:<8} {e.nbytes} B")
        return "\n".join(lines)


def _live(x: torch.Tensor, length: int) -> torch.Tensor:
    """``x`` (1, Hkv, L, D) with the rows at or past ``length`` zeroed."""
    dead = torch.arange(x.shape[2], device=x.device) >= length
    return x.masked_fill(dead[None, None, :, None], 0)


def _gather_layer(cache, slot: int, lb: int, length: int, pids, offs):
    """One slot's state of one layer's pool, as a batch-of-one source for
    ``worker._install_layer``: paged pools become dense (1, Hkv, lb, D)
    rows through the (lb,) page ids ``pids`` and offsets ``offs``, dense
    KV caches keep their first ``lb`` rows (both zero past ``length``),
    every other leaf gives the slot's row whole."""
    if isinstance(cache, QuantizedPool):
        # payload and scales migrate verbatim, through the same recursion
        return cache.with_state(
            _gather_layer(cache.payload, slot, lb, length, pids, offs),
            _gather_layer(cache.scale, slot, lb, length, pids, offs))
    if isinstance(cache, PagedKVCache):
        # (lb,) pages and offsets -> (lb, Hkv, D) rows -> (1, Hkv, lb, D)
        k, v = (x[pids, :, offs].transpose(0, 1)[None]
                for x in (cache.k, cache.v))
        return KVCache(k=_live(k, length), v=_live(v, length),
                       pos=cache.pos[slot:slot + 1])
    if isinstance(cache, KVCache):
        return KVCache(k=_live(cache.k[slot:slot + 1, :, :lb], length),
                       v=_live(cache.v[slot:slot + 1, :, :lb], length),
                       pos=cache.pos[slot:slot + 1])
    if isinstance(cache, torch.Tensor):
        return cache[slot:slot + 1]
    # FlowState, LinearState, the RG-LRU and SSD trees: the slot's rows
    return _rebuild(cache, [_gather_layer(c, slot, lb, length, pids, offs)
                            for c in cache])


class StateTransport:
    """Serialize and deserialize slot state bundles between workers.

    Stateless apart from the running counters the fleet's migration
    accounting reads (``bytes_moved``, ``bundles_moved``).
    """

    def __init__(self):
        self.bytes_moved = 0
        self.bundles_moved = 0

    def export(self, worker, slot: int, length: int) -> StateBundle:
        """Gather ``slot``'s state (``length`` consumed tokens) off a
        worker: one gather a leaf on its device, one concatenation of
        their bytes, one device-to-host copy."""
        dev = worker.device
        lb = _bucket_len(max(int(length), 1), worker.max_len)
        pids = offs = None
        alloc = worker.allocator
        if alloc is not None:
            idx = np.arange(lb)
            # unmapped entries (the sentinel, the trash page) clamp into
            # the real pages; those rows lie past length and are zeroed
            pages = np.minimum(alloc.table[slot, idx // alloc.page_size],
                               alloc.num_pages - 1)
            pids = torch.as_tensor(pages, dtype=torch.long, device=dev)
            offs = torch.as_tensor(idx % alloc.page_size, dtype=torch.long,
                                   device=dev)
        leaves: list[tuple[int, str, torch.Tensor]] = []
        skeletons = []
        with torch.inference_mode():
            for layer, cache in enumerate(worker.caches):
                out: list = []
                skeletons.append(_flatten(_gather_layer(
                    cache, slot, lb, int(length), pids, offs), "", out))
                leaves += [(layer, path, t) for path, t in out]
            # the migration IS the transfer: the bundle buffer is the wire
            buffer = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                                for _, _, t in leaves]).cpu().numpy()
        manifest, offset = [], 0
        for layer, path, t in leaves:
            n = t.numel() * t.element_size()
            manifest.append(ManifestEntry(
                layer=layer, path=path,
                dtype=str(t.dtype).removeprefix("torch."),
                shape=tuple(t.shape), offset=offset, nbytes=n))
            offset += n
        return StateBundle(manifest=tuple(manifest), buffer=buffer,
                           skeletons=tuple(skeletons), length=int(length),
                           padded_len=lb)

    def install(self, worker, slot: int, bundle: StateBundle, *,
                span: int | None = None):
        """Scatter a bundle into ``slot`` of a (possibly different) worker.

        ``span`` is the total token reservation for a paged target
        (consumed tokens plus the remaining decode budget), as admission
        maps a request's whole span; it defaults to the bundle's length.
        """
        dev = worker.device
        trees = bundle.unpack(dev)
        pids = offs = None
        alloc = worker.allocator
        if alloc is not None:
            alloc.admit(slot, span if span is not None else bundle.length)
            pids, offs = (torch.as_tensor(a, dtype=torch.long, device=dev)
                          for a in alloc.install_indices(
                              [slot], [bundle.length], bundle.padded_len))
        ids = torch.tensor([slot], dtype=torch.long, device=dev)
        with torch.inference_mode():
            for dst, src in zip(worker.caches, trees, strict=True):
                _install_layer(dst, src, ids, pids, offs)
        self.bytes_moved += bundle.nbytes
        self.bundles_moved += 1
