"""Rank-ordered collectives over per-position lists, and ``run_spmd``,
which runs a shard body at every position of a mesh (port-only).

A sharded op on a single controller holds one tensor per position: a list
whose entry ``i`` belongs to the ``i``-th position, row-major, of the
sub-mesh over ``over`` (a tuple of axis names; default every axis of the
mesh).  A collective over ``axis`` (a name or a tuple of names) combines
the entries of the positions that differ only along ``axis`` and returns
a list of the same length, each entry ``.to()`` its position's device:

* ``psum``, ``pmax``: the sum or maximum, added in rank order (no float
  atomics, so every result is bitwise repeatable);
* ``all_gather``: the group's entries stacked on a new leading axis, in
  rank order;
* ``exclusive_prefix``: ``all_gather`` and then each position's exclusive
  prefix, ``cumsum - partials`` at its own rank, as
  ``repro/attention/cp.py::_prefix`` computes it.

Autograd flows through all of them: they are tensor operations.

``run_spmd`` drives a shard body written as a generator: where the
reference's body calls ``jax.lax.psum(x, axis_name)``, the port's yields
``ax.psum(x)`` and receives the result.  ``run_spmd`` steps every
position's generator in rank order up to its next collective, runs the
collective on the yielded list, and sends each position its entry; every
position must reach the same collective, as under ``shard_map``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distribution.mesh import Mesh, axis_tuple


def _groups(mesh: Mesh, axis, over) -> tuple[list, list]:
    """(coords of the positions over ``over``, the groups of their indices
    that differ only along ``axis``, each in rank order)."""
    over = mesh.axis_names if over is None else axis_tuple(over)
    axes = axis_tuple(axis)
    for a in axes:
        if a not in over:
            raise ValueError(f"axis {a!r} is not among the list's axes {over}")
    coords = mesh.coords(over)
    groups: dict = {}
    for i, c in enumerate(coords):
        key = tuple(c[a] for a in over if a not in axes)
        groups.setdefault(key, []).append(i)
    return coords, list(groups.values())


def _check_len(xs, coords):
    if len(xs) != len(coords):
        raise ValueError(f"{len(xs)} entries for {len(coords)} positions")


def _reduce(xs, mesh, axis, over, combine):
    coords, groups = _groups(mesh, axis, over)
    _check_len(xs, coords)
    out = [None] * len(xs)
    for group in groups:
        total = xs[group[0]]
        for i in group[1:]:
            total = combine(total, xs[i].to(total.device))
        for i in group:
            out[i] = total.to(mesh.device_at(coords[i]))
    return out


def psum(xs: list, mesh: Mesh, axis, over=None) -> list:
    """Each position's sum over ``axis``, added in rank order."""
    return _reduce(xs, mesh, axis, over, torch.add)


def pmax(xs: list, mesh: Mesh, axis, over=None) -> list:
    """Each position's elementwise maximum over ``axis``."""
    return _reduce(xs, mesh, axis, over, torch.maximum)


def all_gather(xs: list, mesh: Mesh, axis, over=None) -> list:
    """Each position's (P, ...) stack of the entries along ``axis``."""
    coords, groups = _groups(mesh, axis, over)
    _check_len(xs, coords)
    out = [None] * len(xs)
    for group in groups:
        dev = xs[group[0]].device
        stacked = torch.stack([xs[i].to(dev) for i in group])
        for i in group:
            out[i] = stacked.to(mesh.device_at(coords[i]))
    return out


def exclusive_prefix(xs: list, mesh: Mesh, axis, over=None) -> list:
    """Each position's sum of the entries of lower rank along ``axis``
    (zeros at rank 0), as ``cumsum(all_gather) - all_gather`` at its
    rank."""
    coords, groups = _groups(mesh, axis, over)
    _check_len(xs, coords)
    out = [None] * len(xs)
    for group in groups:
        dev = xs[group[0]].device
        part = torch.stack([xs[i].to(dev) for i in group])
        excl = torch.cumsum(part, dim=0) - part
        for rank, i in enumerate(group):
            out[i] = excl[rank].to(mesh.device_at(coords[i]))
    return out


_OPS = {"psum": psum, "pmax": pmax, "all_gather": all_gather,
        "exclusive_prefix": exclusive_prefix}


@dataclasses.dataclass(frozen=True)
class _Request:
    op: str
    x: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AxisContext:
    """What a shard body knows of its position: its rank along the
    collective axis (``jax.lax.axis_index``), the axis size
    (``jax.lax.psum(1, axis)``) and its device.  Its methods build the
    requests a body yields."""

    index: int
    size: int
    device: torch.device

    def psum(self, x):
        return _Request("psum", x)

    def pmax(self, x):
        return _Request("pmax", x)

    def all_gather(self, x):
        return _Request("all_gather", x)

    def exclusive_prefix(self, x):
        return _Request("exclusive_prefix", x)


def run_spmd(body, args: list, mesh: Mesh, axis, over=None) -> list:
    """Run ``body(*args[i], ax)`` for every position ``i`` of the sub-mesh
    over ``over``, in lockstep: each collective a body yields is run over
    ``axis`` once every position has yielded it.  Returns the bodies'
    return values, one a position."""
    coords, _ = _groups(mesh, axis, over)
    _check_len(args, coords)
    axes = axis_tuple(axis)
    size = mesh.axes_size(axes)
    gens = []
    for c, a in zip(coords, args):
        rank = 0
        for name in axes:
            rank = rank * mesh.shape[name] + c[name]
        gens.append(body(*a, AxisContext(rank, size, mesh.device_at(c))))
    sends = [None] * len(gens)
    while True:
        reqs, done = [], []
        for g, s in zip(gens, sends):
            try:
                reqs.append(g.send(s))
            except StopIteration as stop:
                done.append(stop.value)
        if len(done) == len(gens):
            return done
        if done or len({r.op for r in reqs}) != 1:
            raise RuntimeError("shard bodies diverged: every position must "
                               "reach the same collective")
        sends = _OPS[reqs[0].op]([r.x for r in reqs], mesh, axis, over)
