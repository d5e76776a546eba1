"""The port's device mesh: an array of ``torch.device``s with axis names.

The counterpart of ``jax.sharding.Mesh`` as the reference uses it: the
spec functions of ``sharding.py`` read ``mesh.shape`` (a dict of axis
sizes), the context-parallel backends read an axis's size, and the sharded
steps of ``launch/steps.py`` read the dp axes.  One device may fill many positions: on one
card every position of a (2, 2) mesh is ``cuda:0``, and a sharded op runs
the positions one after another there.  Positions are numbered in
row-major order over ``axis_names``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch


class Mesh:
    """``devices`` (a numpy object array of ``torch.device``, one entry a
    position) with one name per axis.  Hashed by identity, as the
    reference's meshes are jit-static objects: a ``ShardSpec`` holding it
    stays hashable."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        devs = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            devs[idx] = torch.device(src[idx])
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devs.shape} need "
                             f"{devs.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", axis_names)

    def __setattr__(self, name, value):
        raise AttributeError("Mesh is frozen")

    @property
    def shape(self) -> dict:
        """``{axis name: size}`` in axis order, as ``mesh.shape`` is in the
        reference."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """The number of positions."""
        return int(self.devices.size)

    def __repr__(self) -> str:
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({sizes}; {', '.join(devs)})"

    def axes_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name, a tuple of names
        or None, which is 1)."""
        size = 1
        for a in axis_tuple(axes):
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} (axes: "
                                 f"{self.axis_names})")
            size *= self.shape[a]
        return size

    def coords(self, axes=None) -> list:
        """Every position of the sub-mesh over ``axes`` (default every
        axis), row-major, as ``{axis: index}`` dicts."""
        axes = self.axis_names if axes is None else axis_tuple(axes)
        ranges = [range(self.axes_size(a)) for a in axes]
        return [dict(zip(axes, idx)) for idx in itertools.product(*ranges)]

    def device_at(self, coord: dict) -> torch.device:
        """The device of the position at ``coord`` (an axis it omits at
        index 0)."""
        return self.devices[tuple(coord.get(a, 0) for a in self.axis_names)]


def axis_tuple(axes) -> tuple:
    """An axis entry as a tuple of names: None -> (), "a" -> ("a",)."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def grid(shape, axes, devices) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``axes`` that fills its positions from
    ``devices`` round-robin (row-major), so a mesh with more positions
    than devices reuses them."""
    shape = tuple(int(s) for s in shape)
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = int(np.prod(shape)) if shape else 1
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = devs[i % len(devs)]
    return Mesh(arr.reshape(shape), axes)
