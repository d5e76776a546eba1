"""Meshes, the counterpart of ``repro/launch/mesh.py``.

``make_mesh(shape, axes)`` and ``make_production_mesh()`` return the
port's ``distribution.mesh.Mesh``: the reference's shapes and axis names
(single pod (data=16, model=16); multi-pod (pod=2, data=16, model=16)),
each position a ``torch.device``.  The port runs a mesh from one process
(``distribution/collectives.py``), so a mesh may hold more positions than
there are cards: the cards fill the positions round-robin, and on one
H100 every position of a production mesh is ``cuda:0``.

``make_fleet_meshes`` carves the devices for disaggregated
(prefill/decode) fleet serving.  The reference returns one 1-D JAX mesh a
group; the port returns the groups' ``torch.device`` lists, which is all
the fleet router reads of them.

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

import torch

from repro_torch.distribution.mesh import Mesh, grid
from repro_torch.utils import resolve_device


def _all_devices(devices) -> list:
    """``devices``, or every CUDA device when None (raising when there is
    none: pass ``["cpu"]`` to run on the CPU)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over ``devices``
    (default every CUDA device), reused round-robin when the mesh has more
    positions than devices.  For tests and elastic re-meshing."""
    return grid(shape, axes, _all_devices(devices))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh shape, (data=16, model=16), or
    (pod=2, data=16, model=16) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_fleet_meshes(prefill: int, decode: int, devices=None
                      ) -> tuple[list[torch.device], list[torch.device]]:
    """``(prefill_devices, decode_devices)`` for a fleet of ``prefill`` +
    ``decode`` workers.

    The groups are disjoint when there are at least ``prefill + decode``
    devices; else prefill takes the first device and decode the rest when
    there are at least two; else both groups share the only device.  A
    group smaller than its worker count is oversubscribed round-robin by
    the fleet router.  ``devices=None`` means every CUDA device, and
    raises when there is none (pass ``["cpu"]`` to serve on the CPU); an
    explicit list of names or devices is only carved, never touched.
    """
    devs = _all_devices(devices)
    if not devs:
        raise ValueError("a fleet needs at least one device")
    if len(devs) >= prefill + decode:
        return devs[:prefill], devs[prefill:prefill + decode]
    if len(devs) >= 2:
        return devs[:1], devs[1:]
    return devs[:1], devs[:1]
