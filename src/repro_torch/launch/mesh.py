"""Device groups for disaggregated (prefill/decode) fleet serving.

The counterpart of ``repro/launch/mesh.py::make_fleet_meshes``.  The
reference returns one 1-D JAX mesh a group; the port returns the groups'
``torch.device`` lists, which is all the fleet router reads of them.  The
reference's ``make_production_mesh`` and ``make_mesh`` build TPU pod
meshes for sharded training and belong with the port's distribution
slice, not here.

A function, not a module constant: importing this module touches no
device.
"""
from __future__ import annotations

import torch

from repro_torch.utils import resolve_device


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
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a fleet needs at least one device")
    if len(devs) >= prefill + decode:
        return devs[:prefill], devs[prefill:prefill + decode]
    if len(devs) >= 2:
        return devs[:1], devs[1:]
    return devs[:1], devs[:1]
