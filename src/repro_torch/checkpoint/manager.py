"""Atomic, async, auto-resuming checkpoints, the counterpart of
``repro/checkpoint/manager.py`` with the same files on disk::

    <root>/step_000000001230/
        meta.json            step, time, leaf paths, bf16 paths, extra
        shard_<host>.npz     the tree's leaves as numpy arrays
    <root>/LATEST            the last committed step

A step is written into ``step_..._tmp`` and renamed into place once its
files have landed; ``LATEST`` is flipped last (the rename of a one-line
file).  A process killed at any point leaves the previous complete
checkpoint or the new one, never a torn one.

Leaves are named as JAX's ``tree_flatten_with_path`` names them, and
stored in its order: dict keys sorted, a NamedTuple field as ``.name``,
a list or tuple index as its number, joined by ``/`` (a ``TrainState``
gives ``.master/...``, ``.opt/.m/...``, ``.opt/.step``, ``.step``); None
holds no leaf.  A bf16 tensor has no numpy dtype, so it is stored as its
bits (uint16) and listed under ``bf16``; a Python int (the port's step
counters) as a 0-d int32 array.  So either package's manager restores a
directory the other wrote.  ``restore`` puts each leaf on the device of
the ``like`` leaf it replaces, and gives a Python int back where
``like`` holds one.  A ``Placed`` leaf (``distribution.sharding``: a
tensor split over a mesh) is saved whole and restored onto the ``like``
leaf's placement, as the reference restores onto the ``like`` leaf's
sharding.

An async save copies the tree to the host before its writer thread
starts, so the caller may go on with the tensors; a writer's exception is
raised by the next ``wait()`` (which every ``save`` calls first).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.distribution.sharding import Placed, gather, place


def _leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _leaf_paths(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for name in tree._fields
                for pair in _leaf_paths(getattr(tree, name), join("." + name))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, x in enumerate(tree)
                for pair in _leaf_paths(x, join(i))]
    return [(prefix, tree)]


def _to_host(leaf) -> tuple[np.ndarray, bool]:
    """(numpy copy of ``leaf``, whether it is bf16 bits)."""
    if isinstance(leaf, Placed):
        leaf = gather(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), False
    return np.array(leaf, copy=True), False


def _from_host(arr: np.ndarray, bf16: bool, like):
    """``arr`` as the kind of leaf ``like`` is: a tensor on its device (or
    placed as it is), a Python int, or the array itself."""
    if isinstance(like, Placed):
        whole = _from_host(arr, bf16, like.pieces[0])
        return place(whole, like.spec, like.mesh)
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
        return (t.view(torch.bfloat16) if bf16 else t).to(like.device)
    if isinstance(like, int):
        return int(arr)
    return arr


def _rebuild(like, data: dict, bf16: set, prefix: str = ""):
    """``like``'s structure with each leaf taken from ``data`` by path."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, data, bf16, join(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, name), data, bf16,
                                     join("." + name))
                            for name in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, data, bf16, join(i))
                          for i, x in enumerate(like))
    if prefix not in data:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    return _from_host(data[prefix], prefix in bf16, like)


class CheckpointManager:
    def __init__(self, root: str | os.PathLike, *, keep: int = 3,
                 host_id: int = 0):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None,
             async_: bool = False):
        """Write a checkpoint for ``step``; ``extra`` rides along in
        meta.json.  With ``async_`` the file writes run on a thread."""
        self.wait()  # drain an in-flight async write first
        leaves = [(path, *_to_host(leaf)) for path, leaf in _leaf_paths(tree)]

        if async_:
            def work():
                try:
                    self._write(step, leaves, extra or {})
                except BaseException as e:  # raised by the next wait()
                    self._error = e

            self._writer = threading.Thread(target=work, daemon=True)
            self._writer.start()
        else:
            self._write(step, leaves, extra or {})

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, leaves: list, extra: dict):
        name = f"step_{step:012d}"
        tmp = self.root / (name + "_tmp")
        final = self.root / name
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / f"shard_{self.host_id}.npz",
                 **{path: arr for path, arr, _ in leaves})
        meta = {
            "step": step,
            "time": time.time(),
            "paths": [path for path, _, _ in leaves],
            "bf16": [path for path, _, bf16 in leaves if bf16],
            "extra": extra,
        }
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        latest_tmp = self.root / "LATEST_tmp"
        latest_tmp.write_text(str(step))
        latest_tmp.rename(self.root / "LATEST")  # atomic pointer flip
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:012d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.name.endswith("_tmp"):
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        marker = self.root / "LATEST"
        if marker.exists():
            try:
                s = int(marker.read_text().strip())
                if (self.root / f"step_{s:012d}").exists():
                    return s
            except ValueError:
                pass
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like) -> tuple[Any, dict]:
        """The checkpoint of ``step`` in the structure of ``like``, each
        tensor on its ``like`` leaf's device; and its ``extra``."""
        d = self.root / f"step_{step:012d}"
        meta = json.loads((d / "meta.json").read_text())
        bf16 = set(meta.get("bf16", []))
        data = {}
        for shard in sorted(d.glob("shard_*.npz")):
            with np.load(shard) as z:
                data.update({k: z[k] for k in z.files})
        return _rebuild(like, data, bf16), meta["extra"]

    def restore_latest(self, like) -> tuple[int, Any, dict] | None:
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like)
        return step, tree, extra
