"""Checkpointing: atomic, async-capable, readable by both packages.

The port of ``repro.train.checkpoint``, with the reference's file layout:

* **Atomic**: write to ``<dir>/.tmp-<step>``, fsync, ``os.replace`` to
  ``step_<n>.npz``, then update ``manifest.json`` (``steps``, ``latest``,
  ``extra``, ``saved_at``) the same way — a crash mid-save never corrupts
  the latest checkpoint; ``keep`` bounds the steps kept.
* **Async**: ``save(..., blocking=False)`` snapshots every leaf to host
  memory on the caller's thread — the only part that must synchronize with
  the step loop, and what lets the loop update its tensors in place right
  after — then serializes on a daemon thread.
* **Keys**: one array a leaf, named by its path as the reference's
  ``_flatten`` names it (dict keys, ``.field`` for a NamedTuple field, the
  index in a sequence, joined by ``//``): a ``TrainState``'s leaves are
  ``.params//units//b0//mixer//w_q``, ``.opt//.m//embed//embedding``,
  ``.step``.  So the port reads a reference-written checkpoint and the
  reference reads the port's.

bf16 leaves are written as the reference writes them (numpy has no
bfloat16: two raw bytes an element, ``|V2`` when read back), and
``restore`` takes each leaf's dtype from the template, so a bf16 state
round-trips bit for bit — from the port's files and from the reference's.
``restore(step, template, device=None, mesh=None)`` takes the place of
the reference's ``shardings=``: a plain template leaf goes to ``device``
(default: the template leaf's device); a ``DTensor`` template leaf (a state
sharded by ``launch.sharding.distribute_state``) is placed by its spec on
``mesh`` (default: its own mesh) — each rank reads the stored leaf and
keeps its block.  The files hold every leaf whole, so this is the
reference's elastic reshard: a job saved on one mesh shape restarts on
another, or in one process with no mesh.  A sharded ``save`` gathers
each ``DTensor`` leaf on every rank (all ranks call it) and rank 0 writes
the files; a blocking save, and ``wait``, end with a barrier, so every
rank then reads the same manifest.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

SEP = "//"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _items(tree, prefix=()):
    """(path, tensor) pairs of a tree of dicts and NamedTuples, in the
    reference's order (dict keys sorted)."""
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    else:
        yield SEP.join(prefix), tree


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    # a copy, also of a CPU tensor: the step loop may update its state in
    # place while a background thread writes the snapshot
    if isinstance(leaf, DTensor):
        from ..launch.sharding import full_tensor

        leaf = full_tensor(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:       # the reference's |V2 bytes
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree) -> dict:
    """``{key: numpy array}`` of every leaf, copied to host memory."""
    return {k: _to_numpy(leaf) for k, leaf in _items(tree)}


def _leaf_from(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """The stored array as a tensor of ``dtype``: for bf16, 2-byte raw or
    integer arrays are reinterpreted (bit for bit); others are cast."""
    if dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "Viu":
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C")).to(dtype)
    return t.to(device)


def _is_sharded(tree) -> bool:
    if _is_namedtuple(tree):
        return any(_is_sharded(getattr(tree, n)) for n in tree._fields)
    if isinstance(tree, dict):
        return any(_is_sharded(v) for v in tree.values())
    return isinstance(tree, DTensor)


def _place(arr: np.ndarray, tmpl, device, mesh):
    """The stored leaf as ``tmpl``'s kind: a DTensor template's block on
    ``mesh`` (default: its own), else a tensor on ``device``."""
    if not isinstance(tmpl, DTensor):
        return _leaf_from(arr, tmpl.dtype,
                          tmpl.device if device is None else device)
    from ..launch.mesh import mesh_device
    from ..launch.sharding import shard_leaf, spec_of

    mesh = tmpl.device_mesh if mesh is None else mesh
    return shard_leaf(_leaf_from(arr, tmpl.dtype, "cpu"), spec_of(tmpl),
                      mesh, device=mesh_device(mesh))


def _unflatten_into(template, flat, device=None, mesh=None):
    """``template``'s structure with every leaf read from ``flat`` (a dict
    or an open ``.npz``)."""

    def build(tree, prefix=()):
        if _is_namedtuple(tree):
            return type(tree)(*(build(getattr(tree, n), prefix + (f".{n}",))
                                for n in tree._fields))
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        key = SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(tree.shape)}")
        return _place(arr, tree, device, mesh)

    return build(template)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = str(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._sharded = False                 # the last save was a mesh's

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None,
             blocking: bool = True):
        flat = _flatten(tree)                 # snapshot on caller thread
        self._sharded = _is_sharded(tree)
        writer = not self._sharded or dist.get_rank() == 0
        if blocking:
            if writer:
                self._write(step, flat, extra or {})
            self._barrier()
        else:
            self.wait()
            if writer:
                self._thread = threading.Thread(
                    target=self._write, args=(step, flat, extra or {}),
                    daemon=True)
                self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    def _barrier(self):
        if self._sharded:
            dist.barrier()

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step_{step:010d}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        manifest = self._manifest()
        manifest["steps"] = sorted(set(manifest.get("steps", []) + [step]))
        manifest["latest"] = max(manifest["steps"])
        manifest["extra"] = extra
        manifest["saved_at"] = time.time()
        mtmp = os.path.join(self.dir, ".manifest.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, os.path.join(self.dir, "manifest.json"))
        self._gc(manifest)

    def _gc(self, manifest):
        steps = manifest.get("steps", [])
        for s in steps[:-self.keep] if self.keep else []:
            p = os.path.join(self.dir, f"step_{s:010d}.npz")
            if os.path.exists(p):
                os.remove(p)
        manifest["steps"] = steps[-self.keep:] if self.keep else steps

    # -- restore --------------------------------------------------------------
    def _manifest(self) -> dict:
        p = os.path.join(self.dir, "manifest.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def latest_step(self) -> Optional[int]:
        man = self._manifest()
        steps = [s for s in man.get("steps", []) if os.path.exists(
            os.path.join(self.dir, f"step_{s:010d}.npz"))]
        return max(steps) if steps else None

    def restore(self, step: int, template, device=None, mesh=None):
        """Restore into ``template``'s structure (dicts and NamedTuples of
        tensors and DTensors): every leaf with the template leaf's shape
        (checked) and dtype; a tensor on ``device`` (default: the template
        leaf's device), a DTensor's block on ``mesh`` (default: the
        template leaf's mesh) by the template leaf's spec."""
        path = os.path.join(self.dir, f"step_{step:010d}.npz")
        with np.load(path) as z:          # each leaf read as it is needed
            return _unflatten_into(template, z, device, mesh)

    def restore_latest(self, template, device=None, mesh=None):
        s = self.latest_step()
        if s is None:
            return None, None
        return s, self.restore(s, template, device, mesh)


__all__ = ["CheckpointManager", "SEP"]
