"""Checkpoint substrate.

* **Atomic**: write to ``step_K.npz.tmp.npz`` then ``os.replace`` — a
  crash mid-write never corrupts the latest good checkpoint.
* **Integrity-checked latest pointer**: ``LATEST`` names the newest step
  and carries a sha256 of the payload; restore verifies it and falls
  back to the newest file on disk on mismatch (torn-write recovery).
* **Device-free on disk**: leaves are stored as host numpy arrays
  (``.cpu().numpy()``); on restore they are cast to the template's
  dtype and, when a ``device`` is named, moved there.  A template leaf
  may be a ``torch.dtype`` alone: the leaf comes back as a tensor of it,
  with no data needed to build the template.
* **Auto-resume**: ``CheckpointManager.restore_or_init`` returns
  ``(state, start_step)``.
* **Elastic**: arrays are stored whole and logical, whatever mesh wrote
  them; ``shardings`` (a tree like the template's, of ``(mesh,
  placements)`` pairs or None) places each restored tensor leaf as a DTensor on
  the current mesh, each rank keeping its shard.  Leaves are read one at
  a time and placed as they are read, so a rank holds one whole leaf at
  most besides its shards.  A sharded writer gathers whole tensors
  (every rank takes part) and rank 0 alone keeps and writes them
  (``train.loop.TrainLoop``).

Serialization: one ``npz`` per checkpoint, keyed by the flattened tree
path of each leaf (dict keys and sequence positions joined with
``|``; dict keys in sorted order).  This is the reference package's
format, so a checkpoint written by either package restores in the
other.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any

import numpy as np
import torch

from ..models.sharding import place

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

_SEP = "|"


def _leaf_paths(tree: Any, prefix: tuple = ()):
    """``(path, leaf)`` pairs of a tree of dicts, lists and tuples, dict
    keys sorted; ``None`` is an empty subtree, not a leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


#: torch dtypes whose values numpy holds as they are
_NUMPY_OK = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
             torch.int64, torch.float16, torch.float32, torch.float64,
             torch.complex64, torch.complex128)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 (and any type numpy lacks)
    is stored as float32 and cast back to the template's dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype not in _NUMPY_OK:
            t = t.float()
        return t.cpu().numpy()
    a = np.asarray(leaf)
    if a.dtype.kind not in "biufc":
        a = a.astype(np.float32)
    return a


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _host_array(leaf) for path, leaf in _leaf_paths(tree)}


def _tensor(a: np.ndarray) -> torch.Tensor:
    # ascontiguousarray makes a 0-d array 1-d: keep its shape
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))


def _restore_leaf(a: np.ndarray, leaf, device, sharding):
    """The stored array ``a`` cast to ``leaf``'s dtype.  For a tensor or
    ``torch.dtype`` template: a DTensor placed as ``sharding`` (``(mesh,
    placements)``) says when it is given, else a tensor on ``device``,
    else on the template's device, else on the host.  Otherwise a numpy
    array (a tensor on ``device`` when one is named)."""
    if isinstance(leaf, (torch.Tensor, torch.dtype)):
        dtype = leaf if isinstance(leaf, torch.dtype) else leaf.dtype
        if sharding is not None:
            return place(_tensor(a), *sharding).to(dtype)
        if device is None and isinstance(leaf, torch.Tensor):
            device = leaf.device
        return _tensor(a).to(device=device, dtype=dtype)
    if hasattr(leaf, "dtype") and a.dtype != leaf.dtype:
        a = a.astype(leaf.dtype)
    if device is not None:
        return _tensor(a).to(device)
    return a


def _unflatten_into(template, arrays, device=None, shardings=None, prefix: tuple = ()):
    """``template``'s tree with each leaf read from ``arrays`` (a mapping
    of flattened paths, read a leaf at a time) and restored."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_into(v, arrays, device, None if shardings is None
                                   else shardings.get(k), prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, arrays, device, None if shardings is None else shardings[i],
                            prefix + (str(i),))
            for i, v in enumerate(template))
    return _restore_leaf(arrays[_SEP.join(prefix)], template, device, shardings)


def _payload_hash(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _flatten(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = final + ".tmp.npz"
    np.savez(tmp.removesuffix(".npz"), **arrays)
    os.replace(tmp, final)
    meta = dict(step=step, file=os.path.basename(final),
                sha256=_payload_hash(final))
    tmp_meta = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(tmp_meta, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_meta, os.path.join(ckpt_dir, "LATEST"))
    return final


def _list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for fn in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.npz", fn)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    """Newest restorable step, preferring the verified LATEST pointer."""
    pointer = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(pointer):
        try:
            with open(pointer) as f:
                meta = json.load(f)
            path = os.path.join(ckpt_dir, meta["file"])
            if os.path.exists(path) and _payload_hash(path) == meta["sha256"]:
                return int(meta["step"])
        except (json.JSONDecodeError, KeyError, OSError):
            pass  # torn pointer — fall back to directory scan
    steps = _list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template, step: int | None = None,
                       device=None, shardings=None):
    """Restore into ``template``'s tree structure and leaf dtypes.

    ``device`` (a ``torch.device`` or its name) puts every leaf there as
    a tensor; without it, numpy-template leaves come back as numpy
    arrays and tensor-template leaves on the template's device.
    ``shardings`` places leaves on the current mesh (elastic restore):
    a tree like ``template``'s of ``(mesh, placements)`` pairs, or None
    for a leaf to leave whole."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    dev = torch.device(device) if device is not None else None
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}.npz")) as z:
        return _unflatten_into(template, z, dev, shardings), step


class CheckpointManager:
    def __init__(self, ckpt_dir: str, *, keep: int = 3, every: int = 50):
        self.dir = ckpt_dir
        self.keep = keep
        self.every = every

    def maybe_save(self, step: int, state) -> str | None:
        if step % self.every != 0:
            return None
        path = save_checkpoint(self.dir, step, state)
        self._gc()
        return path

    def _gc(self):
        steps = _list_steps(self.dir)
        for s in steps[: -self.keep]:
            try:
                os.remove(os.path.join(self.dir, f"step_{s:08d}.npz"))
            except OSError:
                pass

    def restore_or_init(self, init_fn, device=None, shardings=None):
        """Auto-resume: restore the newest verified checkpoint into the
        structure and dtypes of ``init_fn()``, or return ``init_fn()``
        fresh; leaves land on ``device`` when one is named, and on the
        mesh as ``shardings`` says (see :func:`restore_checkpoint`)."""
        step = latest_step(self.dir)
        if step is None:
            return init_fn(), 0
        state, step = restore_checkpoint(self.dir, init_fn(), step, device, shardings)
        return state, step + 1
