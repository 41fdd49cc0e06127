"""Checkpoint manager: atomic commits and MVGC-driven retention (port of
``repro.ckpt.manager``).

* **atomic commit** — write to ``<dir>/.tmp-<step>`` then ``os.rename``; a
  crash mid-save never corrupts the latest checkpoint, and a leftover
  ``.tmp-<step>`` is invisible to :meth:`CheckpointManager.steps`.
* **restart** — ``latest_step()`` + ``restore()``.
* **MVGC retention** — checkpoints are versions of one object with
  interval ``[step, next_step)``; readers pin steps through the announce
  file, and ``gc()`` deletes every checkpoint that ``needed(A, t)`` does
  not keep, always keeping the newest.

The on-disk format is the JAX package's: one ``leaf_%05d.npy`` per tensor
leaf plus ``manifest.json`` with ``step``, ``num_leaves``, ``extra`` and
``time``.  Leaves are ordered as ``jax.tree.flatten`` orders them:
NamedTuple fields and list/tuple items in order, dict items by sorted key,
depth first, ``None`` an empty subtree.  numpy has no bfloat16, so a
bfloat16 tensor is saved as raw 2-byte records (``|V2``), the file the JAX
manager writes for the same values byte for byte, and the manifest's
per-leaf ``dtypes`` list says which leaves to view back as bfloat16.  A
``|V2`` leaf is read as bfloat16 bits where the manifest or the ``like``
leaf says bfloat16.  float32, int32 and bool trees interchange with the
JAX package in both directions; so do bfloat16 leaves as files, but
``jnp.asarray`` of a loaded ``|V2`` leaf raises, on the port's files as on
the JAX manager's own (so a JAX engine restores no bfloat16 checkpoint).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._tensor import DeviceLike, resolve_device


def tree_flatten(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of nested NamedTuples, tuples, lists and dicts,
    in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """Rebuild ``like``'s structure around ``leaves`` (in
    :func:`tree_flatten` order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _save_leaf(path: str, leaf: torch.Tensor) -> str:
    """Write one leaf as ``.npy``; returns its dtype name for the manifest.
    A bfloat16 leaf is written as the JAX manager's ``np.save`` writes
    ``ml_dtypes.bfloat16``: descr ``'<V2'`` (a plain numpy ``V2`` says
    ``'|V2'``), then the 16-bit patterns."""
    dtype = str(leaf.dtype).removeprefix("torch.")
    arr = leaf.detach().cpu()
    if leaf.dtype != torch.bfloat16:
        np.save(path, arr.numpy())
        return dtype
    bits = np.ascontiguousarray(arr.view(torch.int16).numpy()).reshape(
        tuple(leaf.shape))   # view() of a 0-d tensor comes back 1-d
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": bits.shape})
        f.write(bits.tobytes())
    return dtype


def _from_numpy(arr: np.ndarray, saved: Optional[str], like: Any,
                dev: torch.device) -> torch.Tensor:
    want_bf16 = saved == "bfloat16" or (
        saved is None and torch.is_tensor(like)
        and like.dtype == torch.bfloat16)
    if want_bf16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf must hold 2-byte values, "
                             f"got {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


class CheckpointManager:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._ann_path = os.path.join(directory, "announced.json")

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"ckpt_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves = tree_flatten(tree)
        dtypes = []
        for i, leaf in enumerate(leaves):
            dtypes.append(_save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"),
                                     leaf))
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "dtypes": dtypes,
            "extra": extra or {},
            "time": time.time(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic commit
        return final

    # -- restore ------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any, device: DeviceLike = None
                ) -> Tuple[Any, Dict]:
        """Rebuild the tree saved at ``step`` with ``like``'s structure,
        every leaf on ``device`` (the GPU unless the caller names another).
        Returns ``(tree, extra)``."""
        dev = resolve_device(device)
        path = os.path.join(self.dir, f"ckpt_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        n = manifest["num_leaves"]
        likes = tree_flatten(like)
        if len(likes) != n:
            raise ValueError(f"checkpoint {step} holds {n} leaves, the "
                             f"structure {len(likes)}")
        saved = manifest.get("dtypes", [None] * n)
        leaves = [_from_numpy(np.load(os.path.join(path, f"leaf_{i:05d}.npy")),
                              saved[i], likes[i], dev) for i in range(n)]
        return tree_unflatten(like, leaves), manifest["extra"]

    # -- MVGC retention -----------------------------------------------------
    def announce(self, reader: str, step: int) -> None:
        """An evaluator/serving job pins checkpoint `step` (the rtx announce)."""
        ann = self._read_ann()
        ann[reader] = step
        with open(self._ann_path, "w") as f:
            json.dump(ann, f)

    def unannounce(self, reader: str) -> None:
        ann = self._read_ann()
        ann.pop(reader, None)
        with open(self._ann_path, "w") as f:
            json.dump(ann, f)

    def _read_ann(self) -> Dict[str, int]:
        if os.path.exists(self._ann_path):
            with open(self._ann_path) as f:
                return json.load(f)
        return {}

    def gc(self, keep_last: int = 1) -> List[int]:
        """Delete obsolete checkpoints per needed(A, t): checkpoint s_i with
        interval [s_i, s_{i+1}) is needed iff some announced step a satisfies
        s_i <= a < s_{i+1}, or it is among the newest ``keep_last``.
        Returns the deleted steps."""
        steps = self.steps()
        if not steps:
            return []
        announced = sorted(self._read_ann().values())
        deleted = []
        for i, s in enumerate(steps):
            if i >= len(steps) - keep_last:
                continue                      # newest versions always needed
            nxt = steps[i + 1]
            needed = any(s <= a < nxt for a in announced)
            if not needed:
                shutil.rmtree(os.path.join(self.dir, f"ckpt_{s:08d}"))
                deleted.append(s)
        return deleted
