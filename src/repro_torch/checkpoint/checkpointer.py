"""Atomic, asynchronous checkpoints of a tree of tensors, the port of
``repro.checkpoint.checkpointer`` with its on-disk layout:

  * one ``.npy`` per leaf plus ``manifest.json`` listing each leaf's path,
    file, shape and dtype, written to ``step_N.tmp/`` and published by an
    atomic rename to ``step_N/`` (``N`` zero-padded to 8 digits);
  * ``save`` snapshots the leaves to the host, then a background thread
    writes them (one save in flight); ``keep`` newest steps are retained.

A tree is nested dicts, lists and tuples of tensors (or numpy arrays); a
dict keyed by dotted names (a port state dict, ``nn.trainable``'s) is the
nested tree those names spell.  Leaf paths are written in the form of
``jax.tree_util.keystr`` (``['params']['unet']['conv_in']['kernel']``), so
a checkpoint of either package restores into the other's tree.  bf16
leaves are stored as the reference stores them, two raw bytes an element
(``<V2``) with ``"bfloat16"`` in the manifest, and read back as bf16.

On a mesh (SPMD ranks, DTensor leaves) every rank snapshots each leaf whole
(``full_tensor``, a collective), rank 0 alone writes, and ``wait`` ends at
a barrier, so every rank then sees the published step.  ``restore`` reads
the host copy on every rank and places each leaf with ``shardings`` (a
tree of ``parallel.sharding.NamedSharding`` like ``tree_like``'s), or with
the placements of the DTensor it replaces: the elastic re-shard onto
another mesh or world size.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.parallel.sharding import is_dtensor


def flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(keystr path, leaf)]`` in the order ``jax.tree_util`` flattens:
    dict keys sorted, dotted keys split into their parts."""
    if isinstance(tree, dict):
        nested: dict = {}
        for key, sub in tree.items():
            *path, last = str(key).split(".")
            node = nested
            for part in path:
                node = node.setdefault(part, {})
            if last in node:
                raise ValueError(f"key {key!r} collides with another path")
            node[last] = sub
        return [item for key in sorted(nested)
                for item in flatten_with_paths(nested[key], f"{prefix}['{key}']")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in flatten_with_paths(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def unflatten_like(tree, leaves):
    """``tree`` with its leaves replaced, in ``flatten_with_paths`` order."""
    paths = [p for p, _ in flatten_with_paths(tree)]
    by_path = dict(zip(paths, leaves))

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, prefix + "".join(f"['{p}']" for p in str(k).split(".")))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}[{i}]") for i, v in enumerate(node))
        return by_path[prefix]

    return rebuild(tree, "")


def to_host(leaf) -> np.ndarray:
    """A copy of a leaf on the host, which later in-place updates of the
    leaf do not reach (``.cpu()`` of a CPU tensor would share its storage
    with the background writer): bf16 as its raw 2-byte elements
    (``<V2``)."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a tensor of its shape (a 0-d leaf stays 0-d)."""
    arr = np.asarray(arr, order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree) -> None:
        """Snapshot to the host, then write in the background (unless
        ``async_save`` is off)."""
        self.wait()  # one in-flight save at a time
        leaves = [(path, to_host(leaf), _dtype_name(leaf))
                  for path, leaf in flatten_with_paths(tree)]
        if _rank() != 0:  # every rank snapshots (a collective); rank 0 writes
            return
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, leaves),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves)

    def _write(self, step: int, leaves: list) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "time": time.time()}
        for i, (path, arr, dtype) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _world() > 1:  # every rank sees the published step from here on
            import torch.distributed as dist

            dist.barrier()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, *, device=None, shardings=None):
        """The leaves of ``tree_like``'s paths from checkpoint ``step``
        (default the newest), as tensors in ``tree_like``'s structure: on
        ``device`` where given, else on the device of the leaf they replace
        (the host for a non-tensor leaf); a leaf with a sharding in
        ``shardings`` (a tree like ``tree_like``'s), or replacing a DTensor,
        becomes a DTensor placed by it, possibly on another mesh than the
        checkpoint was written from."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {m["path"]: m for m in manifest["leaves"]}
        placed = (dict(flatten_with_paths(shardings)) if shardings is not None else {})
        out = []
        for path, like in flatten_with_paths(tree_like):
            m = by_path[path]
            t = from_host(np.load(os.path.join(d, m["file"])), m["dtype"])
            dev = device if device is not None else (
                like.device if isinstance(like, torch.Tensor) else None)
            t = t if dev is None else t.to(dev)
            out.append(_placed(t, placed.get(path), like))
        return unflatten_like(tree_like, out)


def _placed(t: torch.Tensor, sharding, like):
    """``t`` as a DTensor placed by ``sharding`` (a ``NamedSharding``), or
    like the DTensor ``like``; else as it is."""
    from torch.distributed.tensor import distribute_tensor

    if sharding is not None:
        return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)
    if is_dtensor(like):
        return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)
    return t


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _dtype_name(leaf) -> str:
    """numpy's name of the leaf's dtype (``float32``, ``int32``,
    ``bfloat16``), as the reference's manifest writes it."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)
