"""Asynchronous, atomic, keep-N checkpoints of a tree of tensors, in the
JAX package's on-disk format, so either package restores the other's.

Layout:  <dir>/step_<N>/
            manifest.json            leaf keys, shapes, dtypes, "format": 1
            shard_0.npz              leaf i as array "a<i>"

  * async  -- the copy to the host happens on the caller's thread (a
    consistent snapshot, taken of host tensors too); serialization and
    fsync on a background thread, at most one save in flight.
  * atomic -- writes go to step_<N>.tmp, then one os.rename; a crash
    mid-save never corrupts the latest complete checkpoint.
  * keep-N -- older steps are removed after a successful save.

Leaf keys are `repro_torch.tree` paths joined by "/": a dict key as
itself, a list index as its number, a NamedTuple field as ``.field``, in
JAX's leaf order. A tree of DTensors (a sharded train state) is saved as
its global tensors, gathered on every rank and written by rank 0 alone;
`restore(shardings=, mesh=)` places each leaf onto the current mesh,
whatever mesh wrote it (the elastic restart). bfloat16 leaves are stored as their uint16 bits and
float8_e4m3fn / float8_e5m2 leaves as their uint8 bits, each named by its
dtype in the manifest, and rebuilt with ``Tensor.view``; no ml_dtypes is
needed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_paths, tree_unflatten_like


def _flatten(tree) -> tuple[list, list]:
    flat = tree_flatten_with_paths(tree)
    return (["/".join(str(p) for p in path) for path, _ in flat],
            [leaf for _, leaf in flat])


#: dtypes numpy's npz cannot hold: manifest name -> (torch dtype, the
#: signed torch view and the unsigned numpy view of its bits), as the JAX
#: package stores them
_BIT_VIEWS = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.int8, np.uint8),
}
_VIEW_NAMES = {dtype: name for name, (dtype, _, _) in _BIT_VIEWS.items()}


def _to_host(x) -> tuple[np.ndarray, str]:
    """(storable numpy array, manifest dtype string) of a leaf."""
    if torch.is_tensor(x):
        # a copy even of a host tensor: a compiled train step overwrites
        # its state in place while the write is in flight
        x = x.detach().to("cpu", copy=True)
        name = _VIEW_NAMES.get(x.dtype)
        if name is not None:
            _, signed, bits = _BIT_VIEWS[name]
            return x.view(signed).numpy().view(bits), name
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _from_host(x: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype in _BIT_VIEWS:
        torch_dtype, signed, _ = _BIT_VIEWS[dtype]
        signed_np = np.int16 if signed == torch.int16 else np.int8
        return torch.from_numpy(x.view(signed_np)).view(torch_dtype)
    return torch.from_numpy(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Write ``tree`` as step ``step`` in the background (``blocking``:
        wait for it). Waits for the previous save first, and raises its
        error if it failed. DTensor leaves are gathered to their global
        tensors (a collective: every rank of their mesh calls `save`),
        and only global rank 0 writes them."""
        from torch.distributed.tensor import DTensor
        self.wait()
        keys, leaves = _flatten(tree)
        sharded = any(isinstance(x, DTensor) for x in leaves)
        leaves = [x.full_tensor() if isinstance(x, DTensor) else x
                  for x in leaves]
        if sharded and _rank() != 0:
            return
        host = [_to_host(x) for x in leaves]

        def _write():
            try:
                tmp = self.dir / f"step_{step}.tmp"
                final = self.dir / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                manifest = {
                    "step": step,
                    "keys": keys,
                    "shapes": [list(x.shape) for x, _ in host],
                    "dtypes": [dtype for _, dtype in host],
                    "format": 1,
                }
                np.savez(tmp / "shard_0.npz",
                         **{f"a{i}": x for i, (x, _) in enumerate(host)})
                with open(tmp / "manifest.json", "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:     # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Wait for the save in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, like: Any = None,
                shardings: Any = None, mesh=None) -> tuple[int, Any]:
        """Load step ``step`` (default: the latest). With ``like``, a tree
        of tensors, the leaves come back in its structure, each with its
        dtype and on its device (raises `ValueError` when the leaf keys
        differ from the manifest's); without it, as a list of CPU
        tensors. ``shardings``, a tree of placements of ``like``'s
        structure (e.g. `dist.sharding.param_specs` on ``mesh``, the
        current mesh), places each leaf onto ``mesh`` as a DTensor: the
        elastic-restart path."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "shard_0.npz") as data:
            leaves = [_from_host(data[f"a{i}"], manifest["dtypes"][i])
                      for i in range(len(manifest["keys"]))]
        if like is None:
            return step, leaves
        like_keys, like_leaves = _flatten(like)
        if like_keys != manifest["keys"]:
            raise ValueError("checkpoint/tree mismatch: the `like` tree's "
                             "leaf paths differ from the saved manifest")
        leaves = [x.to(device=lk.device, dtype=lk.dtype)
                  if torch.is_tensor(lk) else x
                  for x, lk in zip(leaves, like_leaves)]
        tree = tree_unflatten_like(like, leaves)
        if shardings is not None:
            if mesh is None:
                raise ValueError("restore(shardings=) needs the mesh the "
                                 "placements are on (mesh=)")
            from repro_torch.dist.sharding import place_tree
            tree = place_tree(tree, mesh, shardings)
        return step, tree


def _rank() -> int:
    """This process's global rank (0 without a process group)."""
    import torch.distributed as dist
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)
