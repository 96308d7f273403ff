"""Fault-tolerant checkpointing: atomic step snapshots (tmp dir + rename),
a CRC32 of the arrays in the metadata, keep-last-k, resume from the latest
valid step. Port of ``repro.checkpoint.manager``, numpy, json and zlib only.

The on-disk format is the reference's: ``step_%010d/arrays.npz`` and
``meta.json`` (``step``, ``crc32`` of the npz, ``n_arrays``, ``extra``).
The array keys are the reference's ``_keys``: a leaf's path in
``jax.tree_util.tree_flatten_with_path`` order, dict keys sorted, a tuple
index as its number and a NamedTuple field as ``.name``; for ``(params,
AdamWState)`` that is ``0/<path>``, ``1/.step``, ``1/.mu/<path>`` and
``1/.nu/<path>``. So a checkpoint written by either package restores in
the other. A bfloat16 tensor is stored as its 16-bit pattern (numpy has
no bfloat16) and restored as bfloat16 into a bfloat16 leaf.

In a ``torch.distributed`` world of more than one process (a launcher
under ``torchrun``) every rank holds the same tree and saves at the same
steps: rank 0 alone writes and prunes, and every rank waits at a barrier
until the step is in place, so no two ranks race on a directory and no
rank reads a step before it is whole.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key, leaf) pairs of a tree of dicts, tuples and NamedTuples in the
    reference's leaf order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix[:-1], tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}{k}/")
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    """A tree of ``like``'s structure whose leaf at each key is ``leaves[key]``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves, f"{prefix}.{f}/")
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, f"{prefix}{i}/") for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 and a.dtype.kind != "f":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(like.device)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def save(self, step: int, tree, extra: dict | None = None) -> Path:
        """Atomic: write into a tmp dir, fsync the metadata, rename into
        place (rank 0's work in a world of several processes; every rank
        returns once it is done)."""
        if _world_size() == 1:
            return self._write(step, tree, extra)
        if dist.get_rank() == 0:
            self._write(step, tree, extra)
        dist.barrier()
        return self._step_dir(step)

    def _write(self, step: int, tree, extra: dict | None) -> Path:
        flat = {k: _to_numpy(v) for k, v in _flatten(tree)}
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        crc = zlib.crc32((tmp / "arrays.npz").read_bytes())
        meta = {"step": step, "crc32": crc, "n_arrays": len(flat), "extra": extra or {}}
        with open(tmp / "meta.json", "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _valid(self, d: Path) -> bool:
        try:
            meta = json.loads((d / "meta.json").read_text())
            return meta["crc32"] == zlib.crc32((d / "arrays.npz").read_bytes())
        except (OSError, ValueError, KeyError):
            return False

    def steps(self) -> list[int]:
        return [int(d.name.split("_")[1]) for d in sorted(self.dir.glob("step_*"))
                if self._valid(d)]

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like, step: int | None = None):
        """Restore into the structure of ``tree_like`` (its leaves give each
        restored tensor's device, and bfloat16 where stored as bits).
        Returns (tree, step, extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {self.dir}")
        d = self._step_dir(step)
        if not self._valid(d):
            raise IOError(f"checkpoint {d} failed CRC validation")
        meta = json.loads((d / "meta.json").read_text())
        with np.load(d / "arrays.npz") as data:
            leaves = {k: _to_tensor(data[k], like) for k, like in _flatten(tree_like)}
        return _unflatten(tree_like, leaves), step, meta["extra"]

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
