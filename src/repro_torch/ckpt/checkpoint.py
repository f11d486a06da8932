"""Atomic, committed checkpoints of trees of tensors — the reference's
on-disk layout, so checkpoints cross packages in both directions.
Counterpart of `repro.ckpt.checkpoint`.

Layout (one directory per step):
    ckpt_dir/
      step_000000123/
        meta.json            # step, leaf count, dtypes, pipeline cursor
        shard_00000.npz      # every leaf, keyed leaf_%05d in flatten order
        COMMIT               # written LAST -> crash-safe atomicity marker
      latest                 # textfile with the newest committed step

  * the leaf index is the reference's `tree_flatten` order (`repro_torch.tree`:
    dict keys sorted, lists in order, `AdamWState` as (step, m, v)), so a
    ``{"params", "opt"}`` train state stores ``opt`` first in both packages;
  * ``bfloat16`` leaves are stored as their ``uint16`` bits (npz has no
    bfloat16) and named ``bfloat16`` in ``meta.json``;
  * saves go to a temp dir, every file is fsync'ed, ``COMMIT`` is written,
    then the dir is renamed into place: a crash mid-save never corrupts the
    newest committed checkpoint, and a step dir without ``COMMIT`` is
    ignored and garbage-collected at the next save (``keep`` newest kept);
  * the data-pipeline cursor rides in ``meta.json``, so a resume is
    exactly-once over the sample stream.

Restore checks the leaf count and each leaf's shape against the target
state and places every tensor on the target leaf's device and dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array the npz stores, and the dtype name meta.json
    records (numpy's names; bfloat16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir, step: int, state, *, pipeline_cursor: Optional[Dict] = None,
                    keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f".tmp_step_{step:09d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves = tree_leaves(state)
    arrs = {}
    dtypes = {}
    for i, leaf in enumerate(leaves):
        arrs[f"leaf_{i:05d}"], dtypes[f"leaf_{i:05d}"] = _to_numpy(leaf)
    np.savez(tmp / "shard_00000.npz", **arrs)
    meta = {
        "step": step,
        "time": time.time(),
        "n_leaves": len(leaves),
        "treedef": f"repro_torch tree of {len(leaves)} leaves",
        "dtypes": dtypes,
        "pipeline_cursor": pipeline_cursor or {},
    }
    (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
    # fsync barrier then commit marker then atomic rename
    for f in tmp.iterdir():
        with open(f, "rb") as fh:
            os.fsync(fh.fileno())
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _update_latest(ckpt_dir, step)
    _gc(ckpt_dir, keep)
    return final


def _update_latest(ckpt_dir: Path, step: int):
    (ckpt_dir / "latest").write_text(str(step))


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(committed_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)
    # remove uncommitted debris
    for d in ckpt_dir.glob(".tmp_step_*"):
        shutil.rmtree(d, ignore_errors=True)
    for d in ckpt_dir.glob("step_*"):
        if not (d / "COMMIT").exists():
            shutil.rmtree(d, ignore_errors=True)


def committed_steps(ckpt_dir) -> list:
    ckpt_dir = Path(ckpt_dir)
    out = []
    for d in ckpt_dir.glob("step_*"):
        if (d / "COMMIT").exists():
            try:
                out.append(int(d.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _step_dir(ckpt_dir: Path, step: Optional[int]) -> Path:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"checkpoint {d} not committed")
    return d


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str], like) -> torch.Tensor:
    flat = np.ascontiguousarray(arr).reshape(arr.shape)  # keeps 0-d leaves 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(flat.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(flat)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore_checkpoint(ckpt_dir, state_like, *, step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``state_like`` (a tree of tensors):
    each leaf takes the target leaf's dtype and device.  Raises ValueError
    when the leaf count or a leaf's shape differs from the target's."""
    d = _step_dir(Path(ckpt_dir), step)
    meta = json.loads((d / "meta.json").read_text())
    leaves_like = tree_leaves(state_like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, target structure has "
            f"{len(leaves_like)}"
        )
    dtypes = meta.get("dtypes", {})
    new_leaves = []
    with np.load(d / "shard_00000.npz") as data:
        for i, like in enumerate(leaves_like):
            key = f"leaf_{i:05d}"
            arr = data[key]
            want = tuple(like.shape) if hasattr(like, "shape") else arr.shape
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                                 f"target {want}")
            new_leaves.append(_to_tensor(arr, dtypes.get(key), like))
    return tree_unflatten(state_like, new_leaves), meta
