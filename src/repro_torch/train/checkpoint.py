"""Checkpoint/restart in the JAX package's layout, so either package
restores the other's directory.

Layout on disk:
  <dir>/step_000123/
     manifest.json        tree structure, dtypes, step, extra
     leaf_00000.npy ...   one file per leaf, in flatten order (dict keys
                          sorted); bfloat16 leaves as their uint16 words
  <dir>/LATEST            atomic pointer (written via rename)

Save is atomic (tmp dir + rename); ``keep_last_k`` prunes old steps. The
``treedef`` string is JAX's printed form of the tree, so the two
packages' manifests compare equal. Nothing here imports ``ml_dtypes``: a
bfloat16 leaf is read as ``uint16`` and reinterpreted.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models.convert import leaf_to_numpy
from ..models.spec import tree_leaves, tree_unflatten

# numpy's dtype names, as the JAX package writes them
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16", torch.float64: "float64",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


def treedef_str(tree) -> str:
    """``str(jax.tree.structure(tree))`` for a tree of dicts, tuples and
    lists with tensor leaves."""
    def fmt(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            return "(" + ", ".join(fmt(x) for x in t) + \
                ("," if len(t) == 1 else "") + ")"
        if isinstance(t, list):
            return "[" + ", ".join(fmt(x) for x in t) + "]"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def save(ckpt_dir: str, step: int, tree, *, keep_last_k: int = 3,
         extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tree_leaves(tree)
    dtypes = []
    for i, leaf in enumerate(leaves):
        if leaf.dtype not in _DTYPE_NAMES:
            raise TypeError(f"unsupported leaf dtype {leaf.dtype}")
        dtypes.append(_DTYPE_NAMES[leaf.dtype])
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf_to_numpy(leaf))
    manifest = {"step": step, "treedef": treedef_str(tree),
                "n_leaves": len(leaves), "dtypes": dtypes,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep_last_k)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            return int(f.read().strip().split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None,
            device="cuda"):
    """Restore into the structure of ``tree_like`` (its leaves' values are
    not read); returns (tree, manifest). Each leaf keeps the dtype it was
    saved with and lands on ``device``; without a card this raises unless
    ``device="cpu"`` is given."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n_like = len(tree_leaves(tree_like))
    assert manifest["n_leaves"] == n_like, \
        f"leaf count mismatch: ckpt {manifest['n_leaves']} vs {n_like}"
    leaves = []
    for i in range(n_like):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        if manifest.get("dtypes", [None] * (i + 1))[i] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        leaves.append(t.to(device))
    return tree_unflatten(tree_like, leaves), manifest
