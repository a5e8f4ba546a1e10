"""Checkpoints in the reference's format (port of
``repro.train.checkpoint``): atomic save, pruning, restore.

A checkpoint is ``<dir>/step_<step:08d>/`` holding one ``leaf_<i>.npy``
per leaf of the train state ``{"params", "opt": {"m", "v", "step"}}``
laid out as the reference's tree (``model.reference_layout``: the
pattern blocks' leaves stacked over the groups, ``(num_groups, ...)``),
in ``jax.tree_util.tree_flatten`` order (dict keys sorted), and
``manifest.json`` with the step, the leaf count, the tree's structure as
``jax`` prints it, the time and ``extra``. Writes go to ``<target>.tmp``,
renamed into place when complete; only complete checkpoints count, and
the newest ``keep`` stay. So a checkpoint of either package restores in
the other. A stacked leaf is written layer by layer into a memory-mapped
``.npy`` and read back the same way: no stacked copy is ever held.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.nn import model
from repro_torch.nn.config import ModelConfig

MANIFEST = "manifest.json"


def _leaf_path(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def reference_state(cfg: ModelConfig, state: dict) -> dict:
    """The train state in the reference's tree layout (leaves are the
    state's own tensors; stacked leaves are ``model.Stacked`` lists)."""
    opt = state["opt"]
    return {"params": model.reference_layout(cfg, state["params"]),
            "opt": {"m": model.reference_layout(cfg, opt["m"]),
                    "v": model.reference_layout(cfg, opt["v"]),
                    "step": opt["step"]}}


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` of a nested dict whose
    leaves (tensors, ``model.Stacked`` lists) are each one leaf."""
    def fmt(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"

    return f"PyTreeDef({fmt(tree)})"


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _write_leaf(path: str, leaf) -> None:
    if isinstance(leaf, model.Stacked):
        first = leaf[0]
        out = np.lib.format.open_memmap(
            path, mode="w+", dtype=_host(first.reshape(-1)[:0]).dtype,
            shape=(len(leaf), *first.shape))
        for i, t in enumerate(leaf):
            out[i] = _host(t)
        out.flush()
        del out
    else:
        np.save(path, _host(leaf))


def save(ckpt_dir: str, step: int, state: dict, cfg: ModelConfig,
         extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically save ``state`` at ``step``; prune to the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    target = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = target + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tree = reference_state(cfg, state)
    leaves = model.leaves(tree, stacked=True)
    for i, leaf in enumerate(leaves):
        _write_leaf(os.path.join(tmp, _leaf_path(i)), leaf)
    manifest = {"step": step, "num_leaves": len(leaves),
                "treedef": treedef_str(tree), "time": time.time(),
                "extra": extra or {}}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(target):
        shutil.rmtree(target)
    os.rename(tmp, target)  # atomic publish
    _prune(ckpt_dir, keep)
    return target


def _prune(ckpt_dir: str, keep: int) -> None:
    for s in list_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, MANIFEST)):
                out.append(int(name[5:]))  # only complete checkpoints
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


@torch.no_grad()
def _read_leaf(arr: np.ndarray, leaf) -> None:
    if isinstance(leaf, model.Stacked):
        if arr.shape[0] != len(leaf):
            raise ValueError(f"stacked leaf has {arr.shape[0]} layers, the "
                             f"state {len(leaf)}")
        for i, t in enumerate(leaf):
            t.copy_(torch.from_numpy(np.array(arr[i])).to(t.dtype))
    else:
        leaf.copy_(torch.from_numpy(np.array(arr)).to(leaf.dtype))


def restore(ckpt_dir: str, state: dict, cfg: ModelConfig,
            step: Optional[int] = None) -> tuple:
    """Restore the checkpoint at ``step`` (default: the newest) into
    ``state``'s tensors, in place, each cast to its dtype and moved to its
    device. Returns (state, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    target = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(target, MANIFEST)) as f:
        manifest = json.load(f)
    leaves = model.leaves(reference_state(cfg, state), stacked=True)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                         f"state expects {len(leaves)}")
    for i, leaf in enumerate(leaves):
        arr = np.load(os.path.join(target, _leaf_path(i)), mmap_mode="r")
        if leaf is state["opt"]["step"]:
            state["opt"]["step"] = torch.tensor(int(arr), dtype=torch.int32)
        else:
            _read_leaf(arr, leaf)
    return state, step, manifest.get("extra", {})
