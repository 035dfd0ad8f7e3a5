"""Dependency-free tree checkpointing.

Layout: ``<dir>/step_<N:08d>/arrays.npz`` and ``tree.json``, as in the JAX
package.  A tree is nested dicts, lists and tuples (named ones too) of
tensors, numpy arrays or scalars; ``None`` leaves hold nothing and are
skipped.  Leaves are stored by flattened index and restored against a
template of the same structure (a training loop always has one: its
initial state), each onto the template leaf's device.

numpy has no bfloat16, so a bf16 tensor is stored as its 16-bit pattern
(int16) with ``"bfloat16"`` as its dtype in ``tree.json``, and viewed back
on restore; every dtype check compares these logical names.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["save", "restore", "latest_step"]

_BF16 = "bfloat16"


def _leaves(tree: Any) -> List[Any]:
    return [x for x in tree_leaves(tree) if x is not None]


def _dtype_name(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _shape(x: Any) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _stored_dtype(x: np.ndarray, recorded: Optional[str]) -> str:
    """The logical dtype of a loaded array: its own, or bfloat16 for the
    int16 pattern that ``tree.json`` records as one."""
    if recorded == _BF16 and x.dtype == np.int16:
        return _BF16
    return str(x.dtype)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write ``tree``'s leaves under ``<ckpt_dir>/step_<step:08d>/`` -> that
    path."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    leaves = _leaves(tree)
    np.savez(os.path.join(path, "arrays.npz"), **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
    meta = {
        "step": step,
        "num_leaves": len(leaves),
        "treedef": str(tree_map(lambda x: None if x is None else "*", tree)),
        "shapes": [list(_shape(x)) for x in leaves],
        "dtypes": [_dtype_name(x) for x in leaves],
    }
    with open(os.path.join(path, "tree.json"), "w") as f:
        json.dump(meta, f)
    return path


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None) -> Any:
    """Load a snapshot (the latest without ``step``) into ``template``'s
    structure: a tensor leaf comes back as a tensor on the template leaf's
    device, any other leaf as a numpy array.

    The snapshot must match the template: leaf count, each leaf's shape and
    each leaf's dtype are checked against both ``tree.json`` and the loaded
    arrays, and a mismatch raises ``ValueError``: a snapshot of another
    config never unflattens into garbage state.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    if meta.get("num_leaves") != len(leaves):
        raise ValueError(
            f"corrupt checkpoint at {path}: tree.json records {meta.get('num_leaves')} leaves "
            f"but arrays.npz holds {len(leaves)}"
        )
    t_leaves = _leaves(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint at {path} has {len(leaves)} leaves, template has {len(t_leaves)} — "
            "snapshot and restore config disagree"
        )
    meta_shapes = [tuple(s) for s in meta.get("shapes", [])]
    meta_dtypes = list(meta.get("dtypes", []))
    out = []
    for i, (x, t) in enumerate(zip(leaves, t_leaves)):
        recorded = meta_dtypes[i] if meta_shapes else None
        dtype = _stored_dtype(x, recorded)
        if meta_shapes and (tuple(x.shape) != meta_shapes[i] or dtype != recorded):
            raise ValueError(
                f"corrupt checkpoint at {path}: leaf {i} is {dtype}{tuple(x.shape)} but tree.json "
                f"recorded {recorded}{meta_shapes[i]}"
            )
        if tuple(x.shape) != _shape(t):
            raise ValueError(
                f"checkpoint leaf {i} at {path}: saved shape {tuple(x.shape)} does not match "
                f"template shape {_shape(t)} — snapshot and restore config disagree"
            )
        if dtype != _dtype_name(t):
            raise ValueError(
                f"checkpoint leaf {i} at {path}: saved dtype {dtype} does not match template "
                f"dtype {_dtype_name(t)} — snapshot and restore config disagree"
            )
        if isinstance(t, torch.Tensor):
            x = torch.from_numpy(x)
            x = (x.view(torch.bfloat16) if dtype == _BF16 else x).to(t.device)
        out.append(x)
    it = iter(out)
    return tree_map(lambda t: None if t is None else next(it), template)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest ``N`` of the ``step_N`` snapshots under ``ckpt_dir``, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir) if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None
