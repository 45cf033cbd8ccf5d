"""Checkpoint save/restore with atomic commit and an integrity manifest.
Counterpart of ``repro.checkpoint.checkpoint``, on the same disk layout::

    <dir>/step_00000123/
        manifest.json      # tree structure, shapes, dtypes, sizes, crc32s
        arr_00000.npy ...  # one file per leaf, a host copy of the tensor

Atomicity: everything is written into ``step_X.tmp`` and renamed once the
manifest (written last, fsynced) is on disk, so a crashed save is never
taken for a complete checkpoint.  Integrity is checked on restore: every
leaf carries its byte count and a crc32 of its bytes, and the stored tree
structure must equal the restore target's.  Stray entries that are not
``step_NNNNNNNN`` checkpoints are ignored, and orphaned ``*.tmp``
directories of a crashed save are removed (one writer per directory).

Trees are flattened with ``torch.utils._pytree``: tuples, lists, dicts and
NamedTuples are containers; tensors, numpy arrays and Python scalars are
leaves.  The stored ``treedef`` is that module's string of the tree, not
JAX's.  A leaf restores to its *like* leaf's kind: a tensor to a tensor
of the like leaf's dtype on its device, a Python ``int``/``float``/
``bool`` to that type, a numpy array to the like array's dtype.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

_STEP_RE = re.compile(r"^step_(\d{8})$")
_SCALARS = (bool, int, float)


def flatten(tree):
    """(leaves, treedef) of a tree."""
    return pytree.tree_flatten(tree)


def leaf_paths(tree) -> list:
    """The key path of each leaf, as a string (``.sts.zn``, ...)."""
    return [pytree.keystr(kp) for kp, _ in
            pytree.tree_flatten_with_path(tree)[0]]


def to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def like_leaf(arr: np.ndarray, like):
    """``arr`` as the kind of ``like``: dtype, device and type."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            dtype=like.dtype, device=like.device)
    if isinstance(like, _SCALARS):
        return type(like)(arr.item())
    return np.asarray(arr).astype(np.asarray(like).dtype)


def leaf_shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _step_of(name: str) -> Optional[int]:
    """Step number of a checkpoint entry; None for anything that is not a
    complete ``step_NNNNNNNN`` name (stray files, ``.tmp`` dirs, ...)."""
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def gc_incomplete(ckpt_dir: str) -> list:
    """Remove orphaned ``*.tmp`` dirs left by a crashed save; returns the
    removed names.  The rename to ``step_X`` follows the fsynced manifest,
    so a surviving ``.tmp`` entry is never a restore target."""
    removed = []
    if not os.path.isdir(ckpt_dir):
        return removed
    for name in sorted(os.listdir(ckpt_dir)):
        full = os.path.join(ckpt_dir, name)
        if name.endswith(".tmp") and os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
            removed.append(name)
    return removed


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extras: Optional[dict] = None) -> str:
    """Write ``tree`` (a tree of tensors, arrays and scalars) and the
    JSON-able ``extras`` as checkpoint ``step``; returns its path."""
    final = step_path(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves, treedef = flatten(tree)
    entries = []
    for i, leaf in enumerate(leaves):
        arr = to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        entries.append({"file": fname, "shape": list(arr.shape),
                        "dtype": str(arr.dtype), "bytes": int(arr.nbytes),
                        "crc32": int(zlib.crc32(arr.tobytes()))})
    manifest = {
        "step": step,
        "treedef": str(treedef),
        "n_leaves": len(leaves),
        "entries": entries,
        "extras": extras or {},
        "total_bytes": int(sum(e["bytes"] for e in entries)),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for name in os.listdir(ckpt_dir)
             if (s := _step_of(name)) is not None and
             os.path.exists(os.path.join(ckpt_dir, name, "manifest.json"))]
    return max(steps) if steps else None


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_leaf(path: str, entry: dict) -> np.ndarray:
    """One leaf array, its byte count and (when the manifest has one) its
    crc32 checked."""
    arr = np.load(os.path.join(path, entry["file"]))
    if int(arr.nbytes) != entry["bytes"]:
        raise IOError(f"integrity failure on {entry['file']}: "
                      f"{arr.nbytes} bytes != manifest {entry['bytes']}")
    crc = entry.get("crc32")
    if crc is not None and int(zlib.crc32(arr.tobytes())) != crc:
        raise IOError(f"integrity failure on {entry['file']}: crc32 mismatch")
    return arr


def check_structure(manifest: dict, leaves, treedef) -> None:
    """Raise unless the stored leaf count and tree structure are the
    restore target's."""
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(leaves)}")
    stored_td = manifest.get("treedef")
    if stored_td is not None and stored_td != str(treedef):
        raise ValueError(
            "checkpoint tree structure does not match the restore target:\n"
            f"  stored:   {stored_td}\n  expected: {treedef}")


def restore_checkpoint(ckpt_dir: str, step: int, like_tree: Any):
    """Restore checkpoint ``step`` into the structure of ``like_tree``;
    returns (tree, extras).  Every leaf must keep its like leaf's shape."""
    path = step_path(ckpt_dir, step)
    manifest = read_manifest(path)
    leaves, treedef = flatten(like_tree)
    check_structure(manifest, leaves, treedef)
    out = []
    for i, (entry, like) in enumerate(zip(manifest["entries"], leaves)):
        arr = load_leaf(path, entry)
        if tuple(arr.shape) != leaf_shape(like):
            raise ValueError(f"leaf {i} shape {arr.shape} != expected "
                             f"{leaf_shape(like)}")
        out.append(like_leaf(arr, like))
    return pytree.tree_unflatten(out, treedef), manifest["extras"]


# --- per-tenant checkpoints (repro_torch.serve) -----------------------------
#
# The service snapshots each tenant's carry slice on its own: a tenant's
# rollback never rewinds a neighbour, so each request id has its own
# directory (``tenant_000007/step_00000042/``, the same commit protocol);
# the tenant id also rides the manifest extras.

def tenant_dir(ckpt_dir: str, tenant: int) -> str:
    return os.path.join(ckpt_dir, f"tenant_{int(tenant):06d}")


def save_tenant_checkpoint(ckpt_dir: str, tenant: int, step: int, tree: Any,
                           extras: Optional[dict] = None) -> str:
    ex = dict(extras or {})
    ex["tenant"] = int(tenant)
    return save_checkpoint(tenant_dir(ckpt_dir, tenant), step, tree, extras=ex)


def latest_tenant_step(ckpt_dir: str, tenant: int) -> Optional[int]:
    return latest_step(tenant_dir(ckpt_dir, tenant))


def restore_tenant_checkpoint(ckpt_dir: str, tenant: int, step: int,
                              like_tree: Any):
    return restore_checkpoint(tenant_dir(ckpt_dir, tenant), step, like_tree)


def list_tenants(ckpt_dir: str) -> list:
    """Tenant ids with at least one complete checkpoint on disk."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"^tenant_(\d{6})$", name)
        if m and latest_step(os.path.join(ckpt_dir, name)) is not None:
            out.append(int(m.group(1)))
    return sorted(out)


def prune_tenant_checkpoints(ckpt_dir: str, tenant: int, keep: int = 2):
    prune_checkpoints(tenant_dir(ckpt_dir, tenant), keep)


def prune_checkpoints(ckpt_dir: str, keep: int = 3):
    """Keep the ``keep`` newest checkpoints; remove orphaned ``.tmp``
    dirs.  Entries that are not checkpoints stay."""
    if not os.path.isdir(ckpt_dir):
        return
    gc_incomplete(ckpt_dir)
    steps = sorted(s for n in os.listdir(ckpt_dir)
                   if (s := _step_of(n)) is not None)
    for s in steps[:-keep]:
        shutil.rmtree(step_path(ckpt_dir, s), ignore_errors=True)
