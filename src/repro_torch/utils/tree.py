"""Tree helpers: flatten, byte accounting, content hashing, equality.

A tree is nested dicts, lists and tuples (``None`` is an empty subtree, as
in ``jax.tree``); anything else is a leaf: ``torch.Tensor``, ``np.ndarray``,
numpy or Python scalars, strings. Dict keys are visited in sorted order,
as ``jax.tree`` visits them, so leaves come out in the reference's order.
The structure is a nested tuple, hashable and comparable; ``tree_hash``
hashes its ``repr``, so hash strings differ from the reference's, which
hashes ``repr`` of a jax treedef (compare leaves and bytes across the two
packages instead). A leaf larger than ``HASH_CHUNK`` bytes enters the hash
as the SHA-256 digests of its HASH_CHUNK-byte pieces, in order, taken on a
pool of threads (hashlib releases the GIL): a full-width training state
(~28 GiB) hashes in seconds rather than a minute, and a smaller leaf
enters as its bytes, as before.
"""
from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

Treedef = Tuple[Any, ...]
_LEAF: Treedef = ("*",)

HASH_CHUNK = 1 << 26  # 64 MiB
_pool: Optional[ThreadPoolExecutor] = None


def flatten(tree) -> Tuple[List[Any], Treedef]:
    """(leaves in order, structure)."""
    leaves: List[Any] = []

    def walk(node) -> Treedef:
        if node is None:
            return ("None",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(c) for c in node))
        leaves.append(node)
        return _LEAF

    treedef = walk(tree)
    return leaves, treedef


def unflatten(treedef: Treedef, leaves) -> Any:
    it = iter(leaves)

    def build(td: Treedef):
        kind = td[0]
        if kind == "*":
            return next(it)
        if kind == "None":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        children = [build(c) for c in td[1]]
        return children if kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree) -> Any:
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in leaves])


def as_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array (bfloat16 widened to float32, exactly)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _leaf_bytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
        return int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
    return 0


def tree_bytes(tree) -> int:
    """Total bytes of all array leaves (tensors, arrays, numpy scalars)."""
    return sum(_leaf_bytes(leaf) for leaf in flatten(tree)[0])


def tree_count(tree) -> int:
    """Total number of elements of all array leaves."""
    return sum(int(np.prod(leaf.shape)) for leaf in flatten(tree)[0] if hasattr(leaf, "shape"))


def _sha256(piece) -> bytes:
    return hashlib.sha256(piece).digest()


def _hash_leaf_bytes(h, arr: np.ndarray) -> None:
    global _pool
    if arr.dtype == object or arr.nbytes <= HASH_CHUNK:
        h.update(arr.tobytes())
        return
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    pieces = [flat[i:i + HASH_CHUNK] for i in range(0, flat.size, HASH_CHUNK)]
    if _pool is None:
        _pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 1)
    for digest in _pool.map(_sha256, pieces):
        h.update(digest)


def tree_hash(tree) -> str:
    """Deterministic content hash of a tree of concrete leaves.

    Used by the FT machinery to prove zero data loss across migration and
    checkpoint. A tensor hashes its own dtype name, so a bfloat16 tensor and
    its float32 widening differ."""
    h = hashlib.sha256()
    leaves, treedef = flatten(tree)
    h.update(repr(treedef).encode())
    for leaf in leaves:
        arr = as_numpy(leaf)
        h.update(str(leaf.dtype if isinstance(leaf, torch.Tensor) else arr.dtype).encode())
        h.update(str(arr.shape).encode())
        _hash_leaf_bytes(h, arr)
    return h.hexdigest()


def tree_equal(a, b) -> bool:
    la, ta = flatten(a)
    lb, tb = flatten(b)
    if ta != tb or len(la) != len(lb):
        return False
    return all(np.array_equal(as_numpy(x), as_numpy(y)) for x, y in zip(la, lb))
