"""Disk (de)serialization of Laplace state dicts, pickle-free (port of
`laplace_jax/utils/serialization.py`, the same archive layout).

One `.npz` archive: each array entry under its key, a `Kron` or
`KronDecomposed` as `key::leaf{i}` in the JAX package's tree-flatten order
(group by group; for `KronDecomposed` all eigenvectors, then all
eigenvalues, then `deltas`), a list of arrays as `key::item{i}`, a dict of
arrays as `key::key::{k}`, and everything else (None, bools, numbers,
strings) in a JSON object stored as uint8 under `__laplace_jax_meta__`.
`np.load(..., allow_pickle=False)` reads it, and an archive written by
either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from laplace_jax_torch.utils.matrix import Kron, KronDecomposed

__all__ = ["save_state_dict", "load_state_dict"]

_META_KEY = "__laplace_jax_meta__"


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _leaves(val) -> list:
    """The leaves of a `Kron` / `KronDecomposed` in the JAX tree-flatten order."""
    if isinstance(val, Kron):
        return [H for F in val.kfacs for H in F]
    return ([Q for Qs in val.eigenvectors for Q in Qs]
            + [lam for ls in val.eigenvalues for lam in ls] + [val.deltas])


def _kron_aux(val) -> Any:
    if isinstance(val, Kron):
        return [len(F) for F in val.kfacs]
    return {"lens": [len(ls) for ls in val.eigenvalues], "damping": bool(val.damping)}


def _flatten_state(state: dict) -> tuple[dict, dict]:
    arrays, meta = {}, {}
    for key, val in state.items():
        if isinstance(val, (Kron, KronDecomposed)):
            leaves = _leaves(val)
            meta[key] = {"kind": type(val).__name__, "n_leaves": len(leaves),
                         "aux": _kron_aux(val)}
            for i, leaf in enumerate(leaves):
                arrays[f"{key}::leaf{i}"] = _numpy(leaf)
        elif _is_array(val):
            arrays[key] = _numpy(val)
        elif isinstance(val, (list, tuple)) and val and all(_is_array(v) for v in val):
            meta[key] = {"kind": "array_list", "n": len(val)}
            for i, v in enumerate(val):
                arrays[f"{key}::item{i}"] = _numpy(v)
        elif isinstance(val, dict) and all(_is_array(v) for v in val.values()):
            # e.g. the last-layer discovery probe of a dict-input model
            meta[key] = {"kind": "array_dict", "keys": sorted(val.keys())}
            for k in val:
                arrays[f"{key}::key::{k}"] = _numpy(val[k])
        elif val is None or isinstance(val, (bool, int, float, str)):
            meta[key] = {"kind": "scalar", "value": val}
        else:
            raise ValueError(f"Cannot serialize state entry {key!r} of type {type(val)}.")
    return arrays, meta


def save_state_dict(state: dict, path: str) -> None:
    """Write `state` (tensors, numpy arrays, `Kron`, `KronDecomposed`, lists
    or dicts of arrays, JSON scalars) to the archive `path`."""
    arrays, meta = _flatten_state(state)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state_dict(path: str) -> dict:
    """The state in the archive `path`: numpy arrays, lists and dicts of
    them, JSON scalars, and `Kron` / `KronDecomposed` over CPU tensors that
    share the arrays' memory. The flavor's `load_state_dict` moves each to
    its own device and dtype."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode())
        state: dict = {k: data[k] for k in data.files if k != _META_KEY and "::" not in k}
        for key, m in meta.items():
            if m["kind"] == "scalar":
                state[key] = m["value"]
            elif m["kind"] == "array_list":
                state[key] = [data[f"{key}::item{i}"] for i in range(m["n"])]
            elif m["kind"] == "array_dict":
                state[key] = {k: data[f"{key}::key::{k}"] for k in m["keys"]}
            elif m["kind"] in ("Kron", "KronDecomposed"):
                leaves = [torch.from_numpy(data[f"{key}::leaf{i}"]) for i in range(m["n_leaves"])]
                state[key] = _unflatten(m, leaves)
    return state


def _unflatten(m: dict, leaves: list):
    if m["kind"] == "Kron":
        kfacs, i = [], 0
        for n in m["aux"]:
            kfacs.append(tuple(leaves[i:i + n]))
            i += n
        return Kron(kfacs)
    lens = m["aux"]["lens"]
    total = sum(lens)
    eigvecs, eigvals, i = [], [], 0
    for n in lens:
        eigvecs.append(tuple(leaves[i:i + n]))
        eigvals.append(tuple(leaves[total + i:total + i + n]))
        i += n
    return KronDecomposed(eigvecs, eigvals, leaves[2 * total], damping=m["aux"]["damping"])
