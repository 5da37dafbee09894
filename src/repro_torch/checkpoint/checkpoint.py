"""Sharded checkpoint save/restore with atomic manifests (the counterpart
of ``src/repro/checkpoint/checkpoint.py``, file for file: the same NumPy
tree gives the same ``manifest.json`` and the same ``.npy`` files).

Layout on disk (one directory per step, committed by atomic rename):

    <root>/step_000100/
        manifest.json                 # tree structure, leaf shapes/dtypes,
                                      # shard→host assignment, step metadata
        <host>/<leaf>.<i>.npy         # leaf chunks, one dir per storage host

* Leaves are chunked along axis 0 into ≤``chunk_bytes`` pieces; chunk
  files are assigned to hosts by the Equilibrium placement
  (:mod:`.placement`) so heterogeneous storage fills evenly.
* Writes go to ``step_N.tmp`` and are renamed into place only after the
  manifest is fully written — a crashed writer never corrupts the
  latest checkpoint.
* ``restore_checkpoint`` reassembles the tree as host NumPy arrays; the
  trainer moves them to its device.

The tree is a nested dict of NumPy arrays, or of anything ``np.asarray``
takes; its leaves are visited with the keys sorted, as
``jax.tree_util.tree_flatten_with_path`` visits a dict's, so the leaf
order, the chunk ids and the placement are the reference's.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

from .placement import StorageHost, plan_placement


def _flatten_with_names(tree, prefix: str = ""
                        ) -> list[tuple[str, np.ndarray]]:
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out += _flatten_with_names(tree[key], f"{prefix}{key}/")
        else:
            out.append((f"{prefix}{key}", np.asarray(tree[key])))
    return out


def _chunks(arr: np.ndarray, chunk_bytes: int):
    if arr.ndim == 0 or arr.nbytes <= chunk_bytes:
        yield 0, arr
        return
    rows = max(1, int(chunk_bytes // max(arr[0:1].nbytes, 1)))
    for i, start in enumerate(range(0, arr.shape[0], rows)):
        yield i, arr[start: start + rows]


def save_checkpoint(root: str | Path, step: int, tree,
                    hosts: list[StorageHost] | None = None,
                    replicas: int = 1, chunk_bytes: int = 64 << 20,
                    extra_meta: dict | None = None) -> Path:
    """Write a checkpoint; returns the committed directory."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = _flatten_with_names(tree)
    # chunk plan + Equilibrium placement over hosts
    shard_sizes: dict[str, float] = {}
    chunk_arrays: dict[str, np.ndarray] = {}
    leaf_meta: dict[str, dict] = {}
    for name, arr in leaves:
        ids = []
        for i, chunk in _chunks(arr, chunk_bytes):
            sid = f"{name}.{i}"
            shard_sizes[sid] = chunk.nbytes
            chunk_arrays[sid] = chunk
            ids.append(sid)
        leaf_meta[name] = {"shape": list(arr.shape),
                           "dtype": str(arr.dtype), "chunks": ids}

    if hosts is None:
        hosts = [StorageHost("host0", capacity=2 * sum(shard_sizes.values())
                             + 1)]
    placement = plan_placement(shard_sizes, hosts, replicas=replicas)
    assignment = placement.assignment()

    for sid, arr in chunk_arrays.items():
        for host in assignment[sid]:
            hdir = tmp / host
            hdir.mkdir(exist_ok=True)
            np.save(hdir / (sid.replace("/", "__") + ".npy"), arr)

    manifest = {
        "step": step,
        "leaves": leaf_meta,
        "assignment": assignment,
        "hosts": [{"name": h.name, "capacity": h.capacity, "rack": h.rack}
                  for h in hosts],
        "replicas": replicas,
        "meta": extra_meta or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic commit
    return final


def latest_step(root: str | Path) -> int | None:
    root = Path(root)
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(root: str | Path, step: int | None = None,
                       unavailable_hosts: set[str] = frozenset()):
    """Rebuild the tree (dict of dicts with NumPy leaves) and return it
    with the manifest.  ``unavailable_hosts`` simulates storage-host
    failures: restore succeeds as long as every chunk has a surviving
    replica."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    cdir = root / f"step_{step:08d}"
    manifest = json.loads((cdir / "manifest.json").read_text())

    def load_chunk(sid: str) -> np.ndarray:
        for host in manifest["assignment"][sid]:
            if host in unavailable_hosts:
                continue
            f = cdir / host / (sid.replace("/", "__") + ".npy")
            if f.exists():
                return np.load(f)
        raise IOError(f"no surviving replica for chunk {sid}")

    tree: dict = {}
    for name, meta in manifest["leaves"].items():
        parts = [load_chunk(sid) for sid in meta["chunks"]]
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        node = tree
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr.reshape(meta["shape"]).astype(meta["dtype"])
    return tree, manifest
