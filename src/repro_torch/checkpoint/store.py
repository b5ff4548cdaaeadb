"""Erasure-coded checkpoint store: RS-encoded shard-groups on node dirs.

The port of ``repro/checkpoint/store.py``. Layout on disk (each node j is a
directory, standing in for a storage server), the reference's exactly:

    root/node_<j>/<step>/<group>.chunk<c>     raw coded chunk bytes
    root/manifest_<step>.json                 leaf shapes, dtypes + plan

Write path: each group's leaves as bytes on their device -> split into k
zero-padded rows (``pad_and_split``'s layout) -> RS-encode to n rows
(``storage.rs.encode`` with ``kernels.ops.gf256_matmul``: kernel B2 on CUDA
tensors, its plain twin on CPU ones) -> one host copy -> chunks scattered
to the planned nodes. Read path: Madow-sample k surviving nodes per group
(probabilistic scheduling), read, decode (B2 again whenever a parity chunk
is read), and rebuild each leaf from its bytes with ``Tensor.view(dtype)``
(numpy has no bfloat16). Any (n - k) node losses per group are
survivable; failure injection = removing node dirs. A checkpoint saved by
either package restores in the other.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.storage import rs
from repro_torch.tree import flatten_with_keys, unflatten_like

from .planner import CheckpointPlan, GroupPlan, sample_read_set


def _dtype_name(dtype: torch.dtype) -> str:
    """The reference's (numpy) name of a dtype: ``float32``, ``bfloat16``."""
    return str(dtype).removeprefix("torch.")


def _leaf_bytes(leaf: Any) -> torch.Tensor:
    """A leaf's bytes, row-major, where the leaf lives (0-d leaves too)."""
    return torch.as_tensor(leaf).detach().contiguous().reshape(-1).view(torch.uint8)


def _split_rows(payload: torch.Tensor, k: int) -> torch.Tensor:
    """(k, ceil(L / k)) zero-padded rows of a byte payload, as
    ``storage.rs.pad_and_split`` lays them out, on the payload's device."""
    chunk = -(-payload.numel() // k)
    rows = torch.zeros(k * chunk, dtype=torch.uint8, device=payload.device)
    rows[: payload.numel()] = payload
    return rows.view(k, chunk)


class ECCheckpointStore:
    def __init__(self, root: str | Path, plan: CheckpointPlan, *, backend: str = "auto"):
        self.root = Path(root)
        self.plan = plan
        self.backend = backend
        self.root.mkdir(parents=True, exist_ok=True)

    def _matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return ops.gf256_matmul(a, b, backend=self.backend)

    # ------------------------------------------------------------------ io
    def _chunk_path(self, node: int, step: int, group: str, c: int) -> Path:
        return self.root / f"node_{node}" / str(step) / f"{group}.chunk{c}"

    def save(self, params: Any, step: int) -> dict:
        """Encode and scatter every group of ``params``; returns the manifest."""
        by_key = dict(flatten_with_keys(params))
        manifest: dict = {
            "step": step,
            "treedef": None,  # reconstructed from the template at load
            "groups": [],
            "leaves": {
                k: {"shape": list(torch.as_tensor(v).shape),
                    "dtype": _dtype_name(torch.as_tensor(v).dtype)}
                for k, v in by_key.items()
            },
        }
        for g in self.plan.groups:
            payload = torch.cat([_leaf_bytes(by_key[k]) for k in g.leaves])
            coded = rs.encode(_split_rows(payload, g.k), g.n, matmul=self._matmul)
            host = coded.cpu().numpy()
            for c, node in enumerate(g.placement):
                path = self._chunk_path(node, step, g.name, c)
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_bytes(host[c].tobytes())
            manifest["groups"].append(
                {
                    "name": g.name,
                    "leaves": list(g.leaves),
                    "nbytes": g.nbytes,
                    "k": g.k,
                    "n": g.n,
                    "placement": list(g.placement),
                    "chunk_len": int(coded.shape[1]),
                }
            )
        mpath = self.root / f"manifest_{step}.json"
        mpath.write_text(json.dumps(manifest))
        return manifest

    def alive_nodes(self) -> set[int]:
        return {
            int(p.name.split("_")[1])
            for p in self.root.glob("node_*")
            if p.is_dir()
        }

    def fail_node(self, node: int) -> None:
        """Failure injection: the node's storage disappears."""
        shutil.rmtree(self.root / f"node_{node}", ignore_errors=True)

    def restore(
        self,
        step: int,
        template: Any,
        *,
        seed: int = 0,
        uniforms: Sequence[float] | None = None,
    ) -> Any:
        """Rebuild the parameter tree in ``template``'s structure, on the
        device of its first leaf; survives any per-group <= n-k losses.

        Group i's read set is Madow-sampled with one uniform, drawn from a
        host generator seeded with ``seed``, or ``uniforms[i]``.
        """
        manifest = json.loads((self.root / f"manifest_{step}.json").read_text())
        alive = self.alive_nodes()
        template_leaves = flatten_with_keys(template)
        dev = torch.as_tensor(template_leaves[0][1]).device if template_leaves else "cpu"
        gen = torch.Generator().manual_seed(seed)
        by_key: dict[str, torch.Tensor] = {}
        for gi, g in enumerate(manifest["groups"]):
            gp = GroupPlan(
                name=g["name"],
                leaves=tuple(g["leaves"]),
                nbytes=g["nbytes"],
                k=g["k"],
                n=g["n"],
                placement=tuple(g["placement"]),
                pi=self.plan.groups[gi].pi,
            )
            u = gen if uniforms is None else uniforms[gi]
            read_nodes = sample_read_set(u, gp, alive, self.plan.cluster_size)
            chunk_ids, chunks = [], []
            for node in read_nodes:
                c = gp.placement.index(node)
                raw = self._chunk_path(node, step, gp.name, c).read_bytes()
                chunk_ids.append(c)
                chunks.append(np.frombuffer(raw, np.uint8))
            rows = torch.from_numpy(np.stack(chunks)).to(dev)
            data = rs.decode(rows, chunk_ids, gp.n, gp.k, matmul=self._matmul)
            payload = data.reshape(-1)[: gp.nbytes]
            off = 0
            for lk in gp.leaves:
                meta = manifest["leaves"][lk]
                dtype = getattr(torch, meta["dtype"])
                n = int(np.prod(meta["shape"])) * torch.empty((), dtype=dtype).element_size()
                # a copy starts at offset 0, which any dtype's view accepts
                by_key[lk] = payload[off : off + n].clone().view(dtype).reshape(meta["shape"])
                off += n
        return unflatten_like(template, by_key)

