"""Plan-driven batched erasure codec: the data plane the solver chose.

The port of ``repro/storage/codec.py``. `storage/rs.py` is the single-file
*reference* codec — one request, one host-side matrix inversion, one
matmul. This module is the production path: it takes the control plane's
output (a :class:`~repro_torch.core.jlcm.JLCMSolution` — per-file code
length ``n_i``, MDS parameter ``k_i``, and placement ``S_i``) and turns it
into a :class:`CodecPlan` whose encode and degraded-read decode run
**batched and device-resident**:

* files are grouped by ``(n, k)`` — every group shares one generator
  matrix, so a group's encode is ONE unbatched GF(256) matmul (kernel B2
  on the card) and a batch of its degraded reads ONE batched matmul
  (kernel B3), through ``repro_torch.kernels.ops``, not B Python-level
  codec calls;
* decode matrices for erasure patterns are built on the host **once** per
  distinct pattern (`rs.decode_matrix`, LRU-cached Gauss–Jordan) and
  gathered into a device-resident (B, k, k) bank — a degraded-read storm
  during a node failure cycles through a handful of patterns, so the
  amortized host cost is zero and the steady-state decode is pure device
  work;
* chunk-to-node assignment is derived from the placement row (chunk ``c``
  of file ``i`` lives on the ``c``-th placed node in node order), which is
  what the repair subsystem (`storage/repair.py`) inverts to enumerate the
  chunks lost with a failed node.

Payloads and decoded rows are tensors and stay on the device they live on:
:meth:`CodecPlan.decode_requests` returns tensors where the reference
returns numpy arrays, so a multi-GiB decode is not copied to the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence

import numpy as np
import torch
from torch import Tensor

from . import rs
from .cluster import _device
from .gf256 import gf_matmul_ref

# NOTE: repro_torch.kernels imports are deferred into the functions below —
# kernels.gf256_matmul itself imports repro_torch.storage.gf256, so a
# top-level import here would make `import repro_torch.kernels` circular.


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=512)
def _decode_bank_host(n: int, k: int, patterns: tuple[tuple[int, ...], ...]) -> np.ndarray:
    """(P, k, k) decode-matrix bank for the distinct erasure patterns.

    Each row is ``inv(G[ids])`` from the (LRU-cached) reference inversion;
    the bank itself is also cached so a repeated storm of the same pattern
    mix re-uses the stacked array."""
    return np.stack([rs.decode_matrix(n, k, ids) for ids in patterns])


def decode_bank(
    n: int, k: int, patterns: Sequence[Sequence[int]], device="cuda"
) -> tuple[Tensor, Tensor]:
    """Device bank + per-request gather index for a batch of patterns.

    ``patterns`` is the per-request list of surviving chunk ids (each of
    length k). Returns ``(bank, idx)`` on ``device`` with ``bank`` (P, k, k)
    holding one decode matrix per *distinct* pattern and ``idx`` (B,)
    mapping each request to its bank row, so ``bank[idx]``, gathered on the
    device, is the (B, k, k) operand of the batched matmul.
    """
    device = _device(device)
    keyed = [tuple(int(i) for i in p) for p in patterns]
    distinct = sorted(set(keyed))
    lut = {p: i for i, p in enumerate(distinct)}
    bank = _decode_bank_host(n, k, tuple(distinct))
    idx = np.asarray([lut[p] for p in keyed], np.int64)
    return torch.as_tensor(bank, device=device), torch.as_tensor(idx, device=device)


def decode_batch(
    chunks: Tensor,
    patterns: Sequence[Sequence[int]],
    n: int,
    k: int,
    *,
    backend: str = "auto",
) -> Tensor:
    """Batched degraded-read decode: (B, k, nbytes) chunks -> data rows.

    Request ``b`` holds the k surviving chunks of an (n, k) codeword whose
    original row indices are ``patterns[b]``. The decode-matrix bank is
    assembled on host (cached), then the whole batch is ONE
    `gf256_matmul_batch` call on the selected backend, on the chunks'
    device.
    """
    from repro_torch.kernels.ops import gf256_matmul_batch

    chunks = torch.as_tensor(chunks, dtype=torch.uint8)
    if chunks.dim() != 3 or chunks.shape[1] != k or len(patterns) != chunks.shape[0]:
        raise ValueError(
            f"need (B, k={k}, nbytes) chunks with one pattern per request, "
            f"got {tuple(chunks.shape)} and {len(patterns)} patterns"
        )
    bank, idx = decode_bank(n, k, patterns, device=chunks.device)
    return gf256_matmul_batch(bank[idx], chunks, backend=backend)


def encode_batch(data: Tensor, n: int, *, backend: str = "auto") -> Tensor:
    """Batched systematic encode: (B, k, nbytes) data -> (B, n, nbytes).

    Every request in a group shares the generator, so the parity of the
    whole batch folds into ONE unbatched matmul of the parity matrix
    against the byte-concatenated payloads — the cheapest shape for all
    backends (a (n-k, k) x (k, B*nbytes) call).
    """
    from repro_torch.kernels.ops import gf256_matmul

    data = torch.as_tensor(data, dtype=torch.uint8)
    bsz, k, nbytes = data.shape
    parity_mat = torch.as_tensor(rs.cauchy_parity_matrix(n, k), device=data.device)
    flat = data.transpose(0, 1).reshape(k, bsz * nbytes)
    parity = gf256_matmul(parity_mat, flat, backend=backend)
    parity = parity.reshape(n - k, bsz, nbytes).transpose(0, 1)
    return torch.cat([data, parity], dim=1)


@dataclasses.dataclass(frozen=True)
class CodecGroup:
    """Files of one (n, k) class — the unit of batched codec work."""

    n: int
    k: int
    file_ids: np.ndarray  # (g,) catalog indices sharing this code


@dataclasses.dataclass(frozen=True)
class CodecPlan:
    """The byte-level realization of a solver plan.

    ``n``/``k`` are (r,) ints, ``placement`` (r, m) bool with row sums
    ``n``; ``chunk_node[i]`` lists the nodes storing file i's chunks in
    chunk-row order (chunk c on the c-th placed node, node-id order — the
    deterministic layout both the simulator's placement and the repair
    inventory assume). The plan itself is host-side numpy.
    """

    n: np.ndarray
    k: np.ndarray
    placement: np.ndarray
    groups: tuple[CodecGroup, ...]

    @classmethod
    def from_solution(cls, sol, k: Sequence[float] | np.ndarray | Tensor) -> "CodecPlan":
        """Derive the data-plane plan from a ``JLCMSolution``.

        ``k`` is the catalog's MDS parameter vector (it lives in
        ``JLCMProblem``, not the solution). ``sol.n`` and
        ``sol.placement`` come from the Lemma-4 support extraction; they
        may be tensors on the card, and are copied to the host.
        """
        n = _host(sol.n).astype(np.int32).reshape(-1)
        kk = np.round(_host(k)).astype(np.int32).reshape(-1)
        placement = _host(sol.placement).astype(bool)
        if placement.shape[0] != n.shape[0] or kk.shape[0] != n.shape[0]:
            raise ValueError(
                f"inconsistent plan shapes: n {n.shape}, k {kk.shape}, "
                f"placement {placement.shape}"
            )
        if (n < kk).any():
            raise ValueError("plan places fewer than k chunks for some file")
        groups = []
        for nk in sorted({(int(a), int(b)) for a, b in zip(n, kk)}):
            ids = np.where((n == nk[0]) & (kk == nk[1]))[0]
            groups.append(CodecGroup(n=nk[0], k=nk[1], file_ids=ids))
        return cls(n=n, k=kk, placement=placement, groups=tuple(groups))

    @property
    def r(self) -> int:
        return int(self.n.shape[0])

    @property
    def m(self) -> int:
        return int(self.placement.shape[1])

    def chunk_nodes(self, file_id: int) -> np.ndarray:
        """(n_i,) node ids storing file ``file_id``'s chunks, row order."""
        return np.where(self.placement[file_id])[0][: int(self.n[file_id])]

    def group_of(self, file_id: int) -> CodecGroup:
        for g in self.groups:
            if (g.file_ids == file_id).any():
                return g
        raise KeyError(f"file {file_id} not in any codec group")

    def degraded_patterns(self, file_id: int, dead_nodes: Iterable[int]) -> list[int]:
        """Surviving chunk ids to fetch for file ``file_id`` when
        ``dead_nodes`` are down: the k lowest-indexed live chunk rows
        (data rows first — systematic reads stay cheap)."""
        dead = set(int(d) for d in dead_nodes)
        nodes = self.chunk_nodes(file_id)
        live = [c for c, node in enumerate(nodes) if int(node) not in dead]
        kk = int(self.k[file_id])
        if len(live) < kk:
            raise ValueError(
                f"file {file_id}: only {len(live)} chunks survive, need {kk}"
            )
        return live[:kk]

    def decode_group(
        self,
        group: CodecGroup,
        chunks: Tensor,
        patterns: Sequence[Sequence[int]],
        *,
        backend: str = "auto",
    ) -> Tensor:
        """One batched decode for requests of one (n, k) group."""
        return decode_batch(chunks, patterns, group.n, group.k, backend=backend)

    def decode_requests(
        self,
        file_ids: Sequence[int],
        patterns: Sequence[Sequence[int]],
        chunks: Sequence[Tensor],
        *,
        backend: str = "auto",
    ) -> list[Tensor]:
        """Decode a mixed batch of degraded reads, plan-wide.

        Requests are grouped by their file's (n, k); each group issues ONE
        batched device call; results return in request order, as (k, nbytes)
        tensors on the chunks' device. Chunk payload width may differ
        *across* groups (per-file chunk sizes) but must agree within one.
        """
        if not (len(file_ids) == len(patterns) == len(chunks)):
            raise ValueError("file_ids, patterns, chunks must align")
        out: list[Tensor | None] = [None] * len(file_ids)
        by_group: dict[tuple[int, int], list[int]] = {}
        for req, fid in enumerate(file_ids):
            g = self.group_of(int(fid))
            by_group.setdefault((g.n, g.k), []).append(req)
        for (n, k), reqs in by_group.items():
            stacked = torch.stack(
                [torch.as_tensor(chunks[i], dtype=torch.uint8) for i in reqs]
            )
            decoded = decode_batch(
                stacked, [patterns[i] for i in reqs], n, k, backend=backend
            )
            for row, req in enumerate(reqs):
                out[req] = decoded[row]
        return out  # type: ignore[return-value]


def host_loop_decode(
    chunks: Sequence[np.ndarray],
    patterns: Sequence[Sequence[int]],
    n: int,
    k: int,
) -> list[np.ndarray]:
    """The seed-state baseline: per-request decode with per-call
    Gauss–Jordan inversion (no cache, no batching), on the host. Kept as the
    baseline the batched path is measured against; NOT a production path."""
    out = []
    for c, ids in zip(chunks, patterns):
        g = rs.generator_matrix(n, k)[list(ids)]
        dec = rs.gf_invert_matrix(g)  # deliberately uncached
        out.append(gf_matmul_ref(torch.from_numpy(dec), torch.as_tensor(c)).numpy())
    return out
