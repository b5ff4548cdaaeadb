"""FCFS queue scan for the fleet simulator: a CUDA kernel and its plain twin.

Every simulator path reduces to one sequential recurrence over the merged
arrival stream (see `storage/simulator.py`):

    start_j  = max(t_req, dep_j)          (FCFS, work-conserving)
    finish_j = start_j + service_j
    dep_j   <- finish_j   where node j served this request
    latency  = max_{j in service set} finish_j - t_req
    busy_j  += service_j  where node j served this request

It is sequential in the request axis and parallel in the seed axis.

* :func:`fcfs_scan_cuda` launches the hand-written Hopper kernel in
  ``csrc/fcfs_queue.cu`` (one warp per seed, carries in registers). It
  replaces the Pallas TPU kernel ``repro/kernels/fcfs_queue.py::
  fcfs_scan_pallas``. The library is built with ``nvcc`` for ``sm_90a``
  into ``build/repro_torch/`` at first use, keyed by a hash of the source,
  and loaded with ``ctypes``.
* :func:`fcfs_scan_plain` is the same recurrence as a loop over requests
  of (S, m) tensor ops, in the op order of the reference's ``_step``; the
  kernel is held to it bitwise.
* :func:`fcfs_scan` dispatches on where the tensors live: CUDA tensors go
  to the kernel, CPU tensors to the plain twin. There is no fallback from
  one to the other.

A request whose service set is empty (all-false mask row) gets latency
``-inf``; ``busy`` accrues in the carry rather than per step.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch import Tensor

from ._build import build_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "fcfs_queue.cu"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    lib = build_library(SOURCE)
    lib.fcfs_scan_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.fcfs_scan_launch.restype = ctypes.c_int
    return lib


def fcfs_scan_plain(
    t: Tensor, masks: Tensor, service: Tensor, dep0: Tensor, busy0: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """The recurrence as a loop over requests; leading axes are batch axes.

    Shapes: ``t`` (..., N), ``masks``/``service`` (..., N, m), carries
    (..., m). The op sequence is the reference's ``_step`` verbatim, so
    both agree bit for bit.
    """
    masks = masks.bool()
    dep, busy = dep0, busy0
    lat = []
    for i in range(t.shape[-1]):
        tt, mask, srv = t[..., i], masks[..., i, :], service[..., i, :]
        start = torch.maximum(tt[..., None], dep)
        finish = start + srv
        dep = torch.where(mask, finish, dep)
        lat.append(torch.where(mask, finish, -torch.inf).amax(dim=-1) - tt)
        busy = busy + torch.where(mask, srv, 0.0)
    latency = torch.stack(lat, dim=-1) if lat else torch.empty_like(t)
    return latency, dep, busy


def fcfs_scan_cuda(
    t: Tensor, masks: Tensor, service: Tensor, dep0: Tensor, busy0: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """Launch the CUDA kernel on a seed batch; shapes as :func:`fcfs_scan`.

    Inputs must be contiguous float32 (``masks`` bool or uint8) on one CUDA
    device. Runs on the current stream and does not synchronise.
    """
    if t.dim() != 2:
        raise ValueError(f"t must be (S, N), got shape {tuple(t.shape)}")
    s, n = t.shape
    m = service.shape[-1]
    expect = {
        "t": (t, (s, n), (torch.float32,)),
        "masks": (masks, (s, n, m), (torch.bool, torch.uint8)),
        "service": (service, (s, n, m), (torch.float32,)),
        "dep0": (dep0, (s, m), (torch.float32,)),
        "busy0": (busy0, (s, m), (torch.float32,)),
    }
    for name, (x, shape, dtypes) in expect.items():
        if x.device != t.device or not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}, expected {t.device} (CUDA)")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype not in dtypes:
            raise ValueError(f"{name} has dtype {x.dtype}, expected one of {dtypes}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if masks.dtype == torch.bool:
        masks = masks.view(torch.uint8)
    lib = load_library()
    latency = torch.empty((s, n), dtype=torch.float32, device=t.device)
    dep = torch.empty((s, m), dtype=torch.float32, device=t.device)
    busy = torch.empty((s, m), dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fcfs_scan_launch(
            t.data_ptr(), masks.data_ptr(), service.data_ptr(),
            dep0.data_ptr(), busy0.data_ptr(),
            latency.data_ptr(), dep.data_ptr(), busy.data_ptr(),
            s, n, m, stream,
        )
    if err != 0:
        raise RuntimeError(f"fcfs_scan kernel launch failed: cudaError_t {err}")
    fcfs_scan.launches += 1
    return latency, dep, busy


def fcfs_scan(
    t: Tensor,
    masks: Tensor,
    service: Tensor,
    dep0: Tensor | None = None,
    busy0: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """FCFS queue scan, run where the tensors live.

    Accepts a single system (``t`` (N,), ``masks``/``service`` (N, m),
    carries (m,)) or a seed batch (a leading (S,) axis on everything), in
    any layout: a view is made contiguous before the launch.
    ``dep0``/``busy0`` default to idle queues and zero busy time. Returns
    ``(latency, dep, busy)`` with the same leading axes. CUDA tensors run
    the kernel (and add one to ``fcfs_scan.launches``); CPU tensors run
    :func:`fcfs_scan_plain`.
    """
    m = service.shape[-1]
    cshape = tuple(t.shape[:-1]) + (m,)
    if dep0 is None:
        dep0 = torch.zeros(cshape, dtype=torch.float32, device=t.device)
    if busy0 is None:
        busy0 = torch.zeros(cshape, dtype=torch.float32, device=t.device)
    if t.is_cuda:
        # the launcher takes contiguous tensors only; views are copied here
        t, masks, service, dep0, busy0 = (
            x.contiguous() for x in (t, masks, service, dep0, busy0)
        )
        if t.dim() == 1:
            lat, dep, busy = fcfs_scan_cuda(
                t[None], masks[None], service[None], dep0[None], busy0[None]
            )
            return lat[0], dep[0], busy[0]
        return fcfs_scan_cuda(t, masks, service, dep0, busy0)
    if t.device.type == "cpu":
        return fcfs_scan_plain(t, masks, service, dep0, busy0)
    raise ValueError(f"fcfs_scan runs on CUDA or CPU tensors, got {t.device}")


fcfs_scan.launches = 0
