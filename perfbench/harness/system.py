"""The system under test: the program's entries that a cell's window drives.

The drivers call the program only through a :class:`System`, so a check of
the check can put the reference's control, or a deliberately broken entry,
in the program's place (each driver's `control()` and `fault(name)`) and
see `correct` come out false.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.storage.codec import encode_batch
from repro_torch.storage.simulator import dispatch_masks, simulate_fleet


def decode_requests(plan, file_ids, patterns, chunks):
    return plan.decode_requests(file_ids, patterns, chunks)


@dataclasses.dataclass(frozen=True)
class System:
    # (u, prio, pi, file_id, avail) -> (masks, degraded): storage/simulator.py
    dispatch: Callable = dispatch_masks
    # (plan, file_ids, patterns, chunks) -> decoded rows: storage/codec.py
    decode: Callable = decode_requests
    # (data (B, k, L), n) -> (B, n, L): storage/codec.py
    encode: Callable = encode_batch
    # simulate_fleet's signature: storage/simulator.py
    simulate: Callable = simulate_fleet


# the faults each driver plants in its own entry (`fault(name)`): a step that
# returns its input (or its last result) unchanged, half of the batch left
# out, one answer altered where it is produced; one chip has no exchange
# between chips to leave out
FAULTS = ("unchanged", "half_batch", "altered")
