"""The sequence ring: the ranks that context-parallel attention splits S over.

Counterpart of the ``sequence`` axis of ``phantom_vlb_tpu/core/mesh.py``
(:30-34) and of ``set_sequence_mesh`` / ``get_sequence_mesh``
(``phantom_vlb_tpu/ops/context_parallel.py:41-51``). Rank i holds the i-th
contiguous chunk of the sequence and sends to rank i + 1 (mod n).

A rank is a device, and entries may repeat: n ranks on one card are n
chunks with their own landing slots and streams, moved between by real
asynchronous copies, so the ring's kernels, transport and synchronisation
run on one card as they would over n. Ranks on distinct cards copy into
each other's memory.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["SequenceRing", "set_sequence_ring", "get_sequence_ring"]


class SequenceRing:
    """``devices[i]`` is rank i's device; n = ``len(devices)``.

    Each rank on a card has a compute stream and a copy stream, and a
    persistent int32 word per landing slot (its ready flag), made at first
    use. ``next_epoch()`` numbers the ring passes: a pass marks a slot ready
    by writing its epoch into the flag, never by resetting it, so a pass
    never reads an earlier pass's flag as ready.
    """

    def __init__(self, devices: Sequence[str | torch.device]):
        if not devices:
            raise ValueError("a sequence ring needs at least one rank")
        self.devices = [torch.device(d) for d in devices]
        for i, d in enumerate(self.devices):
            if d.type == "cuda" and d.index is None:
                self.devices[i] = torch.device("cuda", torch.cuda.current_device())
        self._streams: dict[int, tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}
        self._flags: dict[int, torch.Tensor] = {}
        self._epoch = 0

    @property
    def n(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"SequenceRing({[str(d) for d in self.devices]})"

    def streams(self, rank: int) -> tuple[torch.cuda.Stream, torch.cuda.Stream]:
        """(compute, copy) streams of a rank on a card."""
        if rank not in self._streams:
            dev = self.devices[rank]
            self._streams[rank] = (torch.cuda.Stream(device=dev), torch.cuda.Stream(device=dev))
        return self._streams[rank]

    def flags(self, rank: int) -> torch.Tensor:
        """Rank's (max(n - 1, 1),) int32 ready flags, on its card."""
        if rank not in self._flags:
            self._flags[rank] = torch.zeros(max(self.n - 1, 1), dtype=torch.int32,
                                            device=self.devices[rank])
        return self._flags[rank]

    def next_epoch(self) -> int:
        self._epoch += 1
        if self._epoch >= 2**31:
            raise RuntimeError("ring epoch counter exhausted")
        return self._epoch


_SEQUENCE_RING: SequenceRing | None = None


def set_sequence_ring(ring: SequenceRing | None) -> None:
    """Process-level default ring that model code with a ring
    ``attention_impl`` reads (modules carry no ring in their config)."""
    global _SEQUENCE_RING
    _SEQUENCE_RING = ring


def get_sequence_ring() -> SequenceRing:
    if _SEQUENCE_RING is None:
        raise RuntimeError("a ring attention_impl needs set_sequence_ring(ring) first")
    return _SEQUENCE_RING
