"""The mesh of processes that shard training, and the sequence ring.

Counterpart of ``phantom_vlb_tpu/core/mesh.py`` (:37-111): :class:`MeshConfig`
with the same axes (``data``, ``fsdp``, ``tensor``, ``sequence``), the same
``sizes`` and the same errors; :class:`MeshEnv` with ``n_devices``,
``batch_divisor``, each rank's coordinates and its rows of a global batch;
:func:`build_mesh` on ``init_device_mesh``. A device of the mesh is a
process (one card each, ``core/distributed.py``), so ``-1`` absorbs the
world size. Ranks lie on the mesh in row-major order over (``data``,
``fsdp``, ``tensor``), as ``init_device_mesh`` lays them. The batch is
split over (``data``, ``fsdp``): the ranks of batch coordinate b take the
b-th block of rows (:meth:`MeshEnv.local_rows`, the one place that rule is
written; the loader and the dropout masks read it), so the ``tensor`` ranks
of one coordinate hold the same rows and draw the same masks. ``data`` > 1
is HSDP, a 2-D mesh handed to ``fully_shard``; ``tensor`` > 1 splits the
decoder's projections over the ``tensor`` ranks (``parallel/sharding.py``,
``parallel/tensor.py``). ``sequence`` > 1 across processes is not ported
(ROADMAP Queue 1).

Reductions follow the axes: :meth:`MeshEnv.all_sum` (the loss, the
metrics) and :meth:`MeshEnv.all_gather` (the Pearson states) run over the
batch axes alone, since the ``tensor`` ranks of a coordinate hold the same
values; :meth:`MeshEnv.shard_sum` (the gradient norm's squares) over
``fsdp``, and also over ``tensor`` for tensors split along it.

The ``sequence`` axis within one process is :class:`SequenceRing`, the
ranks that context-parallel attention splits S over (the counterpart of
``set_sequence_mesh`` / ``get_sequence_mesh``,
``phantom_vlb_tpu/ops/context_parallel.py:41-51``). Rank i holds the i-th
contiguous chunk of the sequence and sends to rank i + 1 (mod n).

A ring rank is a device, and entries may repeat: n ranks on one card are n
chunks with their own landing slots and streams, moved between by real
asynchronous copies, so the ring's kernels, transport and synchronisation
run on one card as they would over n. Ranks on distinct cards copy into
each other's memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist

from phantom_vlb_tpu_torch.core.distributed import MULTI_CARD_OPT_IN

__all__ = ["MeshConfig", "MeshEnv", "build_mesh", "AXIS_NAMES", "BATCH_AXES",
           "SequenceRing", "set_sequence_ring", "get_sequence_ring"]

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQUENCE_AXIS = "sequence"
AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQUENCE_AXIS)
# Axes over which a batch is split.
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)
_NOT_PORTED = ("the {axis} axis across processes is not ported (ROADMAP Queue 1: the multi-process "
               "ring waits); set mesh.{axis}=1")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh shape; ``-1`` on one axis absorbs the remaining devices."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    sequence: int = 1

    def sizes(self, n_devices: int) -> tuple[int, int, int, int]:
        sizes = [self.data, self.fsdp, self.tensor, self.sequence]
        n_auto = sum(1 for s in sizes if s == -1)
        if n_auto > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes if s != -1)
        if n_auto == 1:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes = [n_devices // fixed if s == -1 else s for s in sizes]
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return tuple(sizes)  # type: ignore[return-value]

    @staticmethod
    def from_config(node) -> "MeshConfig":
        """The ``mesh`` node of a run's config (absent axes at their defaults)."""
        node = node or {}
        return MeshConfig(**{f.name: int(node.get(f.name, f.default)) for f in dataclasses.fields(MeshConfig)})


@dataclasses.dataclass
class MeshEnv:
    """A built mesh: its axis sizes, this process's rank, the ``DeviceMesh``
    over the batch axes that ``fully_shard`` takes (None in a process
    outside any group, which shards nothing), and with ``tensor`` > 1 this
    rank's process groups along ``tensor`` and along the batch axes."""

    shape: dict[str, int]
    rank: int = 0
    device_mesh: object | None = None
    tensor_group: object | None = None
    batch_group: object | None = None

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape.values())

    @property
    def batch_divisor(self) -> int:
        return math.prod(self.shape.get(a, 1) for a in BATCH_AXES)

    @property
    def sharded(self) -> bool:
        return self.device_mesh is not None

    @property
    def is_writer(self) -> bool:
        """The process that writes files and logs (rank 0)."""
        return self.rank == 0

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along each axis (row-major over the axes)."""
        out, rest = {}, self.rank
        for axis in reversed(AXIS_NAMES):
            size = self.shape.get(axis, 1)
            out[axis] = rest % size
            rest //= size
        return {a: out[a] for a in AXIS_NAMES}

    @property
    def batch_rank(self) -> int:
        """This rank's coordinate over the batch axes (data-major): which
        block of a global batch it holds."""
        c = self.coords
        return c[DATA_AXIS] * self.shape.get(FSDP_AXIS, 1) + c[FSDP_AXIS]

    @property
    def tensor_size(self) -> int:
        return self.shape.get(TENSOR_AXIS, 1)

    def local_rows(self, global_rows: int) -> slice:
        """This rank's rows of a global batch of ``global_rows`` (those of
        its batch coordinate); raises when the batch axes do not divide it
        (as ``jax.device_put`` does)."""
        if global_rows % self.batch_divisor:
            raise ValueError(f"a global batch of {global_rows} rows does not split over the mesh's "
                             f"batch axes of {self.batch_divisor} devices")
        n = global_rows // self.batch_divisor
        return slice(self.batch_rank * n, (self.batch_rank + 1) * n)

    def rows(self, local_rows: int) -> tuple[int, int]:
        """(first global row, global rows) of a batch whose rank-local part
        has ``local_rows`` rows: what dropout masks are drawn over."""
        global_rows = local_rows * self.batch_divisor
        return self.local_rows(global_rows).start, global_rows

    def _batch_group(self):
        """The group over the batch axes (the world's when ``tensor`` is 1)."""
        return self.batch_group if self.tensor_size > 1 else None

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks of the batch axes (itself alone
        when unsharded); a new tensor."""
        t = t.clone()
        if self.sharded and (self.tensor_size == 1 or self.batch_divisor > 1):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._batch_group())
        return t

    def shard_sum(self, t: torch.Tensor, over_tensor: bool = False) -> torch.Tensor:
        """``t`` summed over the ``fsdp`` axis, the parameters' shards (their
        ``data`` replicas hold the same values); with ``over_tensor`` over
        the ``tensor`` axis too (the shards of a tensor split along it)."""
        t = t.clone()
        if not self.sharded:
            return t
        if self.tensor_size == 1:
            group = (self.device_mesh.get_group(FSDP_AXIS) if self.shape[DATA_AXIS] > 1
                     else self.device_mesh.get_group())
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            return t
        if self.shape[FSDP_AXIS] > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.device_mesh.get_group(FSDP_AXIS))
        if over_tensor:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.tensor_group)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every batch coordinate's ``t`` (same shape on all), in order."""
        if not self.sharded or (self.tensor_size > 1 and self.batch_divisor == 1):
            return [t]
        out = [torch.empty_like(t) for _ in range(self.batch_divisor)]
        dist.all_gather(out, t.contiguous(), group=self._batch_group())
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A global batch from each rank's rows of it: every batch
        coordinate's ``t`` (its :meth:`local_rows`, the same count on all)
        concatenated in order along dim 0, on every rank. 16-bit floats
        travel as f32, which holds them exactly (gloo takes f32 everywhere)."""
        parts = self.all_gather(t.float() if t.dtype in (torch.float16, torch.bfloat16) else t)
        return torch.cat(parts).to(t.dtype) if len(parts) > 1 else t


def build_mesh(config: MeshConfig | None = None, device: str | torch.device = "cuda") -> MeshEnv:
    """The mesh over this process group's ranks (one device each), or a
    one-device mesh that shards nothing when the process is in no group.
    ``device`` names the devices' type (``cuda`` or ``cpu``)."""
    config = config or MeshConfig()
    if not dist.is_initialized():
        try:
            return MeshEnv(dict(zip(AXIS_NAMES, config.sizes(1))))
        except ValueError as e:
            n = math.prod(max(s, 1) for s in dataclasses.astuple(config))
            raise ValueError(f"{e}: a process is one device; launch one process per device, e.g. "
                             f"torchrun --nproc_per_node={n} -m phantom_vlb_tpu_torch.cli.train ... (over "
                             f"cards, with {MULTI_CARD_OPT_IN}=1: ROADMAP Queue 1 #4)") from e
    world = dist.get_world_size()
    shape = dict(zip(AXIS_NAMES, config.sizes(world)))
    if shape[SEQUENCE_AXIS] > 1:
        raise NotImplementedError(_NOT_PORTED.format(axis=SEQUENCE_AXIS))
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(device).type
    rank = dist.get_rank()
    tensor = shape[TENSOR_AXIS]
    if tensor > 1:
        # The batch axes' mesh is a slice of the whole (data, fsdp, tensor)
        # mesh, as FSDP2 wants; the group along the batch axes is made here
        # (every rank makes every group, in the same order).
        root = init_device_mesh(device_type, (shape[DATA_AXIS], shape[FSDP_AXIS], tensor),
                                mesh_dim_names=(DATA_AXIS, FSDP_AXIS, TENSOR_AXIS))
        mesh = root[DATA_AXIS, FSDP_AXIS] if shape[DATA_AXIS] > 1 else root[FSDP_AXIS]
        batch_group = None
        for t in range(tensor):
            group = dist.new_group(list(range(t, world, tensor)))
            if rank % tensor == t:
                batch_group = group
        return MeshEnv(shape, rank, mesh, root.get_group(TENSOR_AXIS), batch_group)
    if shape[DATA_AXIS] > 1:
        mesh = init_device_mesh(device_type, (shape[DATA_AXIS], shape[FSDP_AXIS]),
                                mesh_dim_names=(DATA_AXIS, FSDP_AXIS))
    else:
        mesh = init_device_mesh(device_type, (shape[FSDP_AXIS],), mesh_dim_names=(FSDP_AXIS,))
    return MeshEnv(shape, rank, mesh)


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
