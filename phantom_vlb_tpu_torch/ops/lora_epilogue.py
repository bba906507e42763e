"""Fused LoRA rank-r epilogue ``y + scaling * (z @ B)``, with its backward.

Counterpart of ``phantom_vlb_tpu/ops/lora_epilogue.py`` (``lora_epilogue``
:96, ``_fwd_kernel`` :45, ``_dz_kernel`` :51, ``_db_kernel`` :69)::

    out  = y + s * (z @ B)        bf16(acc), bf16(. * s), bf16(y + .)
    d(y) = dy                     passed through
    dz   = s * dy @ B^T           f32 sums, one rounding
    dB   = s * z^T @ dy           f32 sums, one rounding

y, dy (..., N); z (..., r); B (r, N), r <= 128. The forward's scaling is
rounded to y's dtype first, as the reference multiplies a bf16 product by
a weakly typed float; the backward's multiplies f32 sums.

On CUDA tensors the kernels of ``csrc/lora_epilogue.cu`` run (bf16,
contiguous, r <= 128; anything else raises): the forward, and one backward
kernel that reads dy once for dz and dB (``lora_epilogue_dzdb``) or is
built with one of the two left out (``lora_epilogue_dz``,
``lora_epilogue_db``).

The forward replaces ``phantom_vlb_tpu/ops/lora_epilogue.py:45``
(``_fwd_kernel``). It is bound by bytes (y read and out written once, z and
B read once): 7.6, 30.1 and 105.4 us at M = 6144, r = 16 and N = 1024, 4096,
14336 on an H100's 3.35 TB/s. So it streams y: persistent blocks, at most
one wave (``_fwd_grid``), each own a column strip and a row group of y's
64 x 64 tiles; a block keeps its strip of B resident in shared memory,
loads y and z through a TMA ring (y evict-first from L2), multiplies z B on
the tensor cores (``mma.sync``, f32 sums), rounds as the reference does and
writes out by asynchronous TMA stores, so that a tile's store overlaps the
next tile's loads. ``backward="xla"`` (the
LoRA flag value ``'fwd'``) keeps the kernel forward and computes dz and dB
with ``torch.addmm`` (the scaling applied to the f32 sums before the one
rounding), as the JAX package leaves them to XLA. On CPU tensors every
part runs its plain version. ``out`` is a new tensor: nothing of the
forward needs y's storage back, and at 80 GB the alias the TPU needs
(:142-146) buys nothing worth an in-place write into an autograd input.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from phantom_vlb_tpu_torch.core.remat import OPAQUE, named
from phantom_vlb_tpu_torch.ops._build import CudaKernel

__all__ = [
    "lora_epilogue", "lora_epilogue_plain", "lora_epilogue_dz_plain", "lora_epilogue_db_plain",
    "lora_epilogue_dzdb_plain", "lora_epilogue_fwd", "lora_epilogue_dz", "lora_epilogue_db",
    "lora_epilogue_dzdb", "EPI_FWD", "EPI_DZ", "EPI_DB", "EPI_DZDB", "MAX_RANK",
]

MAX_RANK = 128
CHUNK = 64            # the kernels' tile edge
# Column chunks a block of the backward kernel may own, by padded rank: its
# dB^T sums stay in registers (CHUNKS_PER_BLOCK * R / 2 a thread).
CHUNKS_PER_BLOCK = {16: 16, 32: 8, 64: 2, 128: 1}
# Column chunks a block of the forward kernel may own, by padded rank: its
# strip of B in shared memory, at most 64 KB (rp * 128 bytes a chunk).
FWD_CHUNKS_PER_BLOCK = {16: 32, 32: 16, 64: 8, 128: 4}
# The grids' cost model (an estimate of a kernel's time, used only to rank
# grids): an H100's HBM rate, the blocks that saturate it, and a 64 x 64
# tile's bytes.
HBM_BYTES_PER_S, SATURATING_BLOCKS, TILE_BYTES = 3.35e12, 100, 8192
# The forward kernel's shared memory (csrc/lora_epilogue.cu FwdSmem): rings
# of STAGES y tiles and of z chunks (Z_STAGES by padded rank), 8 bytes of
# mbarrier each (full and empty) and one for B, then the B strip from a
# 1024-byte boundary, and 1024 bytes of alignment slack.
STAGES = 8
Z_STAGES = {16: 8, 32: 8, 64: 8, 128: 4}

_SRC = "lora_epilogue.cu"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# y, z, B, out | M, N, r, R, mb, nb | s, stream
EPI_FWD = CudaKernel(_SRC, "epi_fwd_launch", [_PTR] * 4 + [_INT] * 6 + [ctypes.c_float, _PTR])
# dy, B, partials, counters, dz | M, N, r, R, mb, nb | s, stream
EPI_DZ = CudaKernel(_SRC, "epi_dz_launch", [_PTR] * 5 + [_INT] * 6 + [ctypes.c_float, _PTR])
# z, dy, partials, counters, dB | M, N, r, R, mb, nb | s, stream
EPI_DB = CudaKernel(_SRC, "epi_db_launch", [_PTR] * 5 + [_INT] * 6 + [ctypes.c_float, _PTR])
# dy, z, B, partials, counters, dz, dB | M, N, r, R, mb, nb | s, stream
EPI_DZDB = CudaKernel(_SRC, "epi_dzdb_launch", [_PTR] * 7 + [_INT] * 6 + [ctypes.c_float, _PTR])


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def lora_epilogue_plain(y, z, b, scaling: float) -> torch.Tensor:
    """Plain forward on 2-D (M, N), (M, r), (r, N): f32 sums, the reference's roundings."""
    acc = (z.float() @ b.float()).to(y.dtype)
    return y + acc * _in_dtype(scaling, y.dtype)


def lora_epilogue_dz_plain(dy, b, scaling: float) -> torch.Tensor:
    """Plain dz (M, r) in dy's dtype."""
    return (scaling * (dy.float() @ b.float().t())).to(dy.dtype)


def lora_epilogue_db_plain(z, dy, scaling: float) -> torch.Tensor:
    """Plain dB (r, N) in dy's dtype."""
    return (scaling * (z.float().t() @ dy.float())).to(dy.dtype)


def lora_epilogue_dzdb_plain(z, dy, b, scaling: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain (dz, dB): the two plain versions above."""
    return lora_epilogue_dz_plain(dy, b, scaling), lora_epilogue_db_plain(z, dy, scaling)


def _check_cuda(**tensors) -> None:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on {dev}; "
                             f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")


def _check_shapes(m, n, r, z_shape, b_shape) -> None:
    if tuple(z_shape) != (m, r) or tuple(b_shape) != (r, n):
        raise ValueError(f"want z ({m}, r) and B (r, {n}); got {tuple(z_shape)}, {tuple(b_shape)}")
    if not 0 < r <= MAX_RANK:
        raise ValueError(f"the epilogue kernels take a rank of 1 to {MAX_RANK}; got {r}")
    if m >= 2**31 or n >= 2**31:
        raise ValueError(f"the epilogue kernels take fewer than 2^31 rows and columns; got ({m}, {n})")


def _padded_rank(r: int) -> int:
    return next(p for p in (16, 32, 64, 128) if r <= p)


@functools.lru_cache(maxsize=None)
def _grid(m: int, n: int, rp: int, dz: bool, db: bool, sms: int) -> tuple[int, int]:
    """(mb, nb): the backward kernel's row groups x column groups of 64-row x
    64-column dy tiles. A block owns one group pair and at most
    ``CHUNKS_PER_BLOCK[rp]`` column chunks; the grid stays within one wave
    of ``sms`` blocks (unless N alone needs more). Among those, the grid of
    least estimated time: the slowest block's tiles (and z chunks) at the
    HBM rate shared by the blocks, and the f32 partials (4 rp (M nb + N mb)
    bytes for the outputs the grid computes), written once and read back
    once."""
    rc, cc = -(-m // CHUNK), -(-n // CHUNK)
    nb_min = -(-cc // CHUNKS_PER_BLOCK[rp])
    best = None
    for nb in range(nb_min, cc + 1):
        if nb > sms and nb > nb_min:
            break
        for mb in range(1, max(1, min(rc, sms // nb)) + 1):
            rows, cols = -(-rc // mb), -(-cc // nb)
            # a block's dy tiles, and a z chunk (rp / 64 of a tile) per row chunk for dB
            tiles = rows * cols + db * rows * rp / 64
            stream = tiles * TILE_BYTES * max(mb * nb, SATURATING_BLOCKS) / HBM_BYTES_PER_S
            part = 4 * rp * (dz * m * nb + db * cc * CHUNK * mb)
            cost = stream + 2 * part / HBM_BYTES_PER_S
            if best is None or cost < best[0]:
                best = (cost, mb, nb)
    return best[1], best[2]


def fwd_smem_bytes(rp: int, cols: int) -> int:
    """Shared memory of a forward block that owns ``cols`` column chunks at
    padded rank ``rp``."""
    rings = STAGES * TILE_BYTES + Z_STAGES[rp] * CHUNK * rp * 2
    bars = 8 * (2 * STAGES + 2 * Z_STAGES[rp] + 1)
    return -(-(rings + bars) // 1024) * 1024 + cols * rp * 128 + 1024


@functools.lru_cache(maxsize=None)
def _fwd_grid(m: int, n: int, rp: int, sms: int) -> tuple[int, int]:
    """(mb, nb): the forward kernel's row groups x column groups of y's
    64 x 64 tiles. A block owns one group pair, keeps its strip of B (at
    most ``FWD_CHUNKS_PER_BLOCK[rp]`` column chunks) and walks its rows; the
    grid stays within one wave of ``sms`` blocks (unless N alone needs
    more). Among those, the grid of least estimated time: the slowest
    block's bytes (its y tiles in and out, a z chunk a row chunk and its B
    strip) at the HBM rate shared by the blocks."""
    rc, cc = -(-m // CHUNK), -(-n // CHUNK)
    nb_min = -(-cc // FWD_CHUNKS_PER_BLOCK[rp])
    best = None
    for nb in range(nb_min, cc + 1):
        if nb > sms and nb > nb_min:
            break
        for mb in range(1, max(1, min(rc, sms // nb)) + 1):
            rows, cols = -(-rc // mb), -(-cc // nb)
            block = 2 * rows * cols * TILE_BYTES + (rows + cols) * rp * 128
            cost = block * max(mb * nb, SATURATING_BLOCKS) / HBM_BYTES_PER_S
            if best is None or cost < best[0]:
                best = (cost, mb, nb)
    return best[1], best[2]


def partial_bytes(m: int, n: int, r: int, dz: bool = True, db: bool = True, sms: int = 132) -> int:
    """Bytes of f32 partial sums the backward kernel writes (and its fold
    reads back) at (M, N, r) on a card of ``sms`` SMs."""
    rp = _padded_rank(r)
    mb, nb = _grid(m, n, rp, dz, db, sms)
    return 4 * rp * (dz * m * nb + db * -(-n // CHUNK) * CHUNK * mb)


_SMS: dict = {}
# The backward kernel's grid barrier (arrivals, generation) and arrival
# counters of its row and column groups, one int32 buffer per (device,
# stream): zeroed once, and every launch leaves the counts at zero again
# (the barrier's last arrival and each group's last block reset their own).
_COUNTERS: dict = {}


def _sm_count(dev) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev.index]


def _counters(dev, stream: int, count: int) -> torch.Tensor:
    buf = _COUNTERS.get((dev.index, stream))
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[(dev.index, stream)] = buf
    return buf


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def lora_epilogue_fwd(y, z, b, scaling: float) -> torch.Tensor:
    """``y + s * (z @ b)`` on 2-D tensors: the kernel on CUDA, the plain version on the CPU."""
    m, n = y.shape
    r = z.shape[1]
    if y.device.type == "cpu":
        return lora_epilogue_plain(y, z, b, scaling)
    _check_cuda(y=y, z=z, b=b)
    _check_shapes(m, n, r, z.shape, b.shape)
    rp = _padded_rank(r)
    mb, nb = _fwd_grid(m, n, rp, _sm_count(y.device))
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        EPI_FWD.launch(y.data_ptr(), z.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, r, rp, mb, nb,
                       _in_dtype(scaling, y.dtype), _stream(y))
    return out


def _dzdb_launch(kernel: CudaKernel, z, dy, b, scaling: float, want_dz: bool, want_db: bool):
    """One launch of the backward kernel (or a build of it: a cost probe)
    for dz, dB or both; returns (dz or None, dB or None)."""
    m, n = dy.shape
    r = (b if want_dz else z).shape[0 if want_dz else 1]
    tensors = {"dy": dy, **({"b": b} if want_dz else {}), **({"z": z} if want_db else {})}
    _check_cuda(**tensors)
    _check_shapes(m, n, r, z.shape if want_db else (m, r), b.shape if want_dz else (r, n))
    rp = _padded_rank(r)
    mb, nb = _grid(m, n, rp, want_dz, want_db, _sm_count(dy.device))
    cols = -(-n // CHUNK) * CHUNK
    part = torch.empty(rp * (want_dz * m * nb + want_db * cols * mb), dtype=torch.float32,
                       device=dy.device)
    dz = torch.empty((m, r), dtype=dy.dtype, device=dy.device) if want_dz else None
    db = torch.empty((r, n), dtype=dy.dtype, device=dy.device) if want_db else None
    stream = _stream(dy)
    counters = _counters(dy.device, stream, 2 + mb + nb)
    sizes = (m, n, r, rp, mb, nb, float(scaling), stream)
    with torch.cuda.device(dy.device):
        if want_dz and want_db:
            kernel.launch(dy.data_ptr(), z.data_ptr(), b.data_ptr(), part.data_ptr(),
                          counters.data_ptr(), dz.data_ptr(), db.data_ptr(), *sizes)
        elif want_dz:
            kernel.launch(dy.data_ptr(), b.data_ptr(), part.data_ptr(), counters.data_ptr(),
                          dz.data_ptr(), *sizes)
        else:
            kernel.launch(z.data_ptr(), dy.data_ptr(), part.data_ptr(), counters.data_ptr(),
                          db.data_ptr(), *sizes)
    return dz, db


def lora_epilogue_dz(dy, b, scaling: float) -> torch.Tensor:
    """``s * dy @ b^T`` (M, r) on 2-D tensors: the kernel on CUDA, plain on the CPU."""
    if dy.device.type == "cpu":
        return lora_epilogue_dz_plain(dy, b, scaling)
    return _dzdb_launch(EPI_DZ, None, dy, b, scaling, True, False)[0]


def lora_epilogue_db(z, dy, scaling: float) -> torch.Tensor:
    """``s * z^T @ dy`` (r, N) on 2-D tensors: the kernel on CUDA, plain on the CPU."""
    if dy.device.type == "cpu":
        return lora_epilogue_db_plain(z, dy, scaling)
    return _dzdb_launch(EPI_DB, z, dy, None, scaling, False, True)[1]


def lora_epilogue_dzdb(z, dy, b, scaling: float, *, kernel: CudaKernel = EPI_DZDB):
    """``(s * dy @ b^T, s * z^T @ dy)`` on 2-D tensors from one pass over dy:
    the kernel on CUDA (``kernel``: another build of its launcher, such as a
    cost probe), plain on the CPU."""
    if dy.device.type == "cpu":
        return lora_epilogue_dzdb_plain(z, dy, b, scaling)
    return _dzdb_launch(kernel, z, dy, b, scaling, True, True)


def _addmm_scaled(a, b, scaling: float) -> torch.Tensor:
    """``scaling * (a @ b)`` by one library call: the scale applied to the
    f32 sums before the one rounding (``beta=0`` ignores the output's old
    contents)."""
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    return out.addmm_(a, b, beta=0, alpha=scaling)


class _Residuals(torch.autograd.Function):
    """z passed through (a view), with z and B saved for the epilogue's
    backward: :class:`_LoRAEpilogue` reads them from this node, so they are
    saved before y is made (see :func:`lora_epilogue`)."""

    @staticmethod
    def forward(ctx, z, b):
        ctx.save_for_backward(z, b)
        return z.view_as(z)

    @staticmethod
    def backward(ctx, dz):
        return dz, None


class _LoRAEpilogue(torch.autograd.Function):
    """The kernel forward; z is :class:`_Residuals`' output, whose node
    holds the saved z and B, so this Function saves nothing."""

    @staticmethod
    def forward(ctx, y, z, b, scaling, backward):
        ctx.residuals = z.grad_fn
        ctx.scaling, ctx.backward = scaling, backward
        # A kernel, not a product: on the CPU, 'dots' does not keep its
        # plain version's product either (core/remat.py).
        with named(OPAQUE):
            return lora_epilogue_fwd(y, z, b, scaling)

    @staticmethod
    def backward(ctx, dy):
        # z's gradient is wanted where the z given to lora_epilogue needs
        # one, not where B alone makes the pass-through need one.
        want_dz = ctx.needs_input_grad[1] and ctx.residuals.needs_input_grad[0]
        want_db = ctx.needs_input_grad[2]
        dy = dy.contiguous()
        dz = db = None
        if want_dz or want_db:
            z, b = ctx.residuals.saved_tensors
        if ctx.backward == "xla":
            if want_dz:
                dz = _addmm_scaled(dy, b.t(), ctx.scaling)
            if want_db:
                db = _addmm_scaled(z.t(), dy, ctx.scaling)
        elif want_dz and want_db:
            dz, db = lora_epilogue_dzdb(z, dy, b, ctx.scaling)
        elif want_dz:
            dz = lora_epilogue_dz(dy, b, ctx.scaling)
        elif want_db:
            db = lora_epilogue_db(z, dy, ctx.scaling)
        return (dy if ctx.needs_input_grad[0] else None), dz, db, None, None


def lora_epilogue(y, z: torch.Tensor, b: torch.Tensor, scaling: float, *,
                  backward: str = "pallas") -> torch.Tensor:
    """``y + scaling * (z @ b)``, differentiable in y, z and b.

    y (..., N), or a function of no arguments that returns it; z (..., r),
    b (r, N). ``backward``: ``"pallas"`` runs the backward kernel (one pass
    over dy for both grads, or the entry point of the one grad needed),
    ``"xla"`` the library products (the forward is the kernel either way).

    z and b are saved for the backward before y is made, where y is given
    as a function: a checkpointed layer's replay stops at the last tensor
    the layer saved, so for the layer's last projection it then runs
    neither the product that makes y nor the kernel forward, whose output
    only the layer's output needs (XLA's replay drops both: the reference
    keeps only (z, B) as residuals, ``lora_epilogue.py:153-154``).
    """
    if backward not in ("pallas", "xla"):
        raise ValueError(f"backward must be 'pallas' or 'xla', not {backward!r}")
    r = b.shape[0]
    z = _Residuals.apply(z.reshape(-1, r), b)
    y = y() if callable(y) else y
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no epilogue kernel for device {y.device}")
    lead, n = y.shape[:-1], y.shape[-1]
    out = _LoRAEpilogue.apply(y.reshape(-1, n), z, b, float(scaling), backward)
    return out.reshape(*lead, n)
