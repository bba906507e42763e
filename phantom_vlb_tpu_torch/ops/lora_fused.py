"""Fused LoRA adapter-input dropout + rank-r matmul, with its backward.

Counterpart of ``phantom_vlb_tpu/ops/lora_fused.py`` (``fused_dropout_matmul``
:147, ``_fwd_kernel`` :62, ``_dx_kernel`` :92, ``_da_kernel`` :111)::

    mid = (mask * x / keep) @ A                          forward
    dx  = (dmid @ A^T) * mask / keep                     backward
    dA  = (mask * x / keep)^T @ dmid   (f32 sums)        backward

x is (M, K), A is (K, r). The mask is never stored: each kernel regenerates
it. Its rule is the reference's u8 threshold, keep iff byte >= thr with
``thr = round(p * 256)`` and ``keep = 1 - thr / 256``; ``thr == 0`` is a
plain product. Dtypes follow the reference: the forward and dA scale x by
``1/keep`` rounded to x's dtype (and round the product to it), dx scales the
f32 ``dmid @ A^T`` by the f32 ``1/keep``.

The bytes come from ``bits`` (an (M, K) uint8 tensor, the test mode) or from
a counter-based hash of (seed, row0 + row, (col0 + col) >> 2) alone: one
32-bit word masks 4 neighbouring elements, byte ``col & 3`` each, as the
reference's ``_keep_planes`` spreads one word over 4 elements. ``row0`` is
the global index of x's first row, so a rank that holds rows [row0, row0 +
M) of a batch split over ranks draws those rows of the one-card mask;
``col0`` (a multiple of 4) is the global index of x's first column, so a
rank of the tensor axis whose row-parallel projection reads columns [col0,
col0 + K) of the input draws those columns of it. A GPU cannot reproduce
the TPU's hardware stream, so the hash is this port's own; because it does
not depend on tile shapes, forward, dx and dA see the same mask by
construction, and :func:`hash_bytes` (torch int64, masked to 32 bits)
gives the kernels' bytes bit for bit.

The 32-bit rule (``dropout_bits=32``, the unfused route's Bernoulli mask,
``models/lora.py``) runs the same kernels in bits mode at ``thr = 1`` over
the 0/1 bytes of :func:`keep_bytes`, which are bit for bit ``torch.rand(shape,
generator=torch.Generator("cuda").manual_seed(seed)) < keep`` on the card:
one launch of the source's own Philox kernel, drawn again in a checkpoint's
replay rather than kept. Its scale is :func:`dropout_rule`'s: the f32
reciprocal of keep rounded to x's dtype, the number PyTorch's ``x /
bf16(keep)`` multiplies by on the card, applied in f32 and rounded to x's
dtype, so the dropped x is the eager route's bit for bit; dx scales its f32
sum by it and rounds once. :func:`keep_bytes_plain` is the draw in int64
torch ops.

On CUDA tensors the three kernels of ``csrc/lora_dropout.cu`` run; on CPU
tensors their plain versions. There is no fallback on the card. The
forward and dA are one launch each that writes the finished output: their
split of the reduction over the blocks of a thread-block cluster, folded
inside the launch in a fixed order, is chosen by :func:`_fwd_plan` and
:func:`_da_plan`. The forward is the dispatcher op
``vlb::lora_dropout_fwd``, so that a checkpoint policy can keep the mid it
makes (``core/remat.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from phantom_vlb_tpu_torch.ops._build import CudaKernel

__all__ = [
    "fused_dropout_matmul", "fused_dropout_matmul_plain", "fused_dropout_bwd_plain",
    "fused_dropout_bwd", "hash_bytes", "dropout_threshold", "dropout_rule", "keep_bytes", "keep_bytes_plain",
    "keep_draw_fits", "KEEP_MAX_NUMEL", "philox4x32_10", "LORA_FWD", "LORA_DX", "LORA_DA", "LORA_KEEP",
    "LORA_CLUSTER_CAPACITY", "smem_bytes", "plan_smem_bytes",
]

CHUNK = 64            # the kernels' tile edge: K must be a multiple of it
RANKS = (16, 32, 64, 128)
_GOLDEN, _M1, _M2 = 0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35
_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1
# Philox4x32-10's round constants (curand_philox4x32_x.h, Random123).
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
# PyTorch's draws on the card: blocks of 256 threads, at most maxThreadsPerSM
# / 256 blocks an SM (calc_execution_policy); an H100 SXM's 132 SMs of 2048
# threads are the plain version's default card.
KEEP_BLOCK = 256
H100_SMS, H100_THREADS_PER_SM = 132, 2048
# A draw whose f32 output passes 2^31 - 1 bytes PyTorch splits into several
# launches, each with its own offset: the kernel draws one, so it takes
# draws of at most this many elements (:func:`keep_draw_fits`).
KEEP_MAX_NUMEL = (2 ** 31 - 1) // 4

# The forward and dA kernels' block (csrc/lora_dropout.cu, mirrored here):
# ring stages of x tiles and consumer groups of four warps by rank, the
# shared memory a block may use, and the cluster sizes (at most 8, the
# portable size).
STAGES = {16: 12, 32: 8, 64: 6, 128: 2}
GROUPS = {16: 4, 32: 4, 64: 2, 128: 2}
SMEM_PER_BLOCK = 232448
CLUSTER_SIZES = (1, 2, 4, 8)
# Clusters of each size (one block an SM) an H100 SXM holds at once, as
# cudaOccupancyMaxActiveClusters reads them on an NVIDIA H100 80GB HBM3
# (chip_smoke.py phase 3 prints them): the plans' default card. On a card
# the plans take its own numbers (_cluster_capacity).
H100_CLUSTERS = (132, 66, 30, 15)
# The plans' costs, in tiles a block streams, read on the card (NVIDIA
# H100 80GB HBM3: grids timed against each other, and the no-mask cost
# probe): an output tile's fold and turn (partials summed, the cluster's
# barrier, the sums through distributed shared memory, the next tile's
# start) costs about 4 tiles in the forward and 10 in dA, and the card
# streams x as fast as about 96 blocks do (~2.4 TB/s against ~25 GB/s a
# block), so more blocks than that gain nothing.
FOLD_TILES = {False: 4, True: 10}          # the forward's, dA's
STREAM_BLOCKS = 96

_SRC = "lora_dropout.cu"
_REDUCE_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_uint32] + [ctypes.c_int] * 3
                + [ctypes.c_float, ctypes.c_void_p])
LORA_FWD = CudaKernel(_SRC, "lora_fwd_launch", _REDUCE_ARGS)
LORA_DX = CudaKernel(
    _SRC, "lora_dx_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_uint32] + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
)
LORA_DA = CudaKernel(_SRC, "lora_da_launch", _REDUCE_ARGS)
LORA_KEEP = CudaKernel(_SRC, "lora_keep_launch", [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32,
                                                  ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p])
# How many clusters of a size the card holds at once (a query, no launch).
LORA_CLUSTER_CAPACITY = CudaKernel(_SRC, "lora_cluster_capacity",
                                   [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])


def smem_bytes(r: int, p_slots: int, bits: bool) -> int:
    """Shared memory of a forward or dA block at rank ``r`` holding
    ``p_slots`` chunks of A or dmid (64 x r bf16 each), with the mask's u8
    tiles in bits mode (``layout_of`` in the source): x tiles, the chunks,
    the u8 tiles, each stage's 64 row keys, each group's f32 partial and
    three slots of the block's, the mbarriers and 1 KB of alignment slack."""
    nst = STAGES[r]
    return (nst * CHUNK * CHUNK * 2 + p_slots * CHUNK * r * 2 + (nst * CHUNK * CHUNK if bits else 0)
            + nst * CHUNK * 4 + (GROUPS[r] + 3) * CHUNK * (r + 4) * 4 + 8 * (2 * nst + 1) + 1024)


@functools.lru_cache(maxsize=None)
def _plan(n_out: int, n_red: int, r: int, bits: bool, caps: tuple, da: bool) -> tuple[int, int, bool]:
    """(cs, clusters, resident) for ``n_out`` output tiles and ``n_red``
    chunks of the reduced axis: a grid of ``clusters`` clusters of ``cs``
    blocks, cluster c walking output tiles c, c + clusters, ... and its
    block of rank q streaming chunks [n_red q / cs, n_red (q + 1) / cs) of
    each (every chunk owned once), within one wave: at most ``caps[i]``
    clusters of CLUSTER_SIZES[i]. Among those, least cost, the larger of
    (output tiles a cluster) x (chunks a block + FOLD_TILES[da]) and all
    tiles over STREAM_BLOCKS; then resident chunks, then the fewest blocks,
    then the smallest cluster. ``resident``: the block's chunks of A or
    dmid fit in shared memory beside the ring, so they are loaded once."""
    floor = -(-n_out * n_red // STREAM_BLOCKS)
    best = None
    for cs, cap in zip(CLUSTER_SIZES, caps):
        if cs > n_red:
            break
        resident = smem_bytes(r, -(-n_red // cs), bits) <= SMEM_PER_BLOCK
        for g in range(1, min(n_out, cap) + 1):
            cost = max(-(-n_out // g) * (-(-n_red // cs) + FOLD_TILES[da]), floor)
            key = (cost, not resident, cs * g, cs)
            if best is None or key < best[0]:
                best = (key, cs, g, resident)
    return best[1], best[2], best[3]


def _fwd_plan(m: int, k: int, r: int, bits: bool = False, caps: tuple = H100_CLUSTERS) -> tuple[int, int, bool]:
    """The forward's plan: output tiles are x's 64-row chunks, the reduced
    axis K's 64-column chunks."""
    return _plan(-(-m // CHUNK), k // CHUNK, r, bits, tuple(caps), False)


def _da_plan(m: int, k: int, r: int, bits: bool = False, caps: tuple = H100_CLUSTERS) -> tuple[int, int, bool]:
    """dA's plan: output tiles are K's 64-column chunks, the reduced axis
    M's 64-row chunks."""
    return _plan(k // CHUNK, -(-m // CHUNK), r, bits, tuple(caps), True)


def plan_smem_bytes(plan: tuple[int, int, bool], n_red: int, r: int, bits: bool) -> int:
    """Shared memory a block of ``plan`` takes (the chunks resident or one a
    stage)."""
    cs, _, resident = plan
    return smem_bytes(r, -(-n_red // cs) if resident else STAGES[r], bits)


def dropout_threshold(p: float) -> tuple[int, float]:
    """(thr, keep) of the u8 rule: keep iff byte >= thr, keep = 1 - thr/256."""
    thr = int(round(p * 256))
    return thr, 1.0 - thr / 256.0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash_bytes(seed: int, m: int, k: int, device=None, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """(m, k) uint8 mask bytes of ``seed`` for global rows [row0, row0 + m)
    and columns [col0, col0 + k), the kernels' exact stream: word(row, w) =
    fmix32(fmix32(seed ^ row * 0x9E3779B1) ^ w) for w = col >> 2, byte
    ``col & 3`` of it for element (row, col)."""
    if k % 4 or col0 % 4:
        raise ValueError(f"k = {k} and col0 = {col0} must be multiples of 4")
    rows = torch.arange(row0, row0 + m, dtype=torch.int64, device=device)
    words = torch.arange(col0 // 4, (col0 + k) // 4, dtype=torch.int64, device=device)
    row_key = _fmix32((seed & _U32) ^ _mul32(rows, _GOLDEN))
    h = _fmix32(row_key[:, None] ^ words[None, :])
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    return ((h[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(m, k)


@functools.lru_cache(maxsize=None)
def dropout_rule(p: float, dropout_bits: int, dtype: torch.dtype) -> tuple[int, float, float]:
    """(thr, scale, inv) of a rule on mask bytes: keep iff byte >= thr (0:
    no dropout); the forward and dA take x * scale in f32 rounded to x's
    dtype, dx its f32 sum * inv. 8: the u8 rule of :func:`dropout_threshold`,
    scale 1/keep rounded to ``dtype``, inv the f32 1/keep. 32: the 0/1 bytes
    of :func:`keep_bytes` at thr 1, and scale = inv = 1 / keep' in f32, keep'
    = 1 - p rounded to ``dtype``: the reciprocal by which PyTorch's CUDA
    division ``x / keep'`` multiplies (BinaryDivTrueKernel.cu, a CPU scalar
    divisor), so ``x * scale`` is that division bit for bit."""
    if dropout_bits == 8:
        thr, _ = dropout_threshold(p)
        return thr, _scale_in_dtype(thr, dtype), _inv_keep(thr)
    if dropout_bits == 32:
        keep = float(torch.tensor(1.0 - p, dtype=dtype))
        inv = float(np.float32(1.0) / np.float32(keep))
        return int(p > 0), inv, inv
    raise ValueError(f"dropout_bits must be 8 or 32, not {dropout_bits}")


def _mulhi32(x: torch.Tensor, c: int) -> torch.Tensor:
    """floor(x * c / 2^32) for int64 x in [0, 2^32), without int64 overflow."""
    return ((x * (c >> 16)) + ((x * (c & 0xFFFF)) >> 16)) >> 16


def philox4x32_10(ctr: tuple, key: tuple[int, int]) -> tuple:
    """Philox4x32-10 (Random123; curand's ``curand_Philox4x32_10``) of four
    int64 tensors (or ints) of 32-bit counter words and a 32-bit key pair:
    the four output words, int64 in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = key[0] & _U32, key[1] & _U32
    for _ in range(10):
        lo0, hi0 = _mul32(c0, _PHILOX_M[0]), _mulhi32(c0, _PHILOX_M[0])
        lo1, hi1 = _mul32(c2, _PHILOX_M[1]), _mulhi32(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def _rand_blocks(numel: int, sms: int, threads_per_sm: int) -> int:
    """The blocks of PyTorch's draw of ``numel`` values (calc_execution_policy)."""
    return min(-(-numel // KEEP_BLOCK), sms * (threads_per_sm // KEEP_BLOCK))


def keep_draw_fits(numel: int) -> bool:
    """Whether PyTorch draws ``numel`` values in one launch, as
    :func:`keep_bytes` does (at most ``KEEP_MAX_NUMEL``)."""
    return numel <= KEEP_MAX_NUMEL


def _check_keep_numel(numel: int) -> None:
    if not keep_draw_fits(numel):
        raise ValueError(f"{numel} elements: PyTorch draws more than {KEEP_MAX_NUMEL} in several launches")


def _uniform(word: int) -> np.float32:
    """curand's uniform of a 32-bit word: word * 2^-32 + 2^-33 in f32."""
    return np.float32(np.float32(word) * np.float32(2.0 ** -32)) + np.float32(2.0 ** -33)


@functools.lru_cache(maxsize=None)
def _keep_words(keep: float) -> tuple[int, int]:
    """(lo, hi): the element of a Philox word w is kept iff w < lo or w >=
    hi. PyTorch keeps it iff u(w) < keep in f32, u the curand uniform
    (:func:`_uniform`) with 1 folded to 0. u is monotone in w, so u(w) <
    f32(keep) below the first w where it is not, and u(w) == 1 (kept) from
    the first w where it is; both found by bisection."""

    def first(pred) -> int:
        lo, hi = 0, 1 << 32
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if pred(mid) else (mid + 1, hi)
        return lo

    k = np.float32(keep)
    return first(lambda w: _uniform(w) >= k), first(lambda w: _uniform(w) == np.float32(1.0))


def keep_bytes_plain(shape, seed: int, keep: float, sms: int = H100_SMS,
                     threads_per_sm: int = H100_THREADS_PER_SM, device=None) -> torch.Tensor:
    """The 32-bit rule's keep bytes in int64 torch ops (on the CPU, or on
    ``device``): (shape) uint8, 1 iff ``torch.rand(shape,
    generator=torch.Generator("cuda").manual_seed(seed)) < keep`` on a card
    of ``sms`` SMs of ``threads_per_sm`` threads (the draw's grid follows
    the card). Element t + 4 T i + T j comes from word j of Philox4x32-10 at
    counter (i, 0, t) (t: the thread, T the grid's threads) under the seed's
    two words, kept as :func:`_keep_words` says (``csrc/lora_dropout.cu``,
    lora_keep_kernel)."""
    numel = math.prod(shape)
    _check_keep_numel(numel)
    if numel == 0:
        return torch.zeros(shape, dtype=torch.uint8, device=device)
    t = _rand_blocks(numel, sms, threads_per_sm) * KEEP_BLOCK
    iters = -(-numel // (4 * t))
    thread = torch.arange(t, dtype=torch.int64, device=device)
    words = philox4x32_10((torch.arange(iters, dtype=torch.int64, device=device)[:, None], 0, thread & _U32,
                           thread >> 32),
                          (seed & _U32, (seed & _U64) >> 32))
    # (i, j, t) in order is element t + 4 T i + T j: the flat index.
    w = torch.stack(torch.broadcast_tensors(*words), dim=1).reshape(-1)[:numel]
    lo, hi = _keep_words(keep)
    return ((w < lo) | (w >= hi)).to(torch.uint8).reshape(shape)


@functools.lru_cache(maxsize=None)
def _card_threads(index: int) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.max_threads_per_multi_processor


def keep_bytes(shape, seed: int, keep: float, device) -> torch.Tensor:
    """(shape) uint8 keep bytes of the 32-bit rule: 1 iff ``torch.rand(shape,
    generator=torch.Generator("cuda").manual_seed(seed)) < keep`` on the
    card, bit for bit. On a CUDA device one launch of lora_keep_kernel on
    PyTorch's grid for the card, the compare on the words
    (:func:`_keep_words`); on the CPU :func:`keep_bytes_plain` (an H100
    SXM's grid)."""
    device = torch.device(device)
    if device.type == "cpu":
        return keep_bytes_plain(shape, seed, keep)
    numel = math.prod(shape)
    _check_keep_numel(numel)
    out = torch.empty(shape, dtype=torch.uint8, device=device)
    if numel:
        index = out.device.index
        with torch.cuda.device(index):
            LORA_KEEP.launch(out.data_ptr(), numel, seed & _U64, *_keep_words(keep),
                             _rand_blocks(numel, *_card_threads(index)), _stream(index))
    return out


def _keep_mask(x, seed, thr, bits, row0, col0):
    b = hash_bytes(seed, x.shape[0], x.shape[1], x.device, row0, col0) if bits is None else bits
    return b >= thr


def _inv_keep(thr: int) -> float:
    return 1.0 / (1.0 - thr / 256.0)


@functools.lru_cache(maxsize=None)
def _scale_in_dtype(thr: int, dtype: torch.dtype) -> float:
    """1/keep rounded to ``dtype``: ``x * it`` rounds the exact product once."""
    return float(torch.tensor(_inv_keep(thr), dtype=dtype))


def _dropped(x, keep, scale):
    """mask * x * scale, the product in f32 rounded to x's dtype: the u8
    rule's scale is a value of x's dtype, so this is its product in x's
    dtype (reference :71-72); the 32-bit rule's is :func:`dropout_rule`'s."""
    return torch.where(keep, (x.float() * scale).to(x.dtype), 0.0)


def fused_dropout_matmul_plain(x, a, seed: int, thr: int, bits=None, row0: int = 0,
                               col0: int = 0, scale: float | None = None) -> torch.Tensor:
    """Plain forward: (M, r) in x's dtype, f32 sums. ``scale`` None: the
    u8 rule's for ``thr``."""
    scale = _scale_in_dtype(thr, x.dtype) if scale is None else scale
    z = _dropped(x, _keep_mask(x, seed, thr, bits, row0, col0), scale)
    return (z.float() @ a.to(x.dtype).float()).to(x.dtype)


def fused_dropout_bwd_plain(x, a, dmid, seed: int, thr: int, bits=None, row0: int = 0, col0: int = 0,
                            scale: float | None = None):
    """Plain backward: (dx in x's dtype, dA f32). ``scale`` None: the u8
    rule's for ``thr``; else the 32-bit rule's, dx's scale too."""
    keep = _keep_mask(x, seed, thr, bits, row0, col0)
    inv = _inv_keep(thr) if scale is None else scale
    scale = _scale_in_dtype(thr, x.dtype) if scale is None else scale
    dmid = dmid.to(x.dtype).float()
    g = dmid @ a.to(x.dtype).float().T
    dx = torch.where(keep, g * inv, 0.0).to(x.dtype)
    da = _dropped(x, keep, scale).float().T @ dmid
    return dx, da


def _check_cuda(x, a, bits, col0=0):
    m, k = x.shape
    if a.shape[0] != k or a.shape[1] not in RANKS:
        raise ValueError(f"A must be ({k}, r) with r in {RANKS}; got {tuple(a.shape)}")
    if k % CHUNK or col0 % 4:
        raise ValueError(f"K = {k} must be a multiple of {CHUNK} and col0 = {col0} one of 4")
    for name, t in (("x", x), ("A", a)):
        if t.device != x.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on {x.device}; got {t.dtype} on {t.device}")
    if bits is not None and (bits.shape != x.shape or bits.dtype != torch.uint8
                             or bits.device != x.device or not bits.is_contiguous()):
        raise ValueError(f"bits must be a contiguous ({m}, {k}) uint8 tensor on {x.device}")


def _stream(index: int) -> int:
    """The raw handle of CUDA device ``index``'s current stream (no Stream
    object made)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _ptr(t):
    return None if t is None else t.data_ptr()


_CAPS: dict = {}


def _cluster_capacity(dev, r: int, da: bool) -> tuple:
    """The clusters of each of CLUSTER_SIZES that ``dev`` holds at once for
    the forward's (or dA's) kernel at rank ``r``, one block an SM (the
    whole shared memory asked for), read once a (device, kernel)."""
    key = (dev.index, r, da)
    if key not in _CAPS:
        fn = LORA_CLUSTER_CAPACITY.load()
        caps = []
        with torch.cuda.device(dev):
            for cs in CLUSTER_SIZES:
                held = ctypes.c_int(0)
                err = fn(int(da), r, cs, SMEM_PER_BLOCK, ctypes.byref(held))
                if err or held.value < 1:
                    raise RuntimeError(f"lora_cluster_capacity: CUDA error {err}, {held.value} clusters of {cs}")
                caps.append(held.value)
        _CAPS[key] = tuple(caps)
    return _CAPS[key]


def _fwd_cuda(x, a, seed, thr, bits, row0, col0, scale=None):
    m, k = x.shape
    r = a.shape[1]
    cs, clusters, resident = _fwd_plan(m, k, r, bits is not None, _cluster_capacity(x.device, r, False))
    mid = torch.empty((m, r), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        LORA_FWD.launch(x.data_ptr(), a.data_ptr(), _ptr(bits), mid.data_ptr(), m, k, r, cs, clusters,
                        int(resident), seed & _U32, row0, col0, thr,
                        _scale_in_dtype(thr, x.dtype) if scale is None else scale,
                        _stream(x.device.index))
    return mid


def _dx_cuda(x, a, dmid, seed, thr, inv, bits, row0, col0):
    m, k = x.shape
    dmid = dmid.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        LORA_DX.launch(dmid.data_ptr(), a.data_ptr(), _ptr(bits), dx.data_ptr(),
                       m, k, a.shape[1], seed & _U32, row0, col0, thr, inv,
                       _stream(x.device.index))
    return dx


def _da_cuda(x, a, dmid, seed, thr, scale, bits, row0, col0):
    m, k = x.shape
    r = a.shape[1]
    dmid = dmid.to(x.dtype).contiguous()
    cs, clusters, resident = _da_plan(m, k, r, bits is not None, _cluster_capacity(x.device, r, True))
    da = torch.empty((k, r), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        LORA_DA.launch(x.data_ptr(), dmid.data_ptr(), _ptr(bits), da.data_ptr(), m, k, r, cs, clusters,
                       int(resident), seed & _U32, row0, col0, thr, scale,
                       _stream(x.device.index))
    return da


def fused_dropout_bwd(x, a, dmid, seed: int, p: float, *, bits=None, need_dx=True, need_da=True,
                      row0: int = 0, col0: int = 0, dropout_bits: int = 8):
    """(dx, dA f32) of :func:`fused_dropout_matmul` at ``p > 0``: the dx and
    dA kernels on CUDA tensors, :func:`fused_dropout_bwd_plain` on CPU
    tensors. A gradient not asked for comes back as None, unlaunched."""
    thr, scale, inv = dropout_rule(p, dropout_bits, x.dtype)
    if x.device.type == "cpu":
        dx, da = fused_dropout_bwd_plain(x, a, dmid, seed, thr, bits, row0, col0,
                                         None if dropout_bits == 8 else scale)
        return (dx if need_dx else None), (da if need_da else None)
    _check_cuda(x, a, bits, col0)
    if dmid.shape != (x.shape[0], a.shape[1]):
        raise ValueError(f"dmid {tuple(dmid.shape)} != ({x.shape[0]}, {a.shape[1]})")
    return (_dx_cuda(x, a, dmid, seed, thr, inv, bits, row0, col0) if need_dx else None,
            _da_cuda(x, a, dmid, seed, thr, scale, bits, row0, col0) if need_da else None)


# The forward as a dispatcher op, so that a checkpoint policy can keep the
# mid and the backward's replay does not launch the kernel again
# (``core/remat.py``): the kernel on CUDA tensors, the plain version on CPU
# tensors. ``scale`` None: the u8 rule's for ``thr``.
_LIB = torch.library.Library("vlb", "FRAGMENT")
_LIB.define("lora_dropout_fwd(Tensor x, Tensor a, int seed, int thr, Tensor? bits, int row0, int col0, "
            "float? scale=None) -> Tensor")
_LIB.impl("lora_dropout_fwd", fused_dropout_matmul_plain, "CPU")
_LIB.impl("lora_dropout_fwd", _fwd_cuda, "CUDA")


class _FusedDropoutMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, seed, p, bits, row0, col0, dropout_bits):
        thr, scale, _ = dropout_rule(p, dropout_bits, x.dtype)
        ctx.save_for_backward(x, a, bits)
        ctx.seed, ctx.p, ctx.row0, ctx.col0, ctx.dropout_bits = seed, p, row0, col0, dropout_bits
        return torch.ops.vlb.lora_dropout_fwd(x, a, seed, thr, bits, row0, col0,
                                              None if dropout_bits == 8 else scale)

    @staticmethod
    def backward(ctx, dmid):
        x, a, bits = ctx.saved_tensors
        dx, da = fused_dropout_bwd(x, a, dmid, ctx.seed, ctx.p, bits=bits,
                                   need_dx=ctx.needs_input_grad[0], need_da=ctx.needs_input_grad[1],
                                   row0=ctx.row0, col0=ctx.col0, dropout_bits=ctx.dropout_bits)
        return dx, (None if da is None else da.to(a.dtype)), None, None, None, None, None, None


def fused_dropout_matmul(x: torch.Tensor, a: torch.Tensor, seed: int, p: float, *,
                         bits: torch.Tensor | None = None, row0: int = 0, col0: int = 0,
                         dropout_bits: int = 8) -> torch.Tensor:
    """``dropout(x; p) @ a`` with the mask fused into the contraction.

    x (M, K), a (K, r); ``seed`` an integer (its low 32 bits are used),
    ignored when ``bits`` (M, K) uint8 is given; ``row0`` and ``col0`` the
    global indices of x's first row and column in the hash mask (col0 a
    multiple of 4). ``dropout_bits`` 8: the u8 rule on ``bits`` or the
    hash; 32: the 32-bit rule on ``bits``, :func:`keep_bytes`'s 0/1 bytes
    (:func:`dropout_rule`). Returns (M, r) in x's
    dtype, differentiable in x and a. On CUDA tensors: bf16, K a multiple of
    64, r in (16, 32, 64, 128), contiguous; anything else raises.
    """
    thr, _, _ = dropout_rule(p, dropout_bits, x.dtype)
    if thr == 0:
        return x @ a.to(x.dtype)
    if dropout_bits == 32 and bits is None:
        raise ValueError("the 32-bit rule reads its keep bytes (keep_bytes) from bits")
    if x.dim() != 2 or a.dim() != 2:
        raise ValueError(f"want x (M, K), a (K, r); got {tuple(x.shape)}, {tuple(a.shape)}")
    if x.device.type == "cuda":
        _check_cuda(x, a, bits, col0)
    elif x.device.type != "cpu":
        raise ValueError(f"no fused dropout kernel for device {x.device}")
    return _FusedDropoutMatmul.apply(x, a, int(seed), p, bits, int(row0), int(col0), dropout_bits)
