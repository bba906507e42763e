"""FSDP2 parameter sharding by the JAX package's rule table.

Counterpart of ``phantom_vlb_tpu/parallel/sharding.py`` (:1-133). The JAX
package gives every leaf a ``PartitionSpec`` over (data, fsdp, tensor,
sequence) and lets GSPMD emit the collectives; the port applies
``fully_shard`` (FSDP2) to the reference's units, each parameter split
along the dim that the table's ``fsdp`` entry names:

- :data:`DEFAULT_RULES`: the JAX table on the port's names, in torch's
  layout (``nn.Linear`` weights (out, in), convolutions (O, I, ...)); a
  spec covers a tensor's leading dims, the rest are None. Its ``tensor``
  entries are applied by :func:`split_decoder` (below), which cuts each
  decoder projection's tensors to the rank's block before FSDP2 shards
  the blocks over ``fsdp``.
- Any other tensor: the largest dim that ``fsdp`` divides when it holds at
  least ``MIN_SIZE_TO_SHARD`` values, ties broken in the JAX layout's
  order, as the JAX fallback does; else none.
- A mesh axis that does not divide its dim is dropped, as ``_fit_spec``
  drops it.

FSDP2 shards every parameter of a unit, so where the table says none (a
replicated leaf in JAX) the parameter takes FSDP2's default, dim 0. The
int8 bases' ``weight_q`` and ``weight_scale`` are made frozen parameters
(``requires_grad=False``, the same state-dict names; the codes as the bytes
of a float8 tensor) so that FSDP2 shards them too; it gathers a unit's
mixed dtypes as bytes.

Under ``tensor`` > 1 (``parallel/tensor.py``) the decoder's q/k/v/gate/up
are column-parallel: ``weight``/``weight_q`` (out, in) and ``weight_scale``
split on out, as the table's ``('fsdp', 'tensor')`` on the (in, out)
kernel and ``('tensor',)`` on its scale; o/down are row-parallel:
``weight``/``weight_q`` split on in, ``weight_scale`` whole. The adapters
lie as the collectives need them: a column-parallel ``lora_a`` whole and
its ``lora_b`` split on out (the table's ``(None, 'tensor')``); a
row-parallel ``lora_a`` split on in and its ``lora_b`` whole, where the
table keeps ``lora_a`` whole and splits ``lora_b`` (ROADMAP Queue 3). A
``tensor`` size that does not divide the heads, the kv heads or the MLP's
width raises by name (the JAX table drops the axis and replicates). Each
split parameter carries its split (:data:`TENSOR_SPLIT`), which
:func:`whole` and :func:`shard_like` read; a checkpoint holds whole
tensors, so it restores across mesh shapes.

:func:`shard_model` makes a unit of each decoder layer (the reference's
FULL_SHARD unit, which per-layer remat replays), each CLIP layer, the STC
connector, the embedding and the head, then the root; gradients are summed
over the ranks, not averaged, since the loss already divides by the global
count of valid rows (``train/step.py``).
"""

from __future__ import annotations

import math
import re
from typing import Sequence

import torch
from torch import nn

from phantom_vlb_tpu_torch.core.mesh import FSDP_AXIS, MeshEnv
from phantom_vlb_tpu_torch.models.lora import CODES_DTYPE, _QuantBase
from phantom_vlb_tpu_torch.models.mistral import MistralAttention, MistralConfig, MistralMLP
from phantom_vlb_tpu_torch.parallel.tensor import COLUMN, ROW, TensorSplit, gather_along

__all__ = ["DEFAULT_RULES", "MIN_SIZE_TO_SHARD", "infer_param_shardings", "fsdp_dim", "shard_model",
           "whole", "shard_like", "split_decoder", "tensor_split_of", "TENSOR_SPLIT"]

Spec = tuple  # one entry a dim: an axis name, a tuple of names, or None

DEFAULT_RULES: list[tuple[str, Spec]] = [
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight(_q)?$", ("tensor", "fsdp")),
    (r"(o_proj|down_proj)\.weight(_q)?$", ("fsdp", "tensor")),
    # Per-output-channel scales of quantized bases follow the weight's
    # output dim.
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight_scale$", ("tensor",)),
    (r"(o_proj|down_proj)\.weight_scale$", ("fsdp",)),
    (r"lora_a$", ("fsdp", None)),
    (r"lora_b$", (None, "tensor")),
    (r"embed_tokens\.weight$", ("fsdp", None)),
    (r"head\.ridge\.linear\.weight$", (None, "fsdp")),
    # CLIP / connector dense weights (and the squeeze-excite 1x1 convs): the
    # input dim.
    (r"(fc1|fc2|out_proj|readout\.\d+)\.weight$", (None, "fsdp")),
]

# Tensors smaller than this stay whole under the fallback rule.
MIN_SIZE_TO_SHARD = 2**15


def _flax_order(module: nn.Module, leaf: str, ndim: int) -> list[int]:
    """The port's dims in the order of the JAX leaf's: a dense weight's
    (out, in) is (in, out) there, a convolution's (O, I, ...) is (..., I, O)."""
    if leaf in ("weight", "weight_q") and ndim == 2 and not isinstance(module, nn.Embedding):
        return [1, 0]
    if leaf == "weight" and ndim >= 3 and isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        return [*range(2, ndim), 1, 0]
    return list(range(ndim))


def _axis_size(entry, shape: dict[str, int]) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(shape.get(a, 1) for a in axes)


def _fit(spec: Spec, dims: tuple[int, ...], shape: dict[str, int]) -> Spec:
    """``spec`` over all of ``dims``: padded with None, and each axis that
    does not divide its dim dropped."""
    spec = tuple(spec[:len(dims)]) + (None,) * (len(dims) - len(spec))
    return tuple(e if e is not None and d % _axis_size(e, shape) == 0 else None
                 for e, d in zip(spec, dims))


def _fallback(dims: tuple[int, ...], order: list[int], shape: dict[str, int]) -> Spec:
    fsdp = shape.get(FSDP_AXIS, 1)
    if math.prod(dims) < MIN_SIZE_TO_SHARD or fsdp <= 1:
        return (None,) * len(dims)
    for i in sorted(order, key=lambda i: -dims[i]):           # stable: JAX order on ties
        if dims[i] % fsdp == 0:
            return tuple(FSDP_AXIS if j == i else None for j in range(len(dims)))
    return (None,) * len(dims)


def infer_param_shardings(model: nn.Module, env: MeshEnv,
                          rules: Sequence[tuple[str, Spec]] = tuple(DEFAULT_RULES)) -> dict[str, Spec]:
    """Each parameter's spec (one entry per dim, in torch's layout) by name."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        dims = tuple(p.shape)
        owner, _, leaf = name.rpartition(".")
        spec = next((s for pat, s in compiled if pat.search(name)), None)
        if spec is None:
            spec = _fallback(dims, _flax_order(modules[owner], leaf, len(dims)), env.shape)
        out[name] = _fit(spec, dims, env.shape) if dims else ()
    return out


def fsdp_dim(spec: Spec) -> int | None:
    """The dim that ``fsdp`` splits under ``spec``, or None."""
    for i, e in enumerate(spec):
        if e == FSDP_AXIS or (isinstance(e, tuple) and FSDP_AXIS in e):
            return i
    return None


def _shard_units(model: nn.Module) -> list[nn.Module]:
    """The modules that become FSDP2 units, innermost first (the root last):
    each decoder layer, each CLIP layer, the STC connector, the embedding,
    the head."""
    units: list[nn.Module] = []
    tower = getattr(model, "vision_tower", None)
    if tower is not None:
        units += list(tower.layers)
    if getattr(model, "mm_projector", None) is not None:
        units.append(model.mm_projector)
    decoder = getattr(model, "model", None)
    if decoder is not None:
        units += [*decoder.layers, decoder.embed_tokens]
    if getattr(model, "head", None) is not None:
        units.append(model.head)
    return units


def _refuse_unported(model: nn.Module, world: int) -> None:
    """What a mesh of more than one process does not run (ROADMAP Queue 1)."""
    where = f"under a mesh of {world} processes is not ported (ROADMAP Queue 1); run it in one process"
    for m in model.modules():
        cfg = getattr(m, "cfg", None)
        impl = getattr(cfg, "attention_impl", None) or getattr(getattr(cfg, "mistral", None), "attention_impl", None)
        if impl not in (None, "auto"):
            raise NotImplementedError(f"attention_impl={impl!r} (a ring whose ranks are processes) {where}")


# The attribute of a parameter split over the ``tensor`` axis: (dim, TensorSplit).
TENSOR_SPLIT = "_vlb_tensor_split"
# The decoder projections by role, and the dim of each of their tensors
# that the ``tensor`` axis splits (a tensor not named stays whole).
_ROLES = {"q_proj": COLUMN, "k_proj": COLUMN, "v_proj": COLUMN, "gate_proj": COLUMN, "up_proj": COLUMN,
          "o_proj": ROW, "down_proj": ROW}
_SPLIT_DIMS = {COLUMN: {"weight": 0, "weight_q": 0, "weight_scale": 0, "lora_b": 1},
               ROW: {"weight": 1, "weight_q": 1, "lora_a": 0}}


def tensor_split_of(p) -> tuple[int, TensorSplit] | None:
    """(dim, split) of a parameter split over the ``tensor`` axis, else None."""
    return getattr(p, TENSOR_SPLIT, None)


def _check_tensor_divides(model: nn.Module, size: int) -> None:
    for m in model.modules():
        cfg = getattr(m, "cfg", None)
        if isinstance(m, MistralAttention | MistralMLP) and isinstance(cfg, MistralConfig):
            for what, n in (("attention heads", cfg.num_attention_heads),
                            ("kv heads", cfg.num_key_value_heads),
                            ("MLP width (intermediate_size)", cfg.intermediate_size)):
                if n % size:
                    raise ValueError(f"mesh.tensor={size} does not divide the decoder's {n} {what}; "
                                     "choose a tensor size that divides the heads, the kv heads and the "
                                     "MLP's width")


def _projections(model: nn.Module):
    """(name, module) of each decoder projection, in module order."""
    for m in model.modules():
        if isinstance(m, MistralAttention | MistralMLP):
            for name, proj in m.named_children():
                if name in _ROLES:
                    yield name, proj


def split_decoder(model: nn.Module, env: MeshEnv) -> None:
    """Cut each decoder projection's tensors to this rank's block along the
    ``tensor`` axis and give the projection its ``tensor_split``, in place
    (a no-op at ``tensor`` 1)."""
    size = env.tensor_size
    if size == 1:
        return
    _check_tensor_divides(model, size)
    rank = env.coords["tensor"]
    for name, proj in _projections(model):
        split = TensorSplit(_ROLES[name], env.tensor_group, size, rank)
        for leaf, dim in _SPLIT_DIMS[split.role].items():
            t = getattr(proj, leaf, None)
            if t is None:
                continue
            n = t.shape[dim] // size
            block = t.detach().narrow(dim, rank * n, n).clone()
            if isinstance(t, nn.Parameter):
                setattr(proj, leaf, nn.Parameter(block, requires_grad=t.requires_grad))
            else:
                proj.register_buffer(leaf, block)
        proj.tensor_split = split


def _freeze_quant_buffers(model: nn.Module) -> None:
    """The int8 bases' buffers as frozen parameters of the same names. FSDP2
    makes each sharded tensor a parameter that may take a gradient, which
    an integer tensor may not (torch 2.11 refuses it), so the int8 codes
    ride as the bytes of a float8 tensor, never read as floats: the base
    reads them back as int8 (``_QuantBase.codes``, a view)."""
    for m in model.modules():
        if isinstance(m, _QuantBase) and "weight_q" in m._buffers:
            for leaf in ("weight_q", "weight_scale"):
                t = m._buffers.pop(leaf)
                if t.dtype == torch.int8:
                    t = t.view(CODES_DTYPE)
                m.register_parameter(leaf, nn.Parameter(t, requires_grad=False))


def _mark_splits(model: nn.Module) -> None:
    for name, proj in _projections(model):
        split = getattr(proj, "tensor_split", None)
        if split is None:
            continue
        for leaf, dim in _SPLIT_DIMS[split.role].items():
            p = proj._parameters.get(leaf)
            if p is not None:
                setattr(p, TENSOR_SPLIT, (dim, split))


def shard_model(model: nn.Module, env: MeshEnv,
                rules: Sequence[tuple[str, Spec]] = tuple(DEFAULT_RULES)) -> nn.Module:
    """The decoder's projections cut along ``tensor`` (:func:`split_decoder`),
    the int8 bases made frozen parameters, then ``fully_shard`` over
    ``env``'s batch mesh on the units (each decoder layer, each CLIP
    layer, the STC connector, the embedding, the head), then the root, in
    place; each parameter split along :func:`fsdp_dim` of its spec (dim 0
    where that is None). Gradients are reduced as sums."""
    if not env.sharded:
        raise ValueError("shard_model needs a mesh over a process group (build_mesh after "
                         "maybe_initialize_distributed)")
    if env.n_devices > 1:
        _refuse_unported(model, env.n_devices)
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor import Shard

    split_decoder(model, env)
    _freeze_quant_buffers(model)
    specs = infer_param_shardings(model, env, rules)
    dims = {id(p): fsdp_dim(specs[name]) for name, p in model.named_parameters()}

    def placement(p: nn.Parameter):
        d = dims.get(id(p))
        return Shard(0 if d is None else d)

    for unit in [*_shard_units(model), model]:
        fully_shard(unit, mesh=env.device_mesh, shard_placement_fn=placement)
    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.set_force_sum_reduction_for_comms(True)
            m.set_gradient_divide_factor(1.0)
    _mark_splits(model)
    return model


def whole(t, like=None):
    """A sharded tensor gathered whole on every rank (a collective): a
    ``DTensor``'s shards, then, for a tensor split along ``tensor`` (``t``
    or the parameter ``like`` it belongs to, e.g. its gradient or an AdamW
    moment), the ``tensor`` ranks' blocks; else ``t`` itself."""
    out = t.full_tensor() if hasattr(t, "full_tensor") else t
    split = tensor_split_of(t if like is None else like)
    if split is None or out.dim() == 0:
        return out
    return gather_along(out, *split)


def shard_like(t, param: torch.Tensor):
    """A whole tensor of ``param``'s whole shape cut to this rank's part
    of it: its block along ``tensor`` where ``param`` is split so, then
    split as ``param``'s ``DTensor`` placements split it (no communication:
    every rank holds ``t``); other values (per-tensor step counts) and for
    an unsharded ``param``, ``t``."""
    if not isinstance(t, torch.Tensor):
        return t
    split = tensor_split_of(param)
    if split is not None and t.dim() == param.dim():
        dim, ts = split
        n = param.shape[dim]
        if t.shape[dim] == n * ts.size:
            t = t.narrow(dim, ts.rank * n, n).contiguous()
    if not hasattr(param, "device_mesh") or t.shape != param.shape:
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(param.device), param.device_mesh, param.placements, src_data_rank=None)
