"""FSDP2 parameter sharding by the JAX package's rule table.

Counterpart of ``phantom_vlb_tpu/parallel/sharding.py`` (:1-133). The JAX
package gives every leaf a ``PartitionSpec`` over (data, fsdp, tensor,
sequence) and lets GSPMD emit the collectives; the port applies
``fully_shard`` (FSDP2) to the reference's units, each parameter split
along the dim that the table's ``fsdp`` entry names:

- :data:`DEFAULT_RULES`: the JAX table on the port's names, in torch's
  layout (``nn.Linear`` weights (out, in), convolutions (O, I, ...)); a
  spec covers a tensor's leading dims, the rest are None. The ``tensor``
  entries are kept and not applied (``tensor`` > 1 is not ported).
- Any other tensor: the largest dim that ``fsdp`` divides when it holds at
  least ``MIN_SIZE_TO_SHARD`` values, ties broken in the JAX layout's
  order, as the JAX fallback does; else none.
- A mesh axis that does not divide its dim is dropped, as ``_fit_spec``
  drops it.

FSDP2 shards every parameter of a unit, so where the table says none (a
replicated leaf in JAX) the parameter takes FSDP2's default, dim 0.

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

__all__ = ["DEFAULT_RULES", "MIN_SIZE_TO_SHARD", "infer_param_shardings", "fsdp_dim", "shard_model",
           "whole", "shard_like"]

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
    if any(name.endswith("weight_q") for name, _ in model.named_buffers()):
        raise NotImplementedError(f"base_quant (int8 weights are buffers, which FSDP2 does not shard) {where}")
    for m in model.modules():
        cfg = getattr(m, "cfg", None)
        impl = getattr(cfg, "attention_impl", None) or getattr(getattr(cfg, "mistral", None), "attention_impl", None)
        if impl not in (None, "auto"):
            raise NotImplementedError(f"attention_impl={impl!r} (a ring whose ranks are processes) {where}")


def shard_model(model: nn.Module, env: MeshEnv,
                rules: Sequence[tuple[str, Spec]] = tuple(DEFAULT_RULES)) -> nn.Module:
    """``fully_shard`` over ``env``'s mesh on the units (each decoder layer,
    each CLIP layer, the STC connector, the embedding, the head), then the
    root, in place; each parameter split along :func:`fsdp_dim` of its
    spec (dim 0 where that is None). Gradients are reduced as sums."""
    if not env.sharded:
        raise ValueError("shard_model needs a mesh over a process group (build_mesh after "
                         "maybe_initialize_distributed)")
    if env.n_devices > 1:
        _refuse_unported(model, env.n_devices)
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor import Shard

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
    return model


def whole(t):
    """A sharded tensor (``DTensor``) gathered whole on every rank (a
    collective), else ``t`` itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def shard_like(t, param: torch.Tensor):
    """A whole tensor of ``param``'s shape, split as ``param``'s ``DTensor``
    placements split it (no communication: every rank holds ``t``); other
    values (per-tensor step counts) and for an unsharded ``param``, ``t``."""
    if not hasattr(param, "device_mesh") or not isinstance(t, torch.Tensor) or t.shape != param.shape:
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(param.device), param.device_mesh, param.placements, src_data_rank=None)
