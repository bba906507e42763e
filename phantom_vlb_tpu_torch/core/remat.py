"""The decoder's checkpoint policies and the names they read.

Counterpart of ``_remat_policy`` (``phantom_vlb_tpu/models/mistral.py``
:185-203) and of ``jax.ad_checkpoint.checkpoint_name``. A policy says which
values a checkpointed layer keeps from its forward, so that the backward's
replay of the layer takes them from memory instead of computing them
again:

- ``'nothing'``: keeps nothing (plain per-layer checkpointing);
- ``'attn'``: the attention output (``attn_out``);
- ``'mids'``: the rank-r LoRA mids (``lora_mid``), so no adapter product
  or fused dropout kernel runs twice;
- ``'flash'``: the flash forward's outputs (``flash_out``, ``flash_lse``)
  and the mids, so the flash forward does not run twice either;
- ``'dots'``: every matrix product without batch dimensions
  (``dots_with_no_batch_dims_saveable``): ``aten.mm``, ``aten.addmm`` and
  ``aten._int_mm``, but not those of the w8a8 and w8a8g8 bases (see
  :data:`OPAQUE`). ``bmm`` is a batched product, and a hand kernel is not
  a product: the fused kernels are Pallas calls on the TPU, not dots.

Under a ring ``attention_impl`` each policy keeps what the reference's keeps
there: the rings' ``custom_vjp``s name nothing inside
(``phantom_vlb_tpu/ops/context_parallel.py:268``, ``ops/ring_fused.py:341``),
so ``'flash'`` keeps only the mids (the per-step ring's flash forwards run
outside any named scope, ``attention_with_stats``), ``'attn'`` keeps
``attn_out`` but its replay runs the ring again for the lse the backward
reads, and ``'dots'`` keeps no product of the plain ring, whose products
are batched. Every policy's replay runs a ring pass (``vlb::ring_fwd``,
or the per-step ring's ``vlb::flash_fwd`` calls) again, as the JAX grad's
jaxpr does.

Each maps to a policy function of ``torch.utils.checkpoint``'s selective
checkpointing, which decides per dispatched op whether the replay takes its
outputs from memory. XLA's replay computes only what the backward needs;
the replay here runs the layer's ops in order and stops at the last tensor
the backward saved (early stop), so a value is skipped only when the op
that made it is kept. Hence two ways to name:

- :func:`checkpoint_name` ``(x, name)``, JAX's form, names a value after
  it is made: an alias of x (a view, nothing is copied) that a policy
  keeps. The replay still runs whatever made x. ``attn_out`` is named so:
  the flash backward needs the kernel's lse, so the forward runs again
  under ``'attn'`` in JAX too.
- ``with`` :func:`named` ``(*names)`` names every tensor the ops run inside
  make, so a policy keeps those ops' outputs and the replay does not run
  them: the hand kernels' ops (``vlb::flash_fwd``, ``vlb::lora_dropout_fwd``)
  and the unfused adapter product. An inner scope's names replace an
  outer one's.

Dropout masks come from per-site seeds, never from a generator's state, so
what the replay does compute is what the forward computed.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

__all__ = ["REMAT_POLICIES", "DOT_OPS", "OPAQUE", "checkpoint_name", "named", "current_names",
           "check_remat_policy", "remat_context_fn"]

# The names each policy keeps (None: the matrix products instead).
REMAT_POLICIES = {
    "nothing": frozenset(),
    "attn": frozenset({"attn_out"}),
    "mids": frozenset({"lora_mid"}),
    "flash": frozenset({"flash_out", "flash_lse", "lora_mid"}),
    "dots": None,
}
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                     torch.ops.aten._int_mm.default})
# The name of a scope whose products ``'dots'`` does not keep: the w8a8 and
# w8a8g8 base products run inside a custom-gradient Function, as in JAX
# inside a ``custom_vjp``, whose int8 products the JAX policy does not keep
# (its replay runs them again).
OPAQUE = "custom_vjp"

_SCOPE = threading.local()


def current_names() -> frozenset:
    """The names of the innermost :func:`named` scope (empty outside any)."""
    stack = getattr(_SCOPE, "stack", None)
    return stack[-1] if stack else frozenset()


@contextlib.contextmanager
def named(*names: str):
    """Name the tensors that the ops run inside make (see the module doc)."""
    stack = _SCOPE.__dict__.setdefault("stack", [])
    stack.append(frozenset(names))
    try:
        yield
    finally:
        stack.pop()


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` named ``name``: an alias of x that a policy keeping ``name``
    keeps (``jax.ad_checkpoint.checkpoint_name``)."""
    with named(name):
        return torch.ops.aten.alias.default(x)


def check_remat_policy(name: str) -> str:
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}")
    return name


@functools.cache
def _is_view(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)


def _policy_fn(keep, ctx, func, *args, **kwargs):
    if keep is None:
        saved = func in DOT_OPS and OPAQUE not in current_names()
    else:
        # A view made in a named scope is not kept (the unfused product's
        # reshape of its dropped input would keep that input alive, and the
        # replay makes a view for nothing), but checkpoint_name's alias is
        # the named value itself.
        saved = bool(keep & current_names()) and (
            func is torch.ops.aten.alias.default or not _is_view(func))
    return CheckpointPolicy.MUST_SAVE if saved else CheckpointPolicy.PREFER_RECOMPUTE


def remat_context_fn(policy: str):
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for
    ``policy`` (plain checkpointing's for ``'nothing'``)."""
    keep = REMAT_POLICIES[check_remat_policy(policy)]
    if keep is not None and not keep:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_policy_fn, keep))
