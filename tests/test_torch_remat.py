"""Port parity: the decoder's five ``remat_policy`` checkpoint policies.

At the tiny config (2 layers, packed flash attention, LoRA r 4, a padded
row): under each policy the loss and every gradient of ``mean(out^2)``
match the JAX model under the same policy at the train-step tests'
tolerances (loss 1e-5 relative, gradients 1e-4 x max|g|; the w8a8g8 base at
the int8 decoder tests' 1e-3), and the port runs again exactly what the
JAX grad runs: its ``vlb::flash_fwd`` calls plus one flash backward a layer
are the jaxpr's ``pallas_call``s (Pallas bodies excluded), its ``aten.mm``
calls its ``dot_general``s. In bf16 with adapter dropout 0.1, over the bf16
and w8a8g8 bases and the fused and unfused dropout, every policy gives
the loss and gradients of ``'nothing'`` bit for bit, switched in place on
one model, with the kernel ops' and products' counts each policy implies.
The ring attentions refuse every policy but ``'nothing'``; unknown names
raise; a name is a view, not a copy.
"""

import collections

import jax
import jax.ad_checkpoint  # noqa: F401  (the JAX package names values through it)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from phantom_vlb_tpu.models import mistral as jm
from phantom_vlb_tpu.models.lora import LoRAConfig as JLoRA
from phantom_vlb_tpu_torch.core import remat
from phantom_vlb_tpu_torch.core.remat import REMAT_POLICIES, checkpoint_name
from phantom_vlb_tpu_torch.models import mistral as tm
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.models.lora import LoRAConfig as TLoRA

B, S, E, L = 2, 40, 64, 2
POLICIES = list(REMAT_POLICIES)
# pallas_call and dot_general in the jaxpr of jax.grad over every
# parameter, Pallas bodies excluded, by policy; test_policy_matches_jax reads
# them off the JAX package each time. The w8a8g8 base's int8 products sit in
# a custom_vjp, which 'dots' does not keep: 12 run again.
JAX_PALLAS = {"nothing": 6, "attn": 6, "mids": 6, "flash": 4, "dots": 6}
JAX_DOTS = {None: {"nothing": 150, "attn": 150, "mids": 136, "flash": 136, "dots": 112},
            "w8a8g8": {"nothing": 150, "attn": 150, "mids": 136, "flash": 136, "dots": 124}}
TOL = {None: 1e-4, "w8a8g8": 1e-3}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _jaxpr_counts(jaxpr) -> tuple[int, int]:
    counts = collections.Counter()

    def walk(j):
        for eqn in j.eqns:
            counts[eqn.primitive.name] += 1
            if eqn.primitive.name == "pallas_call":
                continue
            for param in eqn.params.values():
                for sub in param if isinstance(param, (list, tuple)) else [param]:
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return counts["pallas_call"], counts["dot_general"]


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "kernel_q":
            out[k] = rng.integers(-127, 128, v.shape).astype(np.int8)
        elif k == "kernel_scale":
            out[k] = (rng.uniform(0.5, 1.5, v.shape) / (127.0 * np.sqrt(E))).astype(np.float32)
        elif k == "weight":
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "lora_b":
            out[k] = (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
    return out


def _floats(tree):
    """The tree without its integer leaves' (float0) gradients."""
    return {k: _floats(v) if isinstance(v, dict) else v for k, v in tree.items()
            if isinstance(v, dict) or k != "kernel_q"}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    mask = (np.arange(S)[None] < np.array([[S], [29]])).astype(np.int32)
    return rng, x, mask


def _port(base_quant, policy, dtype=torch.float32, lora=None):
    lora = lora or TLoRA(rank=4, alpha=8.0, dropout=0.0)
    return tm.MistralModel(tm.MistralConfig.tiny(lora=lora, base_quant=base_quant, remat=True,
                                                 remat_policy=policy, dtype=dtype))


def _step(model, x, mask, seed=None):
    """Loss and gradients of one backward, with the ops it dispatched."""
    model.zero_grad(set_to_none=True)
    with _Count() as count:
        out = model(x, mask, seed=seed)
        loss = out.float().square().mean()
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, count.calls


@pytest.mark.parametrize("policy,base_quant", [(p, None) for p in POLICIES] + [("mids", "w8a8g8"),
                                                                              ("dots", "w8a8g8")])
def test_policy_matches_jax(policy, base_quant):
    rng, x, mask = _inputs(1)
    jmodel = jm.MistralModel(jm.MistralConfig.tiny(
        attention_impl="pallas", remat=True, remat_policy=policy, base_quant=base_quant,
        lora=JLoRA(rank=4, alpha=8.0, dropout=0.0)))
    params = _randomize(jax.eval_shape(jmodel.init, jax.random.key(0), x, None, mask)["params"], rng)

    def loss(p):
        return jnp.mean(jmodel.apply({"params": p}, x, None, mask) ** 2)

    traced = jax.jit(jax.value_and_grad(loss, allow_int=True)).trace(params)
    pallas, dots = _jaxpr_counts(traced.jaxpr)
    assert (pallas, dots) == (JAX_PALLAS[policy], JAX_DOTS[base_quant][policy])
    want_loss, want_grads = traced.lower().compile()(params)
    want = {k[len("model."):]: v for k, v in from_flax_params({"model": _floats(want_grads)}).items()}

    port = _port(base_quant, policy)
    sd = {k[len("model."):]: v for k, v in from_flax_params({"model": params}).items()}
    assert set(port.load_state_dict(sd, strict=False).missing_keys) <= {"embed_tokens.weight"}
    got_loss, grads, calls = _step(port.train(), torch.from_numpy(x), torch.from_numpy(mask))

    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert len(grads) == 14 * L + 2 * L + 1               # adapters, layer norms, final norm
    for name, g in grads.items():
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= TOL[base_quant] * np.abs(w).max(), name
    assert calls["vlb.flash_fwd"] + L == pallas                # + one backward a layer
    assert calls["aten.mm"] == dots


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("base_quant", [None, "w8a8g8"], ids=["bf16", "w8a8g8"])
def test_policies_are_bit_equal_and_rerun_what_jax_reruns(base_quant, fused):
    """bf16, adapter dropout 0.1 (the fused u8 kernel or the unfused 32-bit
    draw), one model switched in place."""
    rng, x, mask = _inputs(2)
    lora = TLoRA(rank=4, alpha=8.0, dropout=0.1, fused_dropout=fused, dropout_bits=8 if fused else 32)
    model = _port(base_quant, "nothing", torch.bfloat16, lora).train()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * (0.2 if "lora_b" in name else 0.1)
                                     + (1.0 if "norm" in name else 0.0)))
        for name, b in model.named_buffers():
            b.copy_(torch.from_numpy(rng.integers(-127, 128, b.shape)) if b.dtype == torch.int8
                    else torch.from_numpy(rng.uniform(0.5, 1.5, b.shape) / (127.0 * np.sqrt(E))))
    xt, mt = torch.from_numpy(x).bfloat16(), torch.from_numpy(mask)
    ref = None
    for policy in POLICIES:
        tm.set_remat_policy(model, policy)
        assert model.layers[0].self_attn.cfg.remat_policy == policy
        loss, grads, calls = _step(model, xt, mt, seed=5)
        if ref is None:
            ref = (loss, grads)
        assert torch.equal(loss, ref[0]) and grads.keys() == ref[1].keys()
        assert all(torch.equal(g, ref[1][n]) for n, g in grads.items()), policy
        kept = REMAT_POLICIES[policy] or set()
        assert calls["vlb.flash_fwd"] == L * (1 if "flash_out" in kept else 2)
        # Each fused kernel stands for JAX's adapter product x A; under
        # 'dots' JAX keeps that product, while the kernel is no product and
        # runs again.
        kernels = 7 * L * (1 if "lora_mid" in kept else 2) if fused else 0
        products = 7 * L * (1 if "lora_mid" in kept or policy == "dots" else 2) if fused else 0
        assert calls["vlb.lora_dropout_fwd"] == kernels
        assert calls["aten.mm"] == JAX_DOTS[base_quant][policy] - products


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ring_fused"])
def test_rings_take_nothing_only(impl):
    tm.MistralConfig.tiny(attention_impl=impl)                 # 'nothing' by default
    with pytest.raises(NotImplementedError, match="the rings take remat_policy='nothing' only"):
        tm.MistralConfig.tiny(attention_impl=impl, remat_policy="mids")
    model = _port(None, "flash")
    with pytest.raises(NotImplementedError, match=impl):
        tm.set_attention_impl(model, impl)


def test_named_scopes_keep_no_views_but_the_named_alias():
    """A view in a named scope (the unfused product's reshape of its
    dropped input) is not kept, so the input is not kept alive with it."""
    mids = remat._policy_fn
    keep = REMAT_POLICIES["mids"]
    aten = torch.ops.aten
    with remat.named("lora_mid"):
        saved = {f: mids(keep, None, f) for f in (aten.mm.default, aten.view.default, aten.alias.default,
                                                  aten._unsafe_view.default)}
    assert saved == {aten.mm.default: remat.CheckpointPolicy.MUST_SAVE,
                     aten.view.default: remat.CheckpointPolicy.PREFER_RECOMPUTE,
                     aten.alias.default: remat.CheckpointPolicy.MUST_SAVE,
                     aten._unsafe_view.default: remat.CheckpointPolicy.MUST_SAVE}
    assert mids(keep, None, aten.mm.default) == remat.CheckpointPolicy.PREFER_RECOMPUTE   # unnamed
    with remat.named(remat.OPAQUE):
        assert mids(None, None, aten.mm.default) == remat.CheckpointPolicy.PREFER_RECOMPUTE
    assert mids(None, None, aten.mm.default) == remat.CheckpointPolicy.MUST_SAVE         # 'dots'


def test_unknown_policy_raises_and_names_are_views():
    with pytest.raises(ValueError, match="unknown remat_policy 'everything'"):
        tm.MistralConfig.tiny(remat_policy="everything")
    x = torch.randn(3, 4)
    y = checkpoint_name(x, "attn_out")
    assert y.data_ptr() == x.data_ptr() and y._base is x and torch.equal(y, x)
