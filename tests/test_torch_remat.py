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

Under each ring (``'ring'``, ``'ring_flash'``, ``'ring_fused'``; the port
on a CPU ``SequenceRing`` of 2 ranks, JAX on a sequence axis of 2 of the
8-device virtual mesh) and each policy: the loss and every gradient
against JAX's at the same tolerances, and the ring passes (every policy
runs the ring again: JAX's rings name nothing inside), flash forwards and
products against the JAX grad's jaxpr; in bf16 with the fused u8 dropout
each ring's five policies bit-equal. With ``fused_epilogue`` (``'pallas'``,
``'fwd'``) under each policy, at widths where every JAX projection takes its
kernel: the epilogue forwards (7 a layer, 6 in the replay: neither side
replays the last projection's) and the products against the jaxpr traced
as on a TPU, the loss and gradients against JAX's. Unknown names raise; a
name is a view, not a copy.
"""

import collections
import functools

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
from phantom_vlb_tpu_torch.core.mesh import SequenceRing, set_sequence_ring
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
    counts = _jax_counts(jaxpr)
    return counts["pallas_call"], counts["dot"] + counts["dot_batched"]


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


def test_keep_byte_route_policies_are_bit_equal(monkeypatch):
    """bf16, 32-bit adapter dropout 0.1 through the keep-byte route (taken
    on the CPU by patching its test: the kernels' plain versions): every
    policy gives the loss and gradients of ``'nothing'`` bit for bit; the
    keep bytes are drawn in the forward and again in every replay (never
    kept), and the kernel op and the products run as the fused route's."""
    from phantom_vlb_tpu_torch.models import lora as lora_mod

    draws = collections.Counter()
    real = lora_mod.keep_bytes

    def counted(*args, **kwargs):
        draws["keep"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(lora_mod, "takes_keep_bytes", lambda *args: True)
    monkeypatch.setattr(lora_mod, "keep_bytes", counted)
    rng, x, mask = _inputs(2)
    model = _port(None, "nothing", torch.bfloat16, TLoRA(rank=4, alpha=8.0, dropout=0.1, dropout_bits=32)).train()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * (0.2 if "lora_b" in name else 0.1)
                                     + (1.0 if "norm" in name else 0.0)))
    xt, mt = torch.from_numpy(x).bfloat16(), torch.from_numpy(mask)
    ref = None
    for policy in POLICIES:
        tm.set_remat_policy(model, policy)
        draws.clear()
        loss, grads, calls = _step(model, xt, mt, seed=5)
        if ref is None:
            ref = (loss, grads)
        assert torch.equal(loss, ref[0]) and grads.keys() == ref[1].keys()
        assert all(torch.equal(g, ref[1][n]) for n, g in grads.items()), policy
        kept = REMAT_POLICIES[policy] or set()
        assert draws["keep"] == 2 * 7 * L
        assert calls["vlb.lora_dropout_fwd"] == 7 * L * (1 if "lora_mid" in kept else 2)
        products = 7 * L * (1 if "lora_mid" in kept or policy == "dots" else 2)
        assert calls["aten.mm"] == JAX_DOTS[None][policy] - products


# ---------------------------------------------------------------------------
# The rings under each policy: the port on a CPU SequenceRing of N_RING
# ranks, JAX on a sequence axis of N_RING of the 8-device virtual mesh.

RINGS = ["ring", "ring_flash", "ring_fused"]
N_RING = 2
# The JAX grad's jaxpr under a ring, for every policy: pallas_calls (Pallas
# bodies excluded; a shard_map body counts once, for every rank) and
# batched dot_generals; its unbatched dot_generals are JAX_DOTS[None].
JAX_RING_PALLAS = {"ring": 0, "ring_flash": 12, "ring_fused": 8}
JAX_RING_BATCHED = {"ring": 32, "ring_flash": 0, "ring_fused": 0}


def _jax_ring_passes(impl, pallas, batched):
    """Ring passes (forwards and replays) in the JAX grad's jaxpr: a rank's
    pass is one fused kernel ('ring_fused'), N_RING flash forwards
    ('ring_flash': every step, the ones above the diagonal too) or 2 N_RING
    score and value products ('ring'); its backward is N_RING flash
    backward kernels, or 4 N_RING products, a layer."""
    if impl == "ring":
        return (batched - 4 * N_RING * L) // (2 * N_RING)
    return (pallas - N_RING * L) // (1 if impl == "ring_fused" else N_RING)


def _port_ring_passes(impl, calls):
    """Ring passes the port ran: one ``vlb::ring_fwd`` each, n(n+1)/2 flash
    forwards (the steps above the diagonal skipped), or 2 n^2 bmm (every
    rank, every step; the backward's 4 n^2 a layer taken off)."""
    if impl == "ring_fused":
        return calls["vlb.ring_fwd"]
    if impl == "ring_flash":
        return calls["vlb.flash_fwd"] // (N_RING * (N_RING + 1) // 2)
    return (calls["aten.bmm"] - 4 * N_RING ** 2 * L) // (2 * N_RING ** 2)


def _jax_counts(jaxpr) -> collections.Counter:
    """pallas_call by kernel (``pallas:<name>``), unbatched and batched
    dot_general, over a jaxpr and its sub-jaxprs (Pallas bodies excluded);
    a kernel is named ``pallas:<function>@<file>``."""
    counts = collections.Counter()

    def walk(j):
        for eqn in j.eqns:
            name = eqn.primitive.name
            if name == "pallas_call":
                counts["pallas_call"] += 1
                fn, _, where = eqn.params["jaxpr"].debug_info.func_src_info.partition(" at ")
                counts[f"pallas:{fn}@{where.rsplit('/', 1)[-1].split(':')[0]}"] += 1
                continue
            if name == "dot_general":
                name = "dot_batched" if eqn.params["dimension_numbers"][1][0] else "dot"
            counts[name] += 1
            for param in eqn.params.values():
                for sub in param if isinstance(param, (list, tuple)) else [param]:
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return counts


@pytest.fixture(scope="module")
def jax_ring(cpu_devices):
    """JAX's loss and gradients through each ring, by impl, and a function
    that traces the grad under a policy (the ring's sequence mesh set)."""
    from phantom_vlb_tpu.core.mesh import MeshConfig, build_mesh
    from phantom_vlb_tpu.ops import context_parallel as jcp

    rng, x, mask = _inputs(1)
    lora = JLoRA(rank=4, alpha=8.0, dropout=0.0)
    init = jm.MistralModel(jm.MistralConfig.tiny(attention_impl="pallas", lora=lora))
    params = _randomize(jax.eval_shape(init.init, jax.random.key(0), x, None, mask)["params"], rng)

    def grad_fn(impl, remat, policy="nothing"):
        jmodel = jm.MistralModel(jm.MistralConfig.tiny(attention_impl=impl, remat=remat,
                                                       remat_policy=policy, lora=lora))
        return jax.jit(jax.value_and_grad(lambda p: jnp.mean(jmodel.apply({"params": p}, x, None, mask) ** 2)))

    jcp.set_sequence_mesh(build_mesh(MeshConfig(data=1, fsdp=1, tensor=1, sequence=N_RING),
                                     cpu_devices[:N_RING]))
    try:
        # The fused ring's interpret mode (its remote copies simulated by
        # ordered callbacks) cannot run under jax.checkpoint, so its values
        # come from the model without remat: the same function. Its policy
        # jaxprs are traced with the TPU kernel (never run).
        values = {impl: grad_fn(impl, impl != "ring_fused")(params) for impl in RINGS}

        def trace(impl, policy, monkeypatch):
            from phantom_vlb_tpu.ops import ring_fused as jrf

            if impl == "ring_fused":
                monkeypatch.setattr(jrf, "ring_flash_fused",
                                    functools.partial(jrf.ring_flash_fused, interpret=False))
            jcp.set_sequence_mesh(build_mesh(MeshConfig(data=1, fsdp=1, tensor=1, sequence=N_RING),
                                             cpu_devices[:N_RING]))
            try:
                return _jax_counts(grad_fn(impl, True, policy).trace(params).jaxpr)
            finally:
                jcp.set_sequence_mesh(None)
    finally:
        jcp.set_sequence_mesh(None)
    want = {impl: (loss, {k[len("model."):]: t for k, t in from_flax_params({"model": g}).items()})
            for impl, (loss, g) in values.items()}
    return {"params": params, "x": x, "mask": mask, "values": want, "trace": trace}


def _ring_step(model, x, mask, seed=None):
    set_sequence_ring(SequenceRing(["cpu"] * N_RING))
    try:
        return _step(model, x, mask, seed)
    finally:
        set_sequence_ring(None)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("impl", RINGS)
def test_ring_policy_matches_jax(jax_ring, impl, policy, monkeypatch):
    """Each ring under each policy: the loss and every gradient against the
    JAX model's through the same ring (TOL), and the ring passes and
    products the port runs against the JAX grad's jaxpr: every policy runs
    the ring again (2 passes a layer), none keeps it."""
    counts = jax_ring["trace"](impl, policy, monkeypatch)
    assert (counts["pallas_call"], counts["dot"], counts["dot_batched"]) == (
        JAX_RING_PALLAS[impl], JAX_DOTS[None][policy], JAX_RING_BATCHED[impl])
    assert _jax_ring_passes(impl, counts["pallas_call"], counts["dot_batched"]) == 2 * L

    port = tm.MistralModel(tm.MistralConfig.tiny(lora=TLoRA(rank=4, alpha=8.0, dropout=0.0), remat=True,
                                                 remat_policy=policy, attention_impl=impl))
    sd = {k[len("model."):]: v for k, v in from_flax_params({"model": jax_ring["params"]}).items()}
    assert set(port.load_state_dict(sd, strict=False).missing_keys) <= {"embed_tokens.weight"}
    got_loss, grads, calls = _ring_step(port.train(), torch.from_numpy(jax_ring["x"]),
                                        torch.from_numpy(jax_ring["mask"]))
    want_loss, want = jax_ring["values"][impl]
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert len(grads) == 14 * L + 2 * L + 1
    for name, g in grads.items():
        w = np.asarray(want[name])
        assert np.abs(g.numpy() - w).max() <= TOL[None] * np.abs(w).max(), name
    assert _port_ring_passes(impl, calls) == _jax_ring_passes(impl, counts["pallas_call"],
                                                                counts["dot_batched"])
    assert calls["vlb.flash_fwd"] == (0 if impl != "ring_flash" else 2 * L * N_RING * (N_RING + 1) // 2)
    assert calls["aten.mm"] == counts["dot"]


@pytest.mark.parametrize("impl", RINGS)
def test_ring_policies_are_bit_equal_with_fused_dropout(impl):
    """bf16, the fused u8 adapter dropout at 0.1, one model through each
    ring switched through the policies in place: loss and gradients of
    'nothing' bit for bit; every policy runs the ring again, 'mids' and
    'flash' keep the mids (7 fewer dropout kernels a layer)."""
    rng, x, mask = _inputs(3)
    lora = TLoRA(rank=4, alpha=8.0, dropout=0.1, fused_dropout=True, dropout_bits=8)
    model = _port(None, "nothing", torch.bfloat16, lora)
    tm.set_attention_impl(model, impl)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * (0.2 if "lora_b" in name else 0.1)
                                     + (1.0 if "norm" in name else 0.0)))
    xt, mt = torch.from_numpy(x).bfloat16(), torch.from_numpy(mask)
    ref = None
    for policy in POLICIES:
        tm.set_remat_policy(model, policy)
        loss, grads, calls = _ring_step(model.train(), xt, mt, seed=5)
        if ref is None:
            ref = (loss, grads)
        assert torch.equal(loss, ref[0]) and grads.keys() == ref[1].keys()
        assert all(torch.equal(g, ref[1][n]) for n, g in grads.items()), policy
        assert _port_ring_passes(impl, calls) == 2 * L, policy
        kept = REMAT_POLICIES[policy] or set()
        assert calls["vlb.lora_dropout_fwd"] == 7 * L * (1 if "lora_mid" in kept else 2), policy
        products = 7 * L * (1 if "lora_mid" in kept or policy == "dots" else 2)
        assert calls["aten.mm"] == JAX_DOTS[None][policy] - products, policy


# ---------------------------------------------------------------------------
# The fused epilogue under each policy, at widths where every projection of
# the JAX model takes its Pallas epilogue (N >= 128, tiled): hidden 256, 2
# heads and 1 kv head of 128, MLP 256.

EPI_WIDTHS = dict(hidden_size=256, intermediate_size=256, num_attention_heads=2, num_key_value_heads=1,
                  head_dim=128)
EPI_FWD = "pallas:_fwd_kernel@lora_epilogue.py"
FLASH_FWD = "pallas:_fwd_kernel@flash_attention.py"


@pytest.fixture(scope="module")
def jax_epilogue():
    rng, _, mask = _inputs(4)
    x = rng.standard_normal((B, S, EPI_WIDTHS["hidden_size"])).astype(np.float32)

    def model(flag, policy):
        return jm.MistralModel(jm.MistralConfig.tiny(
            attention_impl="pallas", remat=True, remat_policy=policy, **EPI_WIDTHS,
            lora=JLoRA(rank=4, alpha=8.0, dropout=0.0, fused_epilogue=flag)))

    params = _randomize(jax.eval_shape(model("", "nothing").init, jax.random.key(0), x, None, mask)["params"],
                        rng)

    def grad_fn(flag, policy):
        m = model(flag, policy)
        return jax.jit(jax.value_and_grad(lambda p: jnp.mean(m.apply({"params": p}, x, None, mask) ** 2)))

    loss, g = grad_fn("", "nothing")(params)
    want = {k[len("model."):]: t for k, t in from_flax_params({"model": g}).items()}
    return {"x": x, "mask": mask, "params": params, "grad_fn": grad_fn, "values": (loss, want)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("flag", ["pallas", "fwd"])
def test_fused_epilogue_replay_matches_jax(jax_epilogue, flag, policy, monkeypatch):
    """With ``fused_epilogue`` on, the epilogue forwards and the products
    (base, adapter and, with 'fwd', dz and dB) the port runs equal the JAX
    grad's jaxpr's, whose replay runs neither the last projection's base
    product nor its epilogue (the JAX model takes its kernel only on a TPU:
    the jaxpr is traced as there, never run); the loss and gradients are
    JAX's (TOL)."""
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        counts = _jax_counts(jax_epilogue["grad_fn"](flag, policy).trace(jax_epilogue["params"]).jaxpr)
    kept = REMAT_POLICIES[policy] or set()
    assert counts[EPI_FWD] == 13 * L                    # 7 a layer, 6 in its replay
    from phantom_vlb_tpu_torch.ops import lora_epilogue as epi

    # On the CPU the kernels run their plain versions, whose products (one
    # for the forward, two for dz and dB) are the kernels' and no product of
    # JAX's: they are taken off the port's count.
    kernels = collections.Counter()
    for name in ("lora_epilogue_fwd", "lora_epilogue_dzdb"):
        real = getattr(epi, name)
        monkeypatch.setattr(epi, name, lambda *a, real=real, name=name, **k: kernels.update([name]) or real(*a, **k))
    port = tm.MistralModel(tm.MistralConfig.tiny(
        lora=TLoRA(rank=4, alpha=8.0, dropout=0.0, fused_epilogue=flag), remat=True, remat_policy=policy,
        **EPI_WIDTHS))
    sd = {k[len("model."):]: v for k, v in from_flax_params({"model": jax_epilogue["params"]}).items()}
    assert set(port.load_state_dict(sd, strict=False).missing_keys) <= {"embed_tokens.weight"}
    got_loss, grads, calls = _step(port.train(), torch.from_numpy(jax_epilogue["x"]),
                                   torch.from_numpy(jax_epilogue["mask"]))
    assert kernels["lora_epilogue_fwd"] == counts[EPI_FWD]
    assert kernels["lora_epilogue_dzdb"] == (7 * L if flag == "pallas" else 0)
    products = calls["aten.mm"] - kernels["lora_epilogue_fwd"] - 2 * kernels["lora_epilogue_dzdb"]
    assert products + calls["aten.addmm_"] == counts["dot"]             # dz and dB by addmm_ ('fwd')
    assert calls["vlb.flash_fwd"] == counts[FLASH_FWD] == L * (1 if "flash_out" in kept else 2)
    want_loss, want = jax_epilogue["values"]
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for name, g in grads.items():
        w = np.asarray(want[name])
        assert np.abs(g.numpy() - w).max() <= TOL[None] * np.abs(w).max(), name


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
