"""Port parity: context-parallel ring attention against the JAX package.

The JAX side runs on the 8-device virtual CPU mesh of ``tests/conftest.py``
(a ``sequence`` axis of 2 or 4), its Pallas kernels in interpret mode (the
ring kernel's remote copies and semaphores simulated); the port's side on a
:class:`SequenceRing` of CPU ranks, where every kernel wrapper runs its plain
version. Inputs come from numpy with a seed and go to both sides in f32.

Tolerances, the JAX ring tests' own (``tests/test_ring_fused.py``): 2e-3 on
forward outputs (out, lse, the loss), 5e-3 on gradients, each times the
largest reference value (the same f32 arithmetic over other tiles and in
another order). The tiny VLB step is held to ``tests/test_torch_train_step.py``'s
1e-5 (loss) and 1e-4 x max|g| (gradients): nothing but summation order
differs there.
"""

import dataclasses

import jax
import jax.ad_checkpoint  # noqa: F401  (the JAX flash forward names its residuals through it)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from phantom_vlb_tpu.core.mesh import MeshConfig, build_mesh
from phantom_vlb_tpu.models import videollama2 as jv
from phantom_vlb_tpu.ops import context_parallel as jcp
from phantom_vlb_tpu.ops import flash_attention as jfa
from phantom_vlb_tpu.ops import ring_fused as jrf
from phantom_vlb_tpu.train.optim import trainable_labels
from phantom_vlb_tpu.train.step import _masked_mse, combine_params, partition_params
from phantom_vlb_tpu_torch.core.mesh import SequenceRing, get_sequence_ring, set_sequence_ring
from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY, synth_language_row
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.models.mistral import MistralConfig, MistralModel, set_attention_impl
from phantom_vlb_tpu_torch.ops.context_parallel import ring_attention, ring_flash_attention
from phantom_vlb_tpu_torch.ops.flash_attention import (
    attention_packed_bwd,
    attention_packed_plain,
    attention_with_stats,
)
from phantom_vlb_tpu_torch.ops.ring_fused import ring_flash_fused, ring_fwd, ring_fwd_plain, ring_send_plan
from phantom_vlb_tpu_torch.train.step import loss_fn

FWD_TOL, GRAD_TOL = 2e-3, 5e-3
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-5, 1e-4
D = 128
HQ, HKV = 4, 2


def _qkv(seed, b=1, s=256, hq=HQ, hkv=HKV, valid=None):
    """Packed f32 (B, S, H*D) q, k, v, a cotangent shaped as q, and a kv mask
    (None, or keys at and past ``valid`` masked)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq * D)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv * D)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv * D)).astype(np.float32)
    do = rng.standard_normal((b, s, hq * D)).astype(np.float32)
    mask = None if valid is None else (np.arange(s)[None] < np.asarray(valid)[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _heads_first(x, h):
    """(B, S, H*D) numpy -> (B, H, S, D) jax: the reference's layout."""
    b, s, _ = x.shape
    return jnp.asarray(x.reshape(b, s, h, -1).transpose(0, 2, 1, 3))


def _packed(x):
    """(B, H, S, D) jax -> (B, S, H*D) numpy."""
    x = np.asarray(x)
    b, h, s, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, s, h * d)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sequence",))


def _ring(n):
    return SequenceRing(["cpu"] * n)


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


# (a) the flash forward and backward with a causal offset ---------------------

@pytest.mark.parametrize("offset", [0, 64, 100, 256])
def test_flash_with_causal_offset_matches_jax(offset):
    """Forward (out, lse) against the reference's ``attention_with_stats``
    and the backward against ``_bwd_impl`` (the ring backward's call,
    ``context_parallel.py:229``), both with ``causal_offset``."""
    s = 256
    q, k, v, do, mask = _qkv(offset, s=s, valid=[200])
    jq, jk, jv_, jdo = _heads_first(q, HQ), _heads_first(k, HKV), _heads_first(v, HKV), _heads_first(do, HQ)
    jm = jnp.asarray(mask)
    j_out, j_lse = jfa.attention_with_stats(jq, jk, jv_, kv_mask=jm, causal_offset=offset,
                                            interpret=True)
    tq, tk, tv_, tdo, tm = _torch(q, k, v, do, mask)
    out, lse = attention_with_stats(tq, tk, tv_, HQ, HKV, kv_mask=tm, causal_offset=offset)
    _close(out.numpy(), _packed(j_out), FWD_TOL)
    _close(lse.numpy(), j_lse, FWD_TOL)

    bq, bk = min(512, s), jfa._pick_kv_block(s, 1664)
    bias = jfa._kv_bias(jm, 1, s, -(-s // bk) * bk)
    j_grads = jfa._bwd_impl(jq, jk, jv_, bias, True, j_out, j_lse, jdo, True, 1.0 / np.sqrt(D),
                            bq, bk, True, offset)
    grads = attention_packed_bwd(tq, tk, tv_, torch.from_numpy(_packed(j_out)),
                                 torch.from_numpy(np.array(j_lse)), tdo, HQ, HKV, kv_mask=tm,
                                 causal_offset=offset)
    for g, jg in zip(grads, j_grads):
        _close(g.numpy(), _packed(jg), GRAD_TOL)


# (b) the plain ring ------------------------------------------------------------

def test_ring_attention_matches_jax_on_four_ranks(cpu_devices):
    env = build_mesh(MeshConfig(data=1, fsdp=1, tensor=1, sequence=4), cpu_devices[:4])
    q, k, v, do, mask = _qkv(1, b=2, valid=[256, 170])
    jm = jnp.asarray(mask)

    @jax.jit
    def jloss(q_, k_, v_):
        out = jcp.ring_attention(q_, k_, v_, env, causal=True, kv_mask=jm)
        return jnp.sum(out * _heads_first(do, HQ)), out

    (_, j_out), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        _heads_first(q, HQ), _heads_first(k, HKV), _heads_first(v, HKV))
    tq, tk, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring_attention(tq, tk, tv_, HQ, HKV, _ring(4), kv_mask=torch.from_numpy(mask))
    grads = torch.autograd.grad(out, (tq, tk, tv_), torch.from_numpy(do))
    _close(out.detach().numpy(), _packed(j_out), FWD_TOL)
    for g, jg in zip(grads, j_grads):
        _close(g.numpy(), _packed(jg), GRAD_TOL)


# (c) the per-step flash ring ---------------------------------------------------

def test_ring_flash_attention_matches_jax(cpu_devices):
    env = build_mesh(MeshConfig(data=1, fsdp=1, tensor=1, sequence=2), cpu_devices[:2])
    q, k, v, do, mask = _qkv(2, valid=[230])
    jm = jnp.asarray(mask)

    @jax.jit
    def jloss(q_, k_, v_):
        out = jcp.ring_flash_attention(q_, k_, v_, env, causal=True, kv_mask=jm, interpret=True)
        return jnp.sum(out * _heads_first(do, HQ)), out

    (_, j_out), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        _heads_first(q, HQ), _heads_first(k, HKV), _heads_first(v, HKV))
    tq, tk, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring_flash_attention(tq, tk, tv_, HQ, HKV, _ring(2), kv_mask=torch.from_numpy(mask))
    grads = torch.autograd.grad(out, (tq, tk, tv_), torch.from_numpy(do))
    _close(out.detach().numpy(), _packed(j_out), FWD_TOL)
    for g, jg in zip(grads, j_grads):
        _close(g.numpy(), _packed(jg), GRAD_TOL)


# (d) the fused ring forward ----------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "padded_tail"])
def test_ring_fwd_matches_jax(n, masked):
    """(out, lse) of ``ring_fwd`` (its plain version on CPU tensors) against
    ``ring_fwd_sharded`` in interpret mode; padded keys as a masked tail."""
    q, k, v, _, mask = _qkv(3 + n, valid=[200] if masked else None)
    jm = None if mask is None else jnp.asarray(mask)
    mesh = _mesh(n)
    j_out, j_lse = jax.jit(lambda a, b, c: jrf.ring_fwd_sharded(
        a, b, c, jm, mesh, "sequence", causal=True, interpret=True))(
        _heads_first(q, HQ), _heads_first(k, HKV), _heads_first(v, HKV))
    tq, tk, tv_, tm = _torch(q, k, v, mask)
    out, lse = ring_fwd(tq, tk, tv_, HQ, HKV, _ring(n), kv_mask=tm)
    _close(out.numpy(), _packed(j_out), FWD_TOL)
    _close(lse.numpy(), j_lse, FWD_TOL)
    plain = ring_fwd_plain(tq, tk, tv_, HQ, HKV, _ring(n), kv_mask=tm)
    assert torch.equal(out, plain[0]) and torch.equal(lse, plain[1])


def _replay_send_plan(n):
    """Replays ``ring_send_plan(n)`` on numpy chunks: rank i's local chunk
    holds i; a send copies the sender's local chunk (step 0) or its slot
    r - 1 (step r), which must have been written by then, into the right
    neighbour's slot. Returns the slots (-1 where nothing landed) and the
    plan."""
    plan = ring_send_plan(n)
    slots = np.full((n, max(n - 1, 1)), -1)
    for r, i, slot in plan:
        if r == 0:
            chunk = i
        else:
            chunk = slots[i, r - 1]
            assert chunk >= 0, f"send {(r, i, slot)} forwards slot {r - 1} of rank {i} before it landed"
        slots[(i + 1) % n, slot] = chunk
    return slots, plan


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_send_plan_delivers_every_chunk_a_rank_reads(n):
    """At its step r (1 <= r <= my) rank my reads slot r - 1, which must
    hold the chunk of rank my - r once the pass's sends have run."""
    slots, _ = _replay_send_plan(n)
    for my in range(n):
        for r in range(1, my + 1):
            assert slots[my, r - 1] == my - r, (my, r, slots[my])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_send_plan_sends_only_chunks_some_rank_reads(n):
    """n(n-1)/2 sends, in step order, each into a slot its receiver reads
    (slot <= receiver - 1), none past rank n - 1, and no slot written twice."""
    _, plan = _replay_send_plan(n)
    assert len(plan) == n * (n - 1) // 2
    assert [r for r, _, _ in plan] == sorted(r for r, _, _ in plan)
    targets = [((i + 1) % n, slot) for _, i, slot in plan]
    assert len(set(targets)) == len(targets)
    for (r, i, slot), (receiver, _) in zip(plan, targets):
        assert slot == r and receiver == i + 1 and slot <= receiver - 1


# (e) the trainable fused ring ---------------------------------------------------

def test_ring_flash_fused_gradients_match_jax():
    q, k, v, do, mask = _qkv(9, valid=[220])
    jm = jnp.asarray(mask)
    mesh = _mesh(2)

    @jax.jit
    def jloss(q_, k_, v_):
        out = jrf.ring_flash_fused(q_, k_, v_, mesh, "sequence", causal=True, kv_mask=jm,
                                   interpret=True)
        return jnp.sum(out * _heads_first(do, HQ)), out

    (_, j_out), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        _heads_first(q, HQ), _heads_first(k, HKV), _heads_first(v, HKV))
    tq, tk, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring_flash_fused(tq, tk, tv_, HQ, HKV, _ring(2), kv_mask=torch.from_numpy(mask))
    grads = torch.autograd.grad(out, (tq, tk, tv_), torch.from_numpy(do))
    _close(out.detach().numpy(), _packed(j_out), FWD_TOL)
    for g, jg in zip(grads, j_grads):
        _close(g.numpy(), _packed(jg), GRAD_TOL)


# (f) the tiny VLB LoRA step through the fused ring -----------------------------

def _randomize(tree, rng):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _randomize(val, rng)
        elif key in ("weight", "scale"):
            out[key] = (1.0 + 0.1 * rng.standard_normal(val.shape)).astype(np.float32)
        elif key in ("kernel", "lora_a"):
            out[key] = (rng.standard_normal(val.shape) / np.sqrt(val.shape[0])).astype(np.float32)
        elif key == "lora_b":
            out[key] = (0.1 * rng.standard_normal(val.shape)).astype(np.float32)
        else:
            out[key] = (0.5 * rng.standard_normal(val.shape)).astype(np.float32)
    return out


def _batch(rng, b):
    g = TEST_GEOMETRY
    rows = [synth_language_row(g, rng, (i + 1) * g.tr) for i in range(b)]
    return {
        "language": np.stack([r[0] for r in rows]).astype(np.int32),
        "vision": rng.standard_normal((b, g.num_vis_tokens, 64)).astype(np.float32),
        "padvals": np.stack([r[2] for r in rows]).astype(np.int32),
        "vis_weights": rng.uniform(0, 0.3, (b, g.num_ds_frames)).astype(np.float32),
        "lang_weights": rng.uniform(0, 0.3, (b, g.onsets_width)).astype(np.float32),
        "timeseries": rng.standard_normal((b, g.num_parcels)).astype(np.float32),
        "row_mask": np.ones(b, np.float32),
    }


def test_tiny_lora_step_through_the_fused_ring_matches_jax(cpu_devices):
    """Loss and every adapter and head gradient of the tiny VLB LoRA step
    with ``attention_impl='ring_fused'``: the port on a 2-rank CPU ring, JAX
    on a sequence axis of 2, the same seeded weights (``from_flax_params``)
    and batch, no dropout."""
    base = jv.VLBConfig.tiny(use_lora=True, dropout_rate=0.0)
    jcfg = dataclasses.replace(base, mistral=dataclasses.replace(base.mistral,
                                                                 attention_impl="ring_fused"))
    batch = _batch(np.random.default_rng(21), 2)
    params = jax.eval_shape(jv.VideoLLaMA2VLB(base).init, jax.random.key(0), batch["language"],
                            batch["vision"], batch["padvals"], batch["vis_weights"],
                            batch["lang_weights"])["params"]
    params = _randomize(params, np.random.default_rng(22))
    trainable, frozen = partition_params(params, trainable_labels(params, jv.trainable_predicate))
    forward = jv.vlb_forward_fn(jv.VideoLLaMA2VLB(jcfg))
    jb = {key: jnp.asarray(val) for key, val in batch.items()}

    @jax.jit
    def jloss(tr):
        pred, l2 = forward(combine_params(tr, frozen), jb, jax.random.key(0), True)
        return _masked_mse(pred, jb["timeseries"], jb["row_mask"]) + l2

    jcp.set_sequence_mesh(build_mesh(MeshConfig(data=1, fsdp=1, tensor=1, sequence=2),
                                     cpu_devices[:2]))
    try:
        loss_j, grads_j = jax.value_and_grad(jloss)(trainable)
    finally:
        jcp.set_sequence_mesh(None)
    full = jax.tree.map(lambda g, p: np.asarray(np.zeros_like(p) if g is None else g), grads_j,
                        params, is_leaf=lambda x: x is None)
    grads_j = from_flax_params(full)

    cfg = tv.VLBConfig.tiny(use_lora=True, dropout_rate=0.0)
    cfg = dataclasses.replace(cfg, mistral=dataclasses.replace(cfg.mistral, attention_impl="ring_fused"))
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, from_flax_params(params))
    tv.trainable_parameters(model)
    model.train()
    set_sequence_ring(_ring(2))
    try:
        loss = loss_fn(model, {key: torch.from_numpy(val) for key, val in batch.items()}, seed=0)[0]
        loss.backward()
    finally:
        set_sequence_ring(None)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=STEP_LOSS_TOL)
    names = [name for name, p in model.named_parameters() if p.requires_grad]
    assert any("lora_" in name for name in names)
    for name, p in model.named_parameters():
        if p.requires_grad:
            want = grads_j[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), want, atol=STEP_GRAD_TOL * np.abs(want).max(),
                                       rtol=0, err_msg=name)


# The port's own: the ring implementations in the model, and their plumbing ---

@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ring_fused"])
def test_mistral_ring_impls_match_the_packed_path(impl):
    """A 2-layer model with a padded tail: each ring on a 4-rank CPU ring
    gives the packed path's hidden states on the valid rows, and the
    adapters' gradients (f32; summation order only, 1e-5 x max)."""
    from phantom_vlb_tpu_torch.models.convert import init_params
    from phantom_vlb_tpu_torch.models.lora import LoRAConfig

    cfg = tv.VLBConfig.tiny(use_lora=True)
    sd = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for key in sd:
        if key.endswith("lora_b"):
            sd[key] = 0.1 * torch.randn(sd[key].shape, generator=torch.Generator().manual_seed(4))
    mcfg = MistralConfig.tiny(vocab_size=1000, lora=LoRAConfig(rank=4, alpha=8.0, dropout=0.0))
    rng = np.random.default_rng(5)
    embeds = torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(np.float32))
    mask = torch.ones(2, 64, dtype=torch.int32)
    mask[1, 50:] = 0
    # A random cotangent: the final norm makes a sum of squares nearly flat.
    cot = torch.from_numpy(rng.standard_normal((2, 50, 64)).astype(np.float32))
    results = []
    for attention in ("auto", impl):
        with torch.device("meta"):
            model = MistralModel(dataclasses.replace(mcfg, attention_impl=attention))
        model.load_state_dict({key[len("model."):]: val for key, val in sd.items()
                               if key.startswith("model.")}, strict=True, assign=True)
        for name, p in model.named_parameters():
            p.requires_grad_("lora_" in name)
        set_sequence_ring(_ring(4))
        try:
            hidden = model(embeds, kv_mask=mask)
        finally:
            set_sequence_ring(None)
        (hidden[:, :50] * cot).sum().backward()
        results.append((hidden.detach(), {n: p.grad for n, p in model.named_parameters()
                                          if p.requires_grad}))
    (h_ref, g_ref), (h_ring, g_ring) = results
    _close(h_ring[:, :50].numpy(), h_ref[:, :50].numpy(), 1e-5)
    for name, g in g_ref.items():
        _close(g_ring[name].numpy(), g.numpy(), 1e-5)


def test_set_attention_impl_switches_a_built_model_in_place():
    from phantom_vlb_tpu_torch.models.convert import init_params

    cfg = tv.VLBConfig.tiny()
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, device="cpu"))
    weights = {name: p for name, p in model.named_parameters()}
    set_attention_impl(model, "ring_fused")
    assert model.cfg.mistral.attention_impl == "ring_fused"
    assert all(layer.self_attn.cfg.attention_impl == "ring_fused" for layer in model.model.layers)
    assert all(p is weights[name] for name, p in model.named_parameters())
    with pytest.raises(ValueError, match="attention_impl"):
        MistralConfig.tiny(attention_impl="pallas")


def test_the_ring_must_be_set_and_must_divide_the_sequence():
    set_sequence_ring(None)
    with pytest.raises(RuntimeError, match="set_sequence_ring"):
        get_sequence_ring()
    q, k, v, _, _ = _qkv(0, s=96)
    tq, tk, tv_ = _torch(q, k, v)
    with pytest.raises(ValueError, match="divide"):
        ring_fwd(tq, tk, tv_, HQ, HKV, _ring(5))
    with pytest.raises(ValueError, match="CPU ranks"):
        ring_fwd(tq, tk, tv_, HQ, HKV, SequenceRing(["cpu", "meta"]))
    want = attention_packed_plain(tq, tk, tv_, HQ, HKV)[0]
    for fn in (ring_attention, ring_flash_attention, ring_flash_fused):
        assert torch.equal(fn(tq, tk, tv_, HQ, HKV, _ring(1)), want)     # one rank: plain attention
