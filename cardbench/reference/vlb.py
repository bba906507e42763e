"""The VideoLLaMA2 VLB training step in plain PyTorch, f32, for the check.

Written from the model's published description and the recipe, with no
code of the program: frames (B, T, 3, H, W) through CLIP ViT-L/14-336 up to
its penultimate layer (pre-LN, quick-GELU, no post-LN, CLS dropped), the
STC connector (RegNet-Y stages around a Conv3d sampler, exact-GELU
readout), the text embedding with the video tokens spliced in at the
<video> sentinel, the Mistral decoder (RMSNorm, split-half RoPE, causal GQA
attention over the valid keys, SwiGLU) with rank-r LoRA on every projection
and its input dropout, the final norm, the HRF-pooled head (LayerNorm,
pooling, LayerNorm, dropout, ridge with an L2 penalty), the masked MSE,
the global-norm clip and AdamW on the cosine schedule.

Every product runs in f32 with TF32 off. The dropout masks are worked out
again from the step's seed: the trainer's seed stream, one seed per layer
and site by a splitmix-style mix, and from it the mask. The head's is
``torch.rand`` of a generator on the device seeded with it, kept where the
draw is below 1 - p. The adapters' mask depends on how the configuration
draws it (``lora.dropout_bits``, ``lora.fused_dropout``,
``lora.shared_dropout``): each way is a ``keep`` in a file of its own,
``dropout/<mode>.py`` (:func:`dropout_mode` names it), and a configuration
with no such file is refused. Weights come
from ``cardbench/weights.py`` block by block: each decoder layer's are made
again when the layer runs, in the forward and in the backward's replay.

``quant="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with one scale per row (per token, per output channel), the
gradients passed straight through.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cardbench.batches import VIDEO_TOKEN_ID, JOINER_POST, JOINER_PRE, Geometry
from cardbench.weights import blocks, make_block, state_spec

__all__ = ["Reference", "dropout_mode", "site_seed", "step_seeds", "uniform_keep", "weight_mask"]

_U32 = 0xFFFFFFFF
SITES = {"q_proj": 0, "k_proj": 1, "v_proj": 2, "o_proj": 3, "gate_proj": 4, "up_proj": 5, "down_proj": 6}
FP8_MAX = 448.0


def site_seed(seed: int, *parts: int) -> int:
    """A 32-bit seed for one dropout site from a step seed and integer
    parts (layer, site): a splitmix-style mix."""
    h = seed & _U32
    for p in parts:
        h = (h ^ ((p + 0x9E3779B9 + (h << 6) + (h >> 2)) & _U32)) & _U32
        h = ((h ^ (h >> 16)) * 0x85EBCA6B) & _U32
        h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _U32
        h ^= h >> 16
    return h


def step_seeds(random_state: int, n: int) -> list[int]:
    """The trainer's first ``n`` step seeds: uniform 32-bit draws of a CPU
    generator seeded with the run's ``random_state``."""
    gen = torch.Generator().manual_seed(random_state)
    return [int(torch.randint(0, 2**32, (), generator=gen)) for _ in range(n)]


def dropout_mode(lora: dict) -> str:
    """The name of the adapters' dropout, as its file ``dropout/<mode>.py``
    has it: ``unfused-32``, ``fused-8``, ``unfused-32-shared``, ..."""
    mode = f"{'fused' if lora['fused_dropout'] else 'unfused'}-{int(lora['dropout_bits'])}"
    return mode + ("-shared" if lora.get("shared_dropout", False) else "")


def _dropout_keep(lora: dict):
    """The ``keep(shape, site_seed, p, device)`` of the configuration's
    adapter dropout; raises where the reference has no file for it."""
    mode = dropout_mode(lora)
    path = Path(__file__).resolve().parent / "dropout" / f"{mode}.py"
    if not path.is_file():
        raise ValueError(f"the reference does not model the adapter dropout {mode!r}: "
                         f"it needs cardbench/reference/dropout/{mode}.py")
    spec = importlib.util.spec_from_file_location(f"cardbench.reference.dropout.{mode.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.keep


def uniform_keep(shape, seed: int, p: float, device) -> torch.Tensor:
    """A keep mask: one uniform f32 draw an element from a generator on
    the device seeded with ``seed``, kept where it is below 1 - p."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) < 1.0 - p


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale


class Reference:
    """The step of a configuration file's ``model`` group, from the weights
    ``cardbench/weights.py`` makes for ``seed``, on ``device``."""

    def __init__(self, model: dict, seed: int, device, quant: str | None = None):
        self.m, self.seed, self.device = model, seed, device
        self.t, self.v, self.c = model["text"], model["vision"], model["connector"]
        self.lora = model.get("lora") if model["trainable"] == "lora+head" else None
        self.lora_keep = None if self.lora is None else _dropout_keep(self.lora)
        self.geom = Geometry(model["geometry"])
        self.blocks = blocks(state_spec(model))
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', not {quant!r}")
        self.quant = quant

    # -- weights and products ------------------------------------------------
    def block(self, name: str) -> dict[str, torch.Tensor]:
        return {k: t.float() for k, t in make_block(self.seed, name, self.blocks[name], self.device).items()}

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand in the reference's precision (rows along the
        last axis)."""
        if self.quant is None:
            return t
        return t + (_fp8(t) - t).detach() if t.requires_grad else _fp8(t)

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b

    def attention(self, q, k, v, causal: bool, key_valid=None):
        """(B, S, H, D) q and (B, S, Hkv, D) k, v: softmax attention, one
        batch row at a time."""
        b, s, h, d = q.shape
        rep = h // k.shape[2]
        outs = []
        for i in range(b):
            qi = self.q(q[i].transpose(0, 1))                                     # (H, S, D)
            ki = self.q(k[i].transpose(0, 1).repeat_interleave(rep, dim=0))
            vi = v[i].transpose(0, 1).repeat_interleave(rep, dim=0)
            scores = qi @ ki.transpose(1, 2) / math.sqrt(d)
            allowed = torch.ones(s, s, dtype=torch.bool, device=q.device)
            if causal:
                allowed = allowed.tril()
            if key_valid is not None:
                allowed = allowed & key_valid[i][None, :]
            p = scores.masked_fill(~allowed, float("-inf")).softmax(-1)
            outs.append((self.q(p) @ self.q(vi.transpose(1, 2)).transpose(1, 2)).transpose(0, 1))
        return torch.stack(outs)

    # -- the frozen towers ---------------------------------------------------
    @staticmethod
    def layer_norm(x, w, b, eps):
        return F.layer_norm(x, x.shape[-1:], w, b, eps)

    def clip(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) -> the selected layer's patch features (N, P, C)."""
        v, eps = self.v, self.v["layer_norm_eps"]
        w = {}
        for name in ("vision_tower", "vision_tower.patch_embedding", "vision_tower.pre_layrnorm"):
            w.update(self.block(name))
        patches = F.conv2d(self.q(frames), self.q(w["vision_tower.patch_embedding.weight"]),
                           stride=v["patch_size"]).flatten(2).transpose(1, 2)
        n, e = patches.shape[0], v["hidden_size"]
        cls = w["vision_tower.class_embedding"].expand(n, 1, e)
        x = torch.cat([cls, patches], 1) + w["vision_tower.position_embedding"]
        x = self.layer_norm(x, w["vision_tower.pre_layrnorm.weight"], w["vision_tower.pre_layrnorm.bias"], eps)
        layers = v["num_hidden_layers"] + v["select_layer"] + 1 if v["select_layer"] < 0 else v["select_layer"]
        heads = v["num_attention_heads"]
        for i in range(layers):
            pre = f"vision_tower.layers.{i}"
            lw = self.block(pre)

            def lin(name, t):
                return self.linear(t, lw[f"{pre}.{name}.weight"], lw[f"{pre}.{name}.bias"])

            h = self.layer_norm(x, lw[f"{pre}.layer_norm1.weight"], lw[f"{pre}.layer_norm1.bias"], eps)
            split = (n, h.shape[1], heads, e // heads)
            a = self.attention(lin("self_attn.q_proj", h).view(split), lin("self_attn.k_proj", h).view(split),
                               lin("self_attn.v_proj", h).view(split), causal=False)
            x = x + lin("self_attn.out_proj", a.reshape(n, -1, e))
            h = self.layer_norm(x, lw[f"{pre}.layer_norm2.weight"], lw[f"{pre}.layer_norm2.bias"], eps)
            h = lin("mlp.fc1", h)
            x = x + lin("mlp.fc2", h * torch.sigmoid(1.702 * h))
        return x[:, 1:]

    def _conv1x1(self, x, w, b=None):
        return self.linear(x, w[:, :, 0, 0], b)

    def _bottleneck(self, x, pre: str, cin: int, cout: int):
        w = self.block(pre)

        def ln(t, name):
            return self.layer_norm(t, w[f"{pre}.{name}.weight"], w[f"{pre}.{name}.bias"], 1e-5)

        h = F.silu(ln(self._conv1x1(x, w[f"{pre}.conv1.weight"]), "norm1"))
        h = F.conv2d(self.q(h.permute(0, 3, 1, 2)), self.q(w[f"{pre}.conv2.weight"]), padding=1,
                     groups=cout).permute(0, 2, 3, 1)
        h = F.silu(ln(h, "norm2"))
        a = F.silu(self._conv1x1(h.mean(dim=(1, 2), keepdim=True), w[f"{pre}.se.fc1.weight"],
                                 w[f"{pre}.se.fc1.bias"]))
        h = h * torch.sigmoid(self._conv1x1(a, w[f"{pre}.se.fc2.weight"], w[f"{pre}.se.fc2.bias"]))
        h = ln(self._conv1x1(h, w[f"{pre}.conv3.weight"]), "norm3")
        shortcut = ln(self._conv1x1(x, w[f"{pre}.downsample_conv.weight"]), "downsample_norm") if cin != cout else x
        return F.silu(h + shortcut)

    def stc(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, g, g, C_enc) -> (B, T' g' g', E) video tokens."""
        c, ch = self.c, self.c["hidden_size"]
        b, t, g, _, cin = feats.shape
        x = feats.reshape(b * t, g, g, cin)
        for j in range(c["depth"]):
            x = self._bottleneck(x, f"mm_projector.s1.b{j + 1}", cin if j == 0 else ch, ch)
        x = x.reshape(b, t, g, g, ch)
        w = self.block("mm_projector.sampler_conv")
        x = F.conv3d(self.q(x.permute(0, 4, 1, 2, 3)), self.q(w["mm_projector.sampler_conv.weight"]),
                     w["mm_projector.sampler_conv.bias"], stride=2, padding=1).permute(0, 2, 3, 4, 1)
        x = F.silu(x)
        _, td, hd, wd, _ = x.shape
        x = x.reshape(b * td, hd, wd, ch)
        for j in range(c["depth"]):
            x = self._bottleneck(x, f"mm_projector.s2.b{j + 1}", ch, ch)
        for k in range(c["mlp_depth"]):
            w = self.block(f"mm_projector.readout.{k}")
            if k:
                x = F.gelu(x)
            x = self.linear(x, w[f"mm_projector.readout.{k}.weight"], w[f"mm_projector.readout.{k}.bias"])
        return x.reshape(b, td * hd * wd, -1)

    @torch.no_grad()
    def video_tokens(self, frames: torch.Tensor) -> torch.Tensor:
        b, t = frames.shape[:2]
        feats = self.clip(frames.reshape(b * t, *frames.shape[2:]))
        g = self.v["image_size"] // self.v["patch_size"]
        return self.stc(feats.reshape(b, t, g, g, -1))

    # -- the decoder -----------------------------------------------------------
    def embed(self, language: torch.Tensor, video: torch.Tensor):
        """Text embeddings with the video tokens at the sentinel -> (embeds
        (B, S, E), key validity (B, S): text keys with id 0 are not valid)."""
        emb = self.block("model.embed_tokens")["model.embed_tokens.weight"]
        ids = language.long()
        rows, valid = [], []
        for i in range(ids.shape[0]):
            p = int((ids[i] == VIDEO_TOKEN_ID).nonzero()[0])
            text = emb[ids[i].clamp(0, emb.shape[0] - 1)]
            rows.append(torch.cat([text[:p], video[i], text[p + 1:]]))
            ok = ids[i] != 0
            valid.append(torch.cat([ok[:p], torch.ones(video.shape[1], dtype=torch.bool, device=ids.device),
                                    ok[p + 1:]]))
        return torch.stack(rows), torch.stack(valid)

    def rope(self, s: int):
        d = self.t["head_dim"]
        inv = 1.0 / (self.t["rope_theta"] ** (torch.arange(0, d, 2, dtype=torch.float32, device=self.device) / d))
        ang = torch.arange(s, device=self.device, dtype=torch.float32)[:, None] * inv
        return torch.cos(ang), torch.sin(ang)

    @staticmethod
    def apply_rope(x, cos, sin):
        """(B, S, H, D), split-half rotation."""
        x1, x2 = x.chunk(2, dim=-1)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def rms_norm(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.t["rms_norm_eps"]) * w

    def proj(self, x, w: dict, name: str, adapters: dict | None, layer_seed: int | None):
        y = self.linear(x, w[f"{name}.weight"])
        if adapters is None:
            return y
        lora, site = self.lora, name.rsplit(".", 1)[-1]
        xd = x
        if layer_seed is not None and lora["dropout"] > 0:
            keep = self.lora_keep(x.shape, site_seed(layer_seed, SITES[site]), lora["dropout"], x.device)
            xd = torch.where(keep, x / (1.0 - lora["dropout"]), 0.0)
        z = self.q(xd) @ self.q(adapters[f"{name}.lora_a"])
        return y + (self.q(z) @ self.q(adapters[f"{name}.lora_b"])) * (lora["alpha"] / lora["r"])

    def layer(self, x, i: int, rope, key_valid, adapters, layer_seed):
        pre, t = f"model.layers.{i}", self.t
        w = self.block(pre)
        b, s, _ = x.shape
        hq, hkv, d = t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"]
        h = self.rms_norm(x, w[f"{pre}.input_layernorm.weight"])
        att = f"{pre}.self_attn"
        q = self.apply_rope(self.proj(h, w, f"{att}.q_proj", adapters, layer_seed).view(b, s, hq, d), *rope)
        k = self.apply_rope(self.proj(h, w, f"{att}.k_proj", adapters, layer_seed).view(b, s, hkv, d), *rope)
        v = self.proj(h, w, f"{att}.v_proj", adapters, layer_seed).view(b, s, hkv, d)
        a = self.attention(q, k, v, causal=True, key_valid=key_valid).reshape(b, s, hq * d)
        x = x + self.proj(a, w, f"{att}.o_proj", adapters, layer_seed)
        h = self.rms_norm(x, w[f"{pre}.post_attention_layernorm.weight"])
        mlp = f"{pre}.mlp"
        g = self.proj(h, w, f"{mlp}.gate_proj", adapters, layer_seed)
        u = self.proj(h, w, f"{mlp}.up_proj", adapters, layer_seed)
        return x + self.proj(F.silu(g) * u, w, f"{mlp}.down_proj", adapters, layer_seed)

    def decoder(self, embeds, key_valid, adapters, seed):
        """Post-norm hidden states; each layer is replayed in the backward
        (its inputs kept, its weights made again)."""
        rope = self.rope(embeds.shape[1])
        x = embeds
        for i in range(self.t["num_hidden_layers"]):
            layer_seed = None if seed is None else site_seed(seed, i)
            if torch.is_grad_enabled():
                x = checkpoint(self.layer, x, i, rope, key_valid, adapters, layer_seed, use_reentrant=False)
            else:
                x = self.layer(x, i, rope, key_valid, adapters, layer_seed)
        return self.rms_norm(x, self.block("model.norm")["model.norm.weight"])

    # -- the head and the loss -------------------------------------------------
    def head(self, hidden, wmask, params: dict, seed):
        h = self.m["head"]
        x = self.layer_norm(hidden, params["head.layer_norm1.weight"], params["head.layer_norm1.bias"], 1e-6)
        pooled = torch.einsum("bse,bs->be", x, wmask)
        pooled = self.layer_norm(pooled, params["head.layer_norm2.weight"], params["head.layer_norm2.bias"], 1e-6)
        p = h["dropout_rate"]
        if seed is not None and p > 0:
            keep = uniform_keep(pooled.shape, site_seed(seed, self.t["num_hidden_layers"]), p, pooled.device)
            pooled = torch.where(keep, pooled / (1.0 - p), 0.0)
        w = params["head.ridge.linear.weight"]
        return self.linear(pooled, w, params["head.ridge.linear.bias"]), h["l2_lambda"] * w.square().sum()

    def loss(self, batch: dict, params: dict, seed: int):
        """The step's loss on ``batch`` (tensors on the device) with the
        trainable tensors ``params``."""
        dev = self.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        video = self.video_tokens(batch["vision"])
        language = batch["language"]
        adapters = params if self.lora is not None else None
        with torch.set_grad_enabled(self.lora is not None and torch.is_grad_enabled()):
            with torch.no_grad():
                embeds, key_valid = self.embed(language, video)
            hidden = self.decoder(embeds, key_valid, adapters, seed)
        wmask = weight_mask(batch["padvals"], batch["vis_weights"], batch["lang_weights"], self.geom)
        pred, l2 = self.head(hidden, wmask, params, seed)
        y, m = batch["timeseries"], batch["row_mask"]
        mse = ((pred - y).square() * m[:, None]).sum() / (m.sum().clamp_min(1.0) * y.shape[1])
        return mse + l2

    def trainable(self) -> dict[str, torch.Tensor]:
        """The trainable tensors' starting values, f32 leaves."""
        out = {}
        for name, entries in self.blocks.items():
            names = [n for n, _, _ in entries if n.startswith("head.") or n.endswith((".lora_a", ".lora_b"))]
            if self.lora is None:
                names = [n for n in names if n.startswith("head.")]
            if names:
                made = self.block(name)
                out.update({n: made[n].clone().requires_grad_() for n in names})
        return out

    def train(self, batches: list[dict], seeds: list[int]) -> dict:
        """Steps on ``batches`` with dropout seeds ``seeds`` -> each step's
        loss, each leaf's clipped gradient norm at the first step, and each
        leaf's change over the steps."""
        o = self.m["optim"]
        params = self.trainable()
        start = {n: p.detach().clone() for n, p in params.items()}
        m1 = {n: torch.zeros_like(p) for n, p in params.items()}
        m2 = {n: torch.zeros_like(p) for n, p in params.items()}
        b1, b2 = o["betas"]
        losses, grad_norms = [], {}
        for step, (batch, seed) in enumerate(zip(batches, seeds)):
            loss = self.loss(batch, params, seed)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            scale = o["grad_clip"] / norm if norm >= o["grad_clip"] else 1.0
            grads = [g * scale for g in grads]
            if step == 0:
                grad_norms = {n: float(g.norm()) for n, g in zip(params, grads)}
            lr = o["lr"] * (1.0 + math.cos(math.pi * step / o["t_max"])) / 2.0
            with torch.no_grad():
                for (n, p), g in zip(params.items(), grads):
                    p.mul_(1.0 - lr * o["weight_decay"])
                    m1[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    m2[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = (m2[n] / (1.0 - b2 ** (step + 1))).sqrt() + o["eps"]
                    p.addcdiv_(m1[n], denom, value=-lr / (1.0 - b1 ** (step + 1)))
            losses.append(float(loss.detach()))
        change = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
        return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}


def weight_mask(padvals, vis_weights, lang_weights, geom: Geometry) -> torch.Tensor:
    """(B, S) HRF weights over the multimodal sequence: the vision weights
    over each downsampled frame's tokens, the dialogue's over its tokens,
    zeros elsewhere (the left padding, the joiners, the instruction, the
    right padding)."""
    rows = []
    for pv, vw, lw in zip(padvals.long().tolist(), vis_weights.float(), lang_weights.float()):
        pad_len, inst_len, diag_len = pv
        v = geom.num_vis_tokens
        pad_left = geom.feature_len - (v + JOINER_PRE + inst_len + diag_len + JOINER_POST + pad_len)
        row = torch.zeros(geom.feature_len, device=vw.device)
        lo = max(pad_left, 0)
        frames = (torch.arange(lo, pad_left + v, device=vw.device) - pad_left) // geom.tokens_per_frame
        row[lo:pad_left + v] = vw[frames]
        start = pad_left + v + JOINER_PRE + inst_len
        row[start:start + diag_len] = lw[:diag_len]
        rows.append(row)
    return torch.stack(rows)
