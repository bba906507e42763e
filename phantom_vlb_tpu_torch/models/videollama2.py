"""VideoLLaMA2-VLB: the forward, served or trained, from raw frames or cached tokens.

Counterpart of ``phantom_vlb_tpu/models/videollama2.py``::

  frames (B, T, 3, H, W) -> CLIP ViT-L/14-336 (frozen) -> (B, T, 24, 24, 1024)
    -> STC connector (frozen) -> (B, 1183, 4096) video tokens
  text ids (B, Lt) with one <video> sentinel (id -201)
    -> embed -> splice the (B, V, E) video tokens in at the sentinel
    -> (B, Lt - 1 + V, E) -> Mistral decoder -> post-norm hidden states
    -> HRF weight mask + brain readout head -> (preds (B, P), l2 penalty)

``video`` is raw frames (rank 5, through :meth:`VideoLLaMA2VLB.encode_video`,
:150-162) or precomputed video tokens (rank 3, the token cache's, :183-186).

Training follows the reference's two regimes (:176-199, :237-242): the
vision tower and connector always run without recording gradients (the
counterpart of ``stop_gradient``), and the text embeddings and video tokens
enter cut from the graph; in the frozen-baseline regime
(``freeze_backbone``) the whole backbone runs without recording gradients,
so only the head trains; with LoRA the adapters train too.
:func:`trainable_predicate` names what trains. In train mode the head's
dropout and the adapters' dropout are live, with masks from the step seed
passed to :meth:`VideoLLaMA2VLB.forward`.

A model loaded from a state dict without the towers' tensors (a Flax tree
initialised on cached tokens has none, as the reference's towers are
created lazily) has no towers and takes cached tokens only.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from phantom_vlb_tpu_torch.core.geometry import VIDEO_TOKEN_ID, VLBGeometry
from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY
from phantom_vlb_tpu_torch.models.clip_vit import CLIPVisionConfig, CLIPVisionTower
from phantom_vlb_tpu_torch.models.heads import BrainReadoutHead
from phantom_vlb_tpu_torch.models.lora import LoRAConfig, is_lora_path, site_seed
from phantom_vlb_tpu_torch.models.mistral import MistralConfig, MistralModel
from phantom_vlb_tpu_torch.models.stc_connector import STCConfig, STCConnector
from phantom_vlb_tpu_torch.ops.weight_mask import build_weight_mask
from phantom_vlb_tpu_torch.utils.profiling import span

__all__ = ["VLBConfig", "VideoLLaMA2VLB", "splice_multimodal", "trainable_predicate",
           "trainable_parameters", "stored_dtype", "is_norm", "VISION_PREFIXES"]

# State-dict prefixes of the frozen vision path: the tower and the connector.
VISION_PREFIXES = ("vision_tower.", "mm_projector.")


@dataclasses.dataclass(frozen=True)
class VLBConfig:
    clip: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    stc: STCConfig = dataclasses.field(default_factory=STCConfig)
    mistral: MistralConfig = dataclasses.field(default_factory=MistralConfig)
    geometry: VLBGeometry = dataclasses.field(default_factory=VLBGeometry)
    num_target: int = 1000
    l2_lambda: float = 0.001
    dropout_rate: float = 0.1
    freeze_backbone: bool = True    # baseline regime: only the head trains

    def validate(self) -> None:
        g = self.geometry
        g.validate()
        if (self.clip.image_size, self.clip.patch_size) != (g.image_size, g.patch_size):
            raise ValueError(f"the tower's {self.clip.image_size} px / {self.clip.patch_size} "
                             f"patches do not match the geometry's {g.image_size} / {g.patch_size}")
        if self.stc.encoder_hidden_size != self.clip.hidden_size:
            raise ValueError("the connector's input width must be the tower's")
        if self.stc.output_hidden_size != self.mistral.hidden_size:
            raise ValueError("the connector's output width must be the decoder's")

    @staticmethod
    def full(use_lora: bool = False, base_quant: str | None = None, **overrides) -> "VLBConfig":
        """The production VideoLLaMA2-7B geometry, bf16 throughout; with
        ``use_lora`` the reference's adapters (r 16, alpha 32, dropout 0.1);
        ``base_quant`` stores the frozen projections of the decoder and of
        the vision tower int8 (``phantom_vlb_tpu/train/builder.py:122-131``)."""
        base = dict(mistral=MistralConfig(lora=LoRAConfig() if use_lora else None,
                                          base_quant=base_quant),
                    clip=CLIPVisionConfig(base_quant=base_quant), stc=STCConfig(),
                    freeze_backbone=not use_lora)
        base.update(overrides)
        cfg = VLBConfig(**base)
        cfg.validate()
        return cfg

    @staticmethod
    def tiny(use_lora: bool = False, base_quant: str | None = None, **overrides) -> "VLBConfig":
        """The reference's ``VLBConfig.tiny``: TEST_GEOMETRY (56 px frames,
        64-token sequences), the tiny tower and connector in f32; with
        ``use_lora`` rank-4 adapters without dropout."""
        g = TEST_GEOMETRY
        lora = LoRAConfig(rank=4, alpha=8.0, dropout=0.0) if use_lora else None
        clip = CLIPVisionConfig.tiny(image_size=g.image_size, base_quant=base_quant)
        base = dict(mistral=MistralConfig.tiny(vocab_size=1000, lora=lora, base_quant=base_quant),
                    clip=clip, stc=STCConfig.tiny(encoder_hidden_size=clip.hidden_size),
                    geometry=g, num_target=g.num_parcels, freeze_backbone=not use_lora)
        base.update(overrides)
        cfg = VLBConfig(**base)
        cfg.validate()
        return cfg


def trainable_predicate(name: str) -> bool:
    """Trainable = head parameters + LoRA adapters (the reference regimes)."""
    return name.startswith("head.") or is_lora_path(name)


def is_norm(key: str) -> bool:
    """A norm's weight or bias: its module's name holds "norm"."""
    return key.count(".") >= 2 and "norm" in key.rsplit(".", 2)[-2]


def stored_dtype(key: str, cfg: VLBConfig) -> torch.dtype:
    """The dtype a state-dict tensor is kept in: int8 codes; f32 scales,
    trainable tensors and the vision path's LayerNorms (Flax's f32
    ``param_dtype``, applied in f32); otherwise its module's compute dtype."""
    if key.endswith(".weight_q"):
        return torch.int8
    if (key.endswith(".weight_scale") or trainable_predicate(key)
            or (key.startswith(VISION_PREFIXES) and is_norm(key))):
        return torch.float32
    if key.startswith("vision_tower."):
        return cfg.clip.dtype
    if key.startswith("mm_projector."):
        return cfg.stc.dtype
    return cfg.mistral.dtype


def trainable_parameters(model: nn.Module) -> list[nn.Parameter]:
    """Set ``requires_grad`` on exactly the tensors :func:`trainable_predicate`
    selects; returns them."""
    out = []
    for name, p in model.named_parameters():
        p.requires_grad_(trainable_predicate(name))
        if p.requires_grad:
            out.append(p)
    return out


def splice_multimodal(
    text_embeds: torch.Tensor,   # (B, Lt, E)
    text_ids: torch.Tensor,      # (B, Lt) int, one VIDEO_TOKEN_ID per row
    video_embeds: torch.Tensor,  # (B, V, E)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replace the sentinel by the video embeddings.

    Returns (embeds (B, Lt-1+V, E), valid (B, Lt-1+V) int32). Video positions
    are valid; text positions are valid iff their id != 0, so a genuine id 0
    and the right padding are both masked keys (the reference's quirk).
    """
    b, lt, e = text_embeds.shape
    v = video_embeds.shape[1]
    l_out = lt - 1 + v
    p = (text_ids == VIDEO_TOKEN_ID).int().argmax(dim=1)[:, None]    # first sentinel
    pos = torch.arange(l_out, device=text_ids.device)[None, :]
    in_video = (pos >= p) & (pos < p + v)
    text_idx = torch.where(pos < p, pos, pos - v + 1).clamp(0, lt - 1)
    video_idx = (pos - p).clamp(0, v - 1)

    gathered_text = torch.gather(text_embeds, 1, text_idx[..., None].expand(b, l_out, e))
    gathered_video = torch.gather(video_embeds, 1, video_idx[..., None].expand(b, l_out, e))
    embeds = torch.where(in_video[..., None], gathered_video, gathered_text)

    text_valid = (text_ids != 0).int()
    valid = torch.where(in_video, 1, torch.gather(text_valid, 1, text_idx)).int()
    return embeds, valid


class VideoLLaMA2VLB(nn.Module):
    def __init__(self, cfg: VLBConfig, vision: bool = True):
        """``vision``: build the CLIP tower and the STC connector (without
        them the model takes cached video tokens only)."""
        super().__init__()
        self.cfg = cfg
        self.vision_tower = CLIPVisionTower(cfg.clip) if vision else None
        self.mm_projector = STCConnector(cfg.stc) if vision else None
        self.model = MistralModel(cfg.mistral)
        self.head = BrainReadoutHead(
            cfg.mistral.hidden_size, cfg.num_target, cfg.l2_lambda, cfg.dropout_rate
        )

    @classmethod
    def from_state_dict(cls, cfg: VLBConfig, state_dict, device=None) -> "VideoLLaMA2VLB":
        """A frozen eval-mode model holding ``state_dict``'s tensors.

        The module is built on the meta device and the tensors are assigned,
        not copied: tensors already in their :func:`stored_dtype` on
        ``device`` are used as they are. The towers are built when the state
        dict holds any of their tensors, and then must hold all of them. A
        trainer sets ``requires_grad`` on what :func:`trainable_predicate`
        selects.
        """
        vision = any(k.startswith(VISION_PREFIXES) for k in state_dict)
        with torch.device("meta"):
            model = cls(cfg, vision=vision)
        sd = {k: t.to(device=device, dtype=stored_dtype(k, cfg)) for k, t in state_dict.items()}
        model.load_state_dict(sd, strict=True, assign=True)
        return model.eval().requires_grad_(False)

    @torch.no_grad()
    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, 3, H, W) normalised frames -> (B, num_vis_tokens, E) video
        tokens, always frozen: no gradient is recorded."""
        if self.vision_tower is None:
            raise ValueError("this model holds no vision towers (its state dict had none): "
                             "pass cached video tokens (B, num_vis_tokens, hidden)")
        cfg = self.cfg
        b, t = video.shape[:2]
        with span("vision"):
            feats = self.vision_tower(video.reshape(b * t, *video.shape[2:]))      # (B*T, P, C)
            g = cfg.clip.grid
            return self.mm_projector(feats.reshape(b, t, g, g, cfg.clip.hidden_size))

    def backbone(self, language: torch.Tensor, video: torch.Tensor, seed: int | None = None,
                 rows: tuple[int, int] | None = None):
        """Returns (post-norm hidden (B, S, E), valid mask (B, S)).

        ``video`` is raw frames (B, T, 3, H, W) or cached video tokens
        (B, num_vis_tokens, E). The embeddings and video tokens enter cut
        from the graph; with ``freeze_backbone`` no gradient is recorded
        below the head at all. ``rows``: the global batch rows this batch
        holds (dropout masks, ``models/lora.py``).
        """
        if self.cfg.freeze_backbone:
            with torch.no_grad():
                return self._backbone(language, video, seed, rows)
        return self._backbone(language, video, seed, rows)

    def _backbone(self, language, video, seed, rows):
        cfg = self.cfg.mistral
        if video.dim() == 5:
            video = self.encode_video(video)
        elif video.dim() != 3:
            raise ValueError(f"video must be frames (B, T, 3, H, W) or tokens (B, V, E), "
                             f"not {tuple(video.shape)}")
        ids = language.long()
        safe_ids = torch.where(ids == VIDEO_TOKEN_ID, 0, ids).clamp(0, cfg.vocab_size - 1)
        text_embeds = self.model.embed(safe_ids).detach()
        embeds, valid = splice_multimodal(text_embeds, ids, video.detach().to(cfg.dtype))
        return self.model(embeds, kv_mask=valid, seed=seed, rows=rows), valid

    def forward(self, language, video, padvals, vis_weights, lang_weights, seed: int | None = None,
                rows: tuple[int, int] | None = None):
        """-> (predictions (B, num_target) f32, l2 penalty).

        ``seed``: the step's dropout seed, which train mode needs; the
        backbone and the head each derive their own from it. ``rows`` =
        (first global row, global rows) when the batch is a rank's part of
        a global batch: each dropout mask is then the global batch's, on
        these rows.
        """
        if self.training and seed is None:
            raise ValueError("train mode draws its dropout masks from a seed: pass the step's seed")
        layers = self.cfg.mistral.num_hidden_layers
        hidden, _ = self.backbone(language, video, seed, rows)
        weight_mask = build_weight_mask(padvals, vis_weights, lang_weights, self.cfg.geometry)
        return self.head(hidden, weight_mask, None if seed is None else site_seed(seed, layers), rows)
