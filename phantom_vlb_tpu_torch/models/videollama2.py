"""VideoLLaMA2-VLB over cached video tokens: the serving forward.

Counterpart of ``phantom_vlb_tpu/models/videollama2.py`` on its rank-3 path
(precomputed video tokens, :183-186)::

  text ids (B, Lt) with one <video> sentinel (id -201)
    -> embed -> splice the (B, V, E) video tokens in at the sentinel
    -> (B, Lt - 1 + V, E) -> Mistral decoder -> post-norm hidden states
    -> HRF weight mask + brain readout head -> (preds (B, P), l2 penalty)

Raw frames (rank-5 ``video``) need the CLIP + STC vision towers, which are
not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from phantom_vlb_tpu_torch.core.geometry import VIDEO_TOKEN_ID, VLBGeometry
from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY
from phantom_vlb_tpu_torch.models.heads import BrainReadoutHead
from phantom_vlb_tpu_torch.models.mistral import MistralConfig, MistralModel
from phantom_vlb_tpu_torch.ops.weight_mask import build_weight_mask

__all__ = ["VLBConfig", "VideoLLaMA2VLB", "splice_multimodal"]


@dataclasses.dataclass(frozen=True)
class VLBConfig:
    mistral: MistralConfig = dataclasses.field(default_factory=MistralConfig)
    geometry: VLBGeometry = dataclasses.field(default_factory=VLBGeometry)
    num_target: int = 1000
    l2_lambda: float = 0.001
    dropout_rate: float = 0.1

    @staticmethod
    def full(**overrides) -> "VLBConfig":
        """The production VideoLLaMA2-7B geometry, bf16 backbone."""
        cfg = VLBConfig(**overrides)
        cfg.geometry.validate()
        return cfg

    @staticmethod
    def tiny(**overrides) -> "VLBConfig":
        """The reference's ``VLBConfig.tiny``: TEST_GEOMETRY, 64-token sequences."""
        g = TEST_GEOMETRY
        base = dict(mistral=MistralConfig.tiny(vocab_size=1000), geometry=g,
                    num_target=g.num_parcels)
        base.update(overrides)
        return VLBConfig(**base)


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
    def __init__(self, cfg: VLBConfig):
        super().__init__()
        self.cfg = cfg
        self.model = MistralModel(cfg.mistral)
        self.head = BrainReadoutHead(
            cfg.mistral.hidden_size, cfg.num_target, cfg.l2_lambda, cfg.dropout_rate
        )

    @classmethod
    def from_state_dict(cls, cfg: VLBConfig, state_dict, device=None) -> "VideoLLaMA2VLB":
        """A frozen eval-mode model holding ``state_dict``'s tensors.

        The module is built on the meta device and the tensors are assigned,
        not copied: backbone tensors already in ``cfg.mistral.dtype`` and head
        tensors already in f32, on ``device``, are used as they are.
        """
        with torch.device("meta"):
            model = cls(cfg)
        sd = {
            k: t.to(device=device, dtype=torch.float32 if k.startswith("head.") else cfg.mistral.dtype)
            for k, t in state_dict.items()
        }
        model.load_state_dict(sd, strict=True, assign=True)
        return model.eval().requires_grad_(False)

    def backbone(self, language: torch.Tensor, video: torch.Tensor):
        """Returns (post-norm hidden (B, S, E), valid mask (B, S))."""
        cfg = self.cfg.mistral
        if video.dim() != 3:
            raise NotImplementedError(
                "raw video frames need the CLIP + STC vision towers, which come "
                "with the vision slice of the port; pass cached video tokens "
                "(B, num_vis_tokens, hidden)"
            )
        ids = language.long()
        safe_ids = torch.where(ids == VIDEO_TOKEN_ID, 0, ids).clamp(0, cfg.vocab_size - 1)
        text_embeds = self.model.embed(safe_ids)
        embeds, valid = splice_multimodal(text_embeds, ids, video.to(cfg.dtype))
        return self.model(embeds, kv_mask=valid), valid

    def forward(self, language, video, padvals, vis_weights, lang_weights):
        """-> (predictions (B, num_target) f32, l2 penalty)."""
        hidden, _ = self.backbone(language, video)
        weight_mask = build_weight_mask(padvals, vis_weights, lang_weights, self.cfg.geometry)
        return self.head(hidden, weight_mask)
