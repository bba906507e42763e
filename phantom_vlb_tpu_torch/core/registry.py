"""Model registry: model-family names to ``VLBConfig`` factories.

Counterpart of ``phantom_vlb_tpu/core/registry.py``. The reference's CLI
enumerates model types it implements only for Mistral
(``videollama2 | videollama2_llama | videollama2_mistral |
videollama2_mixtral | videollama2_qwen2``); ``videollama2`` and
``videollama2_mistral`` are registered, and the others raise with the
names that are.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["register_model", "get_model_config", "available_models"]

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model_config(name: str, **kwargs):
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise NotImplementedError(
            f"model family {name!r} is not implemented (available: {known}). "
            "The reference enumerates the same names without implementing "
            "them (extractfeatures.py:66); register a factory to add one."
        )
    return _REGISTRY[name](**kwargs)


def available_models() -> list[str]:
    return sorted(_REGISTRY)


@register_model("videollama2")
@register_model("videollama2_mistral")
def _mistral(**kwargs):
    from phantom_vlb_tpu_torch.models.videollama2 import VLBConfig

    return VLBConfig.full(**kwargs)
