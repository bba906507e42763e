"""The adapters' input dropout as the unfused 32-bit path draws it: one
uniform f32 draw an element from a generator on the device, seeded with
the site's seed, kept where the draw is below 1 - p."""

from cardbench.reference.vlb import uniform_keep as keep

__all__ = ["keep"]
