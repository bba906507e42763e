"""The package's version (``phantom_vlb_tpu/version.py``'s counterpart)."""

__version__ = "0.1.0"
