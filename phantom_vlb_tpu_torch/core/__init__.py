"""Configuration, geometry, device and mesh helpers."""
