"""Geometry and device helpers."""
