"""Eval step and streaming metrics."""
