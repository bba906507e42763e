"""Synthetic inputs (numpy only)."""
