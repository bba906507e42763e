"""Synthetic inputs, and the lazy-load data pipeline (h5py imported on use)."""
