"""Synthetic inputs, the lazy-load data pipeline and the vision-token cache (h5py imported on use)."""
