"""Synthetic data pipeline of the port."""
from .pipeline import DataConfig, SyntheticStream, get_batch  # noqa: F401
