"""Datasets and the store that owns them."""
