"""Codec stages, batched over streams."""
