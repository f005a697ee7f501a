"""Codec state and the frame-level encoder and decoder."""
