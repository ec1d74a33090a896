"""Primitive layers, normalization and blocks (NCHW)."""
