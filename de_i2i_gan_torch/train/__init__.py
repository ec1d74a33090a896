"""Serving steps and weight import."""
