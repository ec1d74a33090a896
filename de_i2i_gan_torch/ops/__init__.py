"""Fused ops: kernel dispatch and plain versions."""
