"""Evaluation helpers (FID, IS, LPIPS wait for ROADMAP A.8)."""
