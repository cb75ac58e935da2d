"""Evaluation datasets (host-side numpy)."""
