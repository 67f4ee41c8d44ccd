"""Synthetic scenes and poses (numpy)."""
