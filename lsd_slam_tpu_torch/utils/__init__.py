"""Observability, trajectory evaluation and synthetic scenes."""
