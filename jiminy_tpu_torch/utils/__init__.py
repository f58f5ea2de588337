"""Utilities (numerical health checks)."""
