"""Utilities: numerical health checks, host-side random processes."""
