"""Hardware models (motors)."""
