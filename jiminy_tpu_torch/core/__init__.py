"""Robot model (``tree``) and batched rigid-body algorithms (``algos``)."""
