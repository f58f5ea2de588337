"""Batched math: quaternions (``so3``), spatial algebra (``spatial``) and
small-matrix Cholesky (``linalg``)."""
