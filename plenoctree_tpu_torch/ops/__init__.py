"""Tensor ops: SH basis, image metrics."""
