"""Tensor parallelism of the serving engine (gather-TP)."""
