"""Tensor parallelism of the serving engine (gather-TP) and the gradient
compression of training."""
