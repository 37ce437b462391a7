"""Paged GQA decode attention: a CUDA kernel for sm_90a and its plain version."""

from repro_torch.kernels.paged_decode.ops import paged_decode_attention  # noqa: F401
