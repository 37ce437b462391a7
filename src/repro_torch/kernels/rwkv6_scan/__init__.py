"""Chunked RWKV6 (Finch) recurrence: a CUDA kernel for sm_90a and its plain version."""

from repro_torch.kernels.rwkv6_scan.ops import rwkv6_decode_step, rwkv6_scan  # noqa: F401
