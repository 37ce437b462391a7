"""Flash prefill attention: a CUDA kernel for sm_90a and its plain version."""

from repro_torch.kernels.flash_prefill.ops import flash_prefill  # noqa: F401
