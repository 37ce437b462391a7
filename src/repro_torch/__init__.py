"""PyTorch/CUDA port of the NEO offloading engine.

The JAX package ``repro`` is the reference; this package imports nothing of
it.  Entry points (:class:`~repro_torch.core.engine.NeoEngine`,
:class:`~repro_torch.models.transformer.DenseLM`,
:class:`~repro_torch.core.kv_cache.DualPool`, ``launch.serve.main``) run on
the CUDA card unless the caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device, torch_dtype  # noqa: F401
