"""Models of the port: the dense decoder family (``DenseLM``)."""

from repro_torch.models.api import get_model  # noqa: F401
