"""Hardware profiles read by the perf model."""

from repro_torch.roofline.hw import HARDWARE, HardwareProfile  # noqa: F401
