"""Hardware profiles read by the perf model (:mod:`.hw`), and the dry run's
roofline: the per-rank counter (:mod:`.opcount`), the closed-form HBM
traffic (:mod:`.structural`) and the three-term report (:mod:`.analysis`)."""

from repro_torch.roofline.hw import HARDWARE, HardwareProfile  # noqa: F401
