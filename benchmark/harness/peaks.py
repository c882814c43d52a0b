"""The chip's published peaks, and the roofline arithmetic every share uses.

NVIDIA's data sheet for the H100 SXM, dense rates without sparsity, at the
full 700 W power limit. The configurations here compute in fp32, which the
port may carry on the tensor cores at fp32 accuracy (3xTF32), so the peak of
every share is the dense TF32 rate: an honest kernel cannot pass it, while
the 67 TFLOP/s rate outside the tensor cores is no ceiling for such a kernel.
"""

from __future__ import annotations

TF32_FLOPS_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12
PEAK_NOTE = "H100 SXM dense TF32 495 TFLOP/s, HBM 3.35 TB/s"


def least_seconds(flops: float, bytes_moved: float) -> float:
    """The least time the chip could take for this work: the larger of the
    operations over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / TF32_FLOPS_PER_S, bytes_moved / HBM_BYTES_PER_S)


def share_of_peak(flops: float, seconds: float) -> float:
    """Achieved operations a second as a percentage of the peak rate."""
    return 100.0 * flops / seconds / TF32_FLOPS_PER_S
