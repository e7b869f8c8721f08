"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM
and the operations and bytes each hand kernel's call needs, counted from
the shapes of its inputs (the embedding width as given, not the padded
width a kernel reads). Copied from the bound arithmetic of chip_smoke.py,
which stays as it is."""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: device
# memory bytes/s, bf16 tensor-core and float32 (outside the tensor cores)
# operations/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
# the host link's nominal rate each way, bytes/s: PCIe Gen5 x16 (32 GT/s
# a lane, 128b/130b encoding) = 63.0e9
PEAK_HOST_LINK = 32e9 * 16 * 128 / 130 / 8
# bytes of one neighbor entry on the result wire: the int32 index and the
# float32 distance K10 writes into host memory
RESULT_ENTRY_BYTES = 8


def ops_seconds(ops: float, precision: str) -> float:
    """The least time of `ops` products and sums: over the bf16
    tensor-core peak, or the float32 peak at precision "fp32"."""
    return ops / (PEAK_BF16 if precision == "bf16" else PEAK_FP32)


def k4_seconds(queries: int, candidates: int, d: int,
               precision: str) -> float:
    """The least time of one K4 launch (exact scores and each query's
    running top-k): 2 q c d operations."""
    return ops_seconds(2.0 * queries * candidates * d, precision)


def k6_seconds(pairs: int, queries: int, probes: int, d: int, k: int,
               precision: str) -> float:
    """The least time of one K6 launch (the IVF rescore): the larger of 2 d
    operations a real (query, member) pair score over the peak of its
    precision, and the bytes of the query rows gathered once a probe slot
    (2 or 4 bytes an element) plus the (query, slot, k) int64 buffer it
    writes, over the memory peak."""
    itemsize = 2 if precision == "bf16" else 4
    by_ops = ops_seconds(2.0 * pairs * d, precision)
    by_bytes = (queries * probes * d * itemsize
                + queries * probes * k * 8) / PEAK_BYTES
    return max(by_ops, by_bytes)


def k10_seconds(rows: int, k: int) -> float:
    """The least time of one K10 launch (the result wire): the result's
    bytes over the host link's nominal rate (the keys' read from device
    memory is 53 times faster and never binds)."""
    return rows * k * RESULT_ENTRY_BYTES / PEAK_HOST_LINK
