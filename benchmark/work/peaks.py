"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheet: H100 SXM, dense rates without sparsity, at the 700 W limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}
DEFAULT = "NVIDIA H100 80GB HBM3"


def peak(kind: str) -> dict:
    """The peaks of a card by its torch.cuda.get_device_name()."""
    return PEAKS.get(kind, PEAKS[DEFAULT])


def bound_s(flops: float, nbytes: float, kind: str = DEFAULT) -> float:
    """The least time for `flops` dense bf16 operations and `nbytes` moved
    once: the larger of the two."""
    p = peak(kind)
    return max(flops / p["bf16_flops"], nbytes / p["hbm_bytes_per_s"])
