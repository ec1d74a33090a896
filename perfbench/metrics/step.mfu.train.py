"""The whole step's share of the chip's bf16 peak: the FLOPs of the reference's
step at the cell's shapes, times the steps of the unprofiled window, over
its seconds."""


def read(summary: dict):
    if summary["mode"] != "train" or summary["peak_flops_per_s"] is None:
        return None
    return (100.0 * summary["flops_per_step"] * summary["steps"]
            / summary["seconds"] / summary["peak_flops_per_s"])
