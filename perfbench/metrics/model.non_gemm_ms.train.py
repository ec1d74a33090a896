"""Device ms a step in kernels launched outside the convolution and matrix-
product ops: padding, elementwise ops, norms, losses, the optimizer."""


def read(summary: dict):
    if summary["mode"] != "train":
        return None
    t = summary["trace"]
    return 1e3 * t["non_gemm_s"] / summary["traced_steps"]
