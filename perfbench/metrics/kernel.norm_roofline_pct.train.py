"""The norm kernels' share of their roofline: the bound of the norm calls of
the reference's step, over the device time of the kernels named
modulated_instance_norm_*. Nothing to read where no such kernel ran."""


def read(summary: dict):
    if summary["mode"] != "train":
        return None
    t = summary["trace"]
    if t["norm_kernel_s"] <= 0 or summary["norm_bound_s_per_step"] <= 0:
        return None
    return (100.0 * summary["norm_bound_s_per_step"] * summary["traced_steps"]
            / t["norm_kernel_s"])
