"""Share of the traced window in which no kernel, memcpy or memset runs on the
device."""


def read(summary: dict):
    if summary["mode"] != "train":
        return None
    t = summary["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
