"""``device_idle.train``: the share of the traced window of train steps in
which no kernel, copy or fill ran on the device (1 - the union of their
intervals over the window)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["layer"]["kind"] != "train" or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
