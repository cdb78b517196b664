"""``device_idle.detect``: the share of the traced window of detection
calls in which no kernel, copy or fill ran on the device."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["layer"]["kind"] != "detect" or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
