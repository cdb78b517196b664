"""``launches_per_batch.detect``: kernel launches in the traced window over
its ``inference_detector`` calls (batches)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["layer"]["kind"] != "detect" or tr["launches"] == 0:
        return None
    return tr["launches"] / ctx["layer"]["steps"]
