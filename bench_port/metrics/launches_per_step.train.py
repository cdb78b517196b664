"""``launches_per_step.train``: kernel launches in the traced window over
its train steps."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["layer"]["kind"] != "train" or tr["launches"] == 0:
        return None
    return tr["launches"] / ctx["layer"]["steps"]
