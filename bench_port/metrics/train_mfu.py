"""``train_mfu``: the products of one train step (forward and backward of
the reference network at the cell's shapes, counted on ``meta`` tensors,
frozen stages without weight gradients) over the traced window's time a
step, as a share of one H100's 989e12 dense bf16 FLOP/s."""

PEAK_BF16 = 989e12


def read(ctx):
    layer, tr = ctx["layer"], ctx["trace"]
    if layer["kind"] != "train" or tr["busy_s"] <= 0:
        return None
    return 100.0 * layer["flops_per_step"] * layer["steps"] \
        / tr["window_s"] / PEAK_BF16
