"""``k1_roofline.train``: the frozen roofline's least time for the traced
steps' K1 work (each batch's real ground truths against every anchor; the
pairs that the plain geometric test culls skip the body; bench_port/k1.py)
over the device time of K1's kernel (``pairwise_kernel``) in the trace."""


def read(ctx):
    layer = ctx["layer"]
    if layer["kind"] != "train" or not layer.get("k1_bound_s") \
            or not layer.get("k1_device_s"):
        return None
    return 100.0 * layer["k1_bound_s"] / layer["k1_device_s"]
