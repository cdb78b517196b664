"""``device_idle.train.host``: ``device_idle.train`` of a training cell whose host paces the
step, under its own name so that it moves ``train_img_s.host``."""

from bench_port.run import read_metric


def read(ctx):
    return read_metric("device_idle.train", ctx)
