"""``launches_per_step.train.host``: ``launches_per_step.train`` of a training cell whose host paces the
step, under its own name so that it moves ``train_img_s.host``."""

from bench_port.run import read_metric


def read(ctx):
    return read_metric("launches_per_step.train", ctx)
