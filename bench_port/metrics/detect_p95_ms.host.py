"""``detect_p95_ms.host``: the 95th percentile, over every batch of the
run's measured window, of the host-clock time from the frames handed to
``inference_detector`` to its numpy results. Too noisy from run to run on
the shared host to hold a bound as an end-to-end metric (PERF.md, §2)."""


def read(ctx):
    return ctx["e2e"].get("detect_p95_ms")
