"""Summarise a corruption-robustness run into P / mPC / rPC.

    python -m sph_retina_tpu_torch.robustness_eval robust.json --metric AP50

Reads the JSON of ``test_robustness`` (the JAX package's layout):
P   = the clean performance,
mPC = the mean performance under corruption (severities >= 1),
rPC = mPC / P (the relative robustness),
and each corruption's mean over its severities. Host only.
"""

from __future__ import annotations

import argparse
import json
import sys


def get_results(path: str, metric: str = "AP50") -> dict:
    with open(path) as f:
        data = json.load(f)
    clean = data.get("clean", {}).get("0", {})
    P = clean.get(metric)
    vals = [sev[metric]
            for name, sevs in data.items() if name != "clean"
            for s, sev in sevs.items() if int(s) >= 1 and metric in sev]
    mPC = sum(vals) / len(vals) if vals else None
    rPC = (mPC / P) if (mPC is not None and P) else None
    per_corruption = {
        name: sum(v[metric] for v in sevs.values()) / len(sevs)
        for name, sevs in data.items() if name != "clean" and sevs}
    return {"P": P, "mPC": mPC, "rPC": rPC,
            "per_corruption": per_corruption}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="P / mPC / rPC of a robustness "
                                            "run")
    p.add_argument("results_json")
    p.add_argument("--metric", default="AP50")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = get_results(args.results_json, args.metric)
    print(f"Performance on clean data              [P]   ({args.metric}) = "
          f"{out['P'] if out['P'] is not None else 'n/a'}")
    if out["mPC"] is not None:
        print(f"Mean performance under corruption      [mPC] ({args.metric})"
              f" = {out['mPC']:.4f}")
    if out["rPC"] is not None:
        print(f"Relative performance under corruption  [rPC] ({args.metric})"
              f" = {out['rPC']:.4f}")
    for name, v in sorted(out["per_corruption"].items()):
        print(f"  {name:20s} {v:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
