"""Print a fully resolved config (``_base_`` merged, overrides applied).

    python -m sph_retina_tpu_torch.print_config CONFIG \\
        [--cfg-options optimizer.lr=0.01 ...]

The text is the JAX tool's: ``pprint`` of the merged dict, keys sorted,
100 columns.
"""

from __future__ import annotations

import argparse
import pprint
import sys

from .utils.config import apply_overrides, load_config


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=None)
    args = p.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    pprint.pprint(cfg, sort_dicts=True, width=100)
    return 0


if __name__ == "__main__":
    sys.exit(main())
