"""Visualise Kent distributions on the ERP chart.

    # from a spherical box (theta phi alpha beta, degrees)
    python -m sph_retina_tpu_torch.vis_kent --bfov 120 60 40 30 \\
        --samples 500 --out kent.png
    # from canonical parameters (kappa beta alpha psi eta)
    python -m sph_retina_tpu_torch.vis_kent --kent 20 5 1.0 0.3 0.5 \\
        --out kent.png

The exact density's heat map on the ERP lat-long grid, optional
tangent-Gaussian samples and an optional ERP background image
(``visualize/kent_vis.py``). A ``--bfov`` box is converted by the moment
estimator ``deg2kent`` (``--mle``: the Newton MLE ``kent_mle``). The
estimator and the density run on the CUDA device unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .iou import deg2kent, kent_mle
from .utils.device import resolve_device
from .visualize.kent_vis import plot_kent_density


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bfov", type=float, nargs=4,
                   metavar=("THETA", "PHI", "ALPHA", "BETA"),
                   help="spherical box in degrees; converted with deg2kent")
    p.add_argument("--kent", type=float, nargs=5,
                   metavar=("KAPPA", "BETA", "ALPHA", "PSI", "ETA"),
                   help="canonical Kent parameters (angles in radians)")
    p.add_argument("--mle", action="store_true",
                   help="the Newton MLE instead of moment estimation for "
                        "--bfov")
    p.add_argument("--img-size", type=int, nargs=2, default=(256, 512),
                   metavar=("H", "W"))
    p.add_argument("--samples", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image", default=None, help="ERP background image")
    p.add_argument("--out", default="kent_density.png")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    args = p.parse_args(argv)
    if (args.bfov is None) == (args.kent is None):
        p.error("pass exactly one of --bfov / --kent")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.kent is not None:
        params = np.asarray(args.kent, np.float64)
        title = None
    else:
        box = torch.tensor([args.bfov], dtype=torch.float32, device=device)
        est = kent_mle if args.mle else deg2kent
        params = est(box)[0].double().cpu().numpy()
        title = ("BFoV ({:g}, {:g}, {:g}, {:g}) -> Kent kappa={:.3g} "
                 "beta={:.3g}".format(*args.bfov, params[0], params[1]))

    image = None
    if args.image:
        from PIL import Image

        with Image.open(args.image) as im:
            image = np.asarray(im.convert("RGB"))

    plot_kent_density(params, tuple(args.img_size), samples=args.samples,
                      seed=args.seed, image=image, out_file=args.out,
                      title=title, device=device)
    print(f"kappa={params[0]:.4g} beta={params[1]:.4g} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
