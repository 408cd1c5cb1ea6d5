#!/usr/bin/env python3
"""Run a calibrated optical-flow configuration and save the flow as .mat.

Equivalent of the reference's per-config example scripts (ref: examples/*.py):

    python3 examples/run_config.py PyHSchunck_Fs3_4
    python3 examples/run_config.py LiuSE_denseLK_Fs2_0_PyrLvls2 \
        --im1 path/a.tif --im2 path/b.tif --out flow.mat

Default input is a seeded synthetic 512x512 PIV pair.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    from opticalflow_ri.compile import configure_compile_cache
    from opticalflow_ri.configs import CONFIGS, EXAMPLE_CONFIG_NAMES, run_config
    from opticalflow_ri.utils.io import load_image, save_flow

    configure_compile_cache()

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", choices=sorted(CONFIGS), metavar="config",
                    help="one of: " + ", ".join(EXAMPLE_CONFIG_NAMES) + ", ...")
    ap.add_argument("--im1", help="first frame (default: seeded synthetic pair)")
    ap.add_argument("--im2", help="second frame")
    ap.add_argument("--out", default=None, help="output .mat path (default <config>.mat)")
    args = ap.parse_args()

    if args.im1:
        im1 = load_image(args.im1)
        im2 = load_image(args.im2)
    else:
        print("no input images given; using a synthetic PIV pair", file=sys.stderr)
        from opticalflow_ri.utils.synthetic import particle_image_pair

        im1, im2, _, _ = particle_image_pair(shape=(512, 512), seed=0)

    u, v = run_config(args.config, im1, im2)
    u = np.asarray(u)
    v = np.asarray(v)
    out = args.out or f"{args.config}.mat"
    save_flow(u, v, out)
    print(f"{args.config}: U in [{u.min():.3f}, {u.max():.3f}], "
          f"V in [{v.min():.3f}, {v.max():.3f}] -> {out}")


if __name__ == "__main__":
    main()
