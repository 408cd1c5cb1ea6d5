"""Shared plumbing for the per-config example scripts.

Each example script mirrors one of the reference's calibrated example scripts
(ref: examples/*.py): it constructs its own solver adapters with the
calibration constants visible in the script, then hands them here for the
common load-images -> pyramidal driver -> save-.mat flow.

Run from anywhere: the repository root is put on ``sys.path`` below.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

def run_example(name: str, main_adapter, filter_sigma: float,
                pyr_levels: int = 1, k_levels: int = 1,
                filter_opt=None, optional_adapter=None, **driver_kwargs):
    """CLI + IO wrapper around ``generic_pyramidal_optical_flow``; returns
    (U, V) numpy arrays and writes the .mat output."""
    import numpy as np

    from opticalflow_ri.compile import configure_compile_cache
    from opticalflow_ri.pyramid import generic_pyramidal_optical_flow
    from opticalflow_ri.utils.io import load_image, save_flow

    configure_compile_cache()

    ap = argparse.ArgumentParser(description=f"calibrated config {name}")
    ap.add_argument("--im1", help="first frame (default: seeded synthetic pair)")
    ap.add_argument("--im2", help="second frame")
    ap.add_argument("--out", default=f"{name}.mat")
    args = ap.parse_args()

    if args.im1:
        im1, im2 = load_image(args.im1), load_image(args.im2)
    else:
        print("no input images given; using a synthetic PIV pair", file=sys.stderr)
        from opticalflow_ri.utils.synthetic import particle_image_pair

        im1, im2, _, _ = particle_image_pair(shape=(512, 512), seed=0)

    u, v = generic_pyramidal_optical_flow(
        im1, im2, filter_sigma, main_adapter,
        pyramidalLevels=pyr_levels, kLevels=k_levels,
        FILTER_OPT=filter_opt, optionalOFlowAlgoAdapter=optional_adapter,
        **driver_kwargs,
    )
    u, v = np.asarray(u), np.asarray(v)
    save_flow(u, v, args.out)
    print(f"{name}: U range [{u.min():.3f}, {u.max():.3f}], "
          f"V range [{v.min():.3f}, {v.max():.3f}] -> {args.out}")
    return u, v
