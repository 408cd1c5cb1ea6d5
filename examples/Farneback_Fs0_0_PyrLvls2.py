#!/usr/bin/env python3
"""Calibrated config "Farneback_Fs0_0_PyrLvls2" — Farnebäck under a 2-level
driver pyramid (ref: examples/Farneback_Fs0_0_PyrLvls2.py): no pre-filter, the
driver's 2 levels stack on Farnebäck's own internal pyramid.

    python3 examples/Farneback_Fs0_0_PyrLvls2.py [--im1 a.tif --im2 b.tif --out flow.mat]
"""
import _example_lib  # noqa: F401  (first: puts the repository on sys.path)

from opticalflow_ri import FarnebackAdapter

if __name__ == "__main__":
    _example_lib.run_example(
        "Farneback_Fs0_0_PyrLvls2",
        FarnebackAdapter(),
        filter_sigma=0.0, pyr_levels=2,
    )
