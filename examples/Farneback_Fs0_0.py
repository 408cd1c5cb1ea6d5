#!/usr/bin/env python3
"""Calibrated config "Farneback_Fs0_0" — Farnebäck polynomial-expansion flow
(ref: examples/Farneback_Fs0_0.py): no driver pre-filter (the solver blurs
internally with its bit-exact kernels), single driver level (Farnebäck owns
its own internal pyramid, ref: src/Farneback_PyCL.py:468-487), FILTER_OPT=0.48.

    python3 examples/Farneback_Fs0_0.py [--im1 a.tif --im2 b.tif --out flow.mat]
"""
import _example_lib  # noqa: F401  (first: puts the repository on sys.path)

from opticalflow_ri import FarnebackAdapter

if __name__ == "__main__":
    _example_lib.run_example(
        "Farneback_Fs0_0",
        FarnebackAdapter(),
        filter_sigma=0.0, pyr_levels=1, filter_opt=0.48,
    )
