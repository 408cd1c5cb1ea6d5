#!/usr/bin/env python3
"""Calibrated config "PyHSchunck_Fs3_4" — Horn-Schunck on the bundled PIV pair
(ref: examples/PyHSchunck_Fs3_4.py): sigma=3.4 Gaussian pre-filter, single
pyramid level, 600 Jacobi iterations, h=21 — the (Bits08, Ni06) level-1 entry
of the h-parameter calibration table (ref: examples/PyHSchunck_Fs3_4.py:63-123).

    python3 examples/PyHSchunck_Fs3_4.py [--im1 a.tif --im2 b.tif --out flow.mat]
"""
import _example_lib  # noqa: F401  (first: puts the repository on sys.path)

from opticalflow_ri import HSOpticalFlowAlgoAdapter

if __name__ == "__main__":
    _example_lib.run_example(
        "PyHSchunck_Fs3_4",
        HSOpticalFlowAlgoAdapter([21.0], 600),
        filter_sigma=3.4, pyr_levels=1,
    )
