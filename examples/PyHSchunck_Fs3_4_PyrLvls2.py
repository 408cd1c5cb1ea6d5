#!/usr/bin/env python3
"""Calibrated config "PyHSchunck_Fs3_4_PyrLvls2" — 2-level pyramidal
Horn-Schunck (ref: examples/PyHSchunck_Fs3_4_PyrLvls2.py): sigma=3.4
pre-filter, 600 iterations per level, h=21 at the final level and h=45 at the
coarser level — the (Bits08, Ni06) entries of the calibration table
(ref: examples/PyHSchunck_Fs3_4.py:63-123).  The adapter pops alphas from the
END of the list, so the coarsest level consumes the last entry
(ref: src/HornSchunck.py:36).

    python3 examples/PyHSchunck_Fs3_4_PyrLvls2.py [--im1 a.tif --im2 b.tif --out flow.mat]
"""
import _example_lib  # noqa: F401  (first: puts the repository on sys.path)

from opticalflow_ri import HSOpticalFlowAlgoAdapter

if __name__ == "__main__":
    _example_lib.run_example(
        "PyHSchunck_Fs3_4_PyrLvls2",
        HSOpticalFlowAlgoAdapter([21.0, 45.0], 600),
        filter_sigma=3.4, pyr_levels=2,
    )
