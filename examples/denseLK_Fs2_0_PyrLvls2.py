#!/usr/bin/env python3
"""Calibrated config "denseLK_Fs2_0_PyrLvls2" — 2-level pyramidal dense
Lucas-Kanade (ref: examples/denseLK_Fs2_0_PyrLvls2.py): sigma=2.0 pre-filter,
27x27 window, 5 Gauss-Newton iterations per level, FILTER_OPT=0.48, warping
disabled (ref: src/denseLucasKanade_PyCL.py:177-182).

    python3 examples/denseLK_Fs2_0_PyrLvls2.py [--im1 a.tif --im2 b.tif --out flow.mat]
"""
import _example_lib  # noqa: F401  (first: puts the repository on sys.path)

from opticalflow_ri import DenseLucasKanadeAdapter

if __name__ == "__main__":
    _example_lib.run_example(
        "denseLK_Fs2_0_PyrLvls2",
        DenseLucasKanadeAdapter(Niter=5, halfWindow=13),
        filter_sigma=2.0, pyr_levels=2, filter_opt=0.48, warping=False,
    )
