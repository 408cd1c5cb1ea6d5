#!/usr/bin/env python3
"""Calibrated config "LiuSE_denseLK_Fs2_0_PyrLvls2" — 2-level pyramidal dense
Lucas-Kanade with the Liu-Shen refiner (ref:
examples/LiuSE_denseLK_Fs2_0_PyrLvls2.py): sigma=2.0 pre-filter, 27x27 window,
5 GN iterations per level, FILTER_OPT=0.48, Liu-Shen alpha=10 — the
LK-combination value (ref: examples/LiuSE_denseLK_Fs2_0_PyrLvls2.py:70).

    python3 examples/LiuSE_denseLK_Fs2_0_PyrLvls2.py [--im1 a.tif --im2 b.tif --out flow.mat]
"""
import _example_lib  # noqa: F401  (first: puts the repository on sys.path)

from opticalflow_ri import DenseLucasKanadeAdapter, LiuShenOpticalFlowAlgoAdapter

if __name__ == "__main__":
    _example_lib.run_example(
        "LiuSE_denseLK_Fs2_0_PyrLvls2",
        DenseLucasKanadeAdapter(Niter=5, halfWindow=13),
        filter_sigma=2.0, pyr_levels=2, filter_opt=0.48,
        optional_adapter=LiuShenOpticalFlowAlgoAdapter(10), warping=False,
    )
