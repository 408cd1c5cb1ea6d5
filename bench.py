#!/usr/bin/env python3
"""GPU benchmark for opticalflow_ri.

Times the calibrated configurations as single compiled pipelines (one XLA
program per config — see opticalflow_ri/compile.py) on the default JAX
device, which must be a GPU: on any other backend the script exits non-zero
and prints no metric.  Input is the seeded synthetic PIV pair
(``utils.synthetic.particle_image_pair``, seed 0).

Every record is one JSON line naming the device (platform, device kind,
device count and the nvidia-smi name/power-limit line); the LAST stdout line
is the headline:

    {"metric": "hs_fs3_4_throughput", "value": ..., "unit": "Mpix/s",
     "vs_baseline": ..., "device": {...}}

Baseline: the reference's published HS_Fs3_4 wall time of 23.07 s
(benchmark_results/benchmark_summary.txt:7) normalised to a 512x512 pair
(0.262 Mpix) -> 0.01136 Mpix/s (see BASELINE.md).

Timing: every call ends in ``jax.block_until_ready``; the first call of each
shape compiles and is reported separately; steady-state time is the median
of ``repeats`` calls after it.

    python3 bench.py
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_HS_FS34_SECONDS = 23.07
MPIX_512 = 512 * 512 / 1e6
BASELINE_MPIX_S = MPIX_512 / BASELINE_HS_FS34_SECONDS

# reference benchmark wall times for the CPU rows (benchmark_summary.txt:6-9)
BASELINE_SECONDS = {
    "HS_Fs0_0": 21.53,
    "HS_Fs3_4": 23.07,
    "HS_Fs3_4_PyrLvls2": 39.39,
    "LiuSE_HS_Fs3_4_PyrLvls2": 82.88,
}

GRID = [
    "HS_Fs3_4",
    "HS_Fs0_0",
    "HS_Fs3_4_PyrLvls2",
    "LiuSE_HS_Fs3_4_PyrLvls2",
    "PyHSchunck_Fs3_4",
    "denseLK_Fs2_0",
    "Farneback_Fs0_0",
    "LiuSE_denseLK_Fs2_0_PyrLvls2",
    "LiuSE_Farneback_Fs0_0_PyrLvls2",
    "LiuSE_LK_Fs2_0_PyrLvls2",
    "LiuSE_FB_Fs0_0_PyrLvls2",
]
STREAMED = ("PyHSchunck_Fs3_4", "denseLK_Fs2_0", "Farneback_Fs0_0")
SIZES = (256, 512, 1024, 2048)


def time_fn(fn, *args, repeats=5):
    """(compile_seconds, median steady-state seconds) of ``fn(*args)``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times)


def main():
    import jax
    import jax.numpy as jnp

    from opticalflow_ri.compile import (
        compiled_pipeline, configure_compile_cache, scan_pipeline,
    )
    from opticalflow_ri.models.liu_shen import liu_shen_solve
    from opticalflow_ri.utils.device import require_gpu
    from opticalflow_ri.utils.synthetic import particle_image_pair

    device = require_gpu()
    cache_dir = configure_compile_cache()

    def emit(record):
        print(json.dumps(dict(record, device=device)), flush=True)

    emit({"record": "setup", "compile_cache": cache_dir,
          "jax": jax.__version__})

    im1, im2, _, _ = particle_image_pair(shape=(512, 512), seed=0)
    d1 = jnp.asarray(im1)
    d2 = jnp.asarray(im2)

    failed = []
    results = {}
    for name in GRID:
        try:
            first, t = time_fn(compiled_pipeline(name), d1, d2)
        except Exception as e:  # keep benching the other configs
            failed.append(name)
            emit({"record": "config", "config": name, "error": repr(e)})
            continue
        results[name] = t
        rec = {"record": "config", "config": name, "shape": [512, 512],
               "first_call_s": first, "steady_s": t,
               "mpix_per_s": MPIX_512 / t}
        if name in BASELINE_SECONDS:
            rec["speedup_vs_reference"] = BASELINE_SECONDS[name] / t
        emit(rec)

    k = 16
    for name in STREAMED:
        b1 = jnp.stack([d1] * k)
        b2 = jnp.stack([d2] * k)
        try:
            first, t = time_fn(scan_pipeline(name), b1, b2, repeats=3)
        except Exception as e:
            failed.append(f"streamed:{name}")
            emit({"record": "streamed", "config": name, "error": repr(e)})
            continue
        emit({"record": "streamed", "config": name, "k": k,
              "first_call_s": first, "steady_s_per_pair": t / k,
              "mpix_per_s": MPIX_512 * k / t})

    def liu_shen_60(side):
        z = jnp.zeros((side, side), jnp.float32)
        return jax.jit(lambda a, b: liu_shen_solve(a, b, 10.0, z, z,
                                                   max_iter=60, tol=0.0)[:2])

    # one row per solver family; Liu-Shen times the bare 60-iteration solve
    # (the reference composes it with a main adapter, so no registered
    # pure-LS config exists)
    rows = [("HS_Fs3_4", lambda side: compiled_pipeline("HS_Fs3_4")),
            ("denseLK_Fs2_0", lambda side: compiled_pipeline("denseLK_Fs2_0")),
            ("Farneback_Fs0_0",
             lambda side: compiled_pipeline("Farneback_Fs0_0")),
            ("LiuShen_60it", liu_shen_60)]
    for label, make in rows:
        for side in SIZES:
            s1, s2, _, _ = particle_image_pair(shape=(side, side), seed=0)
            try:
                first, t = time_fn(make(side), jnp.asarray(s1),
                                   jnp.asarray(s2), repeats=3)
            except Exception as e:
                failed.append(f"size:{label}@{side}")
                emit({"record": "size", "solver": label, "side": side,
                      "error": repr(e)})
                continue
            emit({"record": "size", "solver": label, "shape": [side, side],
                  "first_call_s": first, "steady_s": t,
                  "mpix_per_s": side * side / 1e6 / t})

    if "HS_Fs3_4" not in results:
        raise SystemExit(f"headline config failed; failed: {failed}")
    value = MPIX_512 / results["HS_Fs3_4"]
    print(json.dumps({
        "metric": "hs_fs3_4_throughput", "value": value, "unit": "Mpix/s",
        "vs_baseline": value / BASELINE_MPIX_S, "failed": failed,
        "device": device,
    }))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
