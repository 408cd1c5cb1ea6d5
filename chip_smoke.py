#!/usr/bin/env python3
"""Smoke test of the whole engine on one GPU, against plain references.

    python3 chip_smoke.py                # one card: phases 1-5
    python3 chip_smoke.py --four-cards   # four cards: the multi-card paths only

One process drives the card.  It refuses to run (non-zero exit, no result
line) unless JAX's default device is a GPU.  Phases:

1. device: platform, kind, count, the nvidia-smi name and power limit, the
   JAX version and the compile-cache directory;
2. every registered config at 512x512 through ``compile.compiled_pipeline``
   on the seeded synthetic pair, against the same pipeline compiled for
   JAX's CPU backend in this process;
3. ``hs_solve`` / ``liu_shen_solve`` on the GPU against the NumPy/SciPy
   oracles at 512x512;
4. one config per solver family at 2048x2048 and a full sCMOS frame
   (2560x2160), against the CPU backend, with the compiled memory analysis;
5. the other entry points: ``GenericPyramidalOpticalFlowWrapper`` and
   ``compile.scan_pipeline``.

``--four-cards`` runs only the multi-card paths on a 4-device mesh: the
batch-sharded campaign scan, GSPMD auto-sharding and the ppermute-halo
sharded solvers, each against one card.

Each phase prints JSON lines that name the card and the image size; compile
seconds and steady-state milliseconds (median of 5 calls after a warm-up,
each ended by ``block_until_ready``) are printed for every GPU run.  The
last line is ``{"ok": true, "device": {...}}``, printed only when every
check passed; any failure exits non-zero.  No global matmul-precision
context is set, so an f32 contraction that silently runs in TF32 shows up
as a parity failure.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

# The references of phases 2 and 4 run on JAX's CPU backend in this
# process; keep that backend available when JAX_PLATFORMS names only GPUs.
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from opticalflow_ri.compile import (  # noqa: E402
    compiled_pipeline, configure_compile_cache, scan_pipeline,
)
from opticalflow_ri.configs import CONFIGS, build_config  # noqa: E402
from opticalflow_ri.models.farneback import FarnebackAdapter  # noqa: E402
from opticalflow_ri.models.lucas_kanade import (  # noqa: E402
    DenseLucasKanadeAdapter,
)
from opticalflow_ri.utils.device import require_gpu  # noqa: E402
from opticalflow_ri.utils.synthetic import particle_image_pair  # noqa: E402

# GPU-vs-reference parity budgets (those of tests/test_auto_sharding.py):
# HS/LS configs by AEE; LK and FB configs by AEE, LK additionally by the
# share of pixels within 1e-3 px (its 0.01-px early exit amplifies the
# reduction order on borderline pixels).
AEE_TOL = {"hs_ls": 1e-5, "lk": 1e-3, "fb": 1e-3}
LK_BULK_TOL = 1e-3
LK_BULK_SHARE = 0.99
REPEATS = 5

SIZE_CASES = [  # phase 4: (label, config or None for the bare LS solve, shape)
    ("HS_Fs3_4", "HS_Fs3_4", (2048, 2048)),
    ("denseLK_Fs2_0", "denseLK_Fs2_0", (2048, 2048)),
    ("Farneback_Fs0_0", "Farneback_Fs0_0", (2048, 2048)),
    ("liu_shen_solve_60it", None, (2048, 2048)),
    ("LiuSE_PyHSchunck_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2",
     (2160, 2560)),
]
SCAN_CONFIGS = ("PyHSchunck_Fs3_4", "denseLK_Fs2_0", "Farneback_Fs0_0")


class Smoke:
    """Runs the phases and collects failures; ``card`` labels every line."""

    def __init__(self, accel, ref, card):
        self.accel = accel      # device under test
        self.ref = ref          # device of the compiled references
        self.card = card
        self.failures = []

    # -- output ------------------------------------------------------------

    def emit(self, phase, **fields):
        rec = {"phase": phase, "card": self.card,
               "device_kind": self.accel.device_kind}
        rec.update(fields)
        print(json.dumps(rec, default=str), flush=True)

    def check(self, phase, ok, **fields):
        """Record one parity check; a failed one fails the run."""
        self.emit(phase, passed=bool(ok), **fields)
        if not ok:
            self.failures.append((phase, fields))

    def guarded(self, phase, label, fn, *args):
        """Run one case; an exception is printed and fails the run, and the
        remaining cases still run."""
        try:
            return fn(*args)
        except Exception as e:
            self.emit(phase, case=label, passed=False, error=repr(e),
                      traceback=traceback.format_exc())
            self.failures.append((phase, {"case": label, "error": repr(e)}))
            return None

    # -- running -----------------------------------------------------------

    def timed(self, fn, args, repeats=REPEATS):
        """Compile ``fn`` for ``args`` (already on the device under test),
        then time it; returns (outputs as numpy, record, executable)."""
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        compile_s = time.perf_counter() - t0
        out = jax.block_until_ready(compiled(*args))  # warm-up
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(*args))
            times.append(time.perf_counter() - t0)
        rec = {"compile_s": compile_s,
               "steady_ms": statistics.median(times) * 1e3,
               "steady_ms_all": [t * 1e3 for t in times]}
        return _host(out), rec, compiled

    def on_ref(self, fn, args):
        """``fn`` compiled for and run on the reference device."""
        args = [jax.device_put(a, self.ref) for a in args]
        return _host(jax.jit(fn)(*args))

    def put(self, *arrays):
        return [jax.device_put(jnp.asarray(a, jnp.float32), self.accel)
                for a in arrays]

    # -- comparisons -------------------------------------------------------

    def compare(self, phase, family, got, want, require=True, **fields):
        """Hold ``got`` to ``want`` within the family's budget; ``require``
        is one more condition the check must meet."""
        u, v = got
        ur, vr = want
        du = np.abs(u - ur)
        dv = np.abs(v - vr)
        aee = float(np.mean(np.hypot(du, dv)))
        ok = bool(require and np.isfinite(u).all() and np.isfinite(v).all()
                  and u.shape == ur.shape and aee <= AEE_TOL[family])
        fields.update(family=family, aee_vs_ref=aee, aee_tol=AEE_TOL[family])
        if family == "lk":
            share = float(((du < LK_BULK_TOL) & (dv < LK_BULK_TOL)).mean())
            ok = ok and share >= LK_BULK_SHARE
            fields.update(share_within_1e3=share, share_min=LK_BULK_SHARE)
        self.check(phase, ok, **fields)

    # -- phases ------------------------------------------------------------

    def configs_512(self, names, shape=(512, 512)):
        im1, im2, ut, vt = particle_image_pair(shape=shape, seed=0)
        d = self.put(im1, im2)
        for name in names:
            def case(name=name):
                fn = compiled_pipeline(name)
                got, rec, _ = self.timed(fn, d)
                want = self.on_ref(fn, (im1, im2))
                self.compare("configs", _family(name), got, want,
                             config=name, shape=list(shape),
                             aee_vs_truth=_aee(got, (ut, vt)), **rec)
            self.guarded("configs", name, case)

    def oracle_512(self, shape=(512, 512)):
        from opticalflow_ri.models.horn_schunck import hs_solve
        from opticalflow_ri.models.liu_shen import liu_shen_solve
        from opticalflow_ri.oracle import horn_schunck as ohs
        from opticalflow_ri.oracle import liu_shen as ols

        im1, im2, ut, vt = particle_image_pair(shape=shape, seed=0)
        z = np.zeros(shape, np.float32)

        def hs():
            got, rec, _ = self.timed(
                lambda a, b, u, v: hs_solve(a, b, 21.0, 100, u, v)[:2],
                self.put(im1, im2, z, z))
            want = ohs.hs_solve(im1, im2, 21.0, 100, z, z)[:2]
            self.compare("oracle", "hs_ls", got, want, solver="hs_solve",
                         iterations=100, dtype="float32", shape=list(shape),
                         **rec)

        def ls():
            # refine the true flow (internal convention: u along rows), so
            # the compared field is O(1 px), not O(1e-3)
            got, rec, _ = self.timed(
                lambda a, b, u, v: liu_shen_solve(a, b, 5.0, u, v,
                                                  max_iter=60)[:2],
                self.put(im1, im2, vt, ut))
            want = ols.liu_shen_solve(im1, im2, 5.0, vt, ut, max_iter=60)[:2]
            self.compare("oracle", "hs_ls", got, want,
                         solver="liu_shen_solve", iterations=60,
                         dtype="float32", shape=list(shape), **rec)

        self.guarded("oracle", "hs_solve", hs)
        self.guarded("oracle", "liu_shen_solve", ls)

    def sizes(self, cases=SIZE_CASES):
        from opticalflow_ri.models.liu_shen import liu_shen_solve

        for label, name, shape in cases:
            def case(label=label, name=name, shape=shape):
                im1, im2, ut, vt = particle_image_pair(shape=shape, seed=0)
                if name is None:
                    z = np.zeros(shape, np.float32)
                    fn = (lambda a, b, u, v:
                          liu_shen_solve(a, b, 10.0, u, v, max_iter=60,
                                         tol=0.0)[:2])
                    args, family = (im1, im2, z, z), "hs_ls"
                else:
                    fn, args, family = (compiled_pipeline(name), (im1, im2),
                                        _family(name))
                got, rec, compiled = self.timed(fn, self.put(*args))
                want = self.on_ref(fn, args)
                stats = self.accel.memory_stats() or {}
                self.compare("sizes", family, got, want, case=label,
                             shape=list(shape),
                             memory_analysis=_memory(compiled),
                             peak_bytes_in_use=stats.get("peak_bytes_in_use"),
                             **rec)
            self.guarded("sizes", label, case)

    def entry_points(self, shape=(512, 512), k=8):
        from opticalflow_ri import (
            GenericPyramidalOpticalFlowWrapper, HSOpticalFlowAlgoAdapter,
        )

        im1, im2, _, _ = particle_image_pair(shape=shape, seed=0)

        def wrapper():
            d1, d2 = self.put(im1, im2)
            wrap = GenericPyramidalOpticalFlowWrapper(
                HSOpticalFlowAlgoAdapter([21.0], 600), filter_sigma=3.4,
                pyr_levels=1)
            t0 = time.perf_counter()
            got = _host(jax.block_until_ready(wrap.calculateFlow(d1, d2)))
            first_s = time.perf_counter() - t0
            want = _host(compiled_pipeline("PyHSchunck_Fs3_4")(d1, d2))
            self.compare("entry_points", "hs_ls", got, want,
                         entry="GenericPyramidalOpticalFlowWrapper",
                         versus="compiled_pipeline(PyHSchunck_Fs3_4)",
                         shape=list(shape), first_call_s=first_s)

        def scan(name):
            pairs = [particle_image_pair(shape=shape, seed=s)[:2]
                     for s in range(k)]
            s1 = np.stack([p[0] for p in pairs])
            s2 = np.stack([p[1] for p in pairs])
            got, rec, _ = self.timed(scan_pipeline(name), self.put(s1, s2))
            single = compiled_pipeline(name)
            want = [_host(single(*self.put(a, b))) for a, b in pairs]
            want = (np.stack([w[0] for w in want]),
                    np.stack([w[1] for w in want]))
            self.compare("entry_points", _family(name), got, want,
                         entry="scan_pipeline", config=name, k=k,
                         versus="k x compiled_pipeline",
                         bit_identical=_identical(got, want),
                         shape=list(shape), **rec)

        self.guarded("entry_points", "wrapper", wrapper)
        for name in SCAN_CONFIGS:
            self.guarded("entry_points", f"scan:{name}", scan, name)

    def four_cards(self, devices, k=16, small=(512, 512), big=(2048, 2048)):
        """Multi-card paths on ``devices`` (4) against the first device."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from opticalflow_ri.models.horn_schunck import hs_solve
        from opticalflow_ri.models.liu_shen import liu_shen_solve
        from opticalflow_ri.parallel import (
            batch_sharded_scan, batch_sharding, hs_solve_sharded,
            liu_shen_solve_sharded, make_mesh,
        )
        from opticalflow_ri.parallel.auto import auto_sharded_pipeline

        n = len(devices)

        def spread(out):
            """Every output lives on all n devices, none on device 0 only."""
            return all(len(o.sharding.device_set) == n for o in out)

        def batch_scan(name):
            mesh = make_mesh(n, batch=n, devices=devices)
            pairs = [particle_image_pair(shape=small, seed=s)[:2]
                     for s in range(k)]
            s1 = np.stack([p[0] for p in pairs])
            s2 = np.stack([p[1] for p in pairs])
            sh = batch_sharding(mesh)
            args = [jax.device_put(jnp.asarray(a), sh) for a in (s1, s2)]
            fn = batch_sharded_scan(name, mesh)
            out, rec, compiled = self.timed(fn, args)
            spread_ok = spread(compiled(*args))
            want = _host(scan_pipeline(name)(*self.put(s1, s2)))
            self.compare("four_cards", _family(name), out, want,
                         path="batch_sharded_scan", config=name, k=k,
                         mesh=dict(mesh.shape), shape=list(small),
                         bit_identical=_identical(out, want),
                         spread_over_devices=spread_ok, require=spread_ok,
                         **rec)

        def auto(name):
            mesh = make_mesh(n, devices=devices)
            im1, im2, _, _ = particle_image_pair(shape=big, seed=0)
            sh = NamedSharding(mesh, P("y", "x"))
            args = [jax.device_put(jnp.asarray(a), sh) for a in (im1, im2)]
            fn = auto_sharded_pipeline(name, mesh)
            out, rec, compiled = self.timed(fn, args)
            spread_ok = spread(compiled(*args))
            want = _host(compiled_pipeline(name)(*self.put(im1, im2)))
            self.compare("four_cards", _family(name), out, want,
                         path="auto_sharded_pipeline", config=name,
                         mesh=dict(mesh.shape), shape=list(big),
                         spread_over_devices=spread_ok, require=spread_ok,
                         **rec)

        def solver(label):
            mesh = make_mesh(n, devices=devices)
            im1, im2, ut, vt = particle_image_pair(shape=big, seed=0)
            z = np.zeros(big, np.float32)
            sh = NamedSharding(mesh, P("y", "x"))
            if label == "hs_solve_sharded":
                shard_fn = (lambda a, b, u, v:
                            hs_solve_sharded(mesh, a, b, 21.0, 100, u, v)[:2])
                one_fn = lambda a, b, u, v: hs_solve(a, b, 21.0, 100, u, v)[:2]
                host = (im1, im2, z, z)
            else:
                shard_fn = (lambda a, b, u, v: liu_shen_solve_sharded(
                    mesh, a, b, 5.0, u, v, max_iter=60)[:2])
                one_fn = (lambda a, b, u, v:
                          liu_shen_solve(a, b, 5.0, u, v, max_iter=60)[:2])
                host = (im1, im2, vt, ut)
            args = [jax.device_put(jnp.asarray(a), sh) for a in host]
            out, rec, compiled = self.timed(shard_fn, args)
            spread_ok = spread(compiled(*args))
            want = _host(jax.jit(one_fn)(*self.put(*host)))
            self.compare("four_cards", "hs_ls", out, want, path=label,
                         mesh=dict(mesh.shape), shape=list(big),
                         spread_over_devices=spread_ok, require=spread_ok,
                         **rec)

        for name in ("PyHSchunck_Fs3_4", "denseLK_Fs2_0"):
            self.guarded("four_cards", f"batch_sharded_scan:{name}",
                         batch_scan, name)
        for name in ("PyHSchunck_Fs3_4", "Farneback_Fs0_0"):
            self.guarded("four_cards", f"auto_sharded_pipeline:{name}",
                         auto, name)
        for label in ("hs_solve_sharded", "liu_shen_solve_sharded"):
            self.guarded("four_cards", label, solver, label)


def _family(name):
    """Parity family of a registered config: its loosest solver."""
    cfg = build_config(name)
    adapters = [cfg.main()] + ([cfg.optional()] if cfg.optional else [])
    if any(isinstance(a, DenseLucasKanadeAdapter) for a in adapters):
        return "lk"
    if any(isinstance(a, FarnebackAdapter) for a in adapters):
        return "fb"
    return "hs_ls"


def _host(out):
    return tuple(np.asarray(o) for o in out) if isinstance(
        out, (tuple, list)) else np.asarray(out)


def _aee(got, want):
    return float(np.mean(np.hypot(got[0] - want[0], got[1] - want[1])))


def _identical(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _memory(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: getattr(ma, k) for k in dir(ma)
            if k.endswith("_in_bytes") and not k.startswith("_")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths on four GPUs")
    args = ap.parse_args(argv)

    rec = require_gpu()
    devices = jax.devices()
    accel = devices[0]
    if args.four_cards and len(devices) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees {len(devices)}")
    cache_dir = configure_compile_cache()
    card = rec["nvidia_smi"]
    smoke = Smoke(accel, jax.devices("cpu")[0], card)
    smoke.emit("device", platform=accel.platform, count=len(devices),
               jax=jax.__version__, compile_cache=cache_dir)

    t_all = time.perf_counter()
    if args.four_cards:
        phases = [("four_cards", lambda: smoke.four_cards(devices[:4]))]
    else:
        phases = [("configs", lambda: smoke.configs_512(sorted(CONFIGS))),
                  ("oracle", smoke.oracle_512),
                  ("sizes", smoke.sizes),
                  ("entry_points", smoke.entry_points)]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        smoke.emit("elapsed", of=name, seconds=time.perf_counter() - t0)
    smoke.emit("elapsed", of="all", seconds=time.perf_counter() - t_all,
               failures=len(smoke.failures))

    print(card)  # the card's name and power limit, as nvidia-smi gives them
    if smoke.failures:
        for phase, fields in smoke.failures:
            print(f"FAILED {phase}: {json.dumps(fields, default=str)}",
                  file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": accel.platform, "kind": accel.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
