"""Production streaming runner: datasets of image pairs through a compiled
pipeline, with prefetching, checkpoint/resume, failure isolation and
profiling.

The reference processes one pair per script run with no recovery story
(SURVEY.md section 5); this runner is the serving-scale counterpart:

  * pairs stream through ``compile.scan_pipeline`` (one XLA dispatch per
    batch, pairs processed sequentially on device with the single-pair
    working set), with the next batch decoded on host threads (native C++
    TIFF runtime when available) while the device computes;
  * a JSON checkpoint records completed pairs; re-running with the same
    output directory resumes where it stopped;
  * per-batch failures are caught, logged and skipped — one corrupt frame
    cannot kill a long campaign;
  * ``profile_dir`` captures a jax.profiler trace of the steady state for
    xprof analysis.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from queue import Queue

import numpy as np

log = logging.getLogger("opticalflow_ri")


class FlowBatchRunner:
    def __init__(self, config_name: str, batch_size: int = 4,
                 output_dir: str = "flow_out", save_outputs: bool = True,
                 checkpoint_every: int = 1, profile_dir: str | None = None,
                 pipeline: str = "scan", mesh=None):
        if pipeline not in ("scan", "batched"):
            raise ValueError(f"pipeline must be 'scan' or 'batched', got {pipeline!r}")
        self.config_name = config_name
        self.pipeline = pipeline
        self.batch_size = int(batch_size)
        # ``mesh``: shard each batch over the mesh 'batch' axis — every
        # device streams its own slice of the campaign through the scan
        # pipeline, zero collectives
        # (parallel/batch_stream.py)
        self.mesh = mesh
        if mesh is not None:
            if pipeline != "scan":
                raise ValueError("mesh campaigns use the scan pipeline")
            nb = mesh.shape["batch"]
            if self.batch_size % nb:
                raise ValueError(
                    f"batch_size {self.batch_size} must be a multiple of the "
                    f"mesh batch axis ({nb})")
        self.output_dir = output_dir
        self.save_outputs = save_outputs
        self.checkpoint_every = checkpoint_every
        self.profile_dir = profile_dir
        os.makedirs(output_dir, exist_ok=True)
        self._ckpt_path = os.path.join(output_dir, "progress.json")

    # -- checkpointing ------------------------------------------------------

    def _load_checkpoint(self) -> dict:
        if os.path.exists(self._ckpt_path):
            with open(self._ckpt_path) as f:
                return json.load(f)
        return {"config": self.config_name, "done": [], "failed": []}

    def _save_checkpoint(self, state: dict) -> None:
        tmp = self._ckpt_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self._ckpt_path)

    # -- pipeline -----------------------------------------------------------

    def run(self, pairs) -> dict:
        """``pairs``: list of (name, im1_path, im2_path).  Returns the final
        checkpoint state (with timing stats added).

        Three-stage overlapped pipeline — the device never waits on host IO
        and the host transfers never block the next dispatch:

          producer thread : decode TIFFs -> ``jax.device_put`` (async H2D)
          main loop       : dispatch the compiled pipeline (async) only
          writer thread   : wait for completion, D2H, write ``.mat``
                            outputs, own the checkpoint state
        """
        import jax
        from opticalflow_ri.compile import batched_pipeline, scan_pipeline
        from opticalflow_ri.parallel.batch_stream import (
            batch_sharded_scan, batch_sharding,
        )
        from opticalflow_ri.utils.io import load_image_batch, save_flow

        state = self._load_checkpoint()
        if state.get("config") != self.config_name:
            raise ValueError(
                f"checkpoint in {self.output_dir} belongs to config "
                f"{state.get('config')!r}, not {self.config_name!r}"
            )
        done = set(state["done"])
        todo = [p for p in pairs if p[0] not in done]
        if not todo:
            return state

        if self.mesh is not None:
            fn = batch_sharded_scan(self.config_name, self.mesh)
            put_sharding = batch_sharding(self.mesh)
            device_put = lambda a: jax.device_put(a, put_sharding)
        else:
            fn = (scan_pipeline if self.pipeline == "scan"
                  else batched_pipeline)(self.config_name)
            device_put = jax.device_put

        batches = [todo[i : i + self.batch_size]
                   for i in range(0, len(todo), self.batch_size)]
        in_q: Queue = Queue(maxsize=2)
        out_q: Queue = Queue(maxsize=2)  # bounds device arrays in flight

        def producer():
            for chunk in batches:
                names = [c[0] for c in chunk]
                try:
                    im1 = load_image_batch([c[1] for c in chunk])
                    im2 = load_image_batch([c[2] for c in chunk])
                    n_real = im1.shape[0]
                    if n_real < self.batch_size:  # pad the ragged tail
                        pad = self.batch_size - n_real
                        im1 = np.concatenate([im1, np.repeat(im1[-1:], pad, 0)])
                        im2 = np.concatenate([im2, np.repeat(im2[-1:], pad, 0)])
                    # async H2D: overlaps the upload with compute
                    # (pre-sharded over the mesh batch axis when meshed)
                    in_q.put((names, device_put(im1), device_put(im2)))
                except Exception as e:  # pragma: no cover - IO failure path
                    in_q.put((names, e, None))
            in_q.put(None)

        stats = {"batches": 0, "compute_wait_s": 0.0, "transfer_save_s": 0.0}

        def writer():
            # The writer thread is the sole owner of ``state`` while the
            # pipeline runs: the main loop routes its failures through out_q
            # instead of mutating state directly, so a checkpoint can never
            # be serialized mid-update and silently drop in-flight failures.
            while True:
                item = out_q.get()
                if item is None:
                    return
                names, u, v = item
                if u is None:  # failure already logged by the main loop
                    state["failed"].extend(names)
                    continue
                try:
                    t0 = time.perf_counter()
                    jax.block_until_ready((u, v))
                    t1 = time.perf_counter()
                    un = np.asarray(u)  # D2H
                    vn = np.asarray(v)
                    if self.save_outputs:
                        for i, name in enumerate(names):
                            save_flow(un[i], vn[i],
                                      os.path.join(self.output_dir, f"{name}.mat"))
                    stats["compute_wait_s"] += t1 - t0
                    stats["transfer_save_s"] += time.perf_counter() - t1
                except Exception as e:
                    log.error("compute failed for %s: %r", names, e)
                    state["failed"].extend(names)
                    continue
                state["done"].extend(names)
                stats["batches"] += 1
                if stats["batches"] % self.checkpoint_every == 0:
                    self._save_checkpoint(state)

        threading.Thread(target=producer, daemon=True).start()
        writer_t = threading.Thread(target=writer, daemon=True)
        writer_t.start()

        profiling = False
        n_dispatched = 0
        t0_all = time.perf_counter()
        while True:
            item = in_q.get()
            if item is None:
                break
            names, im1, im2 = item
            if isinstance(im1, Exception):
                log.error("load failed for %s: %r", names, im1)
                out_q.put((names, None, None))
                continue

            if self.profile_dir and n_dispatched == 1 and not profiling:
                jax.profiler.start_trace(self.profile_dir)
                profiling = True

            try:
                u, v = fn(im1, im2)  # async dispatch
            except Exception as e:
                log.error("dispatch failed for %s: %r", names, e)
                out_q.put((names, None, None))
                continue
            out_q.put((names, u, v))
            n_dispatched += 1

        out_q.put(None)
        writer_t.join()
        wall = time.perf_counter() - t0_all
        if profiling:
            jax.profiler.stop_trace()
        state["batches"] = stats["batches"]
        if stats["batches"]:
            state["seconds_per_batch"] = wall / stats["batches"]
            state["compute_wait_s"] = stats["compute_wait_s"]
            state["transfer_save_s"] = stats["transfer_save_s"]
        self._save_checkpoint(state)
        return state


def pairs_from_glob(pattern0: str, pattern1: str):
    """Build (name, path0, path1) pairs from two glob patterns that sort into
    correspondence (e.g. 'data/*_0.tif' and 'data/*_1.tif')."""
    import glob

    first = sorted(glob.glob(pattern0))
    second = sorted(glob.glob(pattern1))
    if len(first) != len(second):
        raise ValueError(f"pair count mismatch: {len(first)} vs {len(second)}")
    pairs = []
    for p0, p1 in zip(first, second):
        name = os.path.splitext(os.path.basename(p0))[0]
        pairs.append((name, p0, p1))
    return pairs


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--glob0", required=True, help="glob for frame-0 images")
    ap.add_argument("--glob1", required=True, help="glob for frame-1 images")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--out", default="flow_out")
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--pipeline", choices=("scan", "batched"), default="scan")
    ap.add_argument("--mesh-batch", type=int, default=0,
                    help="shard each batch over N devices (mesh batch axis); "
                         "batch-size must be a multiple of N")
    args = ap.parse_args()

    from opticalflow_ri.compile import configure_compile_cache

    configure_compile_cache()
    mesh = None
    if args.mesh_batch > 1:
        from opticalflow_ri.parallel import make_mesh

        mesh = make_mesh(args.mesh_batch, batch=args.mesh_batch)

    runner = FlowBatchRunner(args.config, batch_size=args.batch_size,
                             output_dir=args.out, profile_dir=args.profile_dir,
                             pipeline=args.pipeline, mesh=mesh)
    state = runner.run(pairs_from_glob(args.glob0, args.glob1))
    done = len(state.get("done", []))
    failed = len(state.get("failed", []))
    spb = state.get("seconds_per_batch")
    rate = f", {args.batch_size / spb:.1f} pairs/s" if spb else ""
    print(f"{done} pairs done, {failed} failed{rate} -> {args.out}")


if __name__ == "__main__":
    main()
