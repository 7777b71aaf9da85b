"""Multi-device scaling-efficiency measurement (BASELINE north star: >=80%
frames/s scaling efficiency at 4 devices).

Measures data-parallel batched-detect throughput over 1..N-device meshes
and reports frames/s + two efficiency views:

* ``efficiency``   = fps(N) / (N * fps(1)) — the real wall-clock scaling
  number. Only meaningful when the N devices are physically parallel
  (real chips, or >= N host cores for a virtual CPU mesh).
* ``work_efficiency`` = fps(N) / fps(1) — throughput of the sharded
  program relative to the unsharded one when all "devices" serialize onto
  the same silicon (a 1-core host). 1.0 means sharding adds no work and
  no collective/glue overhead; the forward DP path has no collectives
  (parallel/dp.py), so on real devices wall-clock efficiency is then
  bounded only by host I/O and per-device dispatch.

On a virtual CPU mesh wall-clock ``efficiency`` mostly measures core
time-slicing; neither view is a device metric there.
CLI: ``python -m vulkansift_tpu.parallel.scaling``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from .dp import make_dp_detect_fn, shard_batch
from .mesh import make_mesh
from ..utils.compile_cache import enable_compile_cache


def measure_dp_scaling(config: SiftConfig, width: int, height: int, *,
                       per_device_batch: int = 2,
                       device_counts: Optional[List[int]] = None,
                       iters: int = 5,
                       seed: int = 0) -> Dict:
    """Throughput of data-parallel batched detect at several mesh sizes.

    Returns {"points": [{"devices", "fps", "ms_per_frame", "efficiency"}],
    "config": ...}. Efficiency = fps(N) / (N * fps(1)).
    """
    nb_dev = len(jax.devices())
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= nb_dev]
    rng = np.random.default_rng(seed)
    points = []
    fps1 = None
    for n in device_counts:
        mesh = make_mesh(n)
        batch = per_device_batch * n
        images = rng.integers(0, 256, (batch, height, width), np.uint8)
        fn = make_dp_detect_fn(config, width, height, mesh)
        dev_images = shard_batch(images, mesh)
        out = fn(dev_images)
        jax.device_get(out.features.count)  # compile+sync
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(dev_images)
            jax.device_get(out.features.count)
        dt = (time.perf_counter() - t0) / (iters * batch)
        fps = 1.0 / dt
        if fps1 is None:
            fps1 = fps
        points.append(dict(devices=n, fps=round(fps, 2),
                           ms_per_frame=round(dt * 1e3, 3),
                           efficiency=round(fps / (n * fps1), 3),
                           work_efficiency=round(fps / fps1, 3)))
    return dict(points=points,
                resolution=f"{width}x{height}",
                per_device_batch=per_device_batch,
                backend=jax.default_backend(),
                host_cores=os.cpu_count())


def main(argv=None):  # pragma: no cover - CLI
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--max-features", type=int, default=8192)
    args = ap.parse_args(argv)
    enable_compile_cache()
    cfg = SiftConfig(use_input_upsampling=False,
                     max_nb_sift_per_buffer=args.max_features,
                     sift_buffer_count=1,
                     input_image_max_size=args.width * args.height)
    result = measure_dp_scaling(cfg, args.width, args.height,
                                per_device_batch=args.batch,
                                iters=args.iters)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":  # pragma: no cover
    main()
