"""Headline benchmark: SIFT detect throughput on one GPU.

Protocol mirrors the reference's perf harness (docs/Performances.md:22 —
warmup + timed full detections on a Hannover-shaped 1536x1024 image).
Baseline: VulkanSift on RTX 2060 = 16.47 ms mean (docs/Performances.md:24-27)
= 60.72 fps.

Measurement mode: the reference API contract makes detectFeatures a
non-blocking submit with N result buffers for pipelining
(vulkansift.h:40-47, vksift_Config.sift_buffer_count). We report pipelined
throughput: dispatch BATCH detections back-to-back, wait for all of them
with ``block_until_ready``, and divide; the single-image latency (one
detect plus its wait) goes in the unit string.

Every JSON line names the device (platform, kind, count) and the card's
name and power limit. The run refuses any device but a GPU and exits
non-zero on the first failure; the headline 1536x1024 line is printed last.

Usage: python bench.py   (BENCH_WARMUP, BENCH_BATCHES, BENCH_BATCH and
BENCH_SKIP_{NORTHSTAR,BIG,MATCH}=1 adjust the run)
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_MS = 16.47  # VulkanSift, RTX 2060, Hannover 1536x1024
W, H = 1536, 1024
WARMUP = int(os.environ.get("BENCH_WARMUP", "5"))
BATCHES = int(os.environ.get("BENCH_BATCHES", "12"))
BATCH = int(os.environ.get("BENCH_BATCH", "24"))


def _bench_image(h, w, seed=0):
    """Deterministic textured image (Hannover images are high-detail
    outdoor photos; multi-scale noise approximates their keypoint
    density)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    for cell in (8, 16, 32, 64):
        small = rng.random((h // cell + 1, w // cell + 1))
        ys = np.linspace(0, small.shape[0] - 1.001, h)
        xs = np.linspace(0, small.shape[1] - 1.001, w)
        yi, xi = ys.astype(int), xs.astype(int)
        fy, fx = (ys - yi)[:, None], (xs - xi)[None, :]
        img += ((1 - fy) * (1 - fx) * small[yi][:, xi]
                + (1 - fy) * fx * small[yi][:, xi + 1]
                + fy * (1 - fx) * small[yi + 1][:, xi]
                + fy * fx * small[yi + 1][:, xi + 1])
    img -= img.min()
    return (255 * img / img.max()).astype(np.uint8)


def _line(stamp, metric, value, unit, vs_baseline):
    return json.dumps(dict(metric=metric, value=value, unit=unit,
                           vs_baseline=vs_baseline, **stamp))


def _time_pipelined(fn, args_cycle, batch, batches, warmup):
    """Seconds per call: ``batch`` calls dispatched back-to-back, then one
    ``block_until_ready`` on all outputs, repeated ``batches`` times."""
    import jax
    for _ in range(warmup):
        jax.block_until_ready([fn(args_cycle[i % len(args_cycle)])
                               for i in range(batch)])
    t0 = time.perf_counter()
    for _ in range(batches):
        jax.block_until_ready([fn(args_cycle[i % len(args_cycle)])
                               for i in range(batch)])
    return (time.perf_counter() - t0) / (batches * batch)


def main():
    from vulkansift_tpu.utils.compile_cache import enable_compile_cache
    from vulkansift_tpu.utils.accelerator import (
        card_name_and_power, device_record, require_gpu)

    card = card_name_and_power()
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from vulkansift_tpu import SiftConfig
    from vulkansift_tpu.ops import match as match_mod
    from vulkansift_tpu.pipeline import make_detect_fn

    devices = jax.devices()
    require_gpu(devices)
    stamp = {"device": device_record(devices), "card": card}

    # --- 640x480 north-star config (BASELINE #1) --------------------------
    if os.environ.get("BENCH_SKIP_NORTHSTAR") != "1":
        ns_cfg = SiftConfig(use_input_upsampling=False,
                            max_nb_sift_per_buffer=4096,
                            sift_buffer_count=2,
                            input_image_max_size=640 * 480)
        ns_detect = jax.jit(make_detect_fn(ns_cfg, 640, 480))
        ns_imgs = [jnp.asarray(_bench_image(480, 640, seed=s))
                   for s in range(2)]
        ns_n = int(ns_detect(ns_imgs[0]).features.count)
        dt = _time_pipelined(ns_detect, ns_imgs, BATCH, BATCHES, WARMUP)
        # The reference's RTX 2060 Oxford data is plot-only
        # (docs/Performances.md:39-52); its curve at ~2.5k features reads
        # ~6.8 ms.
        print(_line(stamp, "sift_detect_fps_640x480", 1 / dt,
                    f"frames/s pipelined ({dt * 1e3:.3f} ms/frame; {ns_n} "
                    f"feats; no upsampling, 4k buffer; ref RTX2060 Oxford "
                    f"plot ~6.8 ms)", 6.8e-3 / dt), flush=True)

    # --- Hannover-large 3456x2304 (docs/Performances.md:24-27: 73.29 ms) --
    if os.environ.get("BENCH_SKIP_BIG") != "1":
        bw, bh = 3456, 2304
        big_cfg = SiftConfig(use_input_upsampling=True,
                             max_nb_sift_per_buffer=32768,
                             sift_buffer_count=2,
                             input_image_max_size=bw * bh)
        big_detect = jax.jit(make_detect_fn(big_cfg, bw, bh))
        big_img = jnp.asarray(_bench_image(bh, bw, seed=0))
        big_n = int(big_detect(big_img).features.count)
        dt = _time_pipelined(big_detect, [big_img], max(4, BATCH // 4),
                             max(3, BATCHES // 4), 2)
        print(_line(stamp, "sift_detect_fps_3456x2304", 1 / dt,
                    f"frames/s pipelined ({dt * 1e3:.3f} ms/frame; {big_n} "
                    f"feats; ref RTX2060 73.29 ms)", 73.29e-3 / dt),
              flush=True)
        del big_detect, big_img

    # --- 2-NN matcher at 16k x 16k ----------------------------------------
    if os.environ.get("BENCH_SKIP_MATCH") != "1":
        nm = 16384
        da = jax.random.randint(jax.random.PRNGKey(0), (nm, 128), 0, 256,
                                jnp.int32).astype(jnp.uint8)
        db = jax.random.randint(jax.random.PRNGKey(1), (nm, 128), 0, 256,
                                jnp.int32).astype(jnp.uint8)
        cnt = jnp.int32(nm)
        mfn = jax.jit(lambda a: match_mod.match_2nn(a, cnt, db, cnt))
        jax.block_until_ready(mfn(da))
        dt = _time_pipelined(mfn, [da], 16, 8, 2)
        # The reference publishes no matching number: no baseline.
        print(_line(stamp, "sift_match_2nn_16k_ms", dt * 1e3,
                    f"ms per {nm}x{nm} u8-descriptor 2-NN match", None),
              flush=True)

    # --- headline: 1536x1024 upsampled, 32k buffer (printed last) ---------
    cfg = SiftConfig(use_input_upsampling=True,
                     max_nb_sift_per_buffer=32768,
                     sift_buffer_count=2,
                     input_image_max_size=W * H)
    detect = jax.jit(make_detect_fn(cfg, W, H))
    imgs = [jnp.asarray(_bench_image(H, W, seed=s)) for s in range(2)]
    n = int(detect(imgs[0]).features.count)
    for _ in range(WARMUP):
        jax.block_until_ready(detect(imgs[0]))
    t0 = time.perf_counter()
    lat_iters = 10
    for _ in range(lat_iters):
        jax.block_until_ready(detect(imgs[0]))
    lat_ms = (time.perf_counter() - t0) / lat_iters * 1e3
    dt = _time_pipelined(detect, imgs, BATCH, BATCHES, WARMUP)
    print(_line(stamp, "sift_detect_fps_1536x1024", 1 / dt,
                f"frames/s pipelined ({dt * 1e3:.3f} ms/frame; single-image "
                f"latency {lat_ms:.3f} ms; {n} feats; ref RTX2060 "
                f"{BASELINE_MS} ms)", BASELINE_MS * 1e-3 / dt),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
