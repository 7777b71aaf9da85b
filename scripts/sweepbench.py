"""Mixed-resolution sweep: compile-time share with/without bucketing.

The reference re-creates images on preallocated memory at zero cost per
resolution change (sift_memory.c:891-924); under XLA each distinct padded
resolution is a compiled program. resolution_bucket bounds the number of
programs. This sweep runs 8 Oxford-like resolutions x N images each and
reports wall-clock and its compile share for bucket=1 vs bucket=128.

Usage: python scripts/sweepbench.py [imgs_per_set]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RESOLUTIONS = [(640, 480), (765, 512), (800, 640), (850, 680),
               (880, 700), (921, 614), (1000, 700), (512, 384)]


def run(bucket: int, imgs_per_set: int) -> None:
    import vulkansift_tpu as vs
    cfg = vs.SiftConfig(use_input_upsampling=False,
                        max_nb_sift_per_buffer=16384,
                        input_image_max_size=1 << 21,
                        resolution_bucket=bucket,
                        detect_cache_size=16,
                        retain_pyramid=False)
    inst = vs.SiftInstance(cfg)
    rng = np.random.default_rng(0)
    total = 0.0
    first_costs = []
    warm = []
    feats = 0
    for (w, h) in RESOLUTIONS:
        imgs = [(rng.random((h, w)) * 255).astype(np.uint8)
                for _ in range(imgs_per_set)]
        for i, img in enumerate(imgs):
            t0 = time.perf_counter()
            inst.detect_features(img, 0)
            feats += inst.get_features_number(0)
            dt = time.perf_counter() - t0
            total += dt
            (first_costs if i == 0 else warm).append(dt)
    warm_mean = float(np.mean(warm)) if warm else 0.0
    compile_s = sum(max(f - warm_mean, 0.0) for f in first_costs)
    print(f"bucket={bucket:4d}: total {total:7.2f} s, compile-attributable "
          f"{compile_s:6.2f} s ({100 * compile_s / total:5.1f}%), "
          f"warm {warm_mean * 1e3:6.1f} ms/img, programs "
          f"{len(inst._detect_cache)}, {feats} feats", flush=True)
    inst.close()


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    run(128, n)
    run(1, n)


if __name__ == "__main__":
    main()
