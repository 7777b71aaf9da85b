"""Profiler-attachable loop (parity: src/examples/test_sift_gpu_debug.cpp —
upload/detect/download round-trips with timing prints; the reference's
DebugPresenter frame-delimiter hack becomes a jax.profiler trace session)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trace-dir", default=None,
                    help="write a jax.profiler trace (the DebugPresenter analogue)")
    args = ap.parse_args()

    import cv2
    import vulkansift_tpu as vs

    rng = np.random.default_rng(3)
    img = cv2.resize(rng.random((96, 128)), (1024, 768),
                     interpolation=cv2.INTER_CUBIC)
    img = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)

    with vs.SiftInstance(vs.SiftConfig(
            max_nb_sift_per_buffer=16384,
            input_image_max_size=4096 * 4096)) as inst:
        inst.detect_features(img, 0)  # compile
        inst.get_features_number(0)
        if args.trace_dir:
            inst.start_trace(args.trace_dir)
        for i in range(args.iters):
            t0 = time.perf_counter()
            inst.detect_features(img, 0)
            n = inst.get_features_number(0)
            t1 = time.perf_counter()
            feats = inst.download_features(0)
            t2 = time.perf_counter()
            print(f"iter {i}: detect+count {1e3 * (t1 - t0):.1f} ms, "
                  f"download {1e3 * (t2 - t1):.1f} ms, {n} features")
        if args.trace_dir:
            inst.stop_trace()
            print(f"trace written to {args.trace_dir}")


if __name__ == "__main__":
    main()
