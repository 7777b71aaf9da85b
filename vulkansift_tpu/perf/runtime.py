"""CLI: runtime benchmark (parity: src/perf/perf_runtime.cpp).

Usage: python -m vulkansift_tpu.perf.runtime IMAGE_PATH DETECTOR_NAME
       [--warmup N] [--iters N]
"""

import argparse
import sys

import numpy as np

from .harness import DETECTORS, NB_ITER_MEAS, NB_ITER_WARMUP, \
    run_runtime_benchmark
from ..utils.compile_cache import enable_compile_cache


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image")
    ap.add_argument("detector", choices=sorted(DETECTORS))
    ap.add_argument("--warmup", type=int, default=NB_ITER_WARMUP)
    ap.add_argument("--iters", type=int, default=NB_ITER_MEAS)
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    enable_compile_cache()

    import cv2
    image = cv2.imread(args.image, 0)
    if image is None:
        print(f"Failed to read image {args.image}", file=sys.stderr)
        return 1
    det = DETECTORS[args.detector]()
    det.init()
    mean_ms, nb = run_runtime_benchmark(
        image, det, warmup=args.warmup, iters=args.iters,
        out_dir=args.out_dir)
    print(f"{args.detector}: {mean_ms:.3f} ms mean, {nb} features")
    det.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
