"""Batched multi-image detect throughput (BASELINE config #4).

Compares single-image pipelined dispatch vs vmapped batched detect at the
same resolution. Usage: python scripts/batchbench.py [WxH] [B]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    wh = sys.argv[1] if len(sys.argv) > 1 else "640x480"
    w, h = map(int, wh.split("x"))
    bsz = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    from vulkansift_tpu import SiftConfig
    from vulkansift_tpu.pipeline import make_detect_batched, make_detect_fn

    cfg = SiftConfig(use_input_upsampling=True,
                     max_nb_sift_per_buffer=16384,
                     input_image_max_size=w * h)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(
        (rng.random((bsz, h, w)) * 255).astype(np.uint8))

    single = jax.jit(make_detect_fn(cfg, w, h))
    batched = jax.jit(make_detect_batched(cfg, w, h))

    def timed(fn, args, frames, k=8):
        out = fn(*args)
        _ = np.asarray(jax.tree.leaves(out)[0]).ravel()[:1]

        def run(n):
            t0 = time.perf_counter()
            o = None
            for _ in range(n):
                o = fn(*args)
            _ = np.asarray(jax.tree.leaves(o)[0]).ravel()[:1]
            return time.perf_counter() - t0

        run(2)
        t1 = min(run(k) for _ in range(2))
        t2 = min(run(2 * k) for _ in range(2))
        return (t2 - t1) / k * 1e3 / frames

    ms1 = timed(single, (imgs[0],), 1)
    n1 = int(single(imgs[0]).features.count)
    print(f"single  : {ms1:7.2f} ms/frame ({n1} feats)", flush=True)
    msb = timed(batched, (imgs,), bsz)
    ob = batched(imgs)
    print(f"batch={bsz}: {msb:7.2f} ms/frame "
          f"(counts {np.asarray(ob.features.count)[:4]}...; "
          f"speedup {ms1 / msb:.2f}x)", flush=True)


if __name__ == "__main__":
    main()
