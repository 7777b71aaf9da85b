"""A/B of the descriptor contraction's precision on the GPU.

The detect program asks for ``Precision.HIGHEST`` in the descriptor
histogram contraction (``ops.descriptor.DESC_PRECISION``); on Hopper the
default precision runs float32 matmuls in TF32. This script compiles the
upsampled 32k-buffer detect program at WxH once with each precision, times
both in alternation (HIGHEST, DEFAULT, DEFAULT, HIGHEST), and counts how
many u8 descriptor bins TF32 moves on the keypoints both runs find.

Usage: python scripts/desc_precision_ab.py [WxH] [reps]   (default
1536x1024, 5 calls per timing round). Refuses any device but a GPU.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import chip_smoke


def main(argv):
    from vulkansift_tpu.utils.accelerator import (card_name_and_power,
                                                  require_gpu)
    from vulkansift_tpu.utils.compile_cache import enable_compile_cache
    size = argv[1] if len(argv) > 1 else "1536x1024"
    reps = int(argv[2]) if len(argv) > 2 else 5
    w, h = (int(v) for v in size.split("x"))
    card = card_name_and_power().splitlines()[0]
    print(f"# card (name, power.limit): {card}", flush=True)
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    require_gpu(jax.devices())

    from vulkansift_tpu import SiftConfig
    from vulkansift_tpu.golden import compare
    from vulkansift_tpu.ops import descriptor
    from vulkansift_tpu.pipeline import make_detect_fn
    from vulkansift_tpu.types import features_to_numpy

    cfg = SiftConfig(use_input_upsampling=True, max_nb_sift_per_buffer=32768,
                     input_image_max_size=w * h)
    img = jnp.asarray(chip_smoke.textured_image(h, w, 7))
    arms = {}
    for name, prec in (("HIGHEST", jax.lax.Precision.HIGHEST),
                       ("DEFAULT", jax.lax.Precision.DEFAULT)):
        # The constant is read at trace time: drop every traced program so
        # the next lowering sees the new value.
        descriptor.DESC_PRECISION = prec
        jax.clear_caches()
        t0 = time.perf_counter()
        arms[name] = jax.jit(make_detect_fn(cfg, w, h)).lower(
            jax.ShapeDtypeStruct((h, w), jnp.uint8)).compile()
        print(f"# {name}: compiled in {time.perf_counter() - t0:.2f} s",
              flush=True)
    descriptor.DESC_PRECISION = jax.lax.Precision.HIGHEST

    times = {name: [] for name in arms}
    for name in ("HIGHEST", "DEFAULT", "DEFAULT", "HIGHEST"):
        fn = arms[name]
        jax.block_until_ready(fn(img))
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(img))
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        print(f"# time {w}x{h} detect, descriptor precision {name}: "
              f"{float(np.median(ts)) * 1e3} ms median of {len(ts)} "
              f"(block_until_ready; {card})", flush=True)

    feats = {}
    for name, fn in arms.items():
        out = jax.device_get(fn(img))
        feats[name] = features_to_numpy(out.features,
                                        int(out.features.count))
    ref, got = feats["HIGHEST"], feats["DEFAULT"]
    pair = compare.pair_features(ref, got, use_angle=True)
    ok = pair >= 0
    diff = np.abs(ref["descriptor"][ok].astype(np.int32)
                  - got["descriptor"][pair[ok]].astype(np.int32))
    moved = diff > 0
    print(f"# features: HIGHEST {len(ref)}, DEFAULT {len(got)}, paired "
          f"{int(ok.sum())}; bins moved {int(moved.sum())} of {diff.size} "
          f"({float(moved.mean())}), max move {int(diff.max())}; features "
          f"with a moved bin {float(moved.any(axis=1).mean())}", flush=True)
    summary, failures = compare.compare_features("DEFAULT vs HIGHEST", ref,
                                                 got)
    print(f"# {summary}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
