"""Profiler trace attribution for the detect pipeline: name the glue tail.

Runs the full jitted detect at a given resolution under
``jax.profiler.start_trace``, then reads the device planes of the produced
``*.xplane.pb`` with ``jax.profiler.ProfileData`` and aggregates per-HLO-op
device time by (a) the ``jax.named_scope`` pipeline stage of each op
(from the compiled HLO's metadata, scripts/hloattr.py) and (b) the
individual op name — printing the top-K ops so every small fusion in the
"long tail" gets a name and a pipeline line to blame.

Usage:  python scripts/tracebench.py [WxH] [iters] [top] [trace_dir]
Output: device lines seen, per-stage table + top-K op table (ms per frame,
averaged over ``iters`` frames).
"""

import collections
import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def bench_image(h, w, seed=0):
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


# Most specific first: nested scopes (ExtractKeypoints/DenseFrontend) must
# be attributed to the inner stage.
SCOPES = ("DenseFrontend", "Refine", "ScaleSpace", "ComputeOrientation",
          "ComputeDescriptors", "PackFeatures", "Matching",
          "ExtractKeypoints")


def device_events(trace_dir):
    """(line, name, dur_ns, stats) for the op events on the device planes
    of the newest trace under ``trace_dir``. Uses the "XLA Ops" line when
    the plane has one (one event per executed HLO op), else every line."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    assert paths, f"no trace files under {trace_dir}"
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        print(f"# {plane.name}: " + ", ".join(
            f"{ln.name} ({len(list(ln.events))})" for ln in lines))
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for ln in ops:
            for e in ln.events:
                yield ln.name, e.name, e.duration_ns, dict(e.stats)


def main():
    wh = sys.argv[1] if len(sys.argv) > 1 else "1536x1024"
    w, h = map(int, wh.split("x"))
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    top = int(sys.argv[3]) if len(sys.argv) > 3 else 60

    from vulkansift_tpu import SiftConfig
    from vulkansift_tpu.pipeline import make_detect_fn

    cfg = SiftConfig(use_input_upsampling=True,
                     max_nb_sift_per_buffer=32768,
                     sift_buffer_count=2,
                     input_image_max_size=w * h)
    detect = jax.jit(make_detect_fn(cfg, w, h))
    img = jnp.asarray(bench_image(h, w))

    # Attribution map from the executable's own HLO: trace event names ==
    # HLO instruction names, and fusions that carry no metadata inherit
    # their fused computation's scope (scripts/hloattr.py) — this is what
    # names the "unattributed sub-0.3ms fusion tail".
    hlo_attr = {}
    try:
        import hloattr
        hlo_attr = hloattr.build_attr(
            detect.lower(img).compile().as_text())
        print(f"# hlo attribution: {len(hlo_attr)} instructions")
    except Exception as e:  # noqa: BLE001
        print(f"# hlo attribution unavailable: {type(e).__name__}: {e}")

    n = int(detect(img).features.count)
    print(f"# {w}x{h}, {n} features; tracing {iters} frames")
    for _ in range(3):
        int(detect(img).features.count)

    tdir = (sys.argv[4] if len(sys.argv) > 4
            else tempfile.mkdtemp(prefix="vstrace_"))
    jax.profiler.start_trace(tdir)
    for _ in range(iters):
        out = detect(img)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()

    by_op = collections.Counter()
    op_count = collections.Counter()
    by_scope = collections.Counter()
    samples = {}
    for _line, name, dur, args in device_events(tdir):
        dur = dur / 1e3  # ns -> us
        by_op[name] += dur
        op_count[name] += 1
        meta = (args.get("tf_op") or args.get("long_name")
                or args.get("hlo_op") or "")
        # The HLO-derived map resolves fusions with no metadata.
        hname = str(args.get("hlo_op") or name).lstrip("%")
        hscope, hsrc = hlo_attr.get(hname, ("", "?"))
        scope = "?"
        for s in SCOPES:
            if s in hscope or s in str(meta):
                scope = s
                break
        by_scope[scope] += dur
        if name not in samples:
            samples[name] = (scope, (str(meta) or hscope)[:80]
                             + (f" @{hsrc}" if hsrc != "?" else ""))

    total = sum(by_op.values())
    print(f"\ntotal device time: {total / iters / 1e3:.2f} ms/frame "
          f"({len(by_op)} distinct ops, {sum(op_count.values())} events)")

    print("\n== by named scope (ms/frame) ==")
    for s, d in by_scope.most_common():
        print(f"  {s:22s} {d / iters / 1e3:8.3f}")

    print(f"\n== top {top} ops (ms/frame, count/frame) ==")
    shown = 0.0
    for name, d in by_op.most_common(top):
        scope, meta = samples[name]
        shown += d
        print(f"  {d / iters / 1e3:7.3f}  x{op_count[name] / iters:5.1f} "
              f" [{scope:>18s}] {name[:80]}")
        if meta and meta != name:
            print(f"           {meta}")
    rest = total - shown
    print(f"  {rest / iters / 1e3:7.3f}  (everything below top {top}: "
          f"{len(by_op) - top} ops)")
    print(f"\ntrace dir: {tdir}")


if __name__ == "__main__":
    main()
