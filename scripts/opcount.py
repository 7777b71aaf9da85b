"""Static glue census: count lowered StableHLO ops per pipeline stage.

A device trace of the detect program shows a long tail of small fusions.
Each tiny fusion is real dispatch + read-modify-write traffic; the tail's
size tracks the number of ops the program lowers to. This tool needs NO hardware: it lowers the full jitted
detect for the current backend and attributes every StableHLO op to the
enclosing ``jax.named_scope`` stage and to the deepest
``vulkansift_tpu`` source line recorded in the op's location metadata —
naming exactly which pipeline lines emit the op-count mass.

It is a *proxy* (XLA later fuses aggressively, and CPU/GPU fusion choices
differ), but scope-relative op mass correlates with the trace tail and is
measurable without the card.

Usage:  python scripts/opcount.py [WxH] [top]
"""

import collections
import re
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    args = sys.argv[1:]
    wh = args[0] if args else "1536x1024"
    top = int(args[1]) if len(args) > 1 else 40
    w, h = map(int, wh.split("x"))

    from vulkansift_tpu import SiftConfig
    from vulkansift_tpu.pipeline import make_detect_fn

    cfg = SiftConfig(use_input_upsampling=True,
                     max_nb_sift_per_buffer=16384,
                     sift_buffer_count=1,
                     input_image_max_size=w * h)
    detect = jax.jit(make_detect_fn(cfg, w, h))
    img = np.zeros((h, w), np.uint8)
    lowered = detect.lower(img)
    text = lowered.as_text(debug_info=True)

    # StableHLO ops look like:  %123 = stablehlo.<op> ... loc(#loc456)
    # loc lines map scope + file/line:  #loc456 = loc("scope/path"(#loc9))
    locdefs = {}
    for m in re.finditer(r'#loc(\d+) = loc\((.*)\)', text):
        locdefs[m.group(1)] = m.group(2)

    def resolve(locid, depth=0):
        """Return (scope, src_line) walking the loc chain.

        ``src_line`` is the INNERMOST vulkansift_tpu frame (the op's own
        source line); callsite locs are ``callsite(#inner at #outer)`` so
        a depth-first walk visiting the first reference first finds the
        innermost frame before the pipeline-level call site.
        """
        seen_scope, seen_src = None, None
        stack = [locid]
        hops = 0
        while stack and hops < 128:
            hops += 1
            cur = stack.pop(0)  # FIFO: innermost refs appear first
            body = locdefs.get(cur)
            if body is None:
                continue
            for s in re.findall(r'"([^"]*)"', body):
                if "/" in s and seen_scope is None and not s.endswith(".py"):
                    seen_scope = s
            for f, ln in re.findall(r'"([^"]+\.py)":(\d+)', body):
                if "vulkansift_tpu" in f and seen_src is None:
                    seen_src = f.rsplit("/", 1)[-1] + ":" + ln
            stack.extend(re.findall(r'#loc(\d+)', body))
        return seen_scope, seen_src

    scope_counts = collections.Counter()
    line_counts = collections.Counter()
    pair_counts = collections.Counter()
    total = 0
    for m in re.finditer(
            r'= (?:stablehlo|chlo|mhlo)\.([\w.]+).*?loc\(#loc(\d+)\)', text):
        op, locid = m.group(1), m.group(2)
        if op in ("constant", "return"):
            continue
        total += 1
        scope, src = resolve(locid)
        stage = (scope or "?").split("/")[0]
        # named scopes are embedded in the scope path, e.g.
        # "jit(detect)/ScaleSpace/..." — pick the first marker-like part.
        parts = (scope or "").split("/")
        stage = next((p for p in parts if p and p[0].isupper()), stage)
        scope_counts[stage] += 1
        line_counts[src or "?"] += 1
        pair_counts[(stage, src or "?", op)] += 1

    print(f"# total non-constant stablehlo ops: {total} "
          f"({wh})")
    print("\n## ops per stage")
    for k, v in scope_counts.most_common():
        print(f"{v:6d}  {k}")
    print(f"\n## top {top} source lines by op count")
    for k, v in line_counts.most_common(top):
        print(f"{v:6d}  {k}")
    print(f"\n## top {top} (stage, line, op)")
    for (stage, src, op), v in pair_counts.most_common(top):
        print(f"{v:6d}  {stage:20s} {src:28s} {op}")


if __name__ == "__main__":
    main()
