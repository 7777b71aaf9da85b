"""Match-recall parity vs OpenCV SIFT (BASELINE north star: >= 95%).

The reference's correctness oracle is cross-implementation metric parity on
Oxford homography data (src/perf/perf_matching.cpp:30-79). This module
hardens the offline synthetic version of that protocol: several texture
families x warp sweeps (rotation, scale, blur, perspective tilt), each
pair matched 2-NN + Lowe 0.75, correct = within 2.5 px of the ground-truth
homography — and reports the *recall-parity* number the round-1 review
found missing:

    recall(detector) = total correct matches / total ground-truth visible
                       keypoints of that detector
    parity           = recall(vulkansift_tpu) / recall(OpenCV)

plus the raw correct-match ratio (our correct matches / OpenCV's). Both
detectors run the SAME pairs. Also sweeps descriptor format (UBC crossed
against OpenCV; VLFeat self-consistency — note the VLFeat layout is a
consistent within-descriptor permutation, so its self-matching metrics are
identical to UBC by construction) and pyramid precision (f32/fp16).

CLI: python -m vulkansift_tpu.perf.parity [--out-dir DIR] [--quick]
Writes ``recall_parity.txt`` (one line per pair) and prints a summary.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .harness import (DetectResult, Detector, LOWES_RATIO,
                      OpenCvDetector, PIXEL_DIST_THRESHOLD, _project,
                      lowe_matches)
from ..utils.compile_cache import enable_compile_cache


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------

def _multiscale_noise(h, w, seed):
    import cv2
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    for cell in (8, 16, 32, 64):
        img += cv2.resize(rng.random((h // cell + 1, w // cell + 1)),
                          (w, h), interpolation=cv2.INTER_LINEAR)
    return cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)


def _blobs(h, w, seed):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    for _ in range(60):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(1.5, min(h, w) / 20)
        img += rng.uniform(-1, 1) * np.exp(
            -((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    img += 0.05 * rng.standard_normal((h, w))
    img -= img.min()
    return (255 * img / img.max()).astype(np.uint8)


def _checker(h, w, seed):
    import cv2
    rng = np.random.default_rng(seed)
    cells = rng.random((h // 24 + 1, w // 24 + 1)) > 0.5
    img = cv2.resize(cells.astype(np.float64), (w, h),
                     interpolation=cv2.INTER_NEAREST)
    img = cv2.GaussianBlur(img, (0, 0), 1.2)
    img += 0.3 * cv2.resize(rng.random((h // 8, w // 8)), (w, h),
                            interpolation=cv2.INTER_CUBIC)
    return cv2.normalize(img, None, 0, 255,
                         cv2.NORM_MINMAX).astype(np.uint8)


def _cubic_noise(h, w, seed):
    import cv2
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.random((h // 8, w // 8)), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    img += 0.5 * cv2.resize(rng.random((h // 32, w // 32)), (w, h),
                            interpolation=cv2.INTER_CUBIC)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    return cv2.normalize(img, None, 0, 255,
                         cv2.NORM_MINMAX).astype(np.uint8)


def _bundled_photo_paths():
    """Real photographs shipped inside this offline environment's
    libraries. Synthetic textures lack the edge/flat-region statistics of
    photographs (the reference's oracle is real Oxford data,
    perf_matching.cpp:30-79), so these families harden the protocol with
    genuine photo content spanning a portrait, architecture, a natural
    macro, and a webcam frame."""
    import matplotlib
    sk = None
    try:
        import sklearn.datasets as _sd
        sk = os.path.join(os.path.dirname(_sd.__file__), "images")
    except ImportError:
        pass
    paths = {"hopper": os.path.join(os.path.dirname(matplotlib.__file__),
                                    "mpl-data", "sample_data",
                                    "grace_hopper.jpg")}
    if sk:
        paths["china"] = os.path.join(sk, "china.jpg")
        paths["flower"] = os.path.join(sk, "flower.jpg")
    cam = ("/opt/venv/lib/python3.12/site-packages/pygame/docs/"
           "generated/_images/camera_rgb.jpg")
    if os.path.exists(cam):
        paths["camera"] = cam
    return {k: p for k, p in paths.items() if os.path.exists(p)}


def _make_photo(path):
    def gen(h, w, seed):
        import cv2
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        rng = np.random.default_rng(seed)
        ph, pw = img.shape
        ch, cw = int(ph * 0.9), int(pw * 0.9)
        y0 = int(rng.integers(0, ph - ch + 1))
        x0 = int(rng.integers(0, pw - cw + 1))
        crop = img[y0:y0 + ch, x0:x0 + cw]
        return cv2.resize(crop, (w, h), interpolation=cv2.INTER_AREA)
    return gen


TEXTURES = tuple(
    [(f"photo_{name}", _make_photo(p))
     for name, p in sorted(_bundled_photo_paths().items())]
    + [("noise", _multiscale_noise), ("blobs", _blobs),
       ("checker", _checker), ("cubic", _cubic_noise)])


# ---------------------------------------------------------------------------
# Warp sweeps
# ---------------------------------------------------------------------------

def warp_sweep(img1: np.ndarray, quick: bool = False
               ) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """(tag, img2, H) pairs: rotation / scale / blur / perspective."""
    import cv2
    h, w = img1.shape
    cx, cy = w / 2, h / 2
    t1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    t2 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])

    rots = (10, 30) if quick else (5, 15, 30, 45)
    for deg in rots:
        a = np.radians(deg)
        r = np.array([[np.cos(a), -np.sin(a), 0],
                      [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        hm = t2 @ r @ t1
        yield (f"rot{deg}", cv2.warpPerspective(img1, hm, (w, h)), hm)

    scales = (0.8, 0.55) if quick else (0.9, 0.75, 0.6, 0.5)
    for s in scales:
        sm = np.array([[s, 0, 0], [0, s, 0], [0, 0, 1.0]])
        hm = t2 @ sm @ t1
        yield (f"scale{s}", cv2.warpPerspective(img1, hm, (w, h)), hm)

    blurs = (2.0,) if quick else (1.0, 2.0, 3.0)
    for b in blurs:
        yield (f"blur{b}", cv2.GaussianBlur(img1, (0, 0), b), np.eye(3))

    tilts = (0.0004,) if quick else (0.0002, 0.0005)
    for p in tilts:
        hm = np.array([[1, 0.05, 0], [0.02, 1, 0], [p, p / 2, 1.0]])
        hm = t2 @ hm @ t1
        yield (f"tilt{p}", cv2.warpPerspective(img1, hm, (w, h)), hm)

    # Illumination (the Oxford "leuven" set varies exposure; H = identity).
    gammas = (0.6,) if quick else (0.6, 1.6)
    f = img1.astype(np.float64) / 255.0
    for g in gammas:
        img2 = np.clip(255.0 * f ** g, 0, 255).astype(np.uint8)
        yield (f"gamma{g}", img2, np.eye(3))
    if not quick:
        img2 = np.clip(img1.astype(np.int32) - 50, 0, 255).astype(np.uint8)
        yield ("dim50", img2, np.eye(3))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def pair_stats(img_shape, hmat: np.ndarray, r1: DetectResult,
               r2: DetectResult) -> Tuple[int, int, int]:
    """(visible_kp1, n_matches, n_correct) for one pair."""
    h2, w2 = img_shape[:2]
    if len(r1.xy) == 0 or len(r2.xy) == 0:
        return 0, 0, 0
    proj = _project(hmat, r1.xy)
    vis = int(((proj[:, 0] >= 0) & (proj[:, 0] < w2)
               & (proj[:, 1] >= 0) & (proj[:, 1] < h2)).sum())
    matches = lowe_matches(r1.descriptors, r2.descriptors, LOWES_RATIO)
    if len(matches) == 0:
        return vis, 0, 0
    gt = _project(hmat, r1.xy[matches[:, 0]])
    dist = np.linalg.norm(gt - r2.xy[matches[:, 1]], axis=1)
    return vis, len(matches), int((dist < PIXEL_DIST_THRESHOLD).sum())


DEFAULT_MODES = ("ubc_f32", "ubc_fp16", "vlfeat_f32")
QUICK_MODES = ("ubc_f32", "ubc_fp16")


def run_parity(out_dir: str = ".", quick: bool = False,
               size: Tuple[int, int] = (480, 640),
               modes: Tuple[str, ...] = None,
               budget_s: float = 0.0,
               out_name: str = "recall_parity.txt") -> Dict[str, float]:
    """Run the parity protocol; returns summary dict.

    Budget-aware + crash-proof (round-4 lesson: a 30-min hardware run
    timed out with ZERO output, results/hw_r4d/parity.log): per-pair
    result lines are flushed to ``out_dir/out_name`` AS THEY COMPLETE, a
    wall-clock ``budget_s`` (0 = unlimited) stops the sweep mid-mode, and
    the summary is always computed from whatever finished — a mode that
    only covered a pair prefix is compared against the OpenCV totals over
    the SAME prefix (apples to apples), with the coverage recorded as
    ``pairs_<mode>``.

    Modes: ``<fmt>_<precision>[_noremap]`` — fmt in {ubc, vlfeat},
    precision in {f32, fp16}; the ``_noremap`` suffix disables
    sigma-scaled sampling (VKSIFT_NO_SIGMA_REMAP=1) for remap-on/off
    recall A/Bs.
    """
    import time as _time
    import vulkansift_tpu as vs
    from .harness import VulkanSiftTpuDetector

    t_start = _time.monotonic()

    def out_of_budget():
        return budget_s > 0 and (_time.monotonic() - t_start) > budget_s

    h, w = size
    cv_det = OpenCvDetector()
    cv_det.init()

    def jax_detector(mode: str):
        parts = mode.split("_")
        fmt, precision = parts[0], parts[1]
        noremap = "noremap" in parts[2:]
        det = VulkanSiftTpuDetector(max_features=16384)
        det.init()
        det._cfg = vs.SiftConfig(
            use_input_upsampling=True,
            max_nb_sift_per_buffer=16384,
            sift_buffer_count=1,
            input_image_max_size=w * h,
            descriptor_format=(vs.DescriptorFormat.VLFEAT if fmt == "vlfeat"
                               else vs.DescriptorFormat.UBC),
            pyramid_precision=(vs.PyramidPrecision.FLOAT16
                               if precision == "fp16"
                               else vs.PyramidPrecision.FLOAT32))
        det._inst = vs.SiftInstance(det._cfg)
        det.name = f"vulkansift_tpu_{mode}"
        return det, noremap

    if modes is None:
        modes = QUICK_MODES if quick else DEFAULT_MODES
    summary: Dict[str, float] = {}

    # Pre-generate all pairs once so every detector sees identical data.
    pairs = []
    for ti, (tname, gen) in enumerate(TEXTURES[:2] if quick else TEXTURES):
        img1 = gen(h, w, seed=100 + ti)
        for tag, img2, hmat in warp_sweep(img1, quick=quick):
            pairs.append((tname, tag, img1, img2, hmat))

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, out_name)
    fh = open(out_path, "w")
    fh.write("# detector;texture;warp;visible_kp;matches;correct\n")
    fh.flush()

    def emit(line):
        fh.write(line + "\n")
        fh.flush()

    # OpenCV baseline over all pairs (CPU, fast; never budget-gated so
    # every device prefix has a same-length baseline prefix to compare to).
    cv_cache: Dict[int, DetectResult] = {}
    cv_rows: List[Tuple[int, int, int]] = []
    for (tname, tag, img1, img2, hmat) in pairs:
        k1 = id(img1)
        if k1 not in cv_cache:
            cv_cache[k1] = cv_det.detect(img1)
        r2 = cv_det.detect(img2)
        st = pair_stats(img2.shape, hmat, cv_cache[k1], r2)
        cv_rows.append(st)
        emit(f"OpenCV;{tname};{tag};{st[0]};{st[1]};{st[2]}")
    cv_tot_all = np.asarray(cv_rows, np.int64).sum(axis=0)
    cv_recall = cv_tot_all[2] / max(cv_tot_all[0], 1)

    import os as _os_mod
    for mode in modes:
        if out_of_budget():
            emit(f"# budget exhausted before mode {mode}")
            summary[f"skipped_{mode}"] = 1.0
            continue
        noremap_prev = _os_mod.environ.get("VKSIFT_NO_SIGMA_REMAP")
        det = None
        done = 0
        try:
            det, noremap = jax_detector(mode)
            if noremap:
                _os_mod.environ["VKSIFT_NO_SIGMA_REMAP"] = "1"
            tot = np.zeros(3, np.int64)
            cache: Dict[int, DetectResult] = {}
            done = 0
            for i, (tname, tag, img1, img2, hmat) in enumerate(pairs):
                if out_of_budget():
                    emit(f"# budget exhausted in mode {mode} after "
                         f"{done}/{len(pairs)} pairs")
                    break
                k1 = id(img1)
                if k1 not in cache:
                    cache[k1] = det.detect(img1)
                r2 = det.detect(img2)
                st = pair_stats(img2.shape, hmat, cache[k1], r2)
                tot += st
                done = i + 1
                emit(f"{det.name};{tname};{tag};{st[0]};{st[1]};{st[2]}")
        finally:
            if det is not None:
                det.terminate()
            if noremap_prev is None:
                _os_mod.environ.pop("VKSIFT_NO_SIGMA_REMAP", None)
            else:
                _os_mod.environ["VKSIFT_NO_SIGMA_REMAP"] = noremap_prev
        if done == 0:
            summary[f"skipped_{mode}"] = 1.0
            continue
        # Compare against the OpenCV totals over the SAME pair prefix.
        cv_tot = np.asarray(cv_rows[:done], np.int64).sum(axis=0)
        cv_recall_pfx = cv_tot[2] / max(cv_tot[0], 1)
        recall = tot[2] / max(tot[0], 1)
        summary[f"recall_{mode}"] = float(recall)
        summary[f"correct_{mode}"] = int(tot[2])
        summary[f"parity_{mode}"] = float(recall / max(cv_recall_pfx, 1e-12))
        summary[f"correct_ratio_{mode}"] = float(tot[2] / max(cv_tot[2], 1))
        summary[f"pairs_{mode}"] = done
        # Flush the running summary after EVERY mode so a later hang
        # still leaves this mode's numbers on disk.
        emit(f"# partial summary after {mode}: " + repr(summary))

    summary["recall_OpenCV"] = float(cv_recall)
    summary["correct_OpenCV"] = int(cv_tot_all[2])
    summary["pairs_total"] = len(pairs)
    summary["elapsed_s"] = round(_time.monotonic() - t_start, 1)

    emit("# summary: " + repr(summary))
    fh.close()
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="wall-clock budget in seconds (0 = unlimited); "
                         "partial results are flushed and summarized")
    ap.add_argument("--modes", default=None,
                    help="comma-separated modes, e.g. "
                         "ubc_f32,ubc_fp16,ubc_f32_noremap")
    ap.add_argument("--out-name", default="recall_parity.txt")
    args = ap.parse_args(argv)
    enable_compile_cache()
    modes = tuple(args.modes.split(",")) if args.modes else None
    summary = run_parity(out_dir=args.out_dir, quick=args.quick,
                         modes=modes, budget_s=args.budget,
                         out_name=args.out_name)
    for k in sorted(summary):
        print(f"{k}: {summary[k]}", flush=True)
    ok = summary.get("parity_ubc_f32", 0.0)
    print(f"PARITY (ubc/f32 vs OpenCV): {ok:.3f} "
          f"({'PASS' if ok >= 0.95 else 'FAIL'} vs 0.95 north star)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
