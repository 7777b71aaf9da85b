"""Pure-NumPy comparisons of detector features and 2-NN match columns.

Each comparison returns a printable summary and the list of what failed
(empty when the result is within bounds); the caller decides whether a
failure raises or is collected. The bounds and why they are what they are:
PERF.md, "Comparison tolerances".
"""

import numpy as np

POS_TOL_PX = 0.01         # paired keypoints: same octave/scale, |dx|,|dy|
ANGLE_TOL = 1e-3          # paired orientations (rad), as the golden tests
MIN_PAIRED = 0.99         # share of reference keypoints that must pair
DESC_MAX_DIFF = 2         # u8 bins a paired descriptor may move ...
MIN_DESC_WITHIN = 0.99    # ... for at least this share of pairs

MATCH_FIELDS = ("idx_b1", "idx_b2", "dist_a_b1", "dist_a_b2")


def pair_features(ref: np.ndarray, got: np.ndarray, *,
                  use_angle: bool) -> np.ndarray:
    """For each ``ref`` feature, the index of the closest ``got`` feature
    at the same octave and scale index within POS_TOL_PX in x and y (and
    within ANGLE_TOL in orientation if ``use_angle``), or -1."""
    cells = {}
    for j, (o, s, x, y) in enumerate(zip(got["octave_idx"], got["scale_idx"],
                                         got["x"], got["y"])):
        key = (int(o), int(s), int(np.floor(x / POS_TOL_PX)),
               int(np.floor(y / POS_TOL_PX)))
        cells.setdefault(key, []).append(j)
    out = np.full(len(ref), -1, np.int64)
    for i, f in enumerate(ref):
        o, s = int(f["octave_idx"]), int(f["scale_idx"])
        cx = int(np.floor(f["x"] / POS_TOL_PX))
        cy = int(np.floor(f["y"] / POS_TOL_PX))
        best, best_d = -1, np.inf
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for j in cells.get((o, s, cx + dx, cy + dy), ()):
                    g = got[j]
                    dpos = max(abs(float(g["x"]) - float(f["x"])),
                               abs(float(g["y"]) - float(f["y"])))
                    if dpos > POS_TOL_PX:
                        continue
                    dang = 0.0
                    if use_angle:
                        dang = abs((float(g["orientation"])
                                    - float(f["orientation"]) + np.pi)
                                   % (2 * np.pi) - np.pi)
                        if dang > ANGLE_TOL:
                            continue
                    d = dpos + dang
                    if d < best_d:
                        best, best_d = j, d
        out[i] = best
    return out


def compare_features(name: str, ref: np.ndarray, got: np.ndarray, *,
                     desc_mask=None) -> tuple[str, list[str]]:
    """Keypoint pairing (position/octave/scale) over unique reference
    keypoints, then orientation + descriptor agreement over the features
    selected by ``desc_mask`` (default: all). Returns (summary, failures)."""
    _, uniq = np.unique(np.stack([ref["x"], ref["y"], ref["octave_idx"]], 1),
                        axis=0, return_index=True)
    kp = ref[np.sort(uniq)]
    kp_pair = pair_features(kp, got, use_angle=False)
    kp_frac = float(np.mean(kp_pair >= 0)) if len(kp) else 0.0
    sel = ref if desc_mask is None else ref[desc_mask]
    pair = pair_features(sel, got, use_angle=True)
    ok = pair >= 0
    ori_frac = float(np.mean(ok)) if len(sel) else 0.0
    diff = np.abs(sel["descriptor"][ok].astype(np.int32)
                  - got["descriptor"][pair[ok]].astype(np.int32))
    per_feat = diff.max(axis=1) if len(diff) else np.zeros(0)
    within = float(np.mean(per_feat <= DESC_MAX_DIFF)) if len(diff) else 0.0
    summary = (
        f"{name}: ref {len(ref)} feats ({len(kp)} keypoints), got "
        f"{len(got)}; keypoints paired {kp_frac:.5f}; features compared "
        f"{len(sel)}, orientation-paired {ori_frac:.5f}; descriptor max "
        f"|diff| <= {DESC_MAX_DIFF} for {within:.5f} of pairs (worst "
        f"{int(per_feat.max()) if len(per_feat) else -1}, mean |diff| "
        f"{float(diff.mean()) if diff.size else 0.0:.4f})")
    failures = []
    if not len(kp):
        failures.append(f"{name}: reference found no keypoints")
    if kp_frac < MIN_PAIRED:
        failures.append(f"{name}: keypoints paired {kp_frac}")
    if ori_frac < MIN_PAIRED:
        failures.append(f"{name}: orientations paired {ori_frac}")
    if within < MIN_DESC_WITHIN:
        failures.append(f"{name}: descriptors within {within}")
    return summary, failures


def compare_matches(name: str, got, ref) -> tuple[str, list[str]]:
    """Exact comparison of the MATCH_FIELDS columns, reporting how many
    rows differ and, for distances, by how many ulps. Returns (summary,
    failures)."""
    lines, failures = [], []
    for field, g, r in zip(MATCH_FIELDS, got, ref):
        g = np.asarray(g)
        r = np.asarray(r).astype(g.dtype)
        bad = g != r
        if not bad.any():
            continue
        i = int(np.nonzero(bad)[0][0])
        detail = f"row {i}: {g[i]!r} vs {r[i]!r}"
        if g.dtype == np.float32:
            ulps = np.abs(g.view(np.int32).astype(np.int64)
                          - r.view(np.int32).astype(np.int64))[bad]
            detail = f"max {int(ulps.max())} ulp, {detail}"
        lines.append(f"{name}: {field} differs in {int(bad.sum())} rows "
                     f"({detail})")
        failures.append(f"{name}: {field} differs in {int(bad.sum())} of "
                        f"{bad.size} rows")
    if not failures:
        lines.append(f"{name}: bit-exact ({len(np.asarray(got[0]))} rows)")
    return "\n".join(lines), failures


def golden_match_columns(g: np.ndarray):
    """``reference.match_2nn_dense_np`` rows -> MATCH_FIELDS columns with
    the float32 distances the matcher reports: correctly rounded roots of
    the exact squared distances."""
    return [g[:, 0].astype(np.int32), g[:, 1].astype(np.int32),
            np.sqrt(g[:, 2].astype(np.float32)),
            np.sqrt(g[:, 3].astype(np.float32))]
