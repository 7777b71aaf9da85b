"""Start-up proof on the GPU: SIFT detect + 2-NN match + SfM, each checked.

Runs the system's main path once, through the entry points a user calls,
at the data sizes the reference publishes (SURVEY.md §6), and compares every
result with a plain reference on the same machine:

  0. environment: the card's name and power limit (``nvidia-smi``, from a
     child that never imports JAX), ``jax.devices()``, and a refusal to go
     on unless JAX's first device is a GPU;
  1. compile: the 3456x2304 upsampled detect program (32k buffer), with its
     compile seconds, ``memory_analysis()`` and the peak device bytes of
     one run;
  2. Oxford 640x480 (no upsampling, 4k buffer) through ``SiftInstance``:
     detect two images, match, download; features against the float64
     golden detector and against the same program on the CPU backend,
     matches against the golden 2-NN on the downloaded descriptors;
  3. Hannover 1536x1024 and 3456x2304 (upsampling, 32k buffers) through
     ``SiftInstance``: detect, download, compare with the CPU backend;
  4. matcher: ``match_2nn_auto`` at 16384 x 16384 u8 descriptors,
     bit-exact against ``match_2nn`` on the CPU backend, and at 4096 x 4096
     against the golden 2-NN;
  5. SfM: ``reconstruct_sequence`` on a synthetic scene of a few hundred
     points, then one bundle-adjustment solve, against the CPU backend.

``--devices 4`` runs only the multi-device paths instead: data-parallel
detect, the ring 2-NN and distributed bundle adjustment on a 1-D mesh over
four GPUs, each against its single-device form, and prints where every
shard lives.

Any failed phase or comparison raises, so the process exits non-zero and
never prints the last line, which on success is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--devices 4] [--seed 0]
"""

import argparse
import json
import sys
import time

import numpy as np

from vulkansift_tpu.golden import compare

SEED = 0
# Published sizes (SURVEY.md §6): Oxford, Hannover, the 2-NN matcher.
OXFORD = (640, 480)
HANNOVER = ((1536, 1024), (3456, 2304))
BIG = (3456, 2304)
MATCH_N = 16384
MATCH_GOLDEN_N = 4096
SFM_CAMS, SFM_POINTS = 4, 400
DP_SIZE = (1536, 1024)
# Comparison bounds of features and matches: vulkansift_tpu.golden.compare
# (reasons in PERF.md, "Comparison tolerances").
BA_REL_TOL = 1e-3         # final BA cost, relative
# LM converges slowly along the monocular scale gauge: 200 iterations reach
# the minimum from the perturbed start on both sides, so the comparison is
# between minima rather than between partial trajectories.
BA_ITERS, BA_CG_ITERS = 200, 50


def last_line(devices) -> str:
    """The one JSON object a successful run ends with."""
    from vulkansift_tpu.utils.accelerator import device_record
    return json.dumps({"ok": True, "device": device_record(devices)})


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Inputs (generated from the seed)
# ---------------------------------------------------------------------------

def textured_image(h: int, w: int, seed: int) -> np.ndarray:
    """Multi-scale value noise: photo-like keypoint density."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell in (8, 16, 32, 64):
        small = rng.random((h // cell + 2, w // cell + 2)).astype(np.float32)
        ys = np.arange(h, dtype=np.float32) / cell
        xs = np.arange(w, dtype=np.float32) / cell
        yi, xi = ys.astype(int), xs.astype(int)
        fy, fx = (ys - yi)[:, None], (xs - xi)[None, :]
        img += ((1 - fy) * (1 - fx) * small[yi][:, xi]
                + (1 - fy) * fx * small[yi][:, xi + 1]
                + fy * (1 - fx) * small[yi + 1][:, xi]
                + fy * fx * small[yi + 1][:, xi + 1])
    img -= img.min()
    return (255 * img / img.max()).astype(np.uint8)


def random_descriptors(rng, n: int) -> np.ndarray:
    return rng.integers(0, 256, (n, 128), dtype=np.uint8)


def tie_rows(n: int):
    """B rows that hold copies of A row 7 (earliest first)."""
    return (9 * n) // 16, (3 * n) // 4 + 1


def tie_descriptors(rng, n: int):
    """Random u8 descriptor sets with exact ties across tiles and shards:
    duplicated B rows, and A row 7 copied into B at two places."""
    a = random_descriptors(rng, n)
    b = random_descriptors(rng, n)
    b[n // 3] = b[n // 100]
    b[n - 2] = b[n // 8 - 1]
    i1, i2 = tie_rows(n)
    b[i1] = a[7]
    b[i2] = a[7]
    return a, b


def sanity_failures(name: str, f: np.ndarray, w: int, h: int) -> list:
    """What is wrong with a downloaded feature set on its own."""
    bad = [f"{name}: no features"] if len(f) == 0 else []
    for field in ("x", "y", "scale_x", "scale_y", "sigma", "orientation",
                  "intensity"):
        if not np.isfinite(f[field]).all():
            bad.append(f"{name}: non-finite {field}")
    if not ((f["x"] >= 0) & (f["x"] < w) & (f["y"] >= 0)
            & (f["y"] < h)).all():
        bad.append(f"{name}: feature outside image")
    if not f["descriptor"].any(axis=1).all():
        bad.append(f"{name}: empty descriptor")
    return bad


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

class Smoke:
    def __init__(self, jax, card: str, seed: int):
        self.jax = jax
        self.card = card
        self.seed = seed
        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        self.failures = []

    def check(self, cond: bool, what: str) -> None:
        """Record a failed check; main() exits non-zero after the phases
        if any was recorded (so one run reports every mismatch)."""
        if not cond:
            self.record("", [what])

    def record(self, summary: str, failures: list) -> None:
        for line in summary.splitlines():
            log(f"# {line}")
        for what in failures:
            log(f"# FAIL: {what}")
        self.failures.extend(failures)

    def timed(self, what: str, fn, reps: int = 5) -> float:
        """Median wall time of ``fn`` ending in block_until_ready."""
        jax = self.jax
        jax.block_until_ready(fn())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        ms = float(np.median(ts)) * 1e3
        log(f"# time {what}: {ms} ms median of {reps} "
            f"(block_until_ready; {self.card})")
        return ms

    def on_cpu(self, fn, *args):
        """Run ``fn`` with its inputs committed to the CPU backend."""
        jax = self.jax
        args = jax.device_put(args, self.cpu)
        with jax.default_device(self.cpu):
            return jax.block_until_ready(fn(*args))

    def detect_cpu(self, cfg, img: np.ndarray) -> np.ndarray:
        from vulkansift_tpu.pipeline import make_detect_fn
        from vulkansift_tpu.types import features_to_numpy
        h, w = img.shape
        t0 = time.perf_counter()
        out = self.on_cpu(self.jax.jit(make_detect_fn(cfg, w, h)), img)
        n = int(out.features.count)
        log(f"# cpu backend detect {w}x{h}: {n} feats, lost "
            f"{int(out.lost)}, {time.perf_counter() - t0:.1f} s incl. "
            f"compile")
        return features_to_numpy(out.features, n)

    # -- phase 1 ------------------------------------------------------------
    def compile_big(self):
        jax = self.jax
        import jax.numpy as jnp
        from vulkansift_tpu import SiftConfig
        from vulkansift_tpu.pipeline import make_detect_fn
        w, h = BIG
        cfg = SiftConfig(use_input_upsampling=True,
                         max_nb_sift_per_buffer=32768,
                         input_image_max_size=w * h)
        t0 = time.perf_counter()
        lowered = jax.jit(make_detect_fn(cfg, w, h)).lower(
            jax.ShapeDtypeStruct((h, w), jnp.uint8))
        t1 = time.perf_counter()
        compiled = lowered.compile()
        t2 = time.perf_counter()
        log(f"# phase 1 setup: {w}x{h} detect traced+lowered in "
            f"{t1 - t0:.2f} s, compiled in {t2 - t1:.2f} s")
        log(f"# memory_analysis: {compiled.memory_analysis()}")
        img = jnp.asarray(textured_image(h, w, self.seed + 7))
        out = jax.block_until_ready(compiled(img))
        n, lost = int(out.features.count), int(out.lost)
        log(f"# {w}x{h} detect: {n} feats, lost {lost}, per-octave "
            f"{np.asarray(out.per_octave_counts).tolist()}")
        self.check(0 < n <= 32768, f"{w}x{h} feature count {n}")
        stats = self.gpu.memory_stats() or {}
        log(f"# peak_bytes_in_use after the {w}x{h} run: "
            f"{stats.get('peak_bytes_in_use')}")
        self.timed(f"{w}x{h} detect (compiled, device-resident image)",
                   lambda: compiled(img), reps=3)

    # -- phase 2 ------------------------------------------------------------
    def oxford(self):
        import vulkansift_tpu as vs
        from vulkansift_tpu.golden import reference as gold
        w, h = OXFORD
        cfg = vs.SiftConfig(use_input_upsampling=False,
                            max_nb_sift_per_buffer=4096,
                            sift_buffer_count=2,
                            input_image_max_size=w * h)
        imgs = [textured_image(h, w, self.seed + i) for i in (1, 2)]
        inst = vs.SiftInstance(cfg)
        t0 = time.perf_counter()
        inst.detect_features(imgs[0], 0)
        inst.detect_features(imgs[1], 1)
        inst.match_features(0, 1)
        feats = [inst.download_features(0), inst.download_features(1)]
        matches = inst.download_matches()
        log(f"# oxford: SiftInstance detect x2 + match + download "
            f"{time.perf_counter() - t0:.2f} s incl. compile; feats "
            f"{[len(f) for f in feats]}, matches {len(matches)}")
        for i, f in enumerate(feats):
            self.record("", sanity_failures(f"oxford image {i}", f, w, h))
        self.timed(f"oxford {w}x{h} detect + count via SiftInstance",
                   lambda: (inst.detect_features(imgs[0], 0),
                            inst.get_features_number(0)))

        # Matches of the product matcher vs the golden 2-NN on the very
        # descriptors that were downloaded.
        g = gold.match_2nn_dense_np(feats[0]["descriptor"],
                                    feats[1]["descriptor"])
        self.check(len(matches) == len(feats[0]),
                   "one match row per A feature")
        self.record(*compare.compare_matches(
            "oxford matches vs golden 2-NN",
            [matches[f] for f in compare.MATCH_FIELDS],
            compare.golden_match_columns(g)))

        t0 = time.perf_counter()
        ref = gold.detect_np(imgs[0], cfg)
        log(f"# golden float64 detect {w}x{h}: {len(ref)} feats in "
            f"{time.perf_counter() - t0:.1f} s")
        golden = np.zeros(len(ref), feats[0].dtype)
        for name in ("x", "y", "scale_x", "scale_y", "scale_idx",
                     "octave_idx", "sigma", "orientation", "intensity",
                     "descriptor"):
            golden[name] = [r[name] for r in ref]
        # Keypoints refined to the top scales sample the next octave at
        # half resolution (ops/patches.build_patchset); the golden detector
        # always samples full resolution, so only the other keypoints'
        # orientations and descriptors are comparable.
        full_res = golden["scale_idx"] < cfg.nb_scales_per_octave
        self.record(*compare.compare_features(
            "oxford gpu vs golden", golden, feats[0], desc_mask=full_res))
        cpu = self.detect_cpu(cfg, imgs[0])
        self.record(*compare.compare_features(
            "oxford gpu vs cpu backend", cpu, feats[0]))

    # -- phase 3 ------------------------------------------------------------
    def hannover(self):
        import vulkansift_tpu as vs
        for (w, h) in HANNOVER:
            cfg = vs.SiftConfig(use_input_upsampling=True,
                                max_nb_sift_per_buffer=32768,
                                sift_buffer_count=1,
                                input_image_max_size=w * h,
                                retain_pyramid=False)
            img = textured_image(h, w, self.seed + 7)
            inst = vs.SiftInstance(cfg)
            t0 = time.perf_counter()
            inst.detect_features(img, 0)
            f = inst.download_features(0)
            log(f"# hannover {w}x{h}: SiftInstance detect + download "
                f"{time.perf_counter() - t0:.2f} s incl. compile; "
                f"{len(f)} feats")
            self.record("", sanity_failures(f"hannover {w}x{h}", f, w, h))
            self.timed(f"hannover {w}x{h} detect + count via SiftInstance",
                       lambda: (inst.detect_features(img, 0),
                                inst.get_features_number(0)), reps=3)
            cpu = self.detect_cpu(cfg, img)
            self.record(*compare.compare_features(
                f"hannover {w}x{h} gpu vs cpu backend", cpu, f))
            inst.close()

    # -- phase 4 ------------------------------------------------------------
    def matcher(self):
        jax = self.jax
        import jax.numpy as jnp
        from vulkansift_tpu.golden import reference as gold
        from vulkansift_tpu.ops.match import match_2nn, match_2nn_auto
        rng = np.random.default_rng(self.seed + 3)
        n = MATCH_N
        a, b = tie_descriptors(rng, n)
        ca, cb = jnp.int32(n), jnp.int32(n)

        da, db = jnp.asarray(a), jnp.asarray(b)
        m_gpu = jax.device_get(match_2nn_auto(da, ca, db, cb))
        self.timed(f"match_2nn_auto {n}x{n}",
                   lambda: match_2nn_auto(da, ca, db, cb))
        t0 = time.perf_counter()
        m_cpu = jax.device_get(self.on_cpu(
            lambda x, y, c: match_2nn(x, c, y, c), a, b, np.int32(n)))
        log(f"# cpu backend match_2nn {n}x{n}: "
            f"{time.perf_counter() - t0:.1f} s incl. compile")
        fields = compare.MATCH_FIELDS
        self.record(*compare.compare_matches(
            f"matcher {n} vs cpu backend",
            [getattr(m_gpu, f) for f in fields],
            [getattr(m_cpu, f) for f in fields]))
        i1, i2 = tie_rows(n)
        self.check(int(m_gpu.idx_b1[7]) == i1 and int(m_gpu.idx_b2[7]) == i2,
              "matcher: tie at A row 7 not broken to the earliest index")

        k = MATCH_GOLDEN_N
        m4 = jax.device_get(match_2nn_auto(
            da[:k], jnp.int32(k), db[:k], jnp.int32(k)))
        g = gold.match_2nn_dense_np(a[:k], b[:k])
        self.record(*compare.compare_matches(
            f"matcher {k} vs golden 2-NN",
            [getattr(m4, f)[:k] for f in fields],
            compare.golden_match_columns(g)))

    # -- phase 5 ------------------------------------------------------------
    def sfm(self):
        jax = self.jax
        import jax.numpy as jnp
        from vulkansift_tpu.sfm import (BAProblem, Camera, SE3,
                                        absolute_trajectory_error,
                                        bundle_adjust, reconstruct_sequence)
        from vulkansift_tpu.types import FEATURE_DTYPE
        rng = np.random.default_rng(self.seed + 5)
        nb_cams, nb_pts = SFM_CAMS, SFM_POINTS
        cam_np = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
        poses, pts, cam_idx, pt_idx, uv = synthetic_scene(
            rng, nb_cams, nb_pts, cam_np, noise_px=0.3)
        descs = random_descriptors(rng, nb_pts)
        feats = []
        for c in range(nb_cams):
            sel = cam_idx == c
            f = np.zeros(int(sel.sum()), FEATURE_DTYPE)
            f["x"], f["y"] = uv[sel, 0], uv[sel, 1]
            jitter = rng.integers(-2, 3, (len(f), 128))
            f["descriptor"] = np.clip(
                descs[pt_idx[sel]].astype(int) + jitter, 0, 255)
            feats.append(f)

        def run_sfm():
            cam = Camera(**{k: jnp.float32(v) for k, v in cam_np.items()})
            rec = reconstruct_sequence(feats, cam, ratio=0.8,
                                       ransac_iters=128, ba_iters=40, seed=0)
            n_obs = len(cam_idx)
            problem = BAProblem(
                poses=jnp.asarray(poses + 0.02 * rng_ba.standard_normal(
                    poses.shape).astype(np.float32)),
                points=jnp.asarray(pts + 0.05 * rng_ba.standard_normal(
                    pts.shape).astype(np.float32)),
                cam_idx=jnp.asarray(cam_idx), pt_idx=jnp.asarray(pt_idx),
                uv=jnp.asarray(uv), valid=jnp.ones(n_obs, bool), camera=cam)
            ba = bundle_adjust(problem, nb_iters=BA_ITERS,
                               nb_cg_iters=BA_CG_ITERS)
            return rec, jax.device_get(ba)

        rng_ba = np.random.default_rng(self.seed + 6)
        t0 = time.perf_counter()
        rec_g, ba_g = run_sfm()
        log(f"# sfm gpu: {time.perf_counter() - t0:.1f} s incl. compile")
        rng_ba = np.random.default_rng(self.seed + 6)
        with jax.default_device(self.cpu):
            rec_c, ba_c = run_sfm()
        for name, rec in (("gpu", rec_g), ("cpu", rec_c)):
            ate = absolute_trajectory_error(rec.poses, poses)
            log(f"# reconstruct_sequence {name}: cost {rec.initial_cost} -> "
                f"{rec.final_cost}, ATE {ate}, "
                f"{int(np.sum(rec.point_valid))} points")
            self.check(rec.final_cost < 1.0 and ate < 0.05,
                  f"reconstruct_sequence on {name}: cost {rec.final_cost}, "
                  f"ATE {ate}")
        cg, cc = float(ba_g.final_cost), float(ba_c.final_cost)
        rel = abs(cg - cc) / max(abs(cc), 1e-12)
        log(f"# bundle_adjust ({nb_cams} cams, {nb_pts} pts, {len(cam_idx)} "
            f"obs): gpu {float(ba_g.initial_cost)} -> {cg}, cpu -> {cc}, "
            f"relative difference {rel}")
        self.check(bool(np.isfinite(cg))
                   and cg < 0.05 * float(ba_g.initial_cost),
              f"bundle_adjust on gpu did not converge: {cg}")
        self.check(rel <= BA_REL_TOL, f"bundle_adjust cost gpu vs cpu: {rel}")

    # -- --devices 4 --------------------------------------------------------
    def multi_device(self, nd: int):
        jax = self.jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from vulkansift_tpu import SiftConfig
        from vulkansift_tpu.ops.match import match_2nn
        from vulkansift_tpu.parallel import (make_dp_detect_fn, make_mesh,
                                             make_ring_match_fn, shard_batch)
        from vulkansift_tpu.pipeline import make_detect_fn
        from vulkansift_tpu.sfm import (BAProblem, Camera, bundle_adjust,
                                        make_distributed_ba)
        from vulkansift_tpu.types import features_to_numpy

        devices = jax.devices()
        self.check(len(devices) >= nd,
                   f"need {nd} devices, have {len(devices)}")
        mesh = make_mesh(nd)
        log(f"# mesh: {mesh}")

        def placement(name, x):
            devs = {s.device for s in x.addressable_shards}
            log(f"# {name}: sharding {x.sharding}, device_set "
                f"{sorted(str(d) for d in x.sharding.device_set)}, shards "
                f"on {len(devs)} distinct devices")
            self.check(len(devs) == nd,
                       f"{name}: shards on {len(devs)} devices")

        # DP detect: four 1536x1024 upsampled images, one per card.
        w, h = DP_SIZE
        cfg = SiftConfig(use_input_upsampling=True,
                         max_nb_sift_per_buffer=32768,
                         input_image_max_size=w * h, retain_pyramid=False)
        imgs = np.stack([textured_image(h, w, self.seed + 10 + i)
                         for i in range(nd)])
        dp = make_dp_detect_fn(cfg, w, h, mesh)
        batch = shard_batch(imgs, mesh)
        placement("dp input images", batch)
        t0 = time.perf_counter()
        out = jax.block_until_ready(dp(batch))
        log(f"# dp detect {nd}x{w}x{h}: {time.perf_counter() - t0:.1f} s "
            f"incl. compile")
        placement("dp output descriptors", out.features.descriptor)
        self.timed(f"dp detect {nd}x{w}x{h}", lambda: dp(batch), reps=3)
        single = jax.jit(make_detect_fn(cfg, w, h))
        for i in range(nd):
            ref = jax.device_get(single(jax.device_put(imgs[i], devices[0])))
            got = jax.tree.map(lambda a: a[i], jax.device_get(out))
            log(f"# dp image {i}: {int(got.features.count)} feats vs "
                f"single-device {int(ref.features.count)}")
            self.record(*compare.compare_features(
                f"dp image {i} vs single device",
                features_to_numpy(ref.features, int(ref.features.count)),
                features_to_numpy(got.features, int(got.features.count))))

        # Ring 2-NN: 16k x 16k, rows sharded over the mesh.
        rng = np.random.default_rng(self.seed + 3)
        n = MATCH_N
        a, b = tie_descriptors(rng, n)
        sh = NamedSharding(mesh, P("data", None))
        da, db = jax.device_put(a, sh), jax.device_put(b, sh)
        placement("ring desc_a", da)
        ring = make_ring_match_fn(mesh)
        m = jax.block_until_ready(ring(da, n, db, n))
        placement("ring idx_b1", m.idx_b1)
        self.timed(f"ring 2-NN {n}x{n} on {nd} devices",
                   lambda: ring(da, n, db, n))
        ref = jax.device_get(match_2nn(
            jax.device_put(a, devices[0]), jnp.int32(n),
            jax.device_put(b, devices[0]), jnp.int32(n)))
        m = jax.device_get(m)
        fields = compare.MATCH_FIELDS
        self.record(*compare.compare_matches(
            "ring 2-NN vs single-device match_2nn",
            [getattr(m, f) for f in fields],
            [getattr(ref, f) for f in fields]))

        # Distributed BA vs single-device BA.
        srng = np.random.default_rng(self.seed + 5)
        cam_np = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
        poses, pts, cam_idx, pt_idx, uv = synthetic_scene(
            srng, SFM_CAMS, SFM_POINTS, cam_np, noise_px=0.3)
        n_obs = len(cam_idx)
        n_pad = -n_obs % nd
        cam = Camera(**{k: jnp.float32(v) for k, v in cam_np.items()})
        problem = BAProblem(
            poses=jnp.asarray(poses + 0.02 * srng.standard_normal(
                poses.shape).astype(np.float32)),
            points=jnp.asarray(pts + 0.05 * srng.standard_normal(
                pts.shape).astype(np.float32)),
            cam_idx=jnp.asarray(np.pad(cam_idx, (0, n_pad))),
            pt_idx=jnp.asarray(np.pad(pt_idx, (0, n_pad))),
            uv=jnp.asarray(np.pad(uv, ((0, n_pad), (0, 0)))),
            valid=jnp.asarray(np.arange(n_obs + n_pad) < n_obs),
            camera=cam)
        dist_ba = make_distributed_ba(mesh, nb_iters=BA_ITERS,
                                      nb_cg_iters=BA_CG_ITERS)
        r_d = jax.block_until_ready(dist_ba(problem))
        r_s = bundle_adjust(problem, nb_iters=BA_ITERS,
                            nb_cg_iters=BA_CG_ITERS)
        cd, cs = float(r_d.final_cost), float(r_s.final_cost)
        rel = abs(cd - cs) / max(abs(cs), 1e-12)
        log(f"# distributed BA on {nd} devices: {float(r_d.initial_cost)} "
            f"-> {cd}; single device -> {cs}; relative difference {rel}")
        self.check(cd < 0.05 * float(r_d.initial_cost),
                   "distributed BA diverged")
        self.check(rel <= BA_REL_TOL, f"distributed BA cost vs single: {rel}")


def synthetic_scene(rng, nb_cams, nb_pts, cam_np, noise_px):
    """Cameras on an arc looking at a point cloud (tests/test_sfm.py's
    scene, enlarged)."""
    import jax.numpy as jnp
    from vulkansift_tpu.sfm import Camera, SE3
    cam = Camera(**{k: jnp.float32(v) for k, v in cam_np.items()})
    pts = rng.uniform(-2, 2, (nb_pts, 3))
    pts[:, 2] += 8.0
    poses = np.asarray([np.concatenate(
        [[0.0, 0.08 * (i - nb_cams / 2), 0.0],
         [0.6 * i - 0.3 * nb_cams, 0.05 * i, 0.0]]) for i in range(nb_cams)],
        np.float32)
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(nb_cams):
        se3 = SE3.from_tangent(jnp.asarray(poses[c]))
        uv = np.asarray(cam.project(se3.apply(jnp.asarray(pts))))
        vis = ((uv[:, 0] > 10) & (uv[:, 0] < 630)
               & (uv[:, 1] > 10) & (uv[:, 1] < 470))
        idx = np.nonzero(vis)[0]
        cam_idx.append(np.full(len(idx), c))
        pt_idx.append(idx)
        uvs.append(uv[idx] + noise_px * rng.standard_normal((len(idx), 2)))
    return (poses, pts.astype(np.float32),
            np.concatenate(cam_idx).astype(np.int32),
            np.concatenate(pt_idx).astype(np.int32),
            np.concatenate(uvs).astype(np.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1 (default): the single-card phases; N > 1: only "
                         "the multi-device paths on an N-device mesh")
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)

    # Phase 0: what card, before JAX touches it.
    from vulkansift_tpu.utils.accelerator import (card_name_and_power,
                                                  require_gpu)
    from vulkansift_tpu.utils.compile_cache import enable_compile_cache
    card = card_name_and_power()
    log(f"# card (name, power.limit): {card}")
    import jax
    # The CPU backend serves as the in-process reference; keep it
    # available when the platform list is pinned (JAX read the environment
    # at import, so this goes through its config).
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    log(f"# compile cache: {enable_compile_cache()}")
    devices = jax.devices()
    log(f"# jax {jax.__version__} devices: {devices}")
    require_gpu(devices)
    smoke = Smoke(jax, card.splitlines()[0], args.seed)

    t_start = time.perf_counter()
    if args.devices > 1:
        smoke.multi_device(args.devices)
        devices = devices[:args.devices]
    else:
        for phase in (smoke.compile_big, smoke.oxford, smoke.hannover,
                      smoke.matcher, smoke.sfm):
            t0 = time.perf_counter()
            log(f"# --- {phase.__name__}")
            phase()
            log(f"# {phase.__name__} done in {time.perf_counter() - t0:.1f} s")
        devices = devices[:1]
    if smoke.failures:
        raise SystemExit(f"{len(smoke.failures)} comparison(s) failed: "
                         + "; ".join(smoke.failures))
    log(f"# all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"({smoke.card})")
    log(last_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
