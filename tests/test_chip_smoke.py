"""``chip_smoke.py``'s contract, checked without a card: it refuses any
device but a GPU, ends with one exact JSON line, and keeps its compile cache
where ``JAX_COMPILATION_CACHE_DIR`` says or at one fixed in-checkout path.

Tests that need the card carry the ``gpu`` marker and skip elsewhere; run
them on a GPU machine with ``python -m pytest tests -m gpu``.
"""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import chip_smoke
from vulkansift_tpu.golden import compare
from vulkansift_tpu.utils import accelerator, compile_cache


def test_require_gpu_refuses_cpu_device():
    with pytest.raises(RuntimeError, match="GPU is required"):
        accelerator.require_gpu(jax.devices("cpu"))
    accelerator.require_gpu(
        [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")])


def test_last_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB "
                            "HBM3")] * 4
    line = chip_smoke.last_line(devs[:1])
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.last_line(devs))["device"]["count"] == 4


@pytest.mark.parametrize("env", [{"JAX_COMPILATION_CACHE_DIR": "/x/cache"},
                                 {}], ids=["env_set", "env_unset"])
def test_compile_cache_dir(env):
    got = compile_cache.compile_cache_dir(env)
    if env:
        assert got == "/x/cache"
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        # Fixed: the same path on every call, listed in .gitignore.
        assert compile_cache.compile_cache_dir({}) == got
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.fixture()
def gpu():
    """The first GPU device; skips where there is none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU")
    return devs[0]


@pytest.mark.gpu
def test_oxford_detect_on_gpu_matches_cpu_backend(gpu):
    from vulkansift_tpu import SiftConfig
    from vulkansift_tpu.pipeline import make_detect_fn
    from vulkansift_tpu.types import features_to_numpy

    w, h = 640, 480
    cfg = SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=4096,
                     input_image_max_size=w * h)
    img = chip_smoke.textured_image(h, w, 1)
    detect = jax.jit(make_detect_fn(cfg, w, h))
    feats = []
    for dev in (gpu, jax.devices("cpu")[0]):
        out = detect(jax.device_put(img, dev))
        feats.append(features_to_numpy(out.features, int(out.features.count)))
    summary, failures = compare.compare_features("gpu vs cpu", feats[1],
                                                 feats[0])
    assert not failures, summary
    assert np.isfinite(feats[0]["x"]).all()


# ---------------------------------------------------------------------------
# The comparisons report what differs
# ---------------------------------------------------------------------------

def _features(n=200, seed=0):
    from vulkansift_tpu.types import FEATURE_DTYPE
    rng = np.random.default_rng(seed)
    f = np.zeros(n, FEATURE_DTYPE)
    f["x"] = rng.uniform(0, 640, n)
    f["y"] = rng.uniform(0, 480, n)
    f["octave_idx"] = rng.integers(0, 4, n)
    f["scale_idx"] = rng.integers(1, 4, n)
    f["orientation"] = rng.uniform(-np.pi, np.pi, n)
    f["descriptor"] = rng.integers(3, 250, (n, 128))
    return f


def _move_x(f):
    f["x"][:10] += 0.05            # 5% of keypoints beyond 0.01 px


def _turn(f):
    f["orientation"][:10] += 0.01  # 5% of orientations beyond 1e-3 rad


def _desc(f):
    f["descriptor"][:10, 5] += 3   # 5% of descriptors 3 bins off


@pytest.mark.parametrize("mutate,flagged", [
    (None, ()),
    (_move_x, ("keypoints paired", "orientations paired")),
    (_turn, ("orientations paired",)),
    (_desc, ("descriptors within",)),
], ids=["same", "moved", "turned", "descriptor"])
def test_compare_features_reports_mismatch(mutate, flagged):
    ref = _features()
    got = ref[::-1].copy()  # order must not matter
    if mutate is not None:
        mutate(got)
    summary, failures = compare.compare_features("t", ref, got)
    assert [f.split(": ")[1].rsplit(" ", 1)[0] for f in failures] == list(
        flagged), summary


@pytest.mark.parametrize("field", [None, "idx_b2", "dist_a_b1"])
def test_compare_matches_reports_mismatch(field):
    rng = np.random.default_rng(1)
    ref = [rng.integers(0, 999, 64).astype(np.int32),
           rng.integers(0, 999, 64).astype(np.int32),
           rng.uniform(1, 500, 64).astype(np.float32),
           rng.uniform(1, 500, 64).astype(np.float32)]
    got = [c.copy() for c in ref]
    if field == "idx_b2":
        got[1][3] += 1
    elif field == "dist_a_b1":
        got[2][5] = np.nextafter(got[2][5], np.float32(np.inf))
    summary, failures = compare.compare_matches("t", got, ref)
    if field is None:
        assert not failures and "bit-exact" in summary
    else:
        assert failures == [f"t: {field} differs in 1 of 64 rows"]
        if field.startswith("dist"):
            assert "max 1 ulp" in summary
