"""Test config: CPU JAX with an 8-device virtual mesh (GPU tests opt in).

Multi-chip sharding paths are exercised on a fake CPU mesh
(`--xla_force_host_platform_device_count`), the standard JAX answer to
"multi-node tests without a cluster" (SURVEY.md §4).
"""

import os

# The CPU is the default backend (the mesh tests need its 8 virtual
# devices). A platform the caller names, e.g. JAX_PLATFORMS=cuda for the
# `gpu`-marked tests, stays available after it: those tests ask for
# jax.devices("gpu") explicitly.
inherited = [p for p in os.environ.get("JAX_PLATFORMS", "").split(",")
             if p and p != "cpu"]
platforms = ",".join(["cpu"] + inherited)
os.environ["JAX_PLATFORMS"] = platforms
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Set the platforms + 8 virtual CPU devices via config as well, which wins
# over anything set in the environment after this point.
import jax  # noqa: E402

jax.config.update("jax_platforms", platforms)
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Smoke tier: `python -m pytest -m smoke` runs a <60 s cross-section (one or
# more fast tests per subsystem). Curated centrally here (durations measured
# on this machine) instead of scattering marks across files.
# ---------------------------------------------------------------------------

_SMOKE_MODULES = {"test_config", "test_native_io", "test_match"}
_SMOKE_TESTS = {
    "test_refinement_matches_golden",        # extract
    "test_blur_matches_scipy",               # scale space
    "test_upsample2x_matches_golden",
    "test_pyramid_bf16_close_to_f32",
    "test_se3_compose_inverse",              # sfm math
    "test_so3_exp_log_roundtrip",
    "test_triangulation_exact",
    "test_ring_match_tie_breaking_across_shards",  # multi-chip merge
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        name = item.name.split("[")[0]
        if mod in _SMOKE_MODULES or name in _SMOKE_TESTS:
            item.add_marker(pytest.mark.smoke)


@pytest.fixture(scope="session")
def blob_image():
    """Deterministic synthetic test image with gaussian blobs + texture."""
    return make_blob_image(480, 640, seed=0)


def make_blob_image(h: int, w: int, seed: int = 0,
                    nb_blobs: int = 40) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    for _ in range(nb_blobs):
        cy = rng.uniform(0.05 * h, 0.95 * h)
        cx = rng.uniform(0.05 * w, 0.95 * w)
        s = rng.uniform(1.5, min(h, w) / 24)
        a = rng.uniform(-1.0, 1.0)
        img += a * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    img += 0.08 * rng.standard_normal((h, w))
    img -= img.min()
    img = 255.0 * img / img.max()
    return img.astype(np.uint8)


@pytest.fixture(scope="session")
def small_image():
    return make_blob_image(96, 128, seed=3, nb_blobs=12)
