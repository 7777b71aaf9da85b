"""Public instance API.

Mirrors the reference's 20-function C ABI (reference: include/vulkansift/
vulkansift.h:23-111) as a Python class plus module-level helpers:

=============================  =========================================
reference                      vulkansift_tpu
=============================  =========================================
vksift_loadVulkan              load_runtime()
vksift_unloadVulkan            unload_runtime()
vksift_getAvailableGPUs        get_available_devices()
vksift_setLogLevel             utils.logging.set_log_level
vksift_createInstance          SiftInstance(config)
vksift_destroyInstance         SiftInstance.close() / context manager
vksift_getDefaultConfig        config.get_default_config()
vksift_detectFeatures          SiftInstance.detect_features
vksift_matchFeatures           SiftInstance.match_features
vksift_getFeaturesNumber       SiftInstance.get_features_number
vksift_downloadFeatures        SiftInstance.download_features
vksift_uploadFeatures          SiftInstance.upload_features
vksift_getMatchesNumber        SiftInstance.get_matches_number
vksift_downloadMatches         SiftInstance.download_matches
vksift_isBufferAvailable       SiftInstance.is_buffer_available
vksift_getScaleSpaceNbOctaves  SiftInstance.get_scale_space_nb_octaves
vksift_getScaleSpaceOctave...  SiftInstance.get_scale_space_octave_resolution
vksift_downloadScaleSpaceImage SiftInstance.download_scale_space_image
vksift_downloadDoGImage        SiftInstance.download_dog_image
vksift_presentDebugFrame       SiftInstance.start_trace/stop_trace (jax.profiler)
=============================  =========================================

Async contract parity (vulkansift.h:40-47): ``detect_features`` /
``match_features`` leave results on device and return without waiting for
them (JAX dispatch is asynchronous); all download functions block until the
data is available, like the reference's fence waits. ``is_buffer_available``
polls without blocking.

Error contract parity: invalid inputs raise
:class:`~vulkansift_tpu.errors.InvalidInputError` (instance stays usable);
device failures raise :class:`~vulkansift_tpu.errors.DeviceError`. An
optional ``on_error`` callback receives the mapped
:class:`~vulkansift_tpu.errors.Result` before the exception propagates,
mirroring the reference's error-callback dispatch (vulkansift.c:31-45).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .config import SiftConfig, get_default_config
from .detector import SiftDetector
from .pipeline import make_detect_fn, octave_plan
from .errors import DeviceError, InvalidInputError, Result
from .ops.match import match_2nn, match_2nn_auto
from .types import (FEATURE_DTYPE, Features, Matches2NN, features_from_numpy,
                    features_to_numpy, matches_to_numpy)
from .utils.logging import logger

_runtime_loaded = False

# AUTO resolution bucketing (config.resolution_bucket == 0): number of
# distinct resolutions that get exact programs before new resolutions
# switch to bucketed ones, and the bucket they then use.
_AUTO_EXACT = 2
_AUTO_BUCKET = 64


def load_runtime() -> Result:
    """Probe the accelerator runtime (parity: vksift_loadVulkan,
    vulkansift.c:68-110). Returns Result.SUCCESS when a JAX backend is
    usable; DEVICE_ERROR (without raising) when none is — so callers can
    fall back to CPU SIFT like the reference's graceful volk failure
    (vulkan_device.c:22-30)."""
    global _runtime_loaded
    try:
        jax.devices()
        _runtime_loaded = True
        return Result.SUCCESS
    except Exception:  # noqa: BLE001 - mirrors reference's catch-all
        logger.error("load_runtime() failure: no usable JAX backend")
        return Result.DEVICE_ERROR


def unload_runtime() -> None:
    """Parity: vksift_unloadVulkan (no-op: PJRT manages its own lifetime)."""
    global _runtime_loaded
    _runtime_loaded = False


def get_available_devices() -> List[str]:
    """Parity: vksift_getAvailableGPUs."""
    try:
        return [f"{d.platform}:{d.device_kind}" for d in jax.devices()]
    except Exception:  # noqa: BLE001
        return []


@dataclasses.dataclass
class _BufferState:
    """Host-side bookkeeping for one on-device SIFT buffer (the analogue of
    the reference's vksift_SiftBufferInfo, sift_memory.h:33-115).

    ``count``/``per_octave_counts`` are fetched lazily (one host round-trip)
    so detect_features stays non-blocking like the reference's async submit
    (vulkansift.h:40-47)."""

    features: Features
    count: Optional[int] = 0
    per_octave_counts: Optional[Tuple[int, ...]] = ()
    input_width: int = 0
    input_height: int = 0
    gaussians: Optional[tuple] = None
    dogs: Optional[tuple] = None
    lost: object = None  # device scalar, checked at first count access
    # The octave resolutions the compiled pipeline ACTUALLY used (under
    # resolution bucketing these come from the padded resolution and may be
    # one octave fewer than the exact-resolution math); recorded at detect
    # time so the debug APIs report what was computed, never a recompute.
    octave_resolutions: Tuple[Tuple[int, int], ...] = ()

    def sync_counts(self, log) -> None:
        if self.count is None:
            import jax as _jax
            cnt, lost, per_oct = _jax.device_get(
                (self.features.count, self.lost, self.per_octave_counts))
            self.count = int(cnt)
            self.per_octave_counts = tuple(int(c) for c in per_oct)
            if int(lost) > 0:
                log.warning(
                    "Buffer too small to store all detected features "
                    "(%d features lost)", int(lost))


class SiftInstance:
    """SIFT detection/matching engine bound to one device.

    Owns ``config.sift_buffer_count`` independent feature buffers so callers
    can detect into one while reading another (parity:
    vksift_Config.sift_buffer_count multi-buffer pipelining).
    """

    def __init__(self, config: Optional[SiftConfig] = None,
                 on_error: Optional[Callable[[Result], None]] = None):
        config = config or get_default_config()
        self._on_error = on_error
        try:
            config.validate()
        except InvalidInputError:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise
        self.config = config
        try:
            devices = jax.devices()
        except Exception as e:  # noqa: BLE001
            self._dispatch_error(Result.DEVICE_ERROR)
            raise DeviceError("no usable JAX backend") from e
        idx = config.device_index
        if idx >= len(devices):
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(
                f"device index {idx} out of range ({len(devices)} devices)")
        self.device = devices[idx] if idx >= 0 else devices[0]
        # Monolithic jitted pipeline, cached per input resolution (the
        # staged SiftDetector remains available for host-visible debugging).
        # Bounded LRU: each entry is a compiled XLA executable
        # (config.detect_cache_size; resolution_bucket reduces distinct
        # keys in the first place).
        self._detect_cache = collections.OrderedDict()
        # Resolutions granted exact (unbucketed) programs in AUTO bucketing
        # mode (config.resolution_bucket == 0); see detect_features.
        self._exact_resolutions: set = set()
        self._buffers: List[_BufferState] = [
            _BufferState(features=Features.empty(config.max_nb_sift_per_buffer))
            for _ in range(config.sift_buffer_count)]
        self._matches: Optional[Matches2NN] = None
        self._matches_count: Optional[int] = 0
        self._closed = False

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Parity: vksift_destroyInstance."""
        self._buffers = []
        self._matches = None
        self._closed = True

    def __enter__(self) -> "SiftInstance":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _dispatch_error(self, result: Result) -> None:
        if self._on_error is not None:
            self._on_error(result)

    def _check_buffer(self, buffer_id: int) -> _BufferState:
        if self._closed:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError("instance is closed")
        if not (0 <= buffer_id < len(self._buffers)):
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(
                f"buffer index {buffer_id} out of range "
                f"({len(self._buffers)} buffers reserved)")
        return self._buffers[buffer_id]

    # -- detection ------------------------------------------------------
    def detect_features(self, image: np.ndarray, buffer_id: int) -> None:
        """Detect SIFT features of a (H, W) uint8 grayscale image into the
        given buffer (parity: vksift_detectFeatures, vulkansift.c:315-344).
        Results stay on device; downloads block until ready."""
        buf = self._check_buffer(buffer_id)
        image = np.asarray(image)
        if image.ndim != 2 or image.dtype != np.uint8:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError("image must be 2-D uint8 grayscale")
        height, width = image.shape
        if width * height > self.config.input_image_max_size:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(
                f"image size {width}x{height} exceeds input_image_max_size "
                f"{self.config.input_image_max_size}")
        if min(width, height) < 32:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError("image dimensions must be >= 32")
        b = self.config.resolution_bucket
        if b == 0:
            # AUTO (the default): the first _AUTO_EXACT distinct resolutions
            # compile exact programs (single-/dual-resolution workloads stay
            # bit-identical to resolution_bucket=1); any further NEW
            # resolution switches to bucket-64 programs so mixed-resolution
            # sweeps compile a bounded set — the analogue of the
            # reference's zero-cost image re-creation on preallocated
            # memory (sift_memory.c:891-924). Measured quality drift of the
            # bucketed path: results/bucket_drift.txt.
            if ((width, height) in self._exact_resolutions
                    or len(self._exact_resolutions) < _AUTO_EXACT):
                self._exact_resolutions.add((width, height))
                b = 1
            else:
                b = _AUTO_BUCKET
        valid_w, valid_h = width, height
        bucketed = b > 1
        if bucketed and (width % b or height % b):
            pw, ph = -width % b, -height % b
            image = np.pad(image, ((0, ph), (0, pw)), mode="edge")
            height, width = image.shape
        # The bucket flag is part of the key: an exact (W, H) program and a
        # bucketed one padded to the same (W, H) take different arguments.
        key = (width, height, bucketed)
        try:
            with jax.default_device(self.device):
                if key in self._detect_cache:
                    self._detect_cache.move_to_end(key)
                else:
                    self._detect_cache[key] = jax.jit(make_detect_fn(
                        self.config, width, height,
                        return_pyramid=self.config.retain_pyramid,
                        bucket=b))
                    while (len(self._detect_cache)
                           > self.config.detect_cache_size):
                        self._detect_cache.popitem(last=False)
                args = ((image, jnp.float32(valid_w), jnp.float32(valid_h))
                        if bucketed else (image,))
                if self.config.retain_pyramid:
                    out, gauss, dogs = self._detect_cache[key](*args)
                else:
                    out = self._detect_cache[key](*args)
                    gauss = dogs = None
        except InvalidInputError:
            raise
        except Exception as e:  # noqa: BLE001
            self._dispatch_error(Result.DEVICE_ERROR)
            raise DeviceError("detection pipeline failure") from e
        # Non-blocking: results stay on device; counts fetch lazily.
        buf.features = out.features
        buf.count = None
        buf.per_octave_counts = out.per_octave_counts
        buf.lost = out.lost
        buf.input_width = valid_w
        buf.input_height = valid_h
        buf.octave_resolutions = octave_plan(self.config, width, height, b)
        buf.gaussians = gauss
        buf.dogs = dogs

    # -- matching -------------------------------------------------------
    def match_features(self, buffer_id_a: int, buffer_id_b: int) -> None:
        """2-NN match buffer A's features against buffer B's
        (parity: vksift_matchFeatures, vulkansift.c:417-441).

        Fully async: no host round-trip between detect and match dispatch —
        the live counts stay device-resident and the matcher scales
        compute with them (bucketed dispatch in ops.match.match_2nn_auto),
        the analogue of the reference reading counters from mapped memory
        before recording the dispatch (sift_memory.c:957-1047)."""
        buf_a = self._check_buffer(buffer_id_a)
        buf_b = self._check_buffer(buffer_id_b)
        try:
            with jax.default_device(self.device):
                self._matches = match_2nn_auto(
                    buf_a.features.descriptor, buf_a.features.count,
                    buf_b.features.descriptor, buf_b.features.count)
        except Exception as e:  # noqa: BLE001
            self._dispatch_error(Result.DEVICE_ERROR)
            raise DeviceError("matching pipeline failure") from e
        self._matches_count = None

    # -- data transfer (blocking) ---------------------------------------
    def get_features_number(self, buffer_id: int) -> int:
        """Parity: vksift_getFeaturesNumber — blocks until the async
        detection finished (reference: fence wait, vulkansift.c:356-360),
        then reads the cached count (no further device work)."""
        buf = self._check_buffer(buffer_id)
        buf.sync_counts(logger)
        return buf.count

    def download_features(self, buffer_id: int) -> np.ndarray:
        """Blocking download of the packed features as a structured array
        with the exact vksift_Feature layout (parity:
        vksift_downloadFeatures)."""
        buf = self._check_buffer(buffer_id)
        buf.sync_counts(logger)
        return features_to_numpy(buf.features, buf.count)

    def upload_features(self, feats: np.ndarray, buffer_id: int) -> None:
        """Parity: vksift_uploadFeatures — uploaded features land packed and
        ready for matching (sift_memory.c:1197-1272)."""
        buf = self._check_buffer(buffer_id)
        if feats.dtype != FEATURE_DTYPE:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(
                "features must be a FEATURE_DTYPE structured array")
        if feats.shape[0] > self.config.max_nb_sift_per_buffer:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError("too many features for the buffer")
        with jax.default_device(self.device):
            buf.features = features_from_numpy(
                feats, self.config.max_nb_sift_per_buffer)
        buf.count = int(feats.shape[0])
        # Uploaded features carry no scale-space: invalidate ALL detection
        # metadata so the pyramid/octave debug APIs cannot silently answer
        # for a previously-detected image (reference invalidates
        # consistently, sift_memory.c:1197-1272).
        buf.per_octave_counts = ()
        buf.input_width = buf.input_height = 0
        buf.octave_resolutions = ()
        buf.gaussians = buf.dogs = None

    def _sync_matches_count(self) -> int:
        # Always read the device-resident snapshot: Matches2NN.count was
        # captured from buffer A's live count at match dispatch and cannot
        # go stale, even if A is re-detected/re-uploaded before the download
        # (the advertised multi-buffer pipelining pattern).
        if self._matches_count is None:
            if self._matches is not None:
                self._matches_count = int(
                    jax.device_get(self._matches.count))
            else:
                self._matches_count = 0
        return self._matches_count

    def get_matches_number(self) -> int:
        """Parity: vksift_getMatchesNumber — blocks until the async match
        count is host-visible (first call only)."""
        return self._sync_matches_count()

    def download_matches(self) -> np.ndarray:
        """Blocking download of vksift_Match_2NN-layout matches
        (parity: vksift_downloadMatches)."""
        if self._matches is None:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError("no matches computed yet")
        return matches_to_numpy(self._matches, self._sync_matches_count())

    def is_buffer_available(self, buffer_id: int) -> bool:
        """Non-blocking poll: True when no async device work on the buffer
        is still in flight (parity: vksift_isBufferAvailable,
        vulkansift.c:295-313)."""
        buf = self._check_buffer(buffer_id)
        try:
            leaves = jax.tree.leaves(buf.features)
            return all(leaf.is_ready() for leaf in leaves
                       if hasattr(leaf, "is_ready"))
        except Exception:  # noqa: BLE001
            return True

    # -- scale-space access (debug/visualization) ------------------------
    def get_scale_space_nb_octaves(self, buffer_id: int = 0) -> int:
        """Parity: vksift_getScaleSpaceNbOctaves. Reports the octave plan
        the compiled pipeline ACTUALLY ran (recorded at detect time), so it
        always agrees with len(per_octave_counts) — under resolution
        bucketing the recomputed exact-resolution count can differ."""
        buf = self._check_buffer(buffer_id)
        return len(buf.octave_resolutions)

    def get_scale_space_octave_resolution(
            self, octave: int, buffer_id: int = 0) -> Tuple[int, int]:
        """Parity: vksift_getScaleSpaceOctaveResolution."""
        buf = self._check_buffer(buffer_id)
        res = buf.octave_resolutions
        if not (0 <= octave < len(res)):
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(f"octave {octave} out of range")
        return res[octave]

    def download_scale_space_image(self, octave: int, scale: int,
                                   buffer_id: int = 0) -> np.ndarray:
        """Blocking download of a gaussian pyramid level as float32 (parity:
        vksift_downloadScaleSpaceImage; FP16 pyramids are converted like the
        reference's blit-conversion, sift_memory.c:1313-1325)."""
        buf = self._check_buffer(buffer_id)
        if buf.gaussians is None:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(
                "no pyramid retained (set config.retain_pyramid)")
        if not (0 <= octave < len(buf.gaussians)):
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(f"octave {octave} out of range")
        g = buf.gaussians[octave]
        if not (0 <= scale < g.shape[0]):
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(f"scale {scale} out of range")
        return np.asarray(g[scale], dtype=np.float32)

    def download_dog_image(self, octave: int, scale: int,
                           buffer_id: int = 0) -> np.ndarray:
        """Parity: vksift_downloadDoGImage."""
        buf = self._check_buffer(buffer_id)
        if buf.dogs is None:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(
                "no pyramid retained (set config.retain_pyramid)")
        if not (0 <= octave < len(buf.dogs)):
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(f"octave {octave} out of range")
        d = buf.dogs[octave]
        if not (0 <= scale < d.shape[0]):
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise InvalidInputError(f"scale {scale} out of range")
        return np.asarray(d[scale], dtype=np.float32)

    # -- profiling hooks (the DebugPresenter analogue) --------------------
    def start_trace(self, log_dir: str) -> None:
        """Start a jax.profiler trace session — the replacement for the
        reference's DebugPresenter frame-delimiter hack
        (vkenv/debug_presenter.c:139-185)."""
        jax.profiler.start_trace(log_dir)

    def stop_trace(self) -> None:
        jax.profiler.stop_trace()
