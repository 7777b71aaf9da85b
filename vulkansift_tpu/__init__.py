"""vulkansift_tpu — a JAX SIFT front-end and SfM engine.

A brand-new JAX/XLA implementation with the capabilities of
VulkanSift (github.com/maelaubert/VulkanSift): gaussian scale-space
construction, DoG extrema detection with subpixel refinement, orientation
assignment, 128-D UBC/VLFeat descriptors, and brute-force 2-NN matching —
plus batched multi-image detection and sharded matching over device meshes.

See SURVEY.md at the repository root for the structural map of the
reference this build follows.
"""

from .config import (DESC_SIZE, DescriptorFormat, PyramidPrecision,
                     SiftConfig, get_default_config)
from .errors import (DeviceError, InvalidConfigError, InvalidInputError,
                     Result, VulkanSiftTpuError)
from .instance import (SiftInstance, get_available_devices, load_runtime,
                       unload_runtime)
from .types import (FEATURE_DTYPE, MATCH_DTYPE, Features, Matches2NN,
                    features_from_numpy, features_to_numpy, matches_to_numpy)
from .utils.logging import LogLevel, set_log_level

__version__ = "0.1.0"

__all__ = [
    "DESC_SIZE", "DescriptorFormat", "PyramidPrecision", "SiftConfig",
    "get_default_config", "DeviceError", "InvalidConfigError",
    "InvalidInputError", "Result", "VulkanSiftTpuError", "SiftInstance",
    "get_available_devices", "load_runtime", "unload_runtime",
    "FEATURE_DTYPE", "MATCH_DTYPE", "Features", "Matches2NN",
    "features_from_numpy", "features_to_numpy", "matches_to_numpy",
    "LogLevel", "set_log_level",
]
