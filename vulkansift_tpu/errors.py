"""Structured error model for vulkansift_tpu.

Mirrors the reference's 3-value ``vksift_Result`` contract
(reference: include/vulkansift/vulkansift_types.h:63-74):

* ``Result.SUCCESS`` — everything fine.
* ``Result.INVALID_INPUT_ERROR`` — detected early, instance stays usable
  (maps to :class:`InvalidInputError`).
* ``Result.VULKAN_ERROR`` — device/runtime failure poisoning the instance
  (maps to :class:`DeviceError`; this wraps XLA/PJRT failures).

The reference dispatches failures through a user-installable error callback
(reference: src/vulkansift/vulkansift.c:31-45); Python users get exceptions,
but an ``on_error`` callback hook with the same semantics is supported on
:class:`~vulkansift_tpu.instance.SiftInstance` for API parity.
"""

from __future__ import annotations

import enum


class Result(enum.Enum):
    """Operation result code (parity: vksift_Result)."""

    SUCCESS = 0
    INVALID_INPUT_ERROR = 1
    DEVICE_ERROR = 2


class VulkanSiftTpuError(Exception):
    """Base class for all vulkansift_tpu errors."""

    result: Result = Result.DEVICE_ERROR


class InvalidInputError(VulkanSiftTpuError, ValueError):
    """Invalid user input; the instance remains fully usable afterwards."""

    result = Result.INVALID_INPUT_ERROR


class InvalidConfigError(InvalidInputError):
    """Configuration validation failure (parity: isConfigurationValid,
    reference: src/vulkansift/vulkansift.c:550-584)."""


class DeviceError(VulkanSiftTpuError, RuntimeError):
    """Device/runtime failure. After this the instance should be discarded,
    matching the reference's VKSIFT_VULKAN_ERROR contract."""

    result = Result.DEVICE_ERROR
