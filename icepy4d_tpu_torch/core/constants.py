"""Shared constants (counterpart of `icepy4d_tpu/core/constants.py`)."""

DATETIME_FMT = "%Y-%m-%d_%H-%M-%S"
DATE_FMT = "%Y-%m-%d"
TIME_FMT = "%H:%M:%S"

DEFAULT_MAX_KEYPOINTS = 8192
DEFAULT_DESCRIPTOR_DIM = 256
