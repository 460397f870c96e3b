"""The uint8 frame codec of the serving wire (intact_tpu/utils/device.py::float_to_u8,
copied; its inverse, the u8 -> [-1, 1] normalize, is `intact_tpu_torch.native.normalize_u8`)."""

from __future__ import annotations

import numpy as np


def float_to_u8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float frames -> uint8, the inverse of `normalize_u8`.

    Serving ships uint8 to the device (4x fewer bytes; the policy normalizes
    on the card). For frames that entered the adapter as uint8 pixels and
    were resized uint8 -> uint8 before normalizing, this recovers the pixels
    exactly; frames interpolated in float space re-quantize with at most
    1/255 per-channel rounding."""
    if img.dtype == np.uint8:
        return img
    return np.clip(np.round((img.astype(np.float32) + 1.0) * 127.5), 0, 255).astype(np.uint8)
