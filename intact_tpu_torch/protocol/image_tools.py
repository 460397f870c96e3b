"""Client-side image helpers (intact_tpu/protocol/image_tools.py, reference
`image_tools.py:9-63`).

Pure numpy/PIL: these run in simulator client processes, never on the card.
`resize_with_pad` reproduces tf.image.resize_with_pad semantics (aspect-
preserving resize, centered zero padding) because VLA success rates are
sensitive to the exact resize used at training time. PIL is imported by the
function that resizes, so a frame already at the target size needs no PIL.
"""

from __future__ import annotations

import numpy as np


def convert_to_uint8(img: np.ndarray) -> np.ndarray:
    """Float image in [0,1] -> uint8 (shrinks network frames ~4x)."""
    if np.issubdtype(img.dtype, np.floating):
        img = (255 * img).astype(np.uint8)
    return img


def resize_with_pad(images: np.ndarray, height: int, width: int, method=None) -> np.ndarray:
    """Resize a batch [..., H, W, C] to (height, width) without distortion.

    The image is scaled to fit inside the target box and centered on a zero
    canvas, matching tf.image.resize_with_pad. `method` is a PIL resampling
    filter; None means PIL's Image.BILINEAR (the reference's default).
    """
    if images.shape[-3:-1] == (height, width):
        return images

    lead = images.shape[:-3]
    flat = images.reshape(-1, *images.shape[-3:])
    out = np.stack(
        [_resize_with_pad_one(im, height, width, method) for im in flat]
    )
    return out.reshape(*lead, *out.shape[-3:])


def _resize_with_pad_one(image: np.ndarray, height: int, width: int, method) -> np.ndarray:
    from PIL import Image

    if method is None:
        method = Image.BILINEAR
    pil = Image.fromarray(image)
    cur_w, cur_h = pil.size
    if (cur_w, cur_h) == (width, height):
        return np.asarray(pil)

    ratio = max(cur_w / width, cur_h / height)
    new_w, new_h = int(cur_w / ratio), int(cur_h / ratio)
    resized = pil.resize((new_w, new_h), resample=method)

    canvas = Image.new(resized.mode, (width, height), 0)
    canvas.paste(resized, ((width - new_w) // 2, (height - new_h) // 2))
    return np.asarray(canvas)
