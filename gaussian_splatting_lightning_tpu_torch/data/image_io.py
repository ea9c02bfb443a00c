"""Image files as uint8 arrays in RGB(A) order, through OpenCV, and animated
GIFs through Pillow.

The port's datasets and CLIs read and write images here. OpenCV (``cv2``,
which the datasets also resize with) keeps colour in BGR(A) order; this
module turns it into the RGB(A) order the rest of the port uses. OpenCV's
own GIF writer quantises coarsely (a grey ramp came back up to 84 levels
off), so GIFs go through Pillow.
"""

from __future__ import annotations

import cv2
import numpy as np


def _swap_red_blue(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        img = img[..., [2, 1, 0, 3][: img.shape[-1]]]
    return np.ascontiguousarray(img)


def read_image(path) -> np.ndarray:
    """An image file as an (H, W, 3|4) RGB(A) or (H, W) grey array."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"cannot read an image from {path}")
    return _swap_red_blue(img)


def write_image(path, image: np.ndarray) -> None:
    """Write an (H, W), (H, W, 3) RGB or (H, W, 4) RGBA uint8 array."""
    if not cv2.imwrite(str(path), _swap_red_blue(np.asarray(image))):
        raise OSError(f"cannot write an image to {path}")


def write_gif(path, frames, fps: float) -> None:
    """Write (H, W, 3) RGB uint8 frames as a looping animated GIF, each
    frame quantised to its own 256-colour palette by Pillow's fast octree
    (its default median cut took ~30x longer on 1080p renders, for ~1.5 dB).
    Pillow merges a frame identical to the one before it into that frame's
    duration."""
    from PIL import Image

    images = [Image.fromarray(np.asarray(f)).quantize(method=Image.Quantize.FASTOCTREE)
              for f in frames]
    images[0].save(path, save_all=True, append_images=images[1:],
                   duration=round(1000.0 / fps), loop=0)
