"""Image transforms, OpenCLIP's, on PIL and numpy (no torchvision).

Counterpart of `contrastors_tpu/data/transforms.py`: train is
RandomResizedCrop with the augmentation scale, val is resize-shorter-side
and center crop, or the ResizeMaxSize letterbox; then the OpenAI mean/std
normalisation to fp32 CHW, or raw uint8 CHW when the trainer normalises on
the device. The same code as JAX's, so the same image gives the same
pixels bit for bit. PIL is imported inside the functions that use it: the
trainer's data hook can feed pixels without it, and the train crop also
takes an `ArrayImage`, a decoded image held in memory, whose resize is
Pillow's bicubic resampling written in numpy, so that a host without Pillow
crops as one with it does.
"""

import functools
import math
import random
from typing import Callable, Optional, Tuple, Union

import numpy as np

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
BICUBIC = 3  # PIL.Image.Resampling.BICUBIC, as a number: the train crop imports no PIL
_PRECISION_BITS = 22  # Pillow's fixed point for 8-bit resampling (libImaging/Resample.c)


def _bicubic_filter(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=4096)
def _resample_weights(in_size: int, in0: float, in1: float, out_size: int) -> np.ndarray:
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc for the bicubic
    filter, as a dense [out_size, in_size] matrix of 22-bit fixed-point
    weights (0 outside each output pixel's span)."""
    scale = float(np.float32(in1) - np.float32(in0)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    dense = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = float(in0) + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic_filter((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        k = np.asarray([v / ww if ww != 0.0 else v for v in w]) * (1 << _PRECISION_BITS)
        dense[xx, xmin:xmin + xmax] = np.trunc(np.where(k < 0, k - 0.5, k + 0.5))
    return dense


def _resample_pass(img: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """One of Pillow's passes over axis (1: horizontal, 0: vertical) of a
    uint8 [H, W, C] image: a rounded fixed-point sum, clipped to uint8."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.tensordot(weights, src, axes=1) + (1 << (_PRECISION_BITS - 1))
    out = np.where(acc <= 0, 0, np.where(acc >= 1 << (_PRECISION_BITS + 8), 255, acc >> _PRECISION_BITS))
    return np.moveaxis(out.astype(np.uint8), 0, axis)


class ArrayImage:
    """A decoded RGB image held in memory (uint8 [H, W, 3]) with the part of
    PIL's Image interface that the crops use: `size`, `crop` (inside the
    image), `resize` (bicubic, with a box: Pillow's resampling of 8-bit
    images, the fixed-point coefficients, a horizontal pass over the rows the
    vertical one reads, then the vertical pass, each rounded and clipped to
    uint8, bit for bit), `convert("RGB")` and `np.asarray`."""

    def __init__(self, array: np.ndarray):
        self.array = np.asarray(array, np.uint8)

    @property
    def size(self) -> Tuple[int, int]:
        return self.array.shape[1], self.array.shape[0]

    def crop(self, box) -> "ArrayImage":
        left, top, right, bottom = box
        if left < 0 or top < 0 or right > self.size[0] or bottom > self.size[1]:
            raise ValueError(f"crop box {box} outside the {self.size} image")
        return ArrayImage(self.array[top:bottom, left:right].copy())

    def convert(self, mode: str) -> "ArrayImage":
        if mode != "RGB":
            raise ValueError(f"ArrayImage holds RGB, not {mode}")
        return self

    def __array__(self, dtype=None, copy=None):
        return self.array if dtype is None else self.array.astype(dtype)

    def resize(self, size: Tuple[int, int], resample: int = BICUBIC, box=None) -> "ArrayImage":
        if resample != BICUBIC:
            raise ValueError("ArrayImage resizes with BICUBIC only")
        (w, h), (W, H) = self.size, size
        box = tuple(box) if box is not None else (0, 0, w, h)
        if (w, h) == (W, H) and box == (0, 0, w, h):
            return ArrayImage(self.array.copy())
        weights_v = _resample_weights(h, box[1], box[3], H)
        img = self.array
        if W != w or box[0] or box[2] != W:
            # the horizontal pass over the rows the vertical one reads
            rows = np.flatnonzero(weights_v.any(axis=0))
            first, last = int(rows[0]), int(rows[-1]) + 1
            img = _resample_pass(img[first:last], _resample_weights(w, box[0], box[2], W), axis=1)
            weights_v = weights_v[:, first:last]
        if H != h or box[1] or box[3] != H:
            img = _resample_pass(img, weights_v, axis=0)
        return ArrayImage(img)


def _to_chw(img: "PIL.Image.Image", mean, std) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    arr = (arr - np.asarray(mean, dtype=np.float32)) / np.asarray(std, dtype=np.float32)
    return arr.transpose(2, 0, 1)


def _to_chw_uint8(img: "PIL.Image.Image") -> np.ndarray:
    """Raw uint8 CHW: the trainer normalises on the device
    (`ImageTextTrainer._pixel_stats`), a 4x smaller host-to-device copy."""
    return np.asarray(img.convert("RGB"), dtype=np.uint8).transpose(2, 0, 1)


def random_resized_crop(
    img: "PIL.Image.Image",
    size: int,
    scale: Tuple[float, float] = (0.9, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    rng: Optional[random.Random] = None,
) -> "PIL.Image.Image":
    rng = rng or random
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            return img.resize((size, size), BICUBIC, box=(x, y, x + cw, y + ch))
    # fallback: center crop
    return center_crop_resize(img, size)


def center_crop_resize(img: "PIL.Image.Image", size: int) -> "PIL.Image.Image":
    w, h = img.size
    short = min(w, h)
    scale = size / short
    img = img.resize((max(size, int(round(w * scale))), max(size, int(round(h * scale)))), BICUBIC)
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def resize_max_letterbox(img: "PIL.Image.Image", size: int, fill: int = 0) -> "PIL.Image.Image":
    """Scale the LONGEST side to `size`, pad to square
    (the reference's ResizeMaxSize)."""
    from PIL import Image

    w, h = img.size
    scale = size / max(w, h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    img = img.resize((nw, nh), Image.BICUBIC)
    canvas = Image.new("RGB", (size, size), (fill, fill, fill))
    canvas.paste(img, ((size - nw) // 2, (size - nh) // 2))
    return canvas


def image_transform(
    image_size: Union[int, Tuple[int, int]] = 224,
    is_train: bool = False,
    mean=OPENAI_MEAN,
    std=OPENAI_STD,
    resize_longest_max: bool = False,
    scale: Tuple[float, float] = (0.9, 1.0),
    fill_color: int = 0,
    seed: Optional[int] = None,
    ship_uint8: bool = False,
) -> Callable[["PIL.Image.Image"], np.ndarray]:
    size = image_size if isinstance(image_size, int) else image_size[0]
    rng = random.Random(seed) if seed is not None else None
    finish = _to_chw_uint8 if ship_uint8 else (lambda img: _to_chw(img, mean, std))

    def train_fn(img: "PIL.Image.Image") -> np.ndarray:
        return finish(random_resized_crop(img, size, scale=scale, rng=rng))

    def val_fn(img: "PIL.Image.Image") -> np.ndarray:
        if resize_longest_max:
            return finish(resize_max_letterbox(img, size, fill_color))
        return finish(center_crop_resize(img, size))

    return train_fn if is_train else val_fn
