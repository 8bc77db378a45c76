"""Image transforms, OpenCLIP's, on PIL and numpy (no torchvision).

Counterpart of `contrastors_tpu/data/transforms.py`: train is
RandomResizedCrop with the augmentation scale, val is resize-shorter-side
and center crop, or the ResizeMaxSize letterbox; then the OpenAI mean/std
normalisation to fp32 CHW, or raw uint8 CHW when the trainer normalises on
the device. The same code as JAX's, so the same image gives the same
pixels bit for bit. PIL is imported inside the functions that use it: the
trainer's data hook can feed pixels without it.
"""

import math
import random
from typing import Callable, Optional, Tuple, Union

import numpy as np

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


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
    from PIL import Image

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
            return img.resize((size, size), Image.BICUBIC, box=(x, y, x + cw, y + ch))
    # fallback: center crop
    return center_crop_resize(img, size)


def center_crop_resize(img: "PIL.Image.Image", size: int) -> "PIL.Image.Image":
    from PIL import Image

    w, h = img.size
    short = min(w, h)
    scale = size / short
    img = img.resize((max(size, int(round(w * scale))), max(size, int(round(h * scale)))), Image.BICUBIC)
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
