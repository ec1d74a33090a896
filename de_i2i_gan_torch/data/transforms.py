"""Host-side image transforms (numpy / PIL), a copy of
``de_i2i_gan_tpu/data/transforms.py``. They mirror the torchvision
pipelines wired in the reference entry scripts:

train (the reference's defectGAN/train_defectgan.py:57-65):
  Resize(1.5x) -> RandomResizedCrop(size, scale=(.6, 1)) -> HFlip -> VFlip ->
  ColorJitter(.2, .2, .2) -> Normalize(mean=.5, std=.5)
val/test (train_defectgan.py:84-89):
  Resize(size) -> RandomCrop(pad_if_needed) -> Normalize

Outputs are NHWC float32 in [-1, 1], the layout of the port's entry points
(the reference produces NCHW torch tensors). PIL is optional: without it
the file datasets cannot decode images, and nothing else needs it.
"""
from __future__ import annotations

import math

import numpy as np

try:
    from PIL import Image
except ImportError:  # only the transforms need PIL, when called
    Image = None


def resize_shorter(img: "Image.Image", size: int) -> "Image.Image":
    """torchvision Resize(int): shorter side -> size, keep aspect ratio."""
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    return img.resize((nw, nh), Image.BILINEAR)


def random_resized_crop(rng: np.random.Generator, img: "Image.Image",
                        size: int, scale=(0.6, 1.0),
                        ratio=(3 / 4, 4 / 3)) -> "Image.Image":
    """torchvision RandomResizedCrop semantics (10 attempts + center fallback)."""
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = round(math.sqrt(target_area * aspect))
        ch = round(math.sqrt(target_area / aspect))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.integers(0, h - ch + 1)
            j = rng.integers(0, w - cw + 1)
            return img.resize((size, size), Image.BILINEAR,
                              box=(j, i, j + cw, i + ch))
    # center-crop fallback
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, round(w / ratio[0])
    elif in_ratio > ratio[1]:
        cw, ch = round(h * ratio[1]), h
    else:
        cw, ch = w, h
    i, j = (h - ch) // 2, (w - cw) // 2
    return img.resize((size, size), Image.BILINEAR, box=(j, i, j + cw, i + ch))


def random_crop_padded(rng: np.random.Generator, img: "Image.Image",
                       size: int) -> "Image.Image":
    """torchvision RandomCrop(pad_if_needed=True)."""
    w, h = img.size
    if w < size or h < size:
        canvas = Image.new(img.mode, (max(w, size), max(h, size)))
        canvas.paste(img, ((max(w, size) - w) // 2, (max(h, size) - h) // 2))
        img, (w, h) = canvas, canvas.size
    i = rng.integers(0, h - size + 1)
    j = rng.integers(0, w - size + 1)
    return img.crop((j, i, j + size, i + size))


def color_jitter(rng: np.random.Generator, arr: np.ndarray,
                 brightness=0.2, saturation=0.2, contrast=0.2) -> np.ndarray:
    """torchvision ColorJitter on a float [0,1] HWC array (random order is
    approximated by a fixed b->s->c order; factors U[1-x, 1+x])."""
    b = rng.uniform(1 - brightness, 1 + brightness)
    arr = np.clip(arr * b, 0.0, 1.0)
    s = rng.uniform(1 - saturation, 1 + saturation)
    grey = arr.mean(axis=2, keepdims=True)
    arr = np.clip(grey + (arr - grey) * s, 0.0, 1.0)
    c = rng.uniform(1 - contrast, 1 + contrast)
    mean = arr.mean()
    arr = np.clip(mean + (arr - mean) * c, 0.0, 1.0)
    return arr


def normalize(arr: np.ndarray) -> np.ndarray:
    """[0,1] -> [-1,1] (Normalize(mean=.5, std=.5))."""
    return (arr.astype(np.float32) - 0.5) / 0.5


class TrainTransform:
    """The reference's training augmentation chain."""

    def __init__(self, image_size: int, jitter: bool = True,
                 hflip: bool = True, vflip: bool = True,
                 randcrop_prob: float = 1.0):
        self.size = image_size
        self.jitter = jitter
        self.hflip = hflip
        self.vflip = vflip
        # stargan-v2 applies the random-resized crop with a probability
        # (--randcrop_prob, data_loader.py:95-105); defectGAN always crops
        self.randcrop_prob = randcrop_prob

    def __call__(self, img, rng: np.random.Generator) -> np.ndarray:
        img = img.convert("RGB")
        if rng.random() < self.randcrop_prob:
            img = resize_shorter(img, int(self.size * 1.5))
            img = random_resized_crop(rng, img, self.size)
        else:
            img = img.resize((self.size, self.size))
        arr = np.asarray(img, np.float32) / 255.0
        if self.hflip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        if self.vflip and rng.random() < 0.5:
            arr = arr[::-1]
        if self.jitter:
            arr = color_jitter(rng, arr)
        return normalize(np.ascontiguousarray(arr))


class EvalTransform:
    """The reference's val/test chain."""

    def __init__(self, image_size: int):
        self.size = image_size

    def __call__(self, img, rng: np.random.Generator) -> np.ndarray:
        img = img.convert("RGB")
        img = resize_shorter(img, self.size)
        img = random_crop_padded(rng, img, self.size)
        return normalize(np.asarray(img, np.float32) / 255.0)
