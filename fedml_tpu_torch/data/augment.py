"""On-device data augmentation, keyed by threefry keys.

Port of ``fedml_tpu/data/augment.py``: the reference's host transforms
(RandomCrop(32, padding=4), RandomHorizontalFlip, Normalize, Cutout(16);
fed_cifar100's RandomCrop(24) and CenterCrop(24)) as tensor ops on the
tensor's own device.  Every function takes ``x`` of shape ``[..., H, W,
C]`` (any leading batch dims) and a `fedml_tpu_torch.core.prng` key, and
draws the JAX package's flips (``prng.bernoulli``), crop offsets and
cutout centres (``prng.randint``) from it, so one key gives the same
images as ``jax.random.key`` does there.  The crops gather the pixels
that JAX's roll of the (zero-padded) image and static slice give; flips
and cutout are selects and a multiply by 0 or 1, and ``normalize`` one
subtract and one divide a pixel."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from fedml_tpu_torch.core import prng


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]
              ) -> torch.Tensor:
    """Channelwise ``(x - mean) / std``."""
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def random_flip(key: prng.Key, x: torch.Tensor) -> torch.Tensor:
    """Horizontal flip with p=0.5, independently per image."""
    flip = prng.bernoulli(key, 0.5, x.shape[:-3], device=x.device)
    return torch.where(flip[..., None, None, None], torch.flip(x, (-2,)), x)


def _window(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
            h: int, w: int) -> torch.Tensor:
    """Each image's ``h x w`` window of ``x`` rolled by ``(-dy, -dx)``:
    ``out[..., i, j, :] = x[..., (i + dy) % H, (j + dx) % W, :]``."""
    H, W = x.shape[-3], x.shape[-2]
    batch = x.shape[:-3]
    flat = x.reshape((-1,) + tuple(x.shape[-3:]))
    dy, dx = dy.reshape(-1, 1).long(), dx.reshape(-1, 1).long()
    rows = (torch.arange(h, device=x.device) + dy) % H       # [N, h]
    cols = (torch.arange(w, device=x.device) + dx) % W       # [N, w]
    n = torch.arange(flat.shape[0], device=x.device)[:, None, None]
    out = flat[n, rows[:, :, None], cols[:, None, :]]
    return out.reshape(tuple(batch) + (h, w, x.shape[-1]))


def random_crop(key: prng.Key, x: torch.Tensor, padding: int = 4
                ) -> torch.Tensor:
    """RandomCrop(H, padding): pad ``padding`` zeros on each side, crop
    back to ``H x W`` at a uniform offset, per image."""
    batch_shape = tuple(x.shape[:-3])
    kdy, kdx = prng.split(key)
    dy = prng.randint(kdy, batch_shape, 0, 2 * padding + 1, device=x.device)
    dx = prng.randint(kdx, batch_shape, 0, 2 * padding + 1, device=x.device)
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    return _window(xp, dy, dx, x.shape[-3], x.shape[-2])


def cutout(key: prng.Key, x: torch.Tensor, length: int = 16) -> torch.Tensor:
    """Cutout: zero a ``length x length`` square at a uniform centre,
    clipped to the image."""
    H, W = x.shape[-3], x.shape[-2]
    batch_shape = tuple(x.shape[:-3])
    ky, kx = prng.split(key)
    cy = prng.randint(ky, batch_shape + (1, 1), 0, H, device=x.device)
    cx = prng.randint(kx, batch_shape + (1, 1), 0, W, device=x.device)
    rows = torch.arange(H, device=x.device)[:, None]
    cols = torch.arange(W, device=x.device)[None, :]
    half = length // 2
    inside = ((rows >= cy - half) & (rows < cy + half)
              & (cols >= cx - half) & (cols < cx + half))
    return x * (1.0 - inside[..., None].to(x.dtype))


def cifar_train_augment(key: prng.Key, x: torch.Tensor,
                        mean: Sequence[float], std: Sequence[float],
                        crop_padding: int = 4, cutout_length: int = 16
                        ) -> torch.Tensor:
    """The CIFAR train pipeline: crop, flip, normalize, cutout."""
    k1, k2, k3 = prng.split(key, 3)
    x = random_crop(k1, x, crop_padding)
    x = random_flip(k2, x)
    x = normalize(x, mean, std)
    return cutout(k3, x, cutout_length)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """CenterCrop(size), fed_cifar100's test transform."""
    H, W = x.shape[-3], x.shape[-2]
    top, left = (H - size) // 2, (W - size) // 2
    return x[..., top:top + size, left:left + size, :]


def random_crop_to(key: prng.Key, x: torch.Tensor, size: int
                   ) -> torch.Tensor:
    """RandomCrop(size) with ``size < H``: a ``size x size`` window at a
    uniform offset (fed_cifar100's 24x24 train crop); the output is
    smaller than the input."""
    H, W = x.shape[-3], x.shape[-2]
    batch_shape = tuple(x.shape[:-3])
    kdy, kdx = prng.split(key)
    dy = prng.randint(kdy, batch_shape, 0, H - size + 1, device=x.device)
    dx = prng.randint(kdx, batch_shape, 0, W - size + 1, device=x.device)
    return _window(x, dy, dx, size, size)


def fed_cifar100_train_augment(key: prng.Key, x: torch.Tensor,
                               mean: Sequence[float], std: Sequence[float],
                               crop_size: int = 24) -> torch.Tensor:
    """fed_cifar100's train pipeline: RandomCrop(24), flip, normalize."""
    k1, k2 = prng.split(key)
    x = random_crop_to(k1, x, crop_size)
    x = random_flip(k2, x)
    return normalize(x, mean, std)


def fed_cifar100_eval_transform(x: torch.Tensor, mean: Sequence[float],
                                std: Sequence[float], crop_size: int = 24
                                ) -> torch.Tensor:
    """fed_cifar100's test pipeline: CenterCrop(24), normalize."""
    return normalize(center_crop(x, crop_size), mean, std)


# the reference's channel statistics
CIFAR10_MEAN = (0.49139968, 0.48215827, 0.44653124)
CIFAR10_STD = (0.24703233, 0.24348505, 0.26158768)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
CINIC10_MEAN = (0.47889522, 0.47227842, 0.43047404)
CINIC10_STD = (0.24205776, 0.23828046, 0.25874835)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
