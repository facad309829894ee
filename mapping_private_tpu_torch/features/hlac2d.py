"""2-D image HLAC features — the reference's ``hlac`` package.

Counterpart of ``mapping_private_tpu/features/hlac2d.py``: in place of
the hand-unrolled mask loops of hlac/include/hlac/HLAC.hpp, each bin is
the sum over pixels of a product of shifted copies of the image.  The
pattern tables are the reference's bin orders (HLAC.hpp _extractBin1_3
:227-241, _extractBin2_3 :254-305, _extractGray1_3, _extractGray2_3
:2456+, _extractColor1_3 :5414+).  Position k ∈ 0..8 is the pixel offset
(rx·(k mod 3 − 1), ry·(k div 3 − 1)); a colour index is 9·channel + k.

Binary HLAC gates each pixel's contribution on the centre being set
(HLAC.hpp:266); gray and colour HLAC carry the centre value inside each
product.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

BIN1_3 = [(4,), (0,), (1,), (2,), (3,)]
BIN2_3 = [
    (4,), (0,), (1,), (2,), (3,),
    (0, 1), (0, 2), (0, 3), (0, 5), (0, 6), (0, 7), (0, 8),
    (1, 2), (1, 3), (1, 6), (1, 7), (1, 8),
    (2, 3), (2, 6), (2, 7), (2, 8),
    (3, 5), (3, 8), (5, 6), (6, 8),
]
GRAY1_3 = [(4,), (4, 0), (4, 1), (4, 2), (4, 3), (4, 4)]
GRAY2_3 = [
    (4,), (4, 0), (4, 1), (4, 2), (4, 3), (4, 4),
    (4, 0, 0), (4, 0, 1), (4, 0, 2), (4, 0, 3), (4, 0, 4), (4, 0, 5),
    (4, 0, 6), (4, 0, 7), (4, 0, 8),
    (4, 1, 1), (4, 1, 2), (4, 1, 3), (4, 1, 4), (4, 1, 6), (4, 1, 7), (4, 1, 8),
    (4, 2, 2), (4, 2, 3), (4, 2, 4), (4, 2, 6), (4, 2, 7), (4, 2, 8),
    (4, 3, 3), (4, 3, 4), (4, 3, 5), (4, 3, 8),
    (4, 4, 4), (4, 5, 6), (4, 6, 8),
]
COLOR1_3 = [
    (4,), (13,), (22,),
    (4, 0), (4, 1), (4, 2), (4, 3), (4, 4), (4, 9), (4, 10), (4, 11),
    (4, 12), (4, 13), (4, 14), (4, 15), (4, 16), (4, 17), (4, 18), (4, 19),
    (4, 20), (4, 21), (4, 22), (4, 23), (4, 24), (4, 25), (4, 26),
    (13, 9), (13, 10), (13, 11), (13, 12), (13, 13), (13, 18), (13, 19),
    (13, 20), (13, 21), (13, 22), (13, 23), (13, 24), (13, 25), (13, 26),
    (22, 18), (22, 19), (22, 20), (22, 21), (22, 22),
]


def _pos_offset(k: int, rx: int, ry: int) -> Tuple[int, int]:
    return (rx * (k % 3 - 1), ry * (k // 3 - 1))


def _shifted(img: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """img(i+di, j+dj) aligned at (i, j), zero outside (the reference's
    interior-only loop bounds), as a slice into zeros."""
    h, w = img.shape[:2]
    out = torch.zeros_like(img)
    if abs(di) >= h or abs(dj) >= w:
        return out
    dst_i, src_i = (slice(0, h - di), slice(di, h)) if di >= 0 else (slice(-di, h), slice(0, h + di))
    dst_j, src_j = (slice(0, w - dj), slice(dj, w)) if dj >= 0 else (slice(-dj, w), slice(0, w + dj))
    out[dst_i, dst_j] = img[src_i, src_j]
    return out


def _planes(img: torch.Tensor, rx: int, ry: int) -> list:
    """9 (gray) or 27 (colour) shifted planes, indexed like the
    reference's a[] array (a[9·channel + k])."""
    if img.ndim == 2:
        return [_shifted(img, *_pos_offset(k, rx, ry)) for k in range(9)]
    return [_shifted(img[..., c], *_pos_offset(k, rx, ry))
            for c in range(img.shape[-1]) for k in range(9)]


def _accumulate(planes: list, patterns: Sequence[Tuple[int, ...]], gate) -> torch.Tensor:
    feats = []
    for pat in patterns:
        prod = None
        for t in pat:
            prod = planes[t] if prod is None else prod * planes[t]
        if gate is not None:
            prod = prod * gate
        feats.append(torch.sum(prod))
    return torch.stack(feats)


def _image(img) -> torch.Tensor:
    return torch.as_tensor(img).to(torch.float32)


def hlac_bin(img, order: int = 2, rx: int = 1, ry: int = 1, normalize: bool = False) -> torch.Tensor:
    """Binary-image HLAC (HLAC::extractBin): (H, W) 0/1 image → (5,) or
    (25,), contributions gated on the centre pixel being set."""
    img = _image(img)
    planes = _planes(img, rx, ry)
    gate = (planes[4] > 0).to(img.dtype)
    out = _accumulate(planes, BIN1_3 if order <= 1 else BIN2_3, gate)
    return out / (img.shape[0] * img.shape[1]) if normalize else out


def hlac_gray(img, order: int = 2, rx: int = 1, ry: int = 1, normalize: bool = False) -> torch.Tensor:
    """Gray-image HLAC (HLAC::extractGray): (H, W) → (6,) or (35,)."""
    img = _image(img)
    out = _accumulate(_planes(img, rx, ry), GRAY1_3 if order <= 1 else GRAY2_3, None)
    return out / (img.shape[0] * img.shape[1]) if normalize else out


def hlac_color(img, rx: int = 1, ry: int = 1, normalize: bool = False) -> torch.Tensor:
    """Colour-image HLAC of order ≤ 1 (HLAC::extractColor): (H, W, 3) → (45,)."""
    img = _image(img)
    out = _accumulate(_planes(img, rx, ry), COLOR1_3, None)
    return out / (img.shape[0] * img.shape[1]) if normalize else out
