"""Magnitude / power / phase decode of re/im spectrum planes."""

from __future__ import annotations

import torch


def magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(re * re + im * im)


def power(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return re * re + im * im


def phase(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.atan2(im, re)


def magnitude_db(re: torch.Tensor, im: torch.Tensor, floor: float = 1e-12) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(power(re, im), min=floor))
