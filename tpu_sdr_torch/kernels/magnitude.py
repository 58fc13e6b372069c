"""Magnitude / power / phase decode of re/im spectrum planes."""

from __future__ import annotations

import torch


def magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(re * re + im * im)


def power(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return re * re + im * im


def phase(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.atan2(im, re)
