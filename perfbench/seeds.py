"""Generators drawn from ``--seed``: one stream a purpose, so that each
tensor depends only on the seed and its own label."""
from __future__ import annotations

import zlib

import torch


def derive(seed: int, label: str) -> int:
    """A 63-bit seed for the stream ``label`` of run seed ``seed`` (any
    whole number, negative or past 64 bits included)."""
    return (seed * 1_000_003 + zlib.crc32(label.encode())) % (1 << 63)


def generator(seed: int, label: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, label))
