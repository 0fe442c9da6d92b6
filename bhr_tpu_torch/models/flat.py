"""Flat (Minkowski) spacetime, the r_s -> 0 limit (PyTorch port of
bhr_tpu/models/flat.py): rays travel in straight lines."""

from __future__ import annotations

import torch


def acceleration(rel_pos, vel, r, rs=0.0, spin=0.0):
    del rel_pos, r, rs, spin
    return torch.zeros_like(vel)


def capture_radius(rs, spin=0.0):
    del spin
    return 1.05 * rs
