"""Mamba-2 SSD chunked scan: ``ssd_scan(xs, dt, A, B_mat, C_mat, D,
init_state=)`` with xs [B, S, nh, hd], dt [B, S, nh], A/D [nh], B/C
[B, S, ns] -> (y [B, S, nh, hd], final state [B, nh, hd, ns])."""

from .ops import ssd_scan
from .ref import reference
