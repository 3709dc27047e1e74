"""Paged decode attention: one query row per lane against a block pool
addressed through per-lane block tables."""

from .ops import paged_attention
from .ref import reference
