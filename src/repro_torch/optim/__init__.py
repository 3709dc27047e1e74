"""AdamW and learning-rate schedules: the port of ``repro.optim`` but
``compression`` (``compressed_psum`` over a process group, ROADMAP queue 1
item 6)."""

from .adamw import (AdamWConfig, clip_by_global_norm, global_norm,
                    init_state, update)
from .schedules import SCHEDULES, constant, warmup_cosine, wsd
