"""Training: the port of ``repro.train``, the one-card step and the
pipeline over a list of stage devices.  The reference's data axis, its
``shard_fn`` and ``grad_constraint`` are the process-group half, ROADMAP
queue 1 item 6."""

from .pipeline import (join_stage_params, make_pipeline_train_step,
                       pipeline_refusal, split_stage_params)
from .step import (TrainStepConfig, cross_entropy, make_train_step,
                   value_and_grad)
