"""Training on one card: the port of ``repro.train`` but ``pipeline``
(multi-device, ROADMAP queue 1 item 9)."""

from .step import (TrainStepConfig, cross_entropy, make_train_step,
                   value_and_grad)
