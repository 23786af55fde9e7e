"""Training substrate: optimizer, data pipelines, loop, checkpointing."""
from repro_torch.training.optimizer import AdamW, AdamWState, cosine_schedule
from repro_torch.training.train import (StepMetrics, Trainer, TrainState,
                                        make_train_step)

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "StepMetrics", "Trainer",
           "TrainState", "make_train_step"]
