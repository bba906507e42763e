"""Train and eval steps, the optimizer, the trainer with its checkpoints and CSV log, the builder,
and the feature cache."""
