"""Train and eval steps, the optimizer, the trainer with its checkpoints and CSV log, and the builder."""
