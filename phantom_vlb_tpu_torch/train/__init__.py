"""Train and eval steps, the optimizer, the train loop and streaming metrics."""
