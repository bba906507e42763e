"""Entry points: training, prediction and brain maps."""
