"""Training: the learning-rate schedule, the fused joint step and the trainer."""
