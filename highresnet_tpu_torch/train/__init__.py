"""Training: train state, steps, epoch loop, checkpoints, selection."""
