"""Training: the optimiser, the train/eval step, checkpoints, the Solver."""
