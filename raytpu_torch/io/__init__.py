"""Input and output: fit checkpoints."""
