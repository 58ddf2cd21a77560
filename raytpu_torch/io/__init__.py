"""Input and output: images, AVI video and fit checkpoints."""
