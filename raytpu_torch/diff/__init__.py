"""Differentiable rendering: trainable parameter views and scene fits."""
