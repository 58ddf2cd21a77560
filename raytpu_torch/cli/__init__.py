"""Command-line entry points (the reference's app shell, Game1.cs/Program.cs,
re-cast as a batch CLI: render a frame, render a turntable animation to
video, view interactively, or run an inverse-rendering fit)."""
