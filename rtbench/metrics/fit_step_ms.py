"""fit_step_ms: the window over the fit steps completed in it (host clock),
in milliseconds: each step a forward, backward and Adam update with its
loss read to the host."""


def read(run):
    if run.kind != "fit" or not run.items:
        return None
    return run.window_s / run.items * 1e3
