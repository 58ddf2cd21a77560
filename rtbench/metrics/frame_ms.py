"""frame_ms: the window over the frames completed in it (host clock), in
milliseconds: every frame from the call to its bytes on the host."""


def read(run):
    if run.kind != "orbit" or not run.items:
        return None
    return run.window_s / run.items * 1e3
