"""Keys of every batch completed in the window over the whole window, in
millions a second (a training step counts its samples x fields ids)."""


def read(run):
    return run.keys / run.window_s / 1e6
