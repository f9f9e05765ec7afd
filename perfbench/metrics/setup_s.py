"""Process start to the window's start: the build, the weights, the
engine, the captures and the warm-up traffic."""


def read(run):
    return run.setup_s
