"""Output tokens seen in the window over the window's seconds; the
tokens of requests still unfinished at the close count."""


def read(run):
    return run.window_tokens() / (run.t_close - run.t_open)
