"""Tokens the token-budget planner packed into a step
(``Engine.last_step_packed``), averaged over the window's steps."""


def read(run):
    packed = [s.packed for s in run.window_steps() if s.packed is not None]
    return sum(packed) / len(packed) if packed else None
