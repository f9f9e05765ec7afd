"""Bytes the window's steps need over the window at the H100's HBM
rate, in %: the weights once a step, each decode row's K/V at its
length read and its new K/V written, each prompt's computed K/V
written."""
from perfbench import roofline as RF
from perfbench.metrics_common import window_work


def read(run):
    w = window_work(run)
    if w is None:
        return None
    return 100.0 * w["bytes"] / (w["seconds"] * RF.HBM_BYTES_PER_S)
