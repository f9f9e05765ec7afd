"""Model FLOPs the window's work needs over the window at the H100's
bf16 peak, in %: each decode row's token through every layer and the
head plus its attention at its context length, and each prompt whose
first token came out in the window, less the tokens the prefix cache
served (``roofline.prefill_flops``)."""
from perfbench import roofline as RF
from perfbench.metrics_common import window_work


def read(run):
    w = window_work(run)
    if w is None:
        return None
    return 100.0 * w["flops"] / (w["seconds"] * RF.PEAK_BF16_FLOPS)
