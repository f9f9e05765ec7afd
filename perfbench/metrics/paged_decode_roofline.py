"""The paged-decode kernel's share of its roofline, in %: the least time
of the window's decode steps' paged attention (``roofline.
paged_decode_bound_s``, from the rows' context lengths) over the device
time of the kernels named in ``kernels/paged_decode/*.txt``."""
from perfbench import roofline as RF
from perfbench.harness import kernel_patterns
from perfbench.trace import kernel_seconds


def read(run):
    if not run.trace:
        return None
    dev = kernel_seconds(run.trace, kernel_patterns("paged_decode"))
    if dev <= 0:
        return None
    bs = run.model["engine"]["block_size"]
    bound = sum(RF.paged_decode_bound_s(run.model, s.decode_ctx, bs)
                for s in run.window_steps())
    return 100.0 * bound / dev
