"""A run with the timed path broken underneath comes out not correct,
once for each fault a one-card serving cell can have; the same run
unbroken comes out correct. The card is not looked for: the program
serves the tiny files on the CPU."""
import pytest
import torch

from perfbench.tests import tiny

CELL = "stablelm-12b.chat"
#: a closed loop whose four clients keep four rows busy
TRAFFIC = "longctx"


def _unchanged(orig):
    """A decode step that returns its state unchanged: each row's next
    token is the token it was fed."""
    from repro_torch.serving import graphs as G

    def step(params, k, v, buf, *, width, **kw):
        B = buf.numel() // (7 + width)
        return G.unpack(buf, (B,), (buf.numel() - B,))[0].clone()
    return step


def _half(orig):
    """Half of the batch left out: every other active row is not
    computed, and its token comes out as zero."""
    from repro_torch.serving import graphs as G

    def step(params, k, v, buf, *, width, **kw):
        out = orig(params, k, v, buf, width=width, **kw).clone()
        B = buf.numel() // (7 + width)
        active = G.unpack(buf, (2 * B,), (B,), (buf.numel() - 3 * B,))[1]
        out[active.nonzero()[1::2, 0]] = 0
        return out
    return step


def _altered(orig):
    """A token altered where it is produced: every third sampling call
    hands out the next id instead of the sampled one."""
    calls = [0]

    def sample(logits, *a, **kw):
        out = orig(logits, *a, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            out = (out + 1) % a[-1] if a else (out + 1) % kw["vocab_size"]
        return out
    return sample


def _run(seed):
    from perfbench import harness
    model, mix = tiny.files("stablelm-12b", TRAFFIC)
    mix["greedy_share"] = 0.5
    import time
    return harness.run_cell(CELL, seed, 2.0, False, time.perf_counter(),
                            device="cpu", model=model, mix=mix)


def test_unbroken_run_is_correct():
    out = _run(2**31 + 11)
    assert out["correct"], out["checks"]
    assert out["checks"]["judged_tokens"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.serving import engine as E
    from repro_torch.serving import sampling as S
    if fault == "altered":
        monkeypatch.setattr(S, "sample_tokens", _altered(S.sample_tokens))
    else:
        wrap = {"unchanged": _unchanged, "half": _half}[fault]
        monkeypatch.setattr(E, "_decode_step", wrap(E._decode_step))
    with torch.no_grad():
        out = _run(2**31 + 11)
    assert not out["correct"], out["checks"]
