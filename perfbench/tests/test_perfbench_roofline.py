"""Operation and byte counts against shapes worked out by hand."""
import pytest

from perfbench.tests import tiny  # noqa: F401
from perfbench import roofline as RF
from perfbench import weights as W
from perfbench import harness

M = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 4,
     "num_key_value_heads": 2, "head_dim": 2, "intermediate_size": 16,
     "vocab_size": 256, "reference": "dense_gqa"}


def test_layer_weights_and_step_bytes():
    # q 8x8, k and v 8x4 each, o 8x8, three 8x16 MLP matrices
    assert RF.layer_weights(M) == 64 + 32 + 32 + 64 + 3 * 128
    assert RF.step_weight_bytes(M) == (2 * 576 + 8 * 256) * 2


def test_kv_and_attention():
    assert RF.kv_bytes_per_token(M) == 2 * 2 * 2 * 2 * 2
    assert RF.attn_flops(M, 10) == 2 * 4 * 4 * 2 * 10
    assert RF.decode_flops(M, 10) == 2 * (2 * 576 + 2048) + 640


def test_prefill_counts_causal_keys_after_the_cached_start():
    # 3 tokens after 5 cached: 6 + 7 + 8 keys
    assert RF.prefill_flops(M, 3, 5) == (2 * 2 * 576 * 3 + 64 * 21
                                         + 2 * 8 * 256)


def test_paged_bound_is_bytes_at_these_shapes():
    # rows of 20 and 3 keys in blocks of 16: 2 + 1 blocks of 16 read
    bs = 16
    nbytes = 3 * bs * 2 * 2 * 2 * 2 + 2 * 2 * 4 * 2 * 2 + 3 * 4 + 2 * 4
    assert RF.paged_decode_bound_s(M, [20, 3], bs) == pytest.approx(
        2 * nbytes / RF.HBM_BYTES_PER_S)
    assert RF.paged_decode_bound_s(M, [], bs) == 0.0


@pytest.mark.parametrize("name", ["stablelm-12b", "chameleon-34b"])
def test_published_weight_bytes(name):
    m = harness._json(harness.BENCH / "configs" / f"{name}.json")
    # 24.28 GB and 68.6 GB of bf16 weights (PERF.md)
    want = {"stablelm-12b": 24.28e9, "chameleon-34b": 68.6e9}[name]
    assert W.weight_bytes(m) == pytest.approx(want, rel=0.01)
    assert RF.step_weight_bytes(m) < W.weight_bytes(m)
