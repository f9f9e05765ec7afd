"""Each configuration's plain reference against the port's float32
forward at a reduced size, on the same weights; and the reference
imports nothing of the program."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.tests import tiny
from perfbench import harness
from perfbench import weights as W
from perfbench.reference import layout

CONFIGS = sorted(p.stem for p in (harness.BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_matches_the_port_in_float32(config):
    from repro_torch.models import transformer as T
    model, _ = tiny.files(config, "chat")
    cfg = harness.port_config(model)
    Reference = layout(model).Reference
    params = W.draw(model, 123, "cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 512, size=n).tolist() for n in (37, 5)]
    ref = Reference(params, model).logits(
        seqs, [slice(0, len(s)) for s in seqs])
    for s, r in zip(seqs, ref):
        toks = torch.tensor([s])
        pos = torch.arange(len(s))[None]
        got = T.forward(params, cfg, toks, pos, mode="train")[0][0, :, :512]
        assert torch.allclose(got, r, rtol=1e-4, atol=1e-4), \
            (got - r).abs().max()


def test_fp8_control_moves_the_logits():
    model, _ = tiny.files("stablelm-12b", "chat")
    params = W.draw(model, 5, "cpu", dtype=torch.float32)
    Reference = layout(model).Reference
    seq = [list(range(1, 30))]
    rows = [slice(0, 29)]
    a = Reference(params, model).logits(seq, rows)[0]
    b = Reference(params, model, "fp8").logits(seq, rows)[0]
    assert 1e-3 < (a - b).abs().max() < 1.0


def test_reference_imports_nothing_of_the_program():
    for f in (Path(harness.BENCH) / "reference").glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("__future__", "contextlib",
                                           "importlib", "math", "typing",
                                           "torch"), m


def test_a_configuration_names_its_layout_and_the_port_checks_it():
    """The file picks its reference module by name, and a field the
    port's architecture does not match fails the run before it starts."""
    model, _ = tiny.files("stablelm-12b", "chat")
    assert layout(model).__name__ == "perfbench.reference.dense_gqa"
    bad = dict(model, port=dict(model["port"],
                                expect={"norm_kind": "layernorm"}))
    with pytest.raises(ValueError, match="norm_kind"):
        harness.port_config(bad)
