"""The README's examples on the port (``examples/torch_*.py``), each run
in-process through its ``main([...])`` on the CPU at reduced size, held
to the banner lines of its reference as ``tests/test_examples.py`` holds
the JAX ones; and a scan that no new example imports jax or the JAX
package. No process is spawned: the migrate example's ranks are threads
(gloo), as on the CPU it runs them."""
import importlib.util
import re
from pathlib import Path

import jax
import pytest

from repro.configs import get_config as jax_config
from repro.core import migration as JM
from repro.models import transformer as JT
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "shared_prefix", "migrate_modules", "serve_autoscale",
         "train_small")


def _example(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    _example("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "greedy tokens:" in out
    assert "paged engine rid=" in out          # the primary decode path ran
    assert "scale-up: replicated" in out       # the CoCoServe plan step ran
    assert "in_use=0 (drained pool -> 0)" in out


def test_shared_prefix(capsys):
    _example("shared_prefix").main(["--device", "cpu", "--streams", "4",
                                    "--sys-len", "16", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[sharing OFF]" in out and "[sharing ON ]" in out
    assert "token-identical: True" in out
    m = re.search(r"\((\d+) saved", out)
    assert m and int(m.group(1)) > 0, out


def test_migrate_modules(capsys):
    """Both moves on two thread ranks, their bytes the reference's
    ``tree_bytes`` of the leaves its example moves (``jax.eval_shape`` of
    its ``init_params`` and ``init_cache``, as ``examples/migrate_modules.py``
    makes them)."""
    _example("migrate_modules").main(["--device", "cpu", "--ranks", "2"])
    out = capsys.readouterr().out
    cfg = jax_config("tinyllama-1.1b").reduced()
    params = jax.eval_shape(lambda k: JT.init_params(cfg, k, "float32"),
                            jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: JT.init_cache(cfg, 2, 64, "float32"))
    attn = JM.tree_bytes(params, r"layers/attn")
    cache = JM.tree_bytes(cache, r"layers/")
    assert "== migrate attention projections" in out
    assert f"moved {attn/1e6:.1f} MB" in out
    assert "== migrate the KV cache" in out
    assert f"moved {cache/1e6:.1f} MB" in out
    assert out.count("(2 ranks on cpu)") == 2


def test_serve_autoscale(capsys):
    _example("serve_autoscale").main(["--device", "cpu", "--requests", "4",
                                      "--rps", "6"])
    out = capsys.readouterr().out
    assert "[serve] cache_kind=paged device=cpu reduced float32" in out
    assert "[serve] 4 requests" in out and "dropped=0" in out


def test_train_small(capsys, tmp_path):
    ckpt = tmp_path / "train_small.ckpt"
    _example("train_small").main([
        "--device", "cpu", "--arch", "tinyllama-1.1b", "--reduce", "--steps",
        "2", "--batch", "2", "--seq", "32", "--ckpt", str(ckpt)])
    out = capsys.readouterr().out
    assert "[train] step    1 loss=" in out
    assert f"[train] saved {ckpt}" in out and ckpt.exists()


def test_examples_import_no_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = [ROOT / "examples" / f"torch_{n}.py" for n in NAMES]
    assert all(f.exists() for f in files)
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_cuda_without_a_card(name, monkeypatch):
    """Each example runs on CUDA by default and raises without a card."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"serve_autoscale": ["--requests", "1"],
            "train_small": ["--steps", "1"]}.get(name, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main(argv)
