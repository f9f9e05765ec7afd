"""The command itself: without a card it prints no result and fails;
importing and planning a run loads no JAX and no JAX package."""
import subprocess
import sys

from perfbench.tests import tiny

SRC = str(tiny.ROOT / "src")


def test_without_a_card_no_result_and_a_failing_exit(tmp_path):
    p = subprocess.run(
        [sys.executable, str(tiny.ROOT / "perfbench" / "run.py"),
         "--workload", "stablelm-12b.chat", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_planning_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import harness, run\n"
        "from perfbench.traffic import Traffic\n"
        "c, m, mix, lim = harness.load_cell('stablelm-12b.chat')\n"
        "harness.port_config(m)\n"
        "import repro_torch.serving.orchestrator\n"
        "t = Traffic(mix, 1, m['vocab_size'], 4096).arrivals(); next(t)\n"
        "print(run.forbidden_modules())\n" % (str(tiny.ROOT), SRC))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types

    from perfbench import run
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serving",
                        types.ModuleType("repro.serving"))
    assert run.forbidden_modules() == ["repro"]
