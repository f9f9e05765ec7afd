"""BENCHMARK.json against the contract's rules and the files it names."""
import json
import re

import pytest

from perfbench.tests import tiny  # noqa: F401
from perfbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = {c["name"]: c for c in MAN["workloads"]}


def _cells(spec):
    return spec.get("workloads", list(CELLS))


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) < 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128


def test_names_and_units():
    names = [s["name"] for s in METRICS] + list(CELLS) + \
        [c["name"] for c in MAN["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for s in METRICS:
        assert UNIT.match(s["unit"]), s
        assert s["better"] in ("lower", "higher")
    for c in MAN["workloads"]:
        assert NAME.match(c["traffic"]) and len(c["why"]) <= 200


def test_at_most_one_cell_in_four_on_four_chips():
    four = sum(c["chips"] == 4 for c in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_bounds():
    for s in MAN["end_to_end"]:
        assert 0.01 <= s["bound"] <= 0.25, s
        assert s["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = {s["name"] for s in MAN["end_to_end"] if cell in _cells(s)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in _cells(s) for s in MAN["per_layer"]), cell


def test_each_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {s["name"]: s for s in MAN["end_to_end"]}
    for s in MAN["per_layer"]:
        moved = e2e[s["moves"]]
        assert set(_cells(s)) <= set(_cells(moved)), s["name"]
        assert "\n" not in s["layer"] and len(s["layer"]) <= 200


def test_rooflines_and_peaks_are_named_as_such():
    for s in MAN["per_layer"]:
        if "roofline" in s["name"]:
            assert s["name"].endswith("_roofline") and s["unit"] == "%"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_cell_finds_its_files_by_name(cell):
    c, model, mix, limits = harness.load_cell(cell)
    assert model["name"] == c["config"] and mix["name"] == c["traffic"]
    assert "max_logit_gap" in limits
    for s in METRICS:
        if cell in _cells(s):
            assert callable(harness.reader(s["name"]))


def test_every_config_is_used_and_lists_no_width():
    used = {c["config"] for c in MAN["workloads"]}
    widths = re.compile(r"(size|_dim|_rank|heads|experts_per_tok)")
    for conf in MAN["configs"]:
        assert conf["name"] in used
        assert conf["file"].startswith("perfbench/")
        m = harness._json(harness.ROOT / conf["file"])
        for key in conf["reduced"]:
            assert not widths.search(key), key
            assert m["published"][key] != m[key], key


def test_the_kernel_patterns_name_the_paged_kernel():
    pats = harness.kernel_patterns("paged_decode")
    split = ("void repro::split_decode::split_kernel<__nv_bfloat16, "
             "(anonymous namespace)::PagedRows<__nv_bfloat16>, 16>(...)")
    dense = ("void repro::split_decode::split_kernel<__nv_bfloat16, "
             "(anonymous namespace)::DenseRows<__nv_bfloat16>, 16>(...)")
    assert any(re.search(p, split) for p in pats)
    assert not any(re.search(p, dense) for p in pats)
