"""One run of one cell: build the program from the cell's files, serve
its traffic through the Orchestrator, time it on the host clock, judge
what it served, and read the cell's metrics.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits, metric readers and kernel patterns
are files found by name (README.md). Nothing here names a cell."""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import itertools
import json
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfbench import check as CHECK
from perfbench import trace as TRACE
from perfbench import weights as W
from perfbench.record import Req, Run, Step
from perfbench.traffic import Traffic

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: how long the drain after the window may wait for a first token
DRAIN_S = 60.0


# ------------------------------------------------------------------ files
def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_mix(traffic: str) -> dict:
    return _json(BENCH / "traffic" / f"{traffic}.json")


def load_cell(name: str, man: Optional[dict] = None):
    """(cell, configuration, traffic mix, limits) of workload ``name``."""
    man = man or manifest()
    cells = {c["name"]: c for c in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    model = _json(ROOT / conf["file"])
    mix = load_mix(cell["traffic"])
    limits = _json(BENCH / "checks" / f"{name}.json")
    return cell, model, mix, limits


def metric_specs(man: dict, workload: str, traced: bool):
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    for spec in man["per_layer" if traced else "end_to_end"]:
        if workload in spec.get("workloads", [workload]):
            yield spec


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_patterns(kernel: str):
    """Every regular expression in ``kernels/<kernel>/*.txt`` (one a
    line; ``#`` starts a comment): the names the kernel's launches take
    in a device trace."""
    out = []
    for f in sorted((BENCH / "kernels" / kernel).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(line)
    return out


# ---------------------------------------------------------------- program
def port_config(model: dict):
    """The port's ``ModelConfig`` of a configuration file: the registry
    entry ``port.arch`` with each field of ``port.from_file`` set to the
    file's key it names (in the field's own type), and every field of
    ``port.expect`` checked, so that a run fails where the port's
    architecture departs from what the file states."""
    from repro_torch.configs import get_config
    port = model["port"]
    base = get_config(port["arch"])
    cfg = dataclasses.replace(base, **{
        field: type(getattr(base, field))(model[key])
        if getattr(base, field) is not None else model[key]
        for field, key in port["from_file"].items()})
    for k, v in port["expect"].items():
        if getattr(cfg, k) != v:
            raise ValueError(f"{model['name']}: the port's {k} is "
                             f"{getattr(cfg, k)!r}, the file says {v!r}")
    return cfg


class Program:
    """The system under test: an Orchestrator over one LocalInstance of a
    paged, CUDA-graph, bf16 Engine."""

    def __init__(self, cfg, params, eng: dict, device):
        from repro_torch.serving.engine import Engine
        from repro_torch.serving.instance import LocalInstance
        from repro_torch.serving.orchestrator import Orchestrator
        self.engine = Engine(
            cfg, params, max_batch=eng["max_batch"], max_len=eng["max_len"],
            dtype="bfloat16", cache_kind="paged",
            block_size=eng["block_size"], n_blocks=eng["n_blocks"],
            token_budget=eng["token_budget"],
            prefix_sharing=eng["prefix_sharing"], device=device,
            cuda_graphs=True)
        self.orch = Orchestrator(
            cfg, params, handles=[LocalInstance(self.engine)],
            max_batch=eng["max_batch"], max_len=eng["max_len"],
            block_size=eng["block_size"], n_blocks=eng["n_blocks"],
            dtype="bfloat16")

    def busy(self) -> bool:
        e = self.engine
        return bool(e.queue or e.active or e.prefilling)

    def requests(self):
        """Every Request object the engine holds or finished."""
        e = self.engine
        return (list(self.orch.finished) + list(e.active.values())
                + list(e.prefilling.values()) + list(e.queue))

    def counters(self) -> dict:
        e = self.engine
        g = e.graphs.counts
        return {"prefix_queries": e.pstate.prefix_queries,
                "prefix_hits": e.pstate.prefix_hits,
                "captures": dict(g.captures), "replays": dict(g.replays),
                "eager": dict(g.eager), "preemptions": e.preempt_count}


def _spec(rid: int, d, mix: dict, seed: int):
    from repro_torch.serving.request import RequestSpec, SamplingParams
    temp = 0.0 if d.greedy else float(mix["temperature"])
    return RequestSpec(rid=rid, prompt=d.prompt, max_tokens=d.max_tokens,
                       sampling=SamplingParams(
                           temperature=temp, top_k=int(mix["top_k"]),
                           seed=(seed * 1_000_003 + rid) % (1 << 32)))


# ----------------------------------------------------------------- warm-up
def warm_decode_keys(prog: Program, mix: dict, vocab: int, rng):
    """Capture the decode step of every table width the traffic can
    reach, greedy and sampled: one request at a time, served two tokens,
    whose prompt (the shortest that does) puts its first decode at that
    width."""
    from repro_torch.serving.request import RequestSpec, SamplingParams
    e = prog.engine
    bs, width = e.pstate.block_size, e.pstate.block_tables.shape[1]
    rid = -1
    nb = 1
    while nb <= width:
        P = max(1, min(nb // 2 * bs, e.max_len - 4))
        for temp in (0.0, float(mix["temperature"])):
            lo, hi = mix.get("text_ids", [0, vocab])
            prompt = rng.integers(lo, hi, size=P).astype(np.int32)
            e.submit(RequestSpec(rid=rid, prompt=prompt, max_tokens=2,
                                 sampling=SamplingParams(
                                     temperature=temp,
                                     top_k=int(mix["top_k"]), seed=1)))
            rid -= 1
            while prog.busy():
                e.step()
        nb *= 2


# ------------------------------------------------------------------ serving
class Server:
    """Drives the traffic through the Orchestrator and records what it
    sees (``record.Run``)."""

    def __init__(self, prog: Program, traffic: Traffic, run: Run,
                 tracer: Optional[TRACE.Tracer]):
        self.prog, self.traffic, self.run = prog, traffic, run
        self.mix = run.mix
        self.tracer = tracer
        self.rids = itertools.count(1)
        self.drafts = {}

    def span(self, name, t0, t1):
        if self.tracer is not None:
            self.tracer.span(name, t0, t1)

    def submit(self, d, due: float):
        rid = next(self.rids)
        self.prog.orch.submit(_spec(rid, d, self.mix, self.run.seed))
        self.run.reqs[rid] = Req(rid, due, len(d.prompt), d.max_tokens,
                                 d.greedy, prompt=d.prompt)
        self.drafts[rid] = d
        return rid

    def observe(self, t0, t1, fin):
        """Record the tokens that came out of the step that ended at
        ``t1``."""
        reqs = self.run.reqs
        decode_ctx = []
        first = first_prompt = 0

        def seen(rid, n):
            nonlocal first, first_prompt
            rec = reqs.get(rid)
            if rec is None:
                return
            k = rec.n
            if n <= k:
                return
            if k == 0:
                first += 1
                first_prompt += rec.prompt_len
                if n >= 2:
                    decode_ctx.append(rec.prompt_len + 1)
            else:
                decode_ctx.append(rec.prompt_len + k)
            rec.times.extend([t1] * (n - k))

        for rid, toks in self.prog.orch.stream_view().items():
            seen(rid, len(toks))
        for r in fin:
            seen(r.rid, len(r.generated))
            rec = reqs.get(r.rid)
            if rec is not None:
                rec.finished = t1
                rec.truncated = len(r.generated) < rec.max_tokens
        e = self.prog.engine
        self.run.steps.append(Step(t0, t1, e.clock, e.last_step_packed,
                                   decode_ctx, first, first_prompt,
                                   e.pstate.blocks_in_use()))

    def serve(self, seconds: float):
        run, mix, prog = self.run, self.mix, self.prog
        clock = time.perf_counter
        open_loop = mix["loop"] == "open"
        t_origin = clock()
        t_open = t_close = t_drain = None
        if open_loop:
            arrivals = self.traffic.arrivals()
            nxt = next(arrivals)
            t_open = t_origin + mix["warmup_s"]
        else:
            for c in range(mix["clients"]):
                self.submit(self.traffic.first(c), clock())
        phase = "warm"
        while True:
            t = clock()
            if phase == "warm" and t_open is not None and t >= t_open:
                phase = "window"
                t_close = t_open + seconds
                self.open_window(t_open, t_close)
            if phase == "window" and t >= t_close:
                phase = "drain"
                self.close_window()
                t_drain = clock() + DRAIN_S
            if phase == "drain":
                if all(r.times for r in run.window_reqs()) or t >= t_drain:
                    break
            if open_loop and phase != "drain":
                ts = t
                while t_origin + nxt.due <= t:
                    due = t_origin + nxt.due
                    if t_open <= due < t_open + seconds:
                        run.gen_lag.append(t - due)
                    self.submit(nxt, due)
                    nxt = next(arrivals)
                self.span("submit", ts, clock())
            if not prog.busy():
                if not open_loop or phase == "drain":
                    break
                until = t_origin + nxt.due
                if phase == "warm":
                    until = min(until, t_open)
                elif phase == "window":
                    until = min(until, t_close)
                ts = clock()
                if until > ts:
                    time.sleep(until - ts)
                self.span("idle", ts, clock())
                continue
            t0 = clock()
            fin = prog.orch.step()
            t1 = clock()
            self.span("step", t0, t1)
            self.observe(t0, t1, fin)
            if not open_loop and phase != "drain":
                for r in fin:
                    d = self.traffic.follow(self.drafts[r.rid], r.generated)
                    self.submit(d, t1)
                if t_open is None:
                    firsts = {self.drafts[rid].client
                              for rid, rec in run.reqs.items() if rec.times}
                    if len(firsts) == mix["clients"]:
                        t_open = t1 + mix["warmup_s"]
            self.span("observe", t1, clock())
        run.drain_end = clock()

    def open_window(self, t_open, t_close):
        run = self.run
        run.t_open, run.t_close = t_open, t_close
        run.setup_s = t_open - run.t_process
        if self.tracer is not None:
            self.tracer.start()
        run.counters["open"] = self.prog.counters()

    def close_window(self):
        if self.tracer is not None:
            self.tracer.stop()
        self.run.counters["close"] = self.prog.counters()

    def finish(self):
        """Served tokens and prefill starts of every recorded request,
        read from the engine's Request objects."""
        clock_t0 = {}
        for s in self.run.steps:
            clock_t0.setdefault(s.clock, s.t0)
        for r in self.prog.requests():
            rec = self.run.reqs.get(r.rid)
            if rec is None:
                continue
            rec.tokens = list(r.generated)
            if r.prefill_start_time is not None:
                rec.prefill_start = clock_t0.get(r.prefill_start_time)


# -------------------------------------------------------------------- run
def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def serve_cell(model: dict, mix: dict, seed: int, seconds: float,
               device, traced: bool = False, t_process: float = 0.0):
    """Draw the weights, build the program, serve the mix and free the
    program. Returns (run, params, peak device bytes)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = [("start", time.perf_counter())]
    cfg = port_config(model)
    params = W.draw(model, seed, dev)
    if on_card:
        torch.cuda.synchronize(dev)
    marks.append(("weights", time.perf_counter()))
    eng = {**model["engine"], **mix.get("engine", {})}
    prog = Program(cfg, params, eng, dev)
    marks.append(("engine", time.perf_counter()))
    traffic = Traffic(mix, seed, model["vocab_size"], eng["max_len"],
                      seconds)
    run = Run("", seed, seconds, dict(model, engine=eng), mix,
              t_process=t_process or marks[0][1])
    tracer = TRACE.Tracer() if traced else None
    warm_decode_keys(prog, mix, model["vocab_size"],
                     np.random.default_rng(np.random.SeedSequence([seed, 3])))
    marks.append(("decode_keys", time.perf_counter()))
    if tracer is not None:
        tracer.warm()
        marks.append(("profiler", time.perf_counter()))
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    server = Server(prog, traffic, run, tracer)
    server.serve(seconds)
    server.finish()
    marks.append(("warm_traffic", run.t_open))
    run.setup_marks = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    run.setup_marks["before_start"] = marks[0][1] - run.t_process
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    prog.orch.close()
    del prog, server
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if tracer is not None:
        run.trace = tracer.reduce(run.t_open, run.t_close)
    return run, params, peak


def read_metrics(man: dict, workload: str, run: Run, traced: bool) -> dict:
    out = {}
    for spec in metric_specs(man, workload, traced):
        v = reader(spec["name"])(run)
        if v is not None:
            out[spec["name"]] = {"value": v, "unit": spec["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t_process: float, device="cuda", model: Optional[dict] = None,
             mix: Optional[dict] = None, man: Optional[dict] = None) -> dict:
    """One run; returns the result line's object. ``model`` and ``mix``
    replace the cell's files (tests run small ones on the CPU)."""
    man = man or manifest()
    cell, file_model, file_mix, limits = load_cell(workload, man)
    model = model or file_model
    mix = mix or file_mix
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    run, params, peak = serve_cell(model, mix, seed, seconds, dev, traced,
                                   t_process)
    run.workload = workload
    t_check = time.perf_counter()
    verdict = CHECK.judge(params, run.model, run, limits,
                          int(mix["check_requests"]))
    check_s = time.perf_counter() - t_check
    metrics = read_metrics(man, workload, run, traced)
    devinfo = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
               "count": cell["chips"], "memory_peak_bytes": int(peak),
               "power_limit": power_limit() if on_card else None}
    out = {"correct": verdict["correct"],
           "attempted": len(run.window_reqs()),
           "failed": verdict["checks"]["unanswered"]["value"],
           "metrics": metrics, "device": devinfo}
    if run.trace is not None:
        devinfo["busy_s"] = run.trace["busy_s"]
        devinfo["window_s"] = run.trace["window_s"]
        out["breakdown"] = TRACE.breakdown(run.trace)
    out["notes"] = notes(run, check_s)
    out["checks"] = verdict["checks"]
    return out


def notes(run: Run, check_s: float) -> dict:
    """What the metrics leave out but a reader of the line wants: how
    late the generator ran, the window's counters, the most pool blocks
    that requests held after a window step (cached-free prefix blocks
    not counted), the trace's costs."""
    lag = sorted(run.gen_lag)
    steps = run.window_steps()
    return {
        "generator_lag_ms_p50": lag[len(lag) // 2] * 1e3 if lag else 0.0,
        "generator_lag_ms_max": lag[-1] * 1e3 if lag else 0.0,
        "check_s": check_s, "window_s": run.t_close - run.t_open,
        "drain_s": run.drain_end - run.t_close,
        "window_steps": len(steps),
        "pool_blocks": run.model["engine"]["n_blocks"],
        "pool_blocks_peak": max((s.blocks for s in steps), default=0),
        "setup_marks_s": run.setup_marks,
        "requests_seen": len(run.reqs),
        "counters": run.counters,
        "trace": ({k: v for k, v in run.trace.items()
                   if k not in ("by_name_s", "idle_by_host_s")}
                  if run.trace else None)}
