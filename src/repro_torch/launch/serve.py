"""Serving driver: the live CoCoServe loop — Orchestrator over N paged
engines, real telemetry feeding Monitor -> Controller, decisions executed
on the running instances (scale-up replication degrees, scale-down
KV-block migration).

Counterpart of ``repro.launch.serve`` for the port. It runs on the card
unless ``--device cpu`` is given, with the reference's reduced config by
default (fp32 weights and pool) or, with ``--no-reduced``, the published
widths (bf16 weights and pool). Weights come from
``models.transformer.init_params`` with a ``torch.Generator`` seeded 0
on the chosen device. Families without paged support (``--cache auto``
picks for them, or ``--cache dense``) run one dense-cache engine, as the
reference's fallback does: the SSM and the hybrid, MLA (minicpm3-4b) and
the audio encoder-decoder (whisper-medium, over the engine's default
zero frames, as the reference serves it):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 24 --rps 4 --instances 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium

Every flag lives on ``ServeConfig`` — one dataclass, built either from
the command line (``ServeConfig.from_args``) or from a TOML file
(``ServeConfig.from_toml``; pass ``--config serve.toml`` and override
individual keys with normal flags on top). Programmatic callers build
the dataclass directly and hand it to ``run()``.

``--workers N`` lifts the same loop onto the DISTRIBUTED serving plane:
N engine-server processes are spawned (one real paged Engine each,
serving/remote_engine.py) and the orchestrator drives them over the RPC
wire protocol — admissions, telemetry snapshots, controller plans and
block migrations all travel as length-prefixed frames, no shared
memory:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 24 --rps 4 --workers 2 --drain

``--inventory pod.toml`` lifts it across MACHINES: the inventory lists
nodes (host, first port, capacity, spawn-vs-attach), launch/pod.py
brings up one engine server per ``tcp://host:port`` endpoint — spawned
locally or attached where already running — and the SAME orchestrator
loop drives them over TCP frames:

    PYTHONPATH=src python -m repro_torch.launch.serve --inventory pod.toml \
        --requests 24 --rps 4 --drain

``--http`` swaps the synthetic workload for the real front door
(serving/ingress.py): streaming completions over HTTP/1.1 with
prefix-affinity routing, SLO-class admission and 429 backpressure; add
``--elastic`` to let the controller grow/shrink the pod while serving.
``--scheduler slo`` runs the class-aware scheduler (DESIGN.md §13) so
``"slo_class": "interactive"`` completions pre-empt batch traffic:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --instances 2 --http --http-port 8080 --scheduler slo

On a host with two or more cards visible, every instance spans the
largest power of two of them (``serving.group.host_width``: the
reference's replication mesh) as a ``serving.group.GroupInstance``: an
engine-server process a card, in one replication group, that draws its
weights by seed (rank 0 draws, a broadcast replicates) — this process
draws none. A scale-up the controller decides then splits the
replicated layers' rows over every card of the instance. That holds on
every plane: ``--instances`` and ``--workers N`` build N such instances
(``w0 .. wN-1``); an ``--inventory`` node holds ``capacity`` of them, W
consecutive endpoints each; ``--elastic`` grows and shrinks the pod by
whole group instances (``g<idx>``); ``--supervise`` respawns a dead one
on the same cards (``w1~r1``), unless its servers were attached. With one
card nothing changes. ``build_plane`` brings a plane up and
``serve_workload`` / ``serve_http`` drive it, as ``run`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serving import scheduler as SCH
from repro_torch.serving.request import RequestSpec

#: every engine's ``max_len`` (tokens a request may hold), as the
#: reference's `launch.serve` sets it
SERVE_MAX_LEN = 128


@dataclasses.dataclass
class ServeConfig:
    """Every serve.py knob in one place (module docstring). Field names
    are the CLI flags with ``-`` -> ``_``; the same names key the TOML
    form (flat, or under a ``[serve]`` table)."""
    arch: str = "tinyllama-1.1b"
    requests: int = 16
    rps: float = 4.0
    max_batch: int = 4
    max_new: int = 16
    prompt_len: int = 12
    instances: int = 2
    workers: int = 0
    inventory: Optional[str] = None
    slo: float = 40.0
    rpc_deadline: Optional[float] = None
    supervise: bool = False
    drain: bool = False
    cache: str = "auto"
    token_budget: int = 128
    scheduler: str = "budget"
    http: bool = False
    http_host: str = "127.0.0.1"
    http_port: int = 8080
    http_seconds: Optional[float] = None
    trace_out: Optional[str] = None
    flightrec_out: Optional[str] = None
    max_queue: int = 8
    elastic: bool = False
    max_pod: int = 4
    govern_budget: bool = True
    device: str = "cuda"
    reduced: bool = True

    def validate(self) -> "ServeConfig":
        if self.scheduler not in SCH.POLICIES:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r} "
                f"(registered: {', '.join(sorted(SCH.POLICIES))})")
        if self.cache not in ("auto", "dense", "paged"):
            raise ValueError(f"cache must be auto|dense|paged, "
                             f"got {self.cache!r}")
        if self.requests < 0 or self.token_budget < 1:
            raise ValueError("requests must be >= 0 and "
                             "token_budget >= 1")
        return self

    @classmethod
    def from_toml(cls, path: str) -> "ServeConfig":
        """Load a config file: all keys optional, unknown keys are an
        error (a typo should not silently fall back to a default).
        Reuses launch/pod.py's tomllib/tomli probe."""
        from repro_torch.launch.pod import _toml
        if _toml is None:  # pragma: no cover - tomli/tomllib baked in
            raise RuntimeError("TOML config needs tomllib (py3.11+) or "
                               "tomli")
        with open(path, "rb") as f:
            data = _toml.load(f)
        if "serve" in data and isinstance(data["serve"], dict):
            data = data["serve"]
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - names)
        if unknown:
            raise ValueError("unknown serve config key(s): "
                             + ", ".join(unknown))
        return cls(**data).validate()

    @classmethod
    def from_args(cls, argv=None) -> "ServeConfig":
        """CLI front: ``--config file.toml`` seeds the defaults, every
        other flag overrides field-by-field on top."""
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("--config", default=None,
                         help="TOML file of ServeConfig keys; flags "
                              "given alongside override it")
        known, rest = pre.parse_known_args(argv)
        base = cls.from_toml(known.config) if known.config else cls()
        args = _build_parser(base).parse_args(rest)
        return cls(**{f.name: getattr(args, f.name)
                      for f in dataclasses.fields(cls)}).validate()


def _build_parser(d: ServeConfig) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--arch", default=d.arch)
    ap.add_argument("--requests", type=int, default=d.requests)
    ap.add_argument("--rps", type=float, default=d.rps)
    ap.add_argument("--max-batch", type=int, default=d.max_batch)
    ap.add_argument("--max-new", type=int, default=d.max_new)
    ap.add_argument("--prompt-len", type=int, default=d.prompt_len)
    ap.add_argument("--instances", type=int, default=d.instances)
    ap.add_argument("--workers", type=int, default=d.workers,
                    help="spawn N engine-server PROCESSES and drive them "
                         "over the RPC transport (the distributed serving "
                         "plane); 0 = in-process instances")
    ap.add_argument("--inventory", default=d.inventory,
                    help="pod inventory file (.toml/.json): bring up one "
                         "engine server per tcp:// endpoint it lists "
                         "(launch/pod.py) and drive them as the serving "
                         "plane; overrides --workers/--instances")
    ap.add_argument("--slo", type=float, default=d.slo,
                    help="engine-clock latency SLO (steps)")
    ap.add_argument("--rpc-deadline", type=float, default=d.rpc_deadline,
                    help="per-call RPC deadline in seconds: a hung "
                         "worker (socket open, no reply) is detected "
                         "within 2x this and quarantined instead of "
                         "stalling the control tick (default: off)")
    ap.add_argument("--supervise", action="store_true",
                    default=d.supervise,
                    help="respawn dead/quarantined spawned workers with "
                         "capped exponential backoff (flap detector "
                         "evicts a worker that keeps dying)")
    ap.add_argument("--drain", action="store_true", default=d.drain,
                    help="after the workload, drain instance N-1 "
                         "(scale-down consolidation demo)")
    ap.add_argument("--cache", choices=["auto", "dense", "paged"],
                    default=d.cache)
    ap.add_argument("--token-budget", type=int, default=d.token_budget,
                    help="per-step token budget for the continuous-"
                         "batching scheduler (DESIGN.md §10): decode "
                         "slots are charged first, the remainder admits "
                         "prefill chunks; paged engines only")
    ap.add_argument("--scheduler", choices=sorted(SCH.POLICIES),
                    default=d.scheduler,
                    help="scheduler policy (serving/scheduler.py "
                         "registry): 'budget' = token-budget continuous "
                         "batching, 'slo' adds per-class budget splits + "
                         "deadline ordering, 'phase' pins the legacy "
                         "prefill-wave/decode-step alternation")
    ap.add_argument("--http", action="store_true", default=d.http,
                    help="serve the HTTP front door instead of the "
                         "synthetic workload: POST /v1/completions "
                         "(chunked token streaming), GET /v1/models "
                         "/healthz /stats (serving/ingress.py); paged "
                         "engines only")
    ap.add_argument("--http-host", default=d.http_host)
    ap.add_argument("--http-port", type=int, default=d.http_port,
                    help="ingress port (0 = ephemeral, printed at bind)")
    ap.add_argument("--http-seconds", type=float, default=d.http_seconds,
                    help="serve for N seconds then exit cleanly "
                         "(default: until Ctrl-C)")
    ap.add_argument("--trace-out", default=d.trace_out,
                    help="append one JSONL line per finished request "
                         "trace (the span tree: accept/route/queue/"
                         "prefill chunks/first token/decode/migration "
                         "hops); --http only")
    ap.add_argument("--flightrec-out", default=d.flightrec_out,
                    help="file the control-plane flight recorder "
                         "auto-dumps its event ring to on crash-"
                         "recovery events (also served live at "
                         "GET /debug/flightrec)")
    ap.add_argument("--max-queue", type=int, default=d.max_queue,
                    help="per-instance admission ceiling: when every "
                         "instance's queue is at this, the ingress "
                         "sheds with 429 + Retry-After")
    ap.add_argument("--elastic", action="store_true", default=d.elastic,
                    help="arm pod grow/shrink: the controller may spawn "
                         "a whole extra worker under sustained pressure "
                         "and drain+reap one when the pod runs empty")
    ap.add_argument("--max-pod", type=int, default=d.max_pod,
                    help="pod-size ceiling for --elastic growth")
    ap.add_argument("--no-govern-budget", dest="govern_budget",
                    action="store_false", default=d.govern_budget,
                    help="pin per-instance token budgets (disable the "
                         "ingress budget governor); --http only")
    ap.add_argument("--device", default=d.device,
                    help="device of every engine: cuda (default) or cpu")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=d.reduced,
                    help="the config's reduced form with fp32 weights "
                         "(default), or with --no-reduced its published "
                         "widths in bf16")
    return ap


def main(argv=None):
    return run(ServeConfig.from_args(argv))


@dataclasses.dataclass
class Plane:
    """What ``build_plane`` brought up: the config, dtype and cache kind
    served, the cards an instance spans (``width``: 1 but for group
    instances), and ``orch``, the Orchestrator over the instances (None
    for the dense fallback, whose one ``engine`` serves alone).
    ``t_start`` is when the instances' bring-up began; ``ingress`` the
    front door ``serve_http`` started."""
    cfg: object
    dtype: str
    kind: str
    width: int
    t_start: float
    n_instances: int = 1
    orch: Optional[object] = None
    engine: Optional[object] = None
    ingress: Optional[object] = None


def run(args: ServeConfig):
    plane = build_plane(args)
    if plane.orch is None:
        return serve_dense(args, plane)
    if args.http:
        serve_http(args, plane)
    else:
        serve_workload(args, plane)
    _close(plane.orch)
    return len(plane.orch.finished)


def build_plane(args: ServeConfig, server: Optional[dict] = None) -> Plane:
    """Bring up the serving plane ``args`` asks for: the weights, the
    instances (in-process, ``--workers`` processes, an ``--inventory``
    pod, or group instances that span this host's cards) and the
    Orchestrator over them, with the ``--elastic`` worker factory and the
    ``--supervise`` policy. ``server`` holds the options of every engine
    server of a group instance (``remote_engine.EngineServer``)."""
    args.validate()
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")
    cfg = get_config(args.arch)
    dtype = "float32" if args.reduced else "bfloat16"
    if args.reduced:
        cfg = cfg.reduced()
    kind = args.cache
    if kind == "auto":  # primary path where the family supports it
        kind = "paged" if cfg.supports_paged_kv else "dense"
    from repro_torch.serving.group import host_width
    width = host_width(args.device, torch.cuda.device_count()
                       if torch.device(args.device).type == "cuda" else 0)
    grouped = width > 1 and kind == "paged"
    # group instances draw their own weights, rank 0 of each on its card
    params = None if grouped else T.init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0), dtype)
    print(f"[serve] cache_kind={kind} device={args.device} "
          f"{'reduced' if args.reduced else 'full width'} {dtype}")
    plane = Plane(cfg, dtype, kind, width if grouped else 1, time.time())

    if args.http and kind != "paged":
        raise SystemExit("[serve] --http needs a paged-cache family "
                         "(prefix-affinity routing keys on the paged "
                         "pool's content chains)")

    if kind == "dense":  # single-engine fallback (no paged pool)
        from repro_torch.serving.engine import Engine
        plane.engine = Engine(cfg, params, max_batch=args.max_batch,
                              max_len=SERVE_MAX_LEN, cache_kind="dense",
                              dtype=dtype, device=args.device)
        return plane

    from repro_torch.serving.orchestrator import Orchestrator, RespawnPolicy
    policy = RespawnPolicy() if args.supervise else None
    sched_kw = dict(scheduler=args.scheduler,
                    token_budget=args.token_budget, device=args.device,
                    dtype=dtype)
    engine_kw = dict(max_batch=args.max_batch, max_len=SERVE_MAX_LEN,
                     **sched_kw)
    # a group instance's servers: W cards, weights by seed, no stream
    group_kw = dict(width=width, draw={"seed": 0, "dtype": dtype},
                    server=server, **engine_kw) if grouped else {}
    front_kw = {}
    if args.http:
        # front-door knobs: admission ceiling (-> 429 at the door) and,
        # with --elastic, the runtime worker factory + pod thresholds
        # that let the controller grow/shrink the pod while serving
        front_kw["max_queue"] = args.max_queue
        if args.elastic:
            from repro_torch.core.controller import PodElasticityConfig
            from repro_torch.launch.pod import make_worker_factory
            front_kw["worker_factory"] = make_worker_factory(
                cfg, params, remote=bool(args.workers or args.inventory),
                **(group_kw or engine_kw))
            front_kw["pod_cfg"] = PodElasticityConfig(
                max_instances=args.max_pod)
    if args.flightrec_out:
        front_kw["flightrec_path"] = args.flightrec_out
    orch_kw = dict(slo_latency=args.slo, telemetry_every=4,
                   rpc_deadline=args.rpc_deadline, respawn_policy=policy,
                   **front_kw)
    if args.inventory:
        from repro_torch.launch.pod import launch_pod, load_inventory
        nodes = load_inventory(args.inventory)
        handles = launch_pod(cfg, params, nodes, **(group_kw or engine_kw))
        plane.n_instances = len(handles)
        plane.orch = Orchestrator(cfg, params, handles=handles, **orch_kw)
        what = (f"{plane.n_instances} instances of {width} engine servers"
                if grouped else f"{plane.n_instances} engine servers")
        print(f"[serve] pod: {what} over TCP "
              f"({sum(n.spawn for n in nodes)} node(s) spawned, "
              f"{sum(not n.spawn for n in nodes)} attached)")
    elif grouped:
        from repro_torch.serving.group import GroupInstance, start_all
        plane.n_instances = args.workers or args.instances
        handles = start_all([
            lambda i=i: GroupInstance(cfg, label=f"w{i}", **group_kw)
            for i in range(plane.n_instances)])
        plane.orch = Orchestrator(cfg, None, handles=handles, **orch_kw)
        b = handles[0].bringup
        print(f"[serve] replication: {plane.n_instances} instances, each a "
              f"group of {width} cards (an engine server a card); instance "
              f"0's rank 0 bring-up: spawn {b[0]['connect_s']:.1f} s, group "
              f"{b[0]['group_s']:.1f} s, draw {b[0]['draw_s']:.1f} s, "
              f"broadcast {b[0]['broadcast_s']:.2f} s")
    else:
        plane.n_instances = args.workers or args.instances
        plane.orch = Orchestrator(cfg, params, n_instances=plane.n_instances,
                                  remote=bool(args.workers), **orch_kw,
                                  **engine_kw)
        if args.workers:
            print(f"[serve] distributed plane: {args.workers} "
                  f"engine-server processes over RPC")
    return plane


def _requests(args: ServeConfig, cfg):
    """The synthetic workload's request maker: prompts drawn from a
    generator seeded 0, in rid order."""
    rng = np.random.default_rng(0)

    def make_request(rid):
        return RequestSpec(
            rid=rid,
            prompt=rng.integers(2, cfg.vocab_size,
                                size=args.prompt_len).astype(np.int32),
            max_tokens=args.max_new)
    return make_request


def serve_dense(args: ServeConfig, plane: Plane) -> int:
    """The synthetic workload on the one dense-cache engine."""
    eng, make_request = plane.engine, _requests(args, plane.cfg)
    submitted, finished, step = 0, [], 0
    while len(finished) < args.requests and step < 5000:
        while submitted < args.requests and \
                submitted <= eng.clock * args.rps:
            eng.submit(make_request(submitted))
            submitted += 1
        finished.extend(eng.step() or [])
        step += 1
    _report(finished, time.time() - plane.t_start)
    return len(finished)


def serve_http(args: ServeConfig, plane: Plane):
    """The HTTP front door over the plane's orchestrator for
    ``--http-seconds`` (or until Ctrl-C), then its counters."""
    from repro_torch.serving.ingress import Ingress
    orch = plane.orch
    ing = Ingress(orch, host=args.http_host, port=args.http_port,
                  model_id=args.arch, trace_out=args.trace_out,
                  govern_budget=args.govern_budget).start()
    plane.ingress = ing
    print(f"[serve] http ingress on http://{ing.host}:{ing.port}  "
          f"(POST /v1/completions; GET /v1/models /healthz /stats "
          f"/metrics /debug/flightrec)"
          + ("  [elastic pod]" if args.elastic else ""), flush=True)
    try:
        if args.http_seconds is not None:
            time.sleep(args.http_seconds)
        else:
            while True:
                time.sleep(1.0)
    except KeyboardInterrupt:
        print("\n[serve] interrupt; draining streams", flush=True)
    ing.close()
    c = ing.counters
    print(f"[serve] ingress: {c.requests} requests "
          f"({c.streamed} streamed), {c.tokens_out} tokens out, "
          f"routed prefix/vacancy={c.routed_prefix}/"
          f"{c.routed_vacancy}, 429s={c.rejected_429}, "
          f"400s={c.bad_requests}")
    _report(orch.finished, time.time() - plane.t_start)


def serve_workload(args: ServeConfig, plane: Plane, hook=None):
    """The synthetic workload through the plane's orchestrator: requests
    admitted at ``--rps`` on the engine clock, the controller's actions
    printed, then with ``--drain`` the last instance drained, and the
    run's stats. ``hook(orch, step)``, where given, runs before every
    orchestrator step."""
    orch, make_request = plane.orch, _requests(args, plane.cfg)
    submitted, step = 0, 0
    seen_actions = 0
    while len(orch.finished) < args.requests and step < 5000:
        clock = orch.clock()
        while submitted < args.requests and submitted <= clock * args.rps:
            orch.submit(make_request(submitted))
            submitted += 1
        if hook is not None:
            hook(orch, step)
        orch.step()
        step += 1
        log = orch.controller.log
        for action in log[seen_actions:]:
            print(f"[serve] t={clock:.1f} controller: {action} "
                  f"P sum={sum(orch.plan.p)}")
        seen_actions = len(log)

    if args.drain and plane.n_instances > 1:
        recs = orch.drain_instance(plane.n_instances - 1)
        for r in recs:
            print(f"[serve] drained rid={r.rid} ({r.mode}) "
                  f"{r.n_blocks} blocks / {r.bytes_moved / 1e6:.2f} MB "
                  f"in {r.seconds * 1e3:.1f} ms, "
                  f"stream stalled {r.stall_s * 1e3:.1f} ms "
                  f"(est {r.est_seconds * 1e3:.0f} ms)")
        orch.run_until_done()

    _report(orch.finished, time.time() - plane.t_start)
    s = orch.stats()
    print(f"[serve] instances={plane.n_instances} dropped={s['dropped']} "
          f"migrations={s['migrations']} "
          f"(overlapped={s['overlapped_migrations']}) "
          f"preemptions={s['preemptions']} recoveries={s['recoveries']}")
    print(f"[serve] budget: utilization={s['budget_utilization']:.2f} "
          f"ttft_p50={s['ttft_p50']:.1f} ttft_p95={s['ttft_p95']:.1f} "
          f"queue_delay_p95={s['queue_delay_p95']:.1f}")
    print(f"[serve] prefix sharing: hit_rate={s['prefix_hit_rate']:.2f} "
          f"blocks_saved_now={s['blocks_saved_now']} "
          f"dedup_imports={s['dedup_imports']}")
    cp = s["control_plane"]
    print(f"[serve] control plane: {cp['rpc_polls_per_tick']:.2f} "
          f"multiplexed polls/tick over "
          f"{cp['step_rpcs_per_tick']:.1f} step RPCs/tick")
    ft = s["faults"]
    print(f"[serve] failure domain: injected={ft['injected']} "
          f"rpc_timeouts={ft['rpc_timeouts']} "
          f"quarantines={ft['quarantines']} respawns={ft['respawns']} "
          f"evictions={ft['evictions']}")
    print(f"[serve] final plan P (first 8): {orch.plan.p[:8]}, "
          f"continuity breaks: {orch.plan.continuity_breaks()}")


def _close(orch):
    """Close every instance. Group instances first print their ranks'
    own counters (decode steps, paged-kernel launches, graph captures
    and replays of decode steps), and after closing their servers' exit
    codes (a retired or failed instance was closed already)."""
    groups = [h for h in orch.instances if hasattr(h, "rank_infos")]
    for i, h in enumerate(groups):
        if h.alive():
            infos = h.rank_infos()
            print(f"[serve] instance {i}, by rank: decode steps "
                  f"{[x['decode_steps'] for x in infos]}, paged launches "
                  f"{[x['paged_launches'] for x in infos]}, decode graphs "
                  f"captured / replayed "
                  f"{[(x['graph_captures'].get('decode', 0), x['graph_replays'].get('decode', 0)) for x in infos]}")
    orch.close()
    if groups:
        print(f"[serve] group servers exited with codes "
              f"{[h.exitcodes for h in groups]}")


def _report(finished, wall):
    toks = sum(len(r.generated) for r in finished)
    lat = [r.finish_time - r.submit_time for r in finished] or [0.0]
    print(f"[serve] {len(finished)} requests, {toks} tokens, "
          f"wall {wall:.1f}s, engine-clock latency p50={np.median(lat):.1f}")


if __name__ == "__main__":
    main()
