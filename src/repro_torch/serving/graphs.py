"""CUDA graphs of the serving engine's steps: one graph per static key.

Counterpart of the reference's compiled steps in
``repro.serving.engine``: ``_jitted_steps()`` (the paged decode step,
``_paged_step_impl``, jitted on cfg, window, impl, stochastic, max_top_k
and degrees, and the dense one, ``_dense_step_impl``, jitted on cfg,
window, stochastic and max_top_k), ``_chunk_prefill_fn`` (one executable
per pow2 (group, context, suffix) bucket) and ``_sample_fn``. A CUDA graph per static key
is the card's counterpart of a jit cache entry per static key: it is
captured at the first call that needs the key, as jit compiles at first
use, and replayed by every later call.

A step reaches its graph through fixed tensors:

* inputs: ``run`` copies each argument into a static input buffer before
  the replay, outside the graph — a host array as one pinned,
  non-blocking upload, a device tensor as a device copy. Graphs of one
  step kind share a buffer where the operand's shape matches: the decode
  graphs of every table width read one per engine. The engine packs all
  of a step's host operands into ONE int32 array (``pack`` / ``unpack``),
  so a step makes one upload. Nothing the graph holds takes a host
  array.
* outputs: the tensor the captured function returned, rewritten by every
  replay; the caller reads it (the engine fetches the sampled ids, the
  step's one host sync) before the next call of the same key.
* the pool, the dense cache and the weights, which the function reads
  through its closure: they are written in place and never rebound (an
  admission inserts into the dense cache with ``copy_``; the dense step
  copies the Mamba2 mixer's new states into the cache's state tensors),
  so a migration (an import writes the pool with ``index_copy_``) or an
  admission keeps every graph valid and captures nothing.

A capture runs the function once eagerly on a side stream — the warm-up,
which sets the kernels' shared-memory attributes and cuBLAS's workspace
for that stream, and whose result is the call's result — then captures
it on the same stream into the one graph memory pool that all of an
engine's graphs share (replays are sequential). So a capture step
computes its result once, like any step, and the replay count is the
call count less the captures.

A step may hold collectives over NCCL (a replicated decode step whose
group is ``capturable``): the warm-up runs them once more, which also
makes the communicator before the first capture, so every rank must
warm up and capture the same keys in the same order, and replay them in
the same order. Such a capture takes ``capture_error_mode=
"thread_local"``: the process group's watchdog thread queries CUDA
events while another thread captures, which the default mode forbids.
A counter given as ``tally`` (a group's or a mesh's collectives) counts
what a replay ran: the recording ran nothing, so its counts are taken
back, and each replay adds them.

On the CPU, and on the card with ``enabled=False`` (the engine's
``cuda_graphs=False``, the eager comparison), ``run`` calls the same
function eagerly on the same inputs: the code the graph holds. On the
card a capture or replay that fails raises; nothing falls back to eager
execution.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.gelu import gelu
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.models.transformer import to_device
from repro_torch.serving import instrument

#: kernel wrappers whose launches ``launches_run`` accounts through replays
COUNTED = (paged_decode_attention, decode_attention, gelu)


def pack(*arrays) -> np.ndarray:
    """Host operands as ONE flat int32 array, in order: 4-byte arrays as
    their bits (float32 and uint32 through a view), others (bool, int64
    indices below 2**31) converted by value."""
    words = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        words.append(a.view(np.int32) if a.dtype.itemsize == 4
                     else a.astype(np.int32))
    return np.concatenate([w.ravel() for w in words])


def unpack(buf: torch.Tensor, *shapes):
    """Views of an int32 tensor in ``pack``'s order, one per shape."""
    out, o = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(buf[o:o + n].view(shape))
        o += n
    if o != buf.numel():
        raise ValueError(f"unpack: {o} words of {buf.numel()} used")
    return out


def as_uint32(t: torch.Tensor) -> torch.Tensor:
    """An int32 view of uint32 bits -> int64 holding the uint32 value."""
    return t.long() & 0xFFFFFFFF


def _counts():
    return {k.__name__: k.launches for k in COUNTED}


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple           # static input buffers
    output: torch.Tensor    # static output
    recorded: dict          # kernel name -> launches the capture recorded
    tallied: collections.Counter   # what a replay adds to ``tally``


class StepGraphs:
    """One engine's captured steps, keyed by the static key whose first
    element names the step's kind (``"decode"``, ``"dense"``,
    ``"chunk"``, ``"sample"``). ``keys`` counts the calls per key on every device;
    ``counts`` the captures and replays by kind on the card, and the
    calls of ``eager`` on every device;
    ``capture_seconds`` holds (kind, warm-up, capture) host seconds of
    each capture — the warm-up's launches, then ``torch.cuda.graph``'s
    entry (which waits for the warm-up), the recording and the
    instantiation. ``tally``: a ``collections.Counter`` the captured
    functions count on, kept true through replays (module docstring);
    ``capture_error_mode``: ``torch.cuda.graph``'s."""

    def __init__(self, device, enabled: bool = True, *, tally=None,
                 capture_error_mode: str = "global"):
        self.device = torch.device(device)
        self.enabled = bool(enabled) and self.device.type == "cuda"
        self.tally = tally
        self.capture_error_mode = capture_error_mode
        self.keys: collections.Counter = collections.Counter()
        self.counts = instrument.GraphCounter()
        # wrapper calls made while a graph was recorded, and the launches
        # that replays ran, by kernel name (``launches_run``)
        self.recorded_calls: collections.Counter = collections.Counter()
        self.replayed: collections.Counter = collections.Counter()
        self._graphs: dict = {}
        self._inputs: dict = {}     # (kind, position, shape, dtype) -> buffer
        self.capture_seconds: list = []
        if self.enabled:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def run(self, key, fn, *inputs) -> torch.Tensor:
        """``fn(*inputs)`` on the engine's device: eagerly, or through
        the graph of ``key`` (captured now if it is new). ``inputs`` are
        numpy arrays and tensors; ``fn`` returns one tensor."""
        self.keys[key] += 1
        if not self.enabled:
            return self._call(fn, inputs)
        g = self._graphs.get(key)
        if g is None:
            return self._capture(key, fn, inputs)
        self._load(g.inputs, inputs)
        g.graph.replay()
        self.counts.replays[key[0]] += 1
        self.replayed.update(g.recorded)
        if self.tally is not None:
            self.tally.update(g.tallied)
        return g.output

    def eager(self, key, fn, *inputs) -> torch.Tensor:
        """``fn(*inputs)`` eagerly whatever ``enabled`` says, counted
        under ``counts.eager``: a step whose collectives a graph cannot
        hold (a replicated decode step over gloo, which stages them
        through the host)."""
        self.keys[key] += 1
        self.counts.eager[key[0]] += 1
        return self._call(fn, inputs)

    def _call(self, fn, inputs):
        return fn(*(to_device(a, self.device) if isinstance(a, np.ndarray)
                    else a.to(self.device) for a in inputs))

    def _load(self, static, inputs):
        for buf, a in zip(static, inputs):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(a).pin_memory()
            buf.copy_(a, non_blocking=True)

    def _static(self, kind, i, a) -> torch.Tensor:
        """The static input buffer for operand ``i`` of a ``kind`` step
        shaped like ``a`` (shared by that kind's graphs)."""
        dtype = torch.from_numpy(a).dtype if isinstance(a, np.ndarray) \
            else a.dtype
        slot = (kind, i, tuple(a.shape), dtype)
        if slot not in self._inputs:
            self._inputs[slot] = torch.empty(a.shape, dtype=dtype,
                                             device=self.device)
        return self._inputs[slot]

    def _capture(self, key, fn, inputs) -> torch.Tensor:
        static = tuple(self._static(key[0], i, a)
                       for i, a in enumerate(inputs))
        self._load(static, inputs)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(self._stream):
            out = fn(*static)              # the warm-up: this call's result
        t1 = time.perf_counter()
        before = _counts()
        counted = collections.Counter(self.tally or ())
        graph = torch.cuda.CUDAGraph()
        with instrument.graph_capture():
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode=self.capture_error_mode):
                output = fn(*static)
        after = _counts()
        tallied = collections.Counter()
        if self.tally is not None:   # the recording ran none of them
            tallied = self.tally - counted
            self.tally.clear()
            self.tally.update(counted)
        self.capture_seconds.append((key[0], t1 - t0, time.perf_counter() - t1))
        main.wait_stream(self._stream)
        out.record_stream(main)
        recorded = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
        self.recorded_calls.update(recorded)
        self._graphs[key] = _Graph(graph, static, output, recorded, tallied)
        self.counts.captures[key[0]] += 1
        return out

    def pool_bytes(self) -> int:
        """Device memory the graphs' shared pool holds (0 off the card)."""
        if not self.enabled:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)


def launches_run(kernel, graphs) -> int:
    """Launches of ``kernel`` that computed a step's result, over the
    ``StepGraphs`` of every engine that ran since ``kernel.launches`` was
    reset: the wrapper's count (each eager call, including the warm-up
    that computes a capture step's result) less the calls made while a
    graph was recorded (each recorded a launch and ran nothing), plus
    the launches each replay ran. For the paged kernel, one per layer of
    a decode step, this is layers x decode steps whether the steps ran
    eagerly or from graphs; so is the dense-decode kernel's in a dense
    step (one per attention layer or shared-block application)."""
    name = kernel.__name__
    return (kernel.launches - sum(g.recorded_calls[name] for g in graphs)
            + sum(g.replayed[name] for g in graphs))
