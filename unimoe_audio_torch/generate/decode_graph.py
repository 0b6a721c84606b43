"""The decode step as one CUDA graph: captured once for a loop state, then
replayed every step, so that the host launches one graph a step in place of
the step's thousands of kernels issued one by one from Python.

`generate/loop.generate` writes its decode step once, as a function of the
loop state and of a dict of device tensors (the call's inputs), and either
calls it (eagerly) or replays it through a `DecodeGraph`.  A replay runs the
kernels the call would run, in the same order, on the same inputs.

What a captured step holds fixed, and what may move (`signature`, `load`):
  * its storages: the loop state's buffer and KV cache (scales included) and
    every parameter tensor, with their shapes and dtypes, and the host
    choices baked into its kernels (batch, text length, cache length,
    dispatch, sampling branch).  Any change is a new signature, and the
    loop captures anew;
  * the call's inputs (the step counter, the start step, masks, per-row
    knobs, seeds, position bases): static copies, refreshed once at the
    start of each `generate` call;
  * the state's control tensors (EOS flags, countdowns, finished steps):
    the state's own at capture, updated in place by each step.  One that a
    caller rebinds between calls (`SlotServer._compact`) is copied into the
    captured tensor and the state bound to that again.

Counters: the Python of a replayed step does not run, so the host counters
it would bump (`int8_expert_matmul.calls` and the other launch counters of
the expert paths) take, per replay, what the capture recorded, and the
program counters (`moe.routed_*`) are summed on the device inside the graph
(`profiling.counts_into`) and handed to `profiling.count` after each replay.
`DecodeGraph.captures` and `.replays` count the mechanism, also as the
program counters `decode.graph_captures` / `decode.graph_replays`.  No
capture runs while a profiler records (the loop's rule).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..parallel.mesh import active
from ..utils import profiling

# The loop state's control tensors that each step updates in place.
HELD = ("eos_detected", "eos_countdown", "finished_step")


def eligible(device: torch.device, *, decode_emit, guidance: bool, do_sample: bool,
             keyed: bool) -> bool:
    """Whether `generate`'s decode steps may run from a CUDA graph: tensors
    on a CUDA device, the `decode_emit` step (decode_emit not False), no
    guidance labels, draws counter-keyed (`sample_seeds`) or greedy (a
    torch.Generator's stream advances on the host at each draw), and no
    active mesh of more than one rank (its collectives stay eager)."""
    ctx = active()
    single = ctx is None or ctx.mesh.size(tuple(ctx.mesh.shape)) == 1
    return (device.type == "cuda" and decode_emit is not False and not guidance
            and (keyed or not do_sample) and single)


def _tensors(tree):
    """The tensors of a parameter tree (dicts, lists, tuples, QTensors)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def signature(params: Dict, state, inputs: Dict[str, torch.Tensor], host: Tuple) -> Tuple:
    """What a captured step holds fixed: the host choices `host`, the
    inputs' names, shapes and dtypes, and the storages it reads and writes
    (the state's buffer, cache and control tensors, the parameters)."""
    def at(t):
        return None if t is None else (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())

    c = state.cache
    return (host,
            tuple((k, v.dtype, tuple(v.shape)) for k, v in sorted(inputs.items())),
            tuple(at(t) for t in (state.buf, c.k, c.v, c.k_scale, c.v_scale)),
            tuple((getattr(state, n).dtype, tuple(getattr(state, n).shape)) for n in HELD),
            tuple(at(t) for t in _tensors(params)))


def _host_counters() -> Dict[tuple, int]:
    """The launch counters that the decode step's Python bumps (int
    attributes of the counted functions)."""
    from ..moe import dispatch
    from ..ops import grouped_gemm

    fns = (dispatch.int8_expert_matmul, dispatch.swiglu_expert_ffn, grouped_gemm.gmm,
           grouped_gemm.tgmm, grouped_gemm.grouped_matmul)
    return {(f, k): v for f in fns for k, v in vars(f).items() if type(v) is int}


class DecodeGraph:
    """One decode step captured for one loop state (`LoopState.graph`)."""

    captures = 0
    replays = 0

    def __init__(self, key: Tuple, inputs: Dict[str, torch.Tensor], state):
        self.key = key
        self.device = state.buf.device
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.held = {n: getattr(state, n) for n in HELD}
        self.graph = torch.cuda.CUDAGraph()
        self.counts: Dict[str, object] = {}      # program counters, summed in the graph
        self.host: Dict[tuple, int] = {}         # host counters' increments a step

    def load(self, inputs: Dict[str, torch.Tensor], state) -> None:
        """A new call's inputs into the static copies, and any control
        tensor the state was rebound to into the captured one."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        for n, t in self.held.items():
            cur = getattr(state, n)
            if cur is not t:
                t.copy_(cur)
                setattr(state, n, t)

    def capture(self, step) -> None:
        """Capture step(self.inputs) (which runs nothing on the device)."""
        before = _host_counters()
        with torch.cuda.device(self.device), profiling.counts_into(self.counts), \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            step(self.inputs)
        for k, v in _host_counters().items():
            if v != before[k]:
                self.host[k] = v - before[k]
            setattr(*k, before[k])
        DecodeGraph.captures += 1
        profiling.count("decode.graph_captures", 1)

    def replay(self) -> None:
        """Run one step: the graph, then the step's counters."""
        with torch.cuda.device(self.device):
            self.graph.replay()
        for (f, k), n in self.host.items():
            setattr(f, k, getattr(f, k) + n)
        DecodeGraph.replays += 1
        profiling.count("decode.graph_replays", 1)
        for name, v in self.counts.items():
            profiling.count(name, v)
