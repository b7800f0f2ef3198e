"""One device dispatch per segment: each segment's steps replayed as one
CUDA graph.

The counterpart of the reference's ``jitted_seg``
(``flink_siddhi_tpu/runtime/executor.py:1236-1262``): ``jax.jit`` of a
``lax.scan`` of ``plan.step_acc`` over a segment of stacked wire tapes,
with the states and the accumulator donated, so that one host call runs a
whole segment. Here the K steps of a segment are captured once into a CUDA
graph and replayed once per segment, by the resident replay
(``runtime/replay.py``) and by the fused streaming ``Job``
(``runtime/executor.py``).

Per plan runtime, ``SegmentGraphs`` holds:

- **the binding**: the state and accumulator tensors every graph of the
  plan reads and updates in place. Each graph ends by copying its new
  states and accumulator meta back into them (the donation analog). A
  runtime whose tensors were rebound to others of the same shapes (a
  flush, an eager segment) has them copied in before the next replay; a
  new state signature (``grow_state``) becomes the new binding and drops
  every graph of the old one, which is never replayed on new tensors;
- **the slots**: one static uint8 buffer per (wire signature, K) that a
  graph reads its tapes from. A replay is one copy of the segment's
  buffer (on the card, or in pinned host memory) into the slot, on the
  current stream, and one ``CUDAGraph.replay``;
- **the graphs**, keyed by (wire signature, K, state signature, each
  tape's chain-matcher branches), at most ``MAX_GRAPHS`` (oldest dropped),
  all in one memory pool. A new key is warmed first by one eager run of
  the segment on a side stream over copies of the states (the kernels'
  build, lazily made constants, the reverse cummin's look-back scratch of
  that stream), then captured on that stream with torch's sync debug mode
  "error": a step that would wait for the device fails the capture, loudly.

A segment with a tape whose chain matcher must read its relevant count (a
host-known bound above the compact width) cannot be captured; it runs its
steps eagerly on the card, and the caller counts it (``Job.
eager_segments``). Nothing else runs eagerly on the card, and a capture
that fails raises.

Kernel wrappers and artifacts count on the host (launches, compaction
reads). A capture records what each counted and restores the counts (a
capture runs nothing); each replay adds them back, so the counts mean what
they mean for eager steps. The reverse cummin's look-back buffers count
their calls the same way (``cuda_ops.ScratchBuffer``). Added back, the
counts cannot show a replay that drops or repeats a kernel: ``chip_smoke.
py`` holds them to the kernel records of a profiler trace of each graph
path.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..compiler import cuda_ops
from ..compiler.nfa import step_branch
from .segment import Segment

MAX_GRAPHS = 8  # per plan


def step_segment(plan, states: Dict, acc: Dict, tapes) -> Tuple[Dict, Dict]:
    """The body of one segment: ``plan.step_acc`` over its tapes (the
    reference's scan body). Padding tapes hold no valid event and emit
    nothing."""
    for tape in tapes:
        states, acc = plan.step_acc(states, acc, tape)
    return states, acc


def _flat(tree, path=()) -> List[Tuple[Tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def _sig(flat) -> Tuple:
    return tuple((p, tuple(t.shape), t.dtype, t.stride()) for p, t in flat)


def _tree_copy(tree):
    """The dicts of a nested dict of tensors copied, the tensors shared."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    return tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _copy_into(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (the same keys,
    shapes and dtypes), skipping a tensor that already is its target."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise ValueError("a segment changed the structure of the state")
        for k in dst:
            _copy_into(dst[k], src[k])
        return
    if src is not dst:
        dst.copy_(src)


class Captured:
    """A captured CUDA graph and what its capture counted on the host:
    ``deltas`` (object, attribute, count) that each replay adds back, and
    ``calls`` (look-back scratch buffer, calls) that each replay
    reserves first."""

    def __init__(self, graph, deltas, calls) -> None:
        self.graph = graph
        self.deltas = deltas
        self.calls = calls

    def replay(self) -> None:
        for buf, n in self.calls:
            buf.reserve(n)
        self.graph.replay()
        for obj, attr, n in self.deltas:
            setattr(obj, attr, getattr(obj, attr) + n)


def capture(fn: Callable, stream, pool=None,
            counted: Sequence = ()) -> Tuple[Captured, object]:
    """Capture ``fn()`` into a CUDA graph on ``stream`` (in ``pool``),
    under sync debug mode "error". Returns the ``Captured`` graph and
    ``fn``'s result (tensors in the graph's pool, rewritten by each
    replay). ``counted``: objects with a ``host_syncs`` count (artifacts)
    besides the kernel wrappers' ``launches``. Fails if the capture
    counted a host sync."""
    counters = [(k, "launches") for k in cuda_ops.KERNELS]
    counters += [(a, "host_syncs") for a in counted]
    before = [getattr(o, a) for o, a in counters]
    bufs = cuda_ops.multi_reverse_cummin.scratch.buffers()
    used = [b.used for b in bufs]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        deltas = [(o, a, getattr(o, a) - b)
                  for (o, a), b in zip(counters, before)
                  if getattr(o, a) != b]
        calls = [(b, b.used - u) for b, u in zip(bufs, used) if b.used != u]
    finally:
        for (o, a), b in zip(counters, before):
            setattr(o, a, b)
        for b, u in zip(bufs, used):
            b.used = u
    if any(a == "host_syncs" for _, a, _ in deltas):
        raise RuntimeError("a captured step read a device value")
    return Captured(graph, deltas, calls), out


class SegmentGraphs:
    """The segments of one plan runtime: its binding, and on a CUDA device
    its slots and graphs. On the CPU it runs the same segment body (the
    steps, then the copy back into the bound tensors) without a graph."""

    def __init__(self, plan, device: torch.device) -> None:
        self.plan = plan
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)  # warm-up and capture
            self.pool = torch.cuda.graph_pool_handle()
        self.graphs: "collections.OrderedDict[Tuple, Captured]" = (
            collections.OrderedDict()
        )
        self.slots: Dict[Tuple, torch.Tensor] = {}
        self.captured = 0  # graphs captured so far
        self._bound = None  # {"states": ..., "acc": ...}
        self._bound_flat: Optional[List] = None
        self._chains = [a for a in plan.artifacts
                        if a.name in dict(plan.spec.relevance)]

    # -- the binding --------------------------------------------------------
    def bind(self, rt) -> None:
        """Make ``rt.states``/``rt.acc`` the bound tensors (see the module
        docstring)."""
        tree = {"states": rt.states, "acc": rt.acc}
        flat = _flat(tree)
        if self._bound_flat is not None and len(flat) == len(
            self._bound_flat
        ) and all(a is b for (_, a), (_, b) in zip(flat, self._bound_flat)):
            return
        if self._bound_flat is not None and _sig(flat) == _sig(
            self._bound_flat
        ):
            _copy_into(self._bound, tree)
        else:
            self._bound = _tree_copy(tree)
            self._bound_flat = _flat(self._bound)
            self.graphs.clear()
        self._publish(rt)

    def _publish(self, rt) -> None:
        rt.states = _tree_copy(self._bound["states"])
        rt.acc = _tree_copy(self._bound["acc"])

    def reset(self, rt, states: Dict) -> bool:
        """Reset the bound tensors in place to ``states`` and an empty
        accumulator, when ``states`` has the bound signature; False (and
        nothing done) otherwise."""
        if self._bound is None or _sig(_flat(states)) != _sig(
            _flat(self._bound["states"])
        ):
            return False
        _copy_into(self._bound["states"], states)
        for t in self._bound["acc"].values():
            t.zero_()
        self._publish(rt)
        return True

    def _body(self, tapes) -> Callable[[], None]:
        """The segment body over ``tapes``: the steps from the bound
        tensors, then their new values copied back into them."""
        plan, bound = self.plan, self._bound

        def body():
            states, acc = step_segment(
                plan, _tree_copy(bound["states"]), _tree_copy(bound["acc"]),
                tapes,
            )
            _copy_into(bound["states"], states)
            _copy_into(bound["acc"], acc)

        return body

    # -- keys, warm-up and capture -----------------------------------------
    def key(self, seg: Segment) -> Optional[Tuple]:
        """The graph key of ``seg`` against the current binding, or None
        when a tape's chain matcher must read its count (no capture)."""
        cap = seg.template.capacity
        branches = tuple(
            tuple(step_branch(a, cap, b.get(a.name)) for a in self._chains)
            for b in seg.bounds
        )
        if any("read" in br for br in branches):
            return None
        return (seg.sig, len(seg), _sig(self._bound_flat), branches)

    def _slot(self, seg: Segment) -> torch.Tensor:
        k = (seg.sig, len(seg))
        slot = self.slots.get(k)
        if slot is None:
            slot = torch.empty(seg.nbytes, dtype=torch.uint8,
                               device=self.device)
            self.slots[k] = slot
        return slot

    def prepare(self, rt, seg: Segment) -> Optional[Tuple]:
        """Bind, and on a CUDA device warm and capture the graph of
        ``seg`` unless it is cached; returns its key (None: the segment
        cannot be captured)."""
        self.bind(rt)
        key = self.key(seg)
        if not self.cuda or key is None or key in self.graphs:
            return key
        slot = self._slot(seg)
        tapes = seg.tapes(slot)
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                slot.copy_(seg.data)
                # on copies of the states; the accumulator's buffer is
                # shared: appends land past its live count, where a drain
                # never reads
                step_segment(self.plan, _clone(rt.states),
                             {"meta": rt.acc["meta"].clone(),
                              "buf": rt.acc["buf"]}, tapes)
            cur.wait_stream(self.stream)
            graph, _ = capture(self._body(tapes), self.stream, self.pool,
                               counted=[a for a in self.plan.artifacts
                                        if hasattr(a, "host_syncs")])
        self.graphs[key] = graph
        self.captured += 1
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return key

    # -- one segment --------------------------------------------------------
    def run(self, rt, seg: Segment) -> bool:
        """Advance ``rt`` over ``seg``: on a CUDA device one copy of its
        buffer (on the card, or in pinned host memory) into the slot, on
        the current stream, and one graph replay, or for a segment that
        cannot be captured the segment body over the slot; on the CPU the
        segment body over its own buffer. Returns whether the segment
        could be captured."""
        key = self.prepare(rt, seg)
        if not self.cuda:
            self._body(seg.tapes())()
            return key is not None
        with torch.cuda.device(self.device):
            slot = self._slot(seg)
            slot.copy_(seg.data, non_blocking=True)
            if key is None:
                self._body(seg.tapes(slot))()
                return False
            self.graphs.move_to_end(key)
            self.graphs[key].replay()
        return True
