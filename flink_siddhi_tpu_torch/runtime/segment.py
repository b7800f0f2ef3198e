"""Segments: K micro-batch wire tapes stacked into one buffer.

The counterpart of the reference's ``_wire_sig``, ``_stack_wires`` and
``_empty_wire_like`` (``flink_siddhi_tpu/runtime/executor.py:98-129``),
shared, as there, by the fused streaming dispatch (``Job``) and the
bounded replay's pre-stager (``runtime/replay.py``). Where the reference
stacks each leaf on a new leading axis for ``lax.scan``, a segment here is
ONE contiguous byte buffer holding every leaf of every tape, leaf-major,
each tape's copy of a leaf 16-byte aligned: one copy, from the card
(the resident replay's staged segments) or from pinned host memory (the
fused streaming ``Job``), feeds the static slot a captured CUDA graph
reads (``runtime/graphs.py``). ``Segment.tapes`` gives the K wire tapes as
typed views into the buffer.

A tape's structure (capacity, kinds, timestamp kind, stream constant,
epoch) and its leaves' shapes and dtypes make up its signature
(``wire_sig``): tapes of one signature stack, and a graph captured on one
segment replays any other of that signature. The host-known relevance
bounds stay on the host, one dict per tape: they choose each chain
matcher's compaction branch, which is part of a graph's key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import torch_dtype
from .tape import WireTape, _put

_ALIGN = 16  # bytes: each tape's copy of a leaf starts on this boundary


def _leaves(wire: WireTape) -> List[Tuple[str, object]]:
    """(name, array) of every leaf that travels, in signature order."""
    out = [("ts", wire.ts)]
    if wire.stream is not None:
        out.append(("stream", wire.stream))
    out.extend((f"col:{k}", wire.cols[k]) for k in sorted(wire.cols))
    out.append(("scalars", wire.scalars))
    return out


def wire_sig(wire: WireTape) -> Tuple:
    """The structural signature of a host wire tape: two tapes with equal
    signatures stack into one segment (the reference's ``_wire_sig``:
    its pytree structure and leaf layouts)."""
    return (
        wire.capacity, wire.ts_kind, wire.kinds, wire.stream_const,
        wire.epoch_i32,
        tuple((name, tuple(a.shape), np.dtype(a.dtype).name)
              for name, a in _leaves(wire)),
    )


def empty_wire_like(wire: WireTape) -> WireTape:
    """A padding tape for a partial trailing segment: the same structure,
    zero valid events, time parked at the source tape's base (the
    reference's ``_empty_wire_like``). Every other leaf aliases the source
    tape (read-only); its host-known bounds are 0."""
    scalars = np.array(wire.scalars, dtype=np.int32)
    scalars[0] = 0
    scalars[3] = 0
    return dataclasses.replace(
        wire, n_valid=np.zeros(1, dtype=np.int32), scalars=scalars,
        bounds={k: 0 for k in wire.bounds},
    )


def _layout(wire: WireTape, k: int):
    """Per leaf: (name, offset, bytes of one tape's copy, dtype, shape);
    and the total bytes of a K-tape segment."""
    out = []
    off = 0
    for name, a in _leaves(wire):
        nb = int(np.prod(a.shape, dtype=np.int64)) * np.dtype(a.dtype).itemsize
        stride = -(-nb // _ALIGN) * _ALIGN
        out.append((name, off, nb, np.dtype(a.dtype), tuple(a.shape)))
        off += stride * k
    return tuple(out), off


@dataclass
class Segment:
    """K wire tapes of one signature in one uint8 buffer: ``data`` is a
    torch tensor (on the host, or on the device after ``to``); ``n_valid``
    and ``bounds`` are the tapes' host copies (padding tapes included)."""

    data: torch.Tensor
    sig: Tuple
    template: WireTape  # the first tape (structure and layout)
    layout: Tuple
    n_valid: List[int]
    bounds: List[Dict[str, int]]

    def __len__(self) -> int:
        return len(self.n_valid)

    @property
    def nbytes(self) -> int:
        return int(self.data.numel())

    def to(self, device: torch.device) -> "Segment":
        """The segment on ``device`` (one pinned, asynchronous copy on a
        GPU: ``tape._put``)."""
        return dataclasses.replace(self, data=_put(self.data.numpy(),
                                                   device))

    def tapes(self, data: Optional[torch.Tensor] = None) -> List[WireTape]:
        """The K wire tapes as typed views into ``data`` (this segment's
        buffer, or another of its size: a graph's static slot)."""
        data = self.data if data is None else data
        k = len(self)
        out = []
        for i in range(k):
            leaves = {}
            for name, off, nb, dt, shape in self.layout:
                stride = -(-nb // _ALIGN) * _ALIGN
                at = off + i * stride
                leaves[name] = data[at:at + nb].view(
                    torch_dtype(dt)).view(shape)
            out.append(dataclasses.replace(
                self.template,
                ts=leaves["ts"],
                stream=leaves.get("stream"),
                cols={key[4:]: v for key, v in leaves.items()
                      if key.startswith("col:")},
                scalars=leaves["scalars"],
                n_valid=np.asarray([self.n_valid[i]], dtype=np.int32),
                bounds=dict(self.bounds[i]),
            ))
        return out


def stack_wires(wires: Sequence[WireTape],
                out: Optional[torch.Tensor] = None) -> Segment:
    """Stack host wire tapes of one signature into a ``Segment`` (the
    reference's ``_stack_wires``), written into ``out`` (a host uint8
    tensor of at least the segment's bytes, such as a pinned buffer) or a
    new one."""
    sig = wire_sig(wires[0])
    for w in wires[1:]:
        if wire_sig(w) != sig:
            raise ValueError("wire tapes of different structure do not "
                             "stack into one segment")
    layout, total = _layout(wires[0], len(wires))
    data = (torch.zeros(total, dtype=torch.uint8) if out is None
            else out[:total])
    buf = data.numpy()
    for i, w in enumerate(wires):
        for (_name, off, nb, _dt, _shape), (_, a) in zip(layout,
                                                         _leaves(w)):
            at = off + i * (-(-nb // _ALIGN) * _ALIGN)
            buf[at:at + nb] = np.ascontiguousarray(a).reshape(-1).view(
                np.uint8)
    return Segment(
        data=data, sig=sig, template=dataclasses.replace(
            wires[0], bounds={}, ts=None, stream=None, cols={},
            scalars=None,
        ),
        layout=layout,
        n_valid=[int(w.n_valid[0]) for w in wires],
        bounds=[dict(w.bounds) for w in wires],
    )


def segment_nbytes(wire: WireTape, k: int) -> int:
    """The bytes of a segment of ``k`` tapes of ``wire``'s structure."""
    return _layout(wire, k)[1]


def pad_segment(wires: List[WireTape], k: int) -> List[WireTape]:
    """``wires`` padded with empty tapes to length ``k``."""
    return list(wires) + [empty_wire_like(wires[-1])] * (k - len(wires))
