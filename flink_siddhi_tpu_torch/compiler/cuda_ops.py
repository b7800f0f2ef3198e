"""Hand-written CUDA kernels for the engine's hot scan primitives.

The counterpart of ``flink_siddhi_tpu/compiler/pallas_ops.py`` for an
NVIDIA Hopper card. Nine kernels live here, all CUDA C++ under ``csrc/``:

* **reverse cummin** (``multi_reverse_cummin``, csrc/reverse_cummin.cu) —
  the chain matcher's "next match at/after position p" tables: one
  suffix-min per pattern row, all rows and the "no match" column in one
  launch (a single-pass scan with decoupled look-back).
* **chain advance** (``chain_advance``, csrc/chain_advance.cu) — every
  candidate partial match advanced through the pattern's remaining
  positive steps, absence guards and ``within`` in one pass, returning the
  per-step match positions the caller replays capture gathers from.
* **unique-window fold** (``unique_window_fold``, csrc/unique_fold.cu) —
  one micro-batch folded into the ``#window.unique`` slot table, with every
  event's count/sum/avg/min/max over the valid slots, as a pipeline of
  data-parallel kernels (a radix sort by slot, device-wide scans and
  interval-stabbing trees over the event axis); float32 and int32 value
  columns.
* **join pairs** (``join_pairs``, csrc/join_pairs.cu) — a windowed
  two-stream join's pairs of one micro-batch (every arriving event against
  the other side's ring and batch, with the ``on`` program), ranked and cut
  as the reference's dense pair mask and sort rank them, without building
  the mask: one walk a candidate, a warp's lanes over an event's
  candidates, the tile's bands in shared memory. No Pallas counterpart:
  the reference runs it as XLA ops
  (``flink_siddhi_tpu/compiler/join.py:335-403``).
* **table mutate** (``table_mutate``, csrc/table_mutate.cu) — an event
  table's update or delete: each table row's last matching event of a
  micro-batch through the ``on`` program (the interpreter K4 and K5
  share). No Pallas counterpart: the reference builds a dense (E, C)
  match matrix and an ``argmax`` over it (``flink_siddhi_tpu/compiler/
  table.py:362-408``). A stream-table join runs on ``join_pairs`` with
  one direction (``table_join_dir``).
* **slot NFA scan** (``slot_nfa_scan``, csrc/slot_nfa.cu) — the slot NFA's
  walk over one micro-batch's events, every partial-match slot advanced at
  each event (sequences, quantifiers, and/or groups, cross-element filters,
  indexed captures, the ``every`` forms). It has no Pallas counterpart: the
  reference runs this loop as ``lax.scan`` (``flink_siddhi_tpu/compiler/
  nfa.py:3107``).
* **the scan windows' loops**, each a ``lax.scan`` in the reference
  (``flink_siddhi_tpu/compiler/scan_windows.py``) and no Pallas kernel:
  ``session_scan`` (csrc/session_scan.cu, a thread walks a key's events),
  ``frequency_scan`` (csrc/frequency_scan.cu, one warp walks the batch
  over a counted-key table, in its lanes' registers up to 32 slots) and
  ``sort_window_scan`` (csrc/sort_window.cu, a top-n buffer a partition:
  up to 32 slots, chunks of the partitions' events walked in parallel
  from exact carry-ins, events that change no buffer skipped by a
  ballot); K8 and K9 share their aggregate rows (csrc/warp_rows.cuh).

Each wrapper takes its plain PyTorch version for tensors on the CPU, and
only then. For a CUDA tensor it launches its kernel or raises: there is no
probe that disables a kernel, no switch that forces the plain version and no
``try`` that falls back. Each wrapper counts its CUDA calls in
``launches`` (a plain integer, bumped only where its kernel is launched;
a CUDA graph that captured a call adds it back at each replay:
``runtime/graphs.py``).

The kernels build at their first CUDA use (or through ``build``) with
``nvcc`` into ``build/torch_kernels/`` beside the package — one shared
library per source with a plain C interface, loaded with ``ctypes``, all
sources compiled in parallel. Importing this module needs no ``nvcc``,
no GPU and no build.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..telemetry import compile_events
from .slot_program import (OP_AND, OP_ANDJ, OP_CAP, OP_EQ_I, OP_EVT,
                           OP_LIT, eval_program)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# -ftz=true: float32 flushes subnormals, as the reference's XLA does on
# the CPU (the program interpreter, csrc/program.cuh, also flushes
# explicitly)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-ftz=true", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# kernel name -> its source under csrc/
SOURCES = {
    "reverse_cummin": "reverse_cummin.cu",
    "chain_advance": "chain_advance.cu",
    "unique_fold": "unique_fold.cu",
    "slot_nfa": "slot_nfa.cu",
    "join_pairs": "join_pairs.cu",
    "table_mutate": "table_mutate.cu",
    "session_scan": "session_scan.cu",
    "frequency_scan": "frequency_scan.cu",
    "sort_window": "sort_window.cu",
    "empty": "empty.cu",
}
CUMMIN_TILE = 2048  # reverse_cummin.cu's kTile: events per block
_EPOCH_LIMIT = (1 << 30) - 1  # the look-back states' epoch field
_MAX_STEPS = 32  # chain_advance.cu's ChainPlan limits
_MAX_GUARDS = 64
FOLD_MAX_SLOTS = 64  # unique_fold.cu plan limits
FOLD_MAX_ARGS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "fst_reverse_cummin": [_P, _P, _P, _I, _I, _L, _I, _I, _P],
    "fst_chain_advance": [
        _P, _L, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I,
        _I, _P, _P,
    ],
    "fst_empty": [_P],
    "fst_barrier_rounds": [_I, _I, _P],
    "fst_unique_fold": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
        _P, _I, _P, _P,
    ],
    "fst_unique_fold_scratch": [
        ctypes.c_longlong, ctypes.c_longlong, _I, _P, _I, _P,
    ],
    "fst_warp_rounds": [_I, _P],
    "fst_ftz_probe": [_P, _P, _P, _I, _P],
    "fst_join_pairs": [_P, _P],
    "fst_table_mutate": [_P, _P],
    "fst_session_scan": [_P, _P],
    "fst_frequency_scan": [_P, _I, _P],
    "fst_frequency_smem": [_I, _I, _I, _I, _I, _I, _I],
    "fst_sort_window": [_P, _P],
    "fst_sort_window_smem": [_I, _I, _I, _I, _I],
    "fst_sort_window_chunk_words": [],
    "fst_slot_nfa_scan": [
        _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
        _P, _P, _I, _I, _P,
    ],
}

# entry points that return something other than a cudaError_t
_RESTYPES = {"fst_frequency_smem": ctypes.c_longlong,
             "fst_sort_window_smem": ctypes.c_longlong,
             "fst_sort_window_chunk_words": ctypes.c_longlong}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH); the CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    # the source and every shared header it may include
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


class _Libraries:
    """The loaded kernel libraries, built on first use."""

    def __init__(self) -> None:
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()
        # per kernel: nvcc's output (ptxas register / spill report)
        self.build_log: Dict[str, str] = {}

    def build(self, names: Optional[Sequence[str]] = None) -> float:
        """Compile (one nvcc per source, all started together) and load
        every named kernel library not loaded yet. Returns the seconds
        spent; a source whose library is already on disk only loads."""
        names = list(SOURCES if names is None else names)
        t0 = time.perf_counter()
        with self._lock:
            todo = [n for n in names if n not in self._libs]
            procs = []
            for n in todo:
                path = _lib_path(n)
                if path.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / SOURCES[n])]
                procs.append((n, path, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )))
            failed = []
            for n, path, tmp, proc in procs:
                out, _ = proc.communicate()
                self.build_log[n] = out
                if proc.returncode != 0:
                    failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
                else:
                    os.replace(tmp, path)
                    # a compile event of the port (compile_events.py):
                    # this source's nvcc, from the start of the builds
                    compile_events.record("build", time.perf_counter() - t0)
            if failed:
                raise KernelBuildError("\n".join(failed))
            for n in todo:
                lib = ctypes.CDLL(str(_lib_path(n)))
                for fn_name, argtypes in _ARGTYPES.items():
                    fn = getattr(lib, fn_name, None)
                    if fn is not None:
                        fn.argtypes = argtypes
                        fn.restype = _RESTYPES.get(fn_name, ctypes.c_int)
                self._libs[n] = lib
        return time.perf_counter() - t0

    def get(self, name: str) -> ctypes.CDLL:
        lib = self._libs.get(name)
        if lib is None:
            self.build([name])
            lib = self._libs[name]
        return lib


LIBRARIES = _Libraries()


def build(names: Optional[Sequence[str]] = None) -> float:
    """Build and load the kernels ahead of their first use (seconds)."""
    return LIBRARIES.build(names)


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {err}"
        )


def _check(t: torch.Tensor, what: str, dtype, device, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}"
        )


def _device_kind(t: torch.Tensor, what: str) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return kind


def _on_device(dev: torch.device):
    """The context a launch on ``dev`` needs: none when ``dev`` is the
    current device (a kernel launches on the current device)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index``."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch_empty() -> None:
    """One launch of an empty kernel (csrc/empty.cu, one block) on the
    current stream: the floor under every kernel's device time, measured
    by chip_smoke.py. No path calls it."""
    err = LIBRARIES.get("empty").fst_empty(
        _stream(torch.cuda.current_device())
    )
    _check_launch("empty", err)


def launch_barrier_rounds(n: int, threads: int) -> None:
    """One launch of ``n`` empty block barrier rounds in one block of
    ``threads`` threads (csrc/empty.cu) on the current stream: the serial
    floor under the slot NFA scan of ``n`` events, measured by
    chip_smoke.py. No path calls it."""
    err = LIBRARIES.get("empty").fst_barrier_rounds(
        n, threads, _stream(torch.cuda.current_device())
    )
    _check_launch("barrier_rounds", err)


def launch_warp_rounds(n: int) -> None:
    """One launch of ``n`` empty warp rounds (a ``__syncwarp`` and a
    dependent ``__shfl_sync`` each) in one warp (csrc/empty.cu) on the
    current stream: the serial floor under the one-warp slot NFA scan of
    ``n`` events, measured by chip_smoke.py. No path calls it."""
    err = LIBRARIES.get("empty").fst_warp_rounds(
        n, _stream(torch.cuda.current_device())
    )
    _check_launch("warp_rounds", err)


def ftz_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float probe (csrc/empty.cu) on float32 CUDA tensors ``a``, ``b``
    ``[n]``: ``[n, 6]`` of a + b, a * b, a / b, a < b, a == b, fmodf(a, b)
    as the build computes them without the interpreter's explicit flush.
    No path calls it."""
    n = int(a.shape[0])
    out = torch.empty((n, 6), dtype=torch.float32, device=a.device)
    err = LIBRARIES.get("empty").fst_ftz_probe(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
        _stream(a.device.index),
    )
    _check_launch("ftz_probe", err)
    return out


# --------------------------------------------------------------------------
# K1: multi-channel reverse cummin
# --------------------------------------------------------------------------

def reverse_cummin_plain(x: torch.Tensor,
                         pad: Optional[int] = None) -> torch.Tensor:
    """The plain version: suffix min along the last axis, int32 in/out;
    with ``pad``, one more column holding ``pad``."""
    out = torch.flip(torch.cummin(torch.flip(x, [-1]), -1).values, [-1])
    if pad is None:
        return out
    col = torch.full((x.shape[0], 1), pad, dtype=x.dtype, device=x.device)
    return torch.cat([out, col], 1)


def padded_stride(E: int) -> int:
    """Row stride of a padded next-match table: E + 1 rounded up to 4
    ints, so that every row starts on a 16-byte boundary (the reverse
    cummin's 16-byte stores)."""
    return (E + 4) // 4 * 4


def cummin_scratch_words(C: int, E: int, tile: int = CUMMIN_TILE) -> int:
    """64-bit words of look-back scratch one call needs: the ticket
    word, then one state per (channel, tile), at least one tile."""
    return 1 + C * max(1, -(-E // tile))


class ScratchBuffer:
    """One look-back scratch of reverse_cummin.cu: ``words`` (int64, on
    the device) and ``used``, the calls enqueued on it since it was last
    zeroed. The kernel keeps its epoch in the buffer's ticket word and
    advances it once a call, so ``used`` is the epoch that word holds once
    those calls have run. ``reserve`` makes room for more calls: the host
    zeroes the buffer (stream-ordered) before the epoch would pass
    ``epoch_limit``."""

    def __init__(self, words: int, device: torch.device,
                 epoch_limit: int = _EPOCH_LIMIT) -> None:
        # zeros: every state reads epoch 0, which no call uses
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.used = 0
        self.epoch_limit = epoch_limit

    def reserve(self, calls: int) -> int:
        """Account for ``calls`` more calls; returns the epoch the last of
        them runs with."""
        if calls > self.epoch_limit:
            raise ValueError(f"{calls} calls exceed the epoch limit")
        if self.used + calls > self.epoch_limit:
            if _capturing(self.words.device):
                raise RuntimeError(
                    "reverse cummin: the look-back epoch would wrap inside "
                    "a CUDA graph capture"
                )
            self.words.zero_()
            self.used = 0
        self.used += calls
        return self.used


def _capturing(device: torch.device) -> bool:
    """Whether work on ``device`` is being captured into a CUDA graph."""
    return (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


class _DeviceInts:
    """Small int32 constants (an ``on`` program, a slot plan) kept on
    their device, each made at its first use there and never inside a
    CUDA graph capture (the first step of a plan runs eagerly)."""

    def __init__(self, what: str) -> None:
        self.what = what
        self._cache: Dict[Tuple, torch.Tensor] = {}

    def __call__(self, values: Sequence[int], dev) -> torch.Tensor:
        key = (tuple(values), str(dev))
        t = self._cache.get(key)
        if t is None:
            if _capturing(dev):
                raise RuntimeError(
                    f"{self.what} is not on the capturing device yet; run "
                    "the captured work once first")
            t = torch.tensor(list(values) or [0], dtype=torch.int32).to(dev)
            self._cache[key] = t
        return t


class LookbackScratch:
    """The look-back scratch buffers of reverse_cummin.cu, one per
    (device, stream), replaced by a larger one when a call needs more
    words (a CUDA graph that captured the old buffer keeps it alive and
    keeps its own count, ``runtime/graphs.py``). A capture takes the
    buffer its stream already holds: it cannot allocate or zero one."""

    def __init__(self, epoch_limit: int = _EPOCH_LIMIT) -> None:
        self.epoch_limit = epoch_limit
        self._bufs: Dict[Tuple, ScratchBuffer] = {}

    def take(self, device: torch.device, stream: int,
             words: int) -> ScratchBuffer:
        """A buffer of at least ``words`` words for calls on ``stream``."""
        key = (device, stream)
        buf = self._bufs.get(key)
        if buf is None or buf.words.numel() < words:
            if _capturing(device):
                raise RuntimeError(
                    "reverse cummin: no look-back scratch of "
                    f"{words} words on the capturing stream; run the "
                    "captured work once on that stream first"
                )
            buf = ScratchBuffer(words, device, self.epoch_limit)
            self._bufs[key] = buf
        return buf

    def buffers(self) -> Tuple[ScratchBuffer, ...]:
        return tuple(self._bufs.values())


class ReverseCummin:
    """``out[c, e] = min(x[c, e:])`` for an int32 ``[C, E]`` tensor; with
    ``pad``, ``[C, E + 1]`` whose column E holds ``pad`` (on the card
    with a row stride of ``padded_stride(E)``). On CUDA one call is one
    kernel launch."""

    name = "multi_reverse_cummin"
    source = "flink_siddhi_tpu_torch/csrc/reverse_cummin.cu"

    def __init__(self) -> None:
        self.launches = 0
        self.scratch = LookbackScratch()

    def __call__(self, x: torch.Tensor,
                 pad: Optional[int] = None) -> torch.Tensor:
        if _device_kind(x, "x") == "cpu":
            return reverse_cummin_plain(x, pad)
        if x.dim() != 2:
            raise ValueError(f"x: expected [C, E], got {tuple(x.shape)}")
        dev = x.device
        _check(x, "x", torch.int32, dev)
        C, E = (int(s) for s in x.shape)
        if not 1 <= C <= 65535 or not 0 <= E < 2 ** 30:
            raise ValueError(f"x: unsupported shape {(C, E)}")
        if pad is not None and not -2 ** 31 <= pad < 2 ** 31:
            raise ValueError(f"pad {pad} is not an int32")
        lib = LIBRARIES.get("reverse_cummin")
        if pad is None:
            ld = E
            out = torch.empty((C, E), dtype=torch.int32, device=dev)
        else:
            ld = padded_stride(E)
            out = torch.empty_strided((C, E + 1), (ld, 1),
                                      dtype=torch.int32, device=dev)
        with _on_device(dev):
            stream = _stream(dev.index)
            states = self.scratch.take(dev, stream,
                                       cummin_scratch_words(C, E))
            states.reserve(1)
            err = lib.fst_reverse_cummin(
                x.data_ptr(), out.data_ptr(), states.words.data_ptr(), C, E,
                ld, int(pad is not None), int(pad or 0), stream,
            )
        _check_launch(self.name, err)
        self.launches += 1
        return out


multi_reverse_cummin = ReverseCummin()


# --------------------------------------------------------------------------
# K2: chain advance
# --------------------------------------------------------------------------

def chain_advance_plain(nxt, pos_rows, guard_rows, ts_pad, act, step, pos,
                        start, within):
    """The plain version: the unfused advance loop of nfa._chain_core
    (without its capture gathers), in torch. One query: ``act`` etc.
    ``[V]``, ``ts_pad [E + 1]``, ``jmat [K-1, V]``. Q queries: ``[Q, V]``,
    ``ts_pad [Q, E + 1]``, ``nxt [Q * rows, E + 1]`` (each query's rows
    together), ``within`` an int or an int32 ``[Q]``, ``jmat
    [Q, K-1, V]``."""
    if act.dim() == 1:
        out = chain_advance_plain(
            nxt, pos_rows, guard_rows, ts_pad.unsqueeze(0),
            act.unsqueeze(0), step.unsqueeze(0), pos.unsqueeze(0),
            start.unsqueeze(0), within,
        )
        return tuple(t[0] for t in out)
    Q, V = (int(s) for s in act.shape)
    E = int(ts_pad.shape[1]) - 1
    tables = nxt.view(Q, -1, E + 1)
    if isinstance(within, torch.Tensor):
        within = within.unsqueeze(1)
    jmat = torch.empty((Q, len(pos_rows), V), dtype=torch.int32,
                       device=act.device)
    for k in range(1, len(pos_rows) + 1):
        at_k = act & (step == k)
        idx = pos.clamp(0, E).long()
        j = torch.take_along_dim(tables[:, pos_rows[k - 1]], idx, 1)
        found = at_k & (j < E)
        for g in guard_rows[k - 1]:
            jg = torch.take_along_dim(tables[:, g], idx, 1)
            violated = at_k & (jg <= j) & (jg < E)
            act = act & ~violated
            found = found & ~violated
        if within is not None:
            ts_j = torch.take_along_dim(ts_pad, j.long(), 1)
            ok = (ts_j - start) <= within
            dead = found & ~ok
            found = found & ok
            act = act & ~dead
        jmat[:, k - 1] = torch.where(found, j, E)
        step = torch.where(found, k + 1, step)
        pos = torch.where(found, j + 1, pos)
    return act, step, pos, jmat


@functools.lru_cache(maxsize=256)
def chain_plan(pos_rows: Tuple[int, ...],
               guard_rows: Tuple[Tuple[int, ...], ...],
               has_within: bool) -> ctypes.Array:
    """chain_advance.cu's plan as a ctypes int array, one per pattern
    layout: ``[n_steps, has_within, pos_row..., g_begin..., g_row...]``."""
    g_begin = [0]
    for gs in guard_rows:
        g_begin.append(g_begin[-1] + len(gs))
    plan = (
        [len(pos_rows), int(has_within)]
        + list(pos_rows)
        + g_begin
        + [g for gs in guard_rows for g in gs]
    )
    return (ctypes.c_int * len(plan))(*plan)


class ChainAdvance:
    """Advance ``V`` candidates through positive steps ``1..K-1``, for one
    query or for Q queries of one pattern shape in the same launch.

    One query: ``nxt`` int32 ``[rows, E + 1]`` next-match table (position
    E = "no match"), rows contiguous, any row stride; ``pos_rows[k-1]``:
    its row for positive step k; ``guard_rows[k-1]``: its rows of step
    k's absence guards; ``ts_pad``: int32 ``[E + 1]``; ``act`` bool and
    ``step``/``pos``/``start`` int32 ``[V]``; ``within``: int, or None
    without a ``within`` clause. Returns ``(act, step, pos, jmat
    int32[K-1, V])``.

    Q queries (``act`` ``[Q, V]``): ``nxt [Q * rows, E + 1]``, query q's
    rows at ``q * rows`` (row indices are per query), ``ts_pad`` int32
    ``[Q, E + 1]``, the candidates ``[Q, V]``, ``within`` an int or an
    int32 ``[Q]`` on the device; ``jmat`` is ``[Q, K-1, V]``.

    On CUDA one call is one kernel launch, none when ``V`` is 0."""

    name = "chain_advance"
    source = "flink_siddhi_tpu_torch/csrc/chain_advance.cu"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, nxt, pos_rows, guard_rows, ts_pad, act, step, pos,
                 start, within):
        if _device_kind(act, "act") == "cpu":
            return chain_advance_plain(
                nxt, pos_rows, guard_rows, ts_pad, act, step, pos, start,
                within,
            )
        n_steps = len(pos_rows)
        if len(guard_rows) != n_steps:
            raise ValueError("guard_rows needs one entry per step")
        n_guards = sum(len(g) for g in guard_rows)
        if not 1 <= n_steps <= _MAX_STEPS or n_guards > _MAX_GUARDS:
            raise ValueError(
                f"chain_advance takes 1..{_MAX_STEPS} steps and at most "
                f"{_MAX_GUARDS} guards, got {n_steps} and {n_guards}"
            )
        dev = act.device
        batched = act.dim() == 2
        Q = int(act.shape[0]) if batched else 1
        E = int(ts_pad.shape[-1]) - 1
        V = int(act.shape[-1])
        if not 1 <= Q <= 65535:
            raise ValueError(f"chain_advance takes 1..65535 queries, got {Q}")
        n_rows = int(nxt.shape[0])
        ld = nxt.stride(0) if n_rows > 1 else E + 1
        if (nxt.dtype != torch.int32 or nxt.device != dev
                or tuple(nxt.shape) != (n_rows, E + 1)
                or nxt.stride(1) != 1 or ld < E + 1 or n_rows % Q):
            raise ValueError(
                f"nxt: expected int32 [{Q} x rows, {E + 1}] on {dev} with "
                f"contiguous rows, got {nxt.dtype} {tuple(nxt.shape)} "
                f"stride {nxt.stride()} on {nxt.device}"
            )
        rows_q = n_rows // Q
        rows = list(pos_rows) + [g for gs in guard_rows for g in gs]
        if any(not 0 <= r < rows_q for r in rows):
            raise ValueError(f"row index out of range 0..{rows_q - 1}")
        lead = (Q,) if batched else ()
        _check(ts_pad, "ts_pad", torch.int32, dev, lead + (E + 1,))
        _check(act, "act", torch.bool, dev, lead + (V,))
        for t, what in ((step, "step"), (pos, "pos"), (start, "start")):
            _check(t, what, torch.int32, dev, lead + (V,))
        within_q = 0
        if isinstance(within, torch.Tensor):
            if not batched:
                raise ValueError("a per-query within needs [Q, V] inputs")
            _check(within, "within", torch.int32, dev, (Q,))
            within_q = within.data_ptr()
        plan = chain_plan(tuple(pos_rows),
                          tuple(tuple(g) for g in guard_rows),
                          within is not None)
        lib = LIBRARIES.get("chain_advance")
        act_o = torch.empty_like(act)
        step_o = torch.empty_like(step)
        pos_o = torch.empty_like(pos)
        jmat = torch.empty(lead + (n_steps, V), dtype=torch.int32,
                           device=dev)
        with _on_device(dev):
            stream = _stream(dev.index)
            err = lib.fst_chain_advance(
                nxt.data_ptr(), ld, rows_q * ld, E, ts_pad.data_ptr(),
                act.data_ptr(), step.data_ptr(), pos.data_ptr(),
                start.data_ptr(), act_o.data_ptr(), step_o.data_ptr(),
                pos_o.data_ptr(), jmat.data_ptr(), V, Q, plan, len(plan),
                0 if isinstance(within, torch.Tensor) else int(within or 0),
                within_q, stream,
            )
        _check_launch(self.name, err)
        self.launches += 1
        return act_o, step_o, pos_o, jmat


chain_advance = ChainAdvance()


# --------------------------------------------------------------------------
# K3: unique-window fold
# --------------------------------------------------------------------------

# slot kinds, and the statistics they read (unique_fold.cu's codes)
_FOLD_KINDS = {"count": 0, "sum": 1, "avg": 2, "min": 3, "max": 4}
_STAT_OP = {"count": 0, "sum": 1, "avg": 1, "min": 2, "max": 3}
# the plain version folds this many table cells (events x slots) at a time:
# 256 events a chunk at C = 16,384 slots
_PLAIN_CHUNK_CELLS = 1 << 22


_INT_MIN, _INT_MAX = -2 ** 31, 2 ** 31 - 1


def _fold_rows(valid, bufs, slots, int_cols=()):
    """Every aggregate slot over the valid slots of ``[T, C]`` tables:
    ``valid`` bool and ``bufs[a]`` float32, or int32 for a column in
    ``int_cols``. Returns float32 ``[S, T]`` (the reference's
    ``ScanWindowArtifact._agg_rows``, per event row): an integer column's
    sum is the float32 sum of its values cast to float32, its min and max
    int32 rows by bit pattern."""
    cnt = valid.sum(1).to(torch.float32)
    sums: Dict[int, torch.Tensor] = {}
    out = []
    for kind, a in slots:
        if kind == "count":
            out.append(cnt)
        elif kind in ("sum", "avg"):
            if a not in sums:
                sums[a] = torch.where(valid, bufs[a], 0).to(
                    torch.float32).sum(1)
            out.append(sums[a] if kind == "sum"
                       else sums[a] / torch.clamp(cnt, min=1.0))
        elif a in int_cols:
            ident = _INT_MAX if kind == "min" else _INT_MIN
            masked = torch.where(valid, bufs[a], ident)
            r = masked.amin(1) if kind == "min" else masked.amax(1)
            out.append(r.to(torch.int32).view(torch.float32))
        else:
            ident = float("inf") if kind == "min" else float("-inf")
            masked = torch.where(valid, bufs[a], ident)
            out.append(masked.amin(1) if kind == "min" else masked.amax(1))
    return torch.stack(out)


def _typed(words: torch.Tensor, a: int, int_cols) -> torch.Tensor:
    """Column ``a`` of an int32 word array: as int32 when it is an integer
    column, else as float32 (a view: bits unchanged)."""
    w = words[a]
    return w if a in int_cols else w.view(torch.float32)


def unique_window_fold_plain(mask, codes, vals, valid0, bufs0, slots,
                             int_cols=()):
    """The plain version, in chunks of events: for T events at a time the
    ``[T, C]`` table of each slot's latest writer in the chunk comes from
    one scatter and a cummax down the chunk; the T table states follow by
    gathers, and masked reductions over C give the T aggregate rows. The
    table moves as int32 words (an integer column's bits kept)."""
    E = int(mask.shape[0])
    C = int(valid0.shape[0])
    dev = mask.device
    rows = torch.empty((len(slots), E), dtype=torch.float32, device=dev)
    int_cols = frozenset(int_cols)
    vals = vals.view(torch.int32)
    valid, bufs = valid0.clone(), bufs0.view(torch.int32).clone()
    code = codes.clamp(0, C - 1)
    T = max(1, min(E, _PLAIN_CHUNK_CELLS // C))
    for t0 in range(0, E, T):
        n = min(T, E - t0)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        # writes of masked-out events go to a dump column C
        col = torch.where(mask[t0:t0 + n], code[t0:t0 + n], C).long()
        last = torch.full((n, C + 1), -1, dtype=torch.int32, device=dev)
        last.scatter_(1, col[:, None], idx[:, None])
        last = torch.cummax(last[:, :C], 0).values
        hit = last >= 0
        at = last.clamp(min=0).long()
        v_t = valid[None, :] | hit
        b_t = [
            torch.where(hit, vals[a, t0:t0 + n][at], bufs[a][None, :])
            for a in range(int(bufs.shape[0]))
        ]
        rows[:, t0:t0 + n] = _fold_rows(
            v_t, [b if a in int_cols else b.view(torch.float32)
                  for a, b in enumerate(b_t)], slots, int_cols)
        valid = v_t[-1].clone()
        for a, b in enumerate(b_t):
            bufs[a] = b[-1]
    return valid, bufs.view(torch.float32), rows


def _fold_plan(slots, A: int = 0, int_cols=()) -> list:
    """unique_fold.cu's plan: slot kinds, the distinct statistics ``(op,
    column)`` the slots read (statistic 0 the count), and per value column
    whether it holds int32 values."""
    stats = [(_STAT_OP["count"], -1)]
    slot_stat = []
    for kind, a in slots:
        if kind not in _FOLD_KINDS:
            raise ValueError(f"unique_window_fold: no {kind!r} aggregate")
        key = stats[0] if kind == "count" else (_STAT_OP[kind], a)
        if key not in stats:
            stats.append(key)
        slot_stat.append(stats.index(key))
    return (
        [len(slots), len(stats)]
        + [_FOLD_KINDS[k] for k, _ in slots]
        + slot_stat
        + [op for op, _ in stats]
        + [a for _, a in stats]
        + [int(a in int_cols) for a in range(A)]
    )


class UniqueWindowFold:
    """Fold a micro-batch into a ``#window.unique`` table, as if in order.

    ``mask`` bool and ``codes`` int32 ``[E]``; ``vals`` float32 ``[A, E]``
    (the events' value columns); ``valid0`` bool ``[C]`` and ``bufs0``
    float32 ``[A, C]`` (the carried table); ``slots``: ``(kind, arg)`` per
    aggregate, kind one of count/sum/avg/min/max (arg -1 for count).
    Event t with ``mask[t]`` sets slot ``clip(codes[t], 0, C - 1)``; then
    every slot is computed over the valid slots. Returns ``(valid bool[C],
    bufs float32[A, C], rows float32[S, E])``. A column in ``int_cols``
    holds int32 values by bit pattern (``.view(torch.float32)``) in
    ``vals`` and ``bufs``; its min and max rows are int32 bit patterns too
    (exact), its sum the float32 sum of its values cast to float32.

    On CUDA one call launches the kernel pipeline of csrc/unique_fold.cu
    (``kernel_launches`` kernels, ``scratch_bytes`` of scratch from
    ``torch.empty``); ``launches`` counts the calls."""

    name = "unique_window_fold"
    source = "flink_siddhi_tpu_torch/csrc/unique_fold.cu"

    def __init__(self) -> None:
        self.launches = 0
        # of the last call: kernels launched and scratch bytes allocated
        self.kernel_launches = 0
        self.scratch_bytes = 0

    def __call__(self, mask, codes, vals, valid0, bufs0, slots,
                 int_cols=()):
        if _device_kind(mask, "mask") == "cpu":
            return unique_window_fold_plain(mask, codes, vals, valid0,
                                            bufs0, slots, int_cols)
        dev = mask.device
        E = int(mask.shape[0])
        C = int(valid0.shape[0])
        A = int(vals.shape[0])
        S = len(slots)
        if not 1 <= S <= FOLD_MAX_SLOTS or A > FOLD_MAX_ARGS:
            raise ValueError(
                f"unique_window_fold takes 1..{FOLD_MAX_SLOTS} aggregates and "
                f"at most {FOLD_MAX_ARGS} value columns, got {S} and {A}"
            )
        if any(kind != "count" and not 0 <= a < A for kind, a in slots):
            raise ValueError("unique_window_fold: slot column out of range")
        _check(mask, "mask", torch.bool, dev, (E,))
        _check(codes, "codes", torch.int32, dev, (E,))
        _check(vals, "vals", torch.float32, dev, (A, E))
        _check(valid0, "valid0", torch.bool, dev, (C,))
        _check(bufs0, "bufs0", torch.float32, dev, (A, C))
        if any(not 0 <= a < A for a in int_cols):
            raise ValueError("unique_window_fold: int column out of range")
        plan = _fold_plan(slots, A, int_cols)
        plan_c = (ctypes.c_int * len(plan))(*plan)
        plan_p = ctypes.cast(plan_c, ctypes.c_void_p)
        lib = LIBRARIES.get("unique_fold")
        nbytes, n_launch = ctypes.c_longlong(0), ctypes.c_int(0)
        if lib.fst_unique_fold_scratch(E, C, A, plan_p, len(plan),
                                       ctypes.addressof(nbytes)) != 0:
            raise ValueError(
                f"unique_window_fold: unique_fold.cu refuses {E} events, "
                f"{C} slots or the plan {plan}"
            )
        valid = torch.empty_like(valid0)
        bufs = torch.empty_like(bufs0)
        rows = torch.empty((S, E), dtype=torch.float32, device=dev)
        scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
        with _on_device(dev):
            err = lib.fst_unique_fold(
                mask.data_ptr(), codes.data_ptr(), vals.data_ptr(),
                valid0.data_ptr(), bufs0.data_ptr(), valid.data_ptr(),
                bufs.data_ptr(), rows.data_ptr(), scratch.data_ptr(),
                nbytes.value, E, C, A, plan_p, len(plan),
                ctypes.addressof(n_launch), _stream(dev.index),
            )
        _check_launch(self.name, err)
        self.launches += 1
        self.kernel_launches = n_launch.value
        self.scratch_bytes = nbytes.value
        return valid, bufs, rows


unique_window_fold = UniqueWindowFold()


# --------------------------------------------------------------------------
# K4: slot NFA scan
# --------------------------------------------------------------------------

# slot_nfa.cu's SlotPlan tables: 32-bit element, group and pair masks
SLOT_MAX_ELEMS = 32  # and groups; K + indexed captures <= 31 (mbits word)
SLOT_MAX_PAIRS = 32
SLOT_FIXED_ROWS = 7  # active, step, count, start, last, matched, idxv
SLOT_STAGE_WORDS = 6  # a fork's staged scalar state (multi-warp pools)
SLOT_TILE = 32  # events a tile (the columns' shared-memory tiles)
SLOT_MAX_SHARED = 232448  # an H100 block's shared memory
SLOT_MAX_R = 16  # slots a thread in the largest pools
_SLOT_HEADER = 20
SLOT_PLAN_WORDS = _SLOT_HEADER + 17 * SLOT_MAX_ELEMS + 1
_SLOT_COL_BITS = 20  # a pair descriptor's column field


def slot_launch_shape(S: int) -> Optional[Tuple[bool, int, int]]:
    """(multi-warp, slots a thread R, threads) of slot_nfa.cu's launch for
    a pool of S slots: one warp at S <= 64 (R = 1 or 2), else as many warps
    of R = 2, 4, 8 or 16 slots a thread as the pool needs. None past
    1,024 threads x SLOT_MAX_R slots."""
    if S <= 32:
        return False, 1, 32
    if S <= 64:
        return False, 2, 32
    r = 2
    while r <= SLOT_MAX_R:
        warps = -(-S // (32 * r))
        if warps <= 32:
            return True, r, 32 * warps
        r *= 2
    return None


@dataclass(frozen=True)
class SlotScanPlan:
    """The static tables of one slot-NFA pattern, as the scan reads them.

    ``groups``: element indices per logical step; ``group_and``: whether
    each is an 'and' group; ``mins``/``maxs``: each group's count bounds
    (an unbounded max is 2^30); ``marked``: the groups of mid-chain ``->
    every`` elements. ``cross[k]``: element k's linked slot program (None
    without a cross filter), ``cross_ref[k]``/``cross_idx[k]``: the matched
    bits and indexed-capture validity bits it requires. ``pair_elem`` and
    ``pair_col``: per capture pair, its element and its event column (a row
    of ``cols``); ``idx_caps``: per indexed capture, (element, pair, k);
    ``cap_rows``: per emission capture row, (0 first / 1 last / 2 indexed,
    pair or indexed capture). The state matrix has SLOT_FIXED_ROWS rows,
    then first and last per pair, then one row per indexed capture."""

    slots: int
    n_elements: int
    sequence: bool
    every: bool
    every_grouped: bool
    within: Optional[int]
    groups: Tuple[Tuple[int, ...], ...]
    group_and: Tuple[bool, ...]
    mins: Tuple[int, ...]
    maxs: Tuple[int, ...]
    marked: Tuple[int, ...]
    cross: Tuple[Optional[Tuple[int, ...]], ...]
    cross_ref: Tuple[int, ...]
    cross_idx: Tuple[int, ...]
    pair_elem: Tuple[int, ...]
    pair_col: Tuple[int, ...]
    idx_caps: Tuple[Tuple[int, int, int], ...]
    cap_rows: Tuple[Tuple[int, int], ...]
    needs_mbits: bool
    n_cols: int

    @property
    def state_rows(self) -> int:
        return SLOT_FIXED_ROWS + 2 * len(self.pair_elem) + len(self.idx_caps)

    @property
    def buf_rows(self) -> int:
        """Emission rows: ts, the mbits row when needed, one per capture."""
        return 1 + int(self.needs_mbits) + len(self.cap_rows)

    @property
    def depth(self) -> int:
        """The deepest program's stack (slot_nfa.cu's per-thread stack)."""
        from .slot_program import _depth

        return max((_depth(c) for c in self.cross if c is not None),
                   default=0)

    @property
    def shared_bytes(self) -> int:
        """slot_nfa.cu's dynamic shared memory: the plan, each slot's
        capture words, each thread's program stack, two tiles of the
        columns and, on a multi-warp pool, the forks' staged state and the
        ballot words (a pool ``slot_launch_shape`` takes)."""
        multi, R, T = slot_launch_shape(self.slots)
        words = 2 * len(self.pair_elem) + len(self.idx_caps)
        return 4 * (SLOT_PLAN_WORDS + len(self.cap_rows)
                    + self.slots * words + self.depth * T
                    + 2 * self.n_cols * SLOT_TILE
                    + (SLOT_STAGE_WORDS * self.slots
                       if multi and self.marked else 0)
                    + (6 * (T // 32) * R if multi else 0))

    @property
    def min_prefix(self) -> Tuple[int, ...]:
        out = [0]
        for m in self.mins:
            out.append(out[-1] + m)
        return tuple(out)

    def check(self) -> None:
        """Raise ValueError for a plan slot_nfa.cu cannot hold, naming the
        limit: the 32-bit element, group and capture-pair masks, the
        mbits word (elements + indexed captures <= 31), the block's
        threads and its shared memory."""
        G, K = len(self.groups), self.n_elements
        P, I = len(self.pair_elem), len(self.idx_caps)
        if not 1 <= G <= K <= SLOT_MAX_ELEMS - 1 or K + I > 31:
            raise ValueError(
                f"slot_nfa_scan: {K} elements and {I} indexed captures "
                "exceed the 31 bits of the match-bitmask word")
        if P > SLOT_MAX_PAIRS:
            raise ValueError(
                f"slot_nfa_scan: {P} capture pairs exceed the 32-bit pair "
                "mask of an element")
        if self.n_cols >= 1 << _SLOT_COL_BITS:
            raise ValueError(
                f"slot_nfa_scan: {self.n_cols} columns exceed a pair "
                f"descriptor's {_SLOT_COL_BITS}-bit column field")
        if slot_launch_shape(self.slots) is None:
            raise ValueError(
                f"slot_nfa_scan: {self.slots} slots exceed one block of "
                f"1,024 threads holding {SLOT_MAX_R} slots each")
        if self.shared_bytes > SLOT_MAX_SHARED:
            raise ValueError(
                f"slot_nfa_scan: {self.shared_bytes} bytes of shared memory "
                f"({self.slots} slots x {2 * P + I} capture words, a "
                f"{self.depth}-deep program stack, {self.n_cols} columns) "
                f"exceed a block's {SLOT_MAX_SHARED}")

    def aux(self) -> list:
        """slot_nfa.cu's aux buffer: each emission capture row's capture
        word, then the programs."""
        P = len(self.pair_elem)
        out = [2 * P + i if kind == 2 else 2 * i + kind
               for kind, i in self.cap_rows]
        for c in self.cross:
            out.extend(c or ())
        return out

    def words(self) -> list:
        """slot_nfa.cu's SlotPlan struct as int32 words."""
        self.check()
        G, P, I = len(self.groups), len(self.pair_elem), len(self.idx_caps)
        g_of = {e: g for g, mem in enumerate(self.groups) for e in mem}

        def pad(vals, n, fill=0):
            return list(vals) + [fill] * (n - len(vals))

        offs, lens = [], []
        at = len(self.cap_rows)
        for c in self.cross:
            offs.append(at if c is not None else -1)
            lens.append(len(c) if c is not None else 0)
            at += len(c or ())
        marked = 0
        for g in self.marked:
            marked |= 1 << g
        cross_mask = sum(1 << k for k, c in enumerate(self.cross)
                         if c is not None)
        header = [
            self.n_elements, G, self.slots, int(self.sequence),
            int(self.every), int(self.every_grouped),
            int(self.within is not None), int(self.within or 0),
            marked, P, I, self.n_cols, self.buf_rows, int(self.needs_mbits),
            cross_mask, at, self.depth, len(self.cap_rows), 0, 0,
        ]
        assert len(header) == _SLOT_HEADER
        gmask = [sum(1 << e for e in mem) for mem in self.groups]
        pre = self.min_prefix
        reach = []
        for g in range(G):
            # slot_nfa.cu's advance loop from step g: t = g + 1 on, while
            # every group in between is optional
            bits, t = 0, max(g + 1, 1)
            while t < G and pre[t] == pre[min(g + 1, G)]:
                bits |= gmask[t]
                t += 1
            reach.append(bits)
        pair_desc = [c | (int(len(self.groups[g_of[e]]) == 1) << 20)
                     | (g_of[e] << 21)
                     for e, c in zip(self.pair_elem, self.pair_col)]
        E32 = SLOT_MAX_ELEMS
        words = (
            header
            + pad(gmask, E32)
            + pad([int(a) for a in self.group_and], E32)
            + pad(self.mins, E32)
            + pad(self.maxs, E32)
            + pad(pre, E32 + 1)
            + pad(reach, E32)
            + pad(offs, E32, -1)
            + pad(lens, E32)
            + pad(self.cross_ref, E32)
            + pad(self.cross_idx, E32)
            + pad(self.pair_elem, SLOT_MAX_PAIRS)
            + pad(pair_desc, SLOT_MAX_PAIRS)
            + pad([sum(1 << p for p, pe in enumerate(self.pair_elem)
                       if pe == e) for e in range(self.n_elements)], E32)
            + pad([sum(1 << j for j, (ie, _, _) in enumerate(self.idx_caps)
                       if ie == e) for e in range(self.n_elements)], E32)
            + pad([e for e, _, _ in self.idx_caps], E32)
            + pad([k for _, _, k in self.idx_caps], E32)
            + pad([self.pair_col[p] for _, p, _ in self.idx_caps], E32)
        )
        assert len(words) == SLOT_PLAN_WORDS
        return words


def _wrap32(x: int) -> int:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def slot_nfa_scan_plain(plan: SlotScanPlan, state, scal, ts, valid, mword,
                        eword, cols, idx=None, cnt=None):
    """The plain version: the reference's scan body (flink_siddhi_tpu/
    compiler/nfa.py:3107-3495) in torch, vectorized over the slots, one
    Python iteration an event. Event i of the loop is ``idx[i]`` for the
    first ``cnt[0]`` entries of ``idx`` (relevance compaction), else i for
    every one of the E events. Returns ``(state, scal, buf)``: the new
    ``[W, S]`` state matrix, int32 ``[4]`` (done, started, overflow, n) and
    the ``[R, E + S]`` emission buffer (ts, mbits, capture rows), zero past
    its n rows.

    It skips work whose outcome is known on the host (an event while no
    slot is active, a transition no slot takes, a mask that is the same
    for every slot) and computes the rest as the reference does."""
    from .slot_program import eval_program

    S = plan.slots
    K, G = plan.n_elements, len(plan.groups)
    P = len(plan.pair_elem)
    E = int(ts.shape[0])
    M = E + S
    dev = ts.device
    i32 = torch.int32
    st = state.clone()
    act = st[0] != 0
    step, count, start, last = st[1], st[2], st[3], st[4]
    matched, idxv = st[5], st[6]
    caps = st[SLOT_FIXED_ROWS:]
    done, started, overflow = (bool(scal[0]), bool(scal[1]), int(scal[2]))
    buf = torch.zeros((plan.buf_rows, M), dtype=i32, device=dev)
    n0 = 0
    mins = torch.tensor(plan.mins, dtype=i32, device=dev)
    maxs = torch.tensor(plan.maxs, dtype=i32, device=dev)
    pre = torch.tensor(plan.min_prefix, dtype=i32, device=dev)
    pre_l = plan.min_prefix
    gmask = [sum(1 << e for e in mem) for mem in plan.groups]
    is_marked = torch.tensor([g in plan.marked for g in range(G + 1)],
                             device=dev)
    g_of = {e: g for g, mem in enumerate(plan.groups) for e in mem}
    has_cross = any(c is not None for c in plan.cross)
    per_slot_need = has_cross or any(plan.group_and)
    zero = torch.zeros(S, dtype=torch.bool, device=dev)
    n_ev = E if idx is None else min(int(cnt.reshape(-1)[0]), E)
    order = range(n_ev) if idx is None else idx[:n_ev].tolist()
    ts_l, v_l = ts.tolist(), valid.tolist()
    m_l, me_l = mword.tolist(), eword.tolist()
    cols_l = cols.tolist()
    for e in order:
        ts_e, v_e, m, me = ts_l[e], v_l[e], m_l[e], me_l[e]
        n_emit = fork_overflow = 0
        if not bool(act.any()):
            act2 = act  # no slot to advance: only arming below
        else:
            # cross-element filters, per slot: ``clear`` has bit k where
            # element k's filter fails for the slot
            eff, effe = m, me
            if has_cross:
                clear = 0
                for k, code in enumerate(plan.cross):
                    if code is None:
                        continue
                    ok = eval_program(code, lambda c: cols[c, e],
                                      lambda w: caps[w]) != 0
                    ref, iref = plan.cross_ref[k], plan.cross_idx[k]
                    if ref:
                        ok = ok & ((matched & ref) == ref)
                    if iref:
                        ok = ok & ((idxv & iref) == iref)
                    clear = clear | torch.where(ok, 0, 1 << k)
                eff, effe = m & ~clear, me & ~clear
            if plan.within is not None and v_e:
                act = act & ((ts_e - start) <= plan.within)
            stepc = step.clamp(0, G - 1).long()
            # the per-group masks: entry (advance INTO the group: any
            # member, entry-guarded) and need (absorb AT the group; 'and'
            # groups need a still-unmatched member)
            if per_slot_need:
                need = torch.stack([
                    ((eff & ~matched & gm) != 0) if a
                    else ((eff & gm) != 0) | zero
                    for gm, a in zip(gmask, plan.group_and)
                ])
                m_at = need.gather(0, stepc[None])[0]
            else:
                need_l = [(eff & gm) != 0 for gm in gmask]
                m_at = (torch.tensor(need_l, device=dev)[stepc]
                        if any(need_l) else None)
            absorb = zero
            if v_e and m_at is not None:
                absorb = act & m_at & (count < maxs[stepc])
            can_leave = count >= mins[stepc]
            from_pre = pre[(step + 1).clamp(0, G).long()]
            # advance target: smallest t > step whose entry mask matches,
            # with only optional groups skipped in between
            adv_t = None
            if v_e:
                base = act & can_leave
                for t in range(G - 1, 0, -1):
                    ent = (effe & gmask[t]) != 0
                    if ent is False:
                        continue
                    reach = base & (step < t) & (from_pre == pre_l[t])
                    if ent is not True:
                        reach = reach & ent
                    adv_t = torch.where(reach, t, G if adv_t is None
                                        else adv_t)
            advance = zero if adv_t is None else ~absorb & (adv_t < G)
            cnt_a = count + absorb.to(i32)
            at_last_full = (act & (step == G - 1)
                            & (cnt_a >= plan.maxs[G - 1])
                            & (cnt_a >= plan.mins[G - 1]))
            moved_to_last = zero
            if adv_t is not None and plan.maxs[G - 1] == 1:
                moved_to_last = advance & (adv_t == G - 1)
            emit_on_break = killed = zero
            if plan.sequence and v_e:
                miss = act & ~absorb & ~advance
                completable = act & can_leave & (from_pre == pre_l[G])
                emit_on_break = miss & completable
                killed = miss
            emit = emit_on_break | at_last_full | moved_to_last
            new_step, new_count, new_last = step, count, last
            new_matched, new_idxv, new_caps = matched, idxv, caps
            fire: Dict[int, torch.Tensor] = {}
            if bool((absorb | advance).any()):
                new_count = torch.where(absorb, count + 1, count)
                if adv_t is not None:
                    new_step = torch.where(advance, adv_t, step)
                    new_count = torch.where(advance, 1, new_count)
                new_last = torch.where(absorb | advance, ts_e, last)
                # the member that fired: lowest matching (for 'and' groups
                # lowest still unmatched) member of the group absorbed at
                # or advanced into
                fg = step if adv_t is None else torch.where(
                    advance, adv_t, step)
                fg = torch.where(absorb | advance, fg, -1)
                for g, (mem, a) in enumerate(zip(plan.groups,
                                                 plan.group_and)):
                    at_g = taken = None
                    for el in mem:
                        cand = (eff >> el) & 1
                        if a:
                            cand = cand & ~((matched >> el) & 1)
                        if isinstance(cand, int):
                            if not cand:
                                continue
                            if at_g is None:
                                at_g = fg == g
                            f = at_g
                        else:
                            if at_g is None:
                                at_g = fg == g
                            f = at_g & (cand != 0)
                        if taken is not None:
                            f = f & ~taken
                        taken = f if taken is None else taken | f
                        fire[el] = f
                for el, f in fire.items():
                    new_matched = torch.where(f, new_matched | (1 << el),
                                              new_matched)
                new_caps = caps.clone()
                for p, (el, c) in enumerate(zip(plan.pair_elem,
                                                plan.pair_col)):
                    took = fire.get(el)
                    if took is None:
                        continue
                    g = g_of[el]
                    if len(plan.groups[g]) == 1:
                        moved = count == 0
                        if adv_t is not None:
                            moved = moved | (advance & (adv_t == g))
                        first_take = took & moved
                    else:
                        first_take = took
                    src = cols_l[c][e]
                    new_caps[2 * p] = torch.where(first_take, src,
                                                  caps[2 * p])
                    new_caps[2 * p + 1] = torch.where(took, src,
                                                      caps[2 * p + 1])
                for j, (el, p, k) in enumerate(plan.idx_caps):
                    if el not in fire:
                        continue
                    wr = fire[el] & (new_count == k + 1)
                    new_caps[2 * P + j] = torch.where(
                        wr, cols_l[plan.pair_col[p]][e], caps[2 * P + j])
                    new_idxv = torch.where(wr, new_idxv | (1 << j),
                                           new_idxv)
            # emissions, in slot order, past n0; beyond M dropped
            n_emit = int(emit.sum())
            if n_emit:
                pos = n0 + torch.cumsum(emit, 0) - 1
                keep = emit & (pos < M)
                dst = pos[keep]
                buf[0, dst] = torch.where(emit_on_break, last, ts_e)[keep]
                r = 1
                if plan.needs_mbits:
                    buf[1, dst] = (new_matched | (new_idxv << K))[keep]
                    r = 2
                for kind, j in plan.cap_rows:
                    w = 2 * P + j if kind == 2 else 2 * j + kind
                    buf[r, dst] = new_caps[w][keep]
                    r += 1
            n0 = min(n0 + n_emit, M)
            # mid-chain `-> every` forks: the advanced instance moves to
            # the lowest free slots in rank order (or emits, when it
            # completes the pattern); the prefix slot reverts and stays
            # armed
            if plan.marked and adv_t is not None:
                fork = advance & is_marked[adv_t.long()]
                act2 = act & ~((emit & ~fork) | killed)
                sources = torch.nonzero(fork & ~moved_to_last).flatten()
                new_start = start
                if sources.numel():
                    free = torch.nonzero(~act2).flatten()
                    placed = min(int(sources.numel()), int(free.numel()))
                    fork_overflow = int(sources.numel()) - placed
                    src, dst = sources[:placed], free[:placed]
                    act2 = act2.clone()
                    act2[dst] = True
                    new_idxv = new_idxv.clone()
                    new_start = start.clone()
                    for t in (new_step, new_count, new_last, new_matched,
                              new_idxv, new_start):
                        t[dst] = t[src]
                    new_caps[:, dst] = new_caps[:, src]
                new_step = torch.where(fork, step, new_step)
                new_count = torch.where(fork, count, new_count)
                new_last = torch.where(fork, last, new_last)
                new_matched = torch.where(fork, matched, new_matched)
                new_caps[:2 * P] = torch.where(fork, caps[:2 * P],
                                               new_caps[:2 * P])
                start = new_start
            else:
                act2 = act & ~(emit | killed)
            step, count, last = new_step, new_count, new_last
            matched, idxv, caps = new_matched, new_idxv, new_caps
        # arm a new slot on a first-group match; without every, "started"
        # holds only while the armed partial is alive (or the single
        # match is done)
        any_act2 = bool(act2.any())
        started_now = started and (any_act2 or done)
        m0 = m & gmask[0]
        if plan.every:
            any_done = done
            want = bool(m0) and v_e
            if plan.every_grouped:
                want = want and not any_act2 and n_emit == 0
        else:
            any_done = done or n_emit > 0
            want = bool(m0) and v_e and not started_now and not any_done
        has_free = False
        if want:
            free_slots = torch.nonzero(~act2).flatten()
            has_free = bool(free_slots.numel())
        if has_free:
            fs = int(free_slots[0])
            arm_e = (m0 & -m0).bit_length() - 1  # lowest matching member
            act2 = act2.clone()
            step, count, start, last = (step.clone(), count.clone(),
                                        start.clone(), last.clone())
            matched, idxv, caps = matched.clone(), idxv.clone(), caps.clone()
            act2[fs] = True
            step[fs], count[fs] = 0, 1
            start[fs] = last[fs] = ts_e
            matched[fs] = 1 << arm_e
            idxv[fs] = 0
            for p, (el, c) in enumerate(zip(plan.pair_elem, plan.pair_col)):
                if el == arm_e:
                    caps[2 * p, fs] = caps[2 * p + 1, fs] = cols_l[c][e]
        overflow = _wrap32(overflow + int(want and not has_free)
                           + fork_overflow)
        started = started_now or want
        done = any_done
        act = act2
    out = torch.cat([
        torch.stack([act.to(i32), step, count, start, last, matched, idxv]),
        caps,
    ]).to(i32)
    scal_out = torch.tensor([int(done), int(started), overflow, n0],
                            dtype=i32, device=dev)
    return out, scal_out, buf


class SlotNFAScan:
    """One micro-batch of the slot NFA: every event advances the ``S``
    partial-match slots of ``plan`` (a ``SlotScanPlan``).

    ``state`` int32 ``[plan.state_rows, S]`` and ``scal`` int32 ``[3]``
    (done, started, overflow) are the carried state; ``ts``, ``mword``
    (bit k: element k's mask), ``eword`` (the entry-guarded masks) int32 and
    ``valid`` bool ``[E]``; ``cols`` int32 ``[plan.n_cols, E]`` (the event
    columns the captures and cross programs read, float32 by bit pattern).
    With ``idx`` (int32 ``[E]``) and ``cnt`` (int32 ``[1]``, on the device)
    the scan visits events ``idx[0 .. cnt)`` (the caller's relevance
    compaction; the count stays on the device), else every event. Returns
    ``(state, scal [4] = done, started, overflow, n, buf [R, E + S])``.

    On CUDA one call is one kernel launch of one block
    (``slot_launch_shape``): one warp at S <= 64, each lane owning R =
    ceil(S / 32) slots; more warps of R slots a thread above."""

    name = "slot_nfa_scan"
    source = "flink_siddhi_tpu_torch/csrc/slot_nfa.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._plans: Dict[Tuple, Tuple] = {}

    def plan_buffers(self, plan: SlotScanPlan, dev) -> Tuple:
        """The plan's struct as a host array and on ``dev``, and its aux
        buffer (capture rows' words, programs) on ``dev``, made at its
        first use there (never inside a CUDA graph capture: the first step
        of a plan runs eagerly, warm-up included)."""
        key = (plan, str(dev))
        bufs = self._plans.get(key)
        if bufs is None:
            if _capturing(dev):
                raise RuntimeError(
                    "slot_nfa_scan: the plan is not on the capturing device "
                    "yet; run the captured work once first"
                )
            words, aux = plan.words(), plan.aux()
            bufs = ((ctypes.c_int * len(words))(*words),
                    torch.tensor(words, dtype=torch.int32).to(dev),
                    torch.tensor(aux or [0], dtype=torch.int32).to(dev),
                    len(aux))
            self._plans[key] = bufs
        return bufs

    def __call__(self, plan: SlotScanPlan, state, scal, ts, valid, mword,
                 eword, cols, idx=None, cnt=None):
        if _device_kind(ts, "ts") == "cpu":
            return slot_nfa_scan_plain(plan, state, scal, ts, valid, mword,
                                       eword, cols, idx, cnt)
        dev = ts.device
        E = int(ts.shape[0])
        S = plan.slots
        plan_host, plan_dev, aux, n_aux = self.plan_buffers(plan, dev)
        _check(state, "state", torch.int32, dev, (plan.state_rows, S))
        _check(scal, "scal", torch.int32, dev, (3,))
        _check(ts, "ts", torch.int32, dev, (E,))
        _check(valid, "valid", torch.bool, dev, (E,))
        _check(mword, "mword", torch.int32, dev, (E,))
        _check(eword, "eword", torch.int32, dev, (E,))
        _check(cols, "cols", torch.int32, dev, (plan.n_cols, E))
        if (idx is None) != (cnt is None):
            raise ValueError("slot_nfa_scan: idx and cnt go together")
        if idx is not None:
            _check(idx, "idx", torch.int32, dev, (E,))
            _check(cnt, "cnt", torch.int32, dev, (1,))
        if E >= 2 ** 30:
            raise ValueError(f"slot_nfa_scan: {E} events")
        lib = LIBRARIES.get("slot_nfa")
        state_o = torch.empty_like(state)
        scal_o = torch.empty(4, dtype=torch.int32, device=dev)
        buf = torch.zeros((plan.buf_rows, E + S), dtype=torch.int32,
                          device=dev)
        null = 0
        with _on_device(dev):
            err = lib.fst_slot_nfa_scan(
                ctypes.addressof(plan_host), len(plan_host),
                plan_dev.data_ptr(), aux.data_ptr(), n_aux,
                state.data_ptr(),
                scal.data_ptr(), ts.data_ptr(), valid.data_ptr(),
                mword.data_ptr(), eword.data_ptr(),
                cols.data_ptr() if plan.n_cols else null,
                idx.data_ptr() if idx is not None else null,
                cnt.data_ptr() if cnt is not None else null, E, S,
                state_o.data_ptr(), scal_o.data_ptr(), buf.data_ptr(),
                plan.state_rows, plan.buf_rows, _stream(dev.index),
            )
        _check_launch(self.name, err)
        self.launches += 1
        return state_o, scal_o, buf


slot_nfa_scan = SlotNFAScan()

# --------------------------------------------------------------------------
# K5: the join's pair step
# --------------------------------------------------------------------------

JOIN_TILE = 256  # join_pairs.cu's kThreads: tape positions a tile
JOIN_WARP = 32  # positions a warp takes, candidates a round
JOIN_STAGE = 128  # join_pairs.cu's kStage: pairs a warp stages
JOIN_UNION_WORDS = 6144  # shared-memory words of a tile's union chunk
JOIN_MAX_TILE = 4096  # join_pairs.cu's kMaxTile (the running max)
N_MAX = 2 ** 31 - 1  # a join step's pair count saturates here
# K5's and K6's `on` program stack: a thread's local array (kLocalDepth)
# up to this depth; a deeper program takes a global stack of depth words a
# thread, its grid cut so that the stack holds at most STACK_WORDS words
STACK_LOCAL_DEPTH = 227
STACK_WORDS = 1 << 24


def join_key_hint(prog: Sequence[int]) -> Tuple[int, int]:
    """``(a, b)`` of the first top-level conjunct of the ``on`` program
    ``prog`` that is an int32 equality of event column ``a`` and
    other-side column ``b`` (``EVT a, CAP b, EQ_I`` or ``CAP b, EVT a,
    EQ_I``), else ``(-1, -1)``. K5 tests it before the program: a
    candidate that fails it fails the program."""
    prog = list(prog)
    ops, pc = set(), 0
    while pc < len(prog):  # the opcodes' positions (a literal is data)
        ops.add(pc)
        pc += 2 if prog[pc] & 0xFF == OP_LIT else 1

    def conjuncts(lo: int, hi: int):
        if hi - lo >= 3 and prog[hi - 1] & 0xFF == OP_AND:
            for k in range(lo, hi - 1):
                if (k in ops and prog[k] & 0xFF == OP_ANDJ
                        and prog[k] >> 8 == hi - k - 1):
                    yield from conjuncts(lo, k)
                    yield from conjuncts(k + 1, hi - 1)
                    return
        yield prog[lo:hi]

    for c in conjuncts(0, len(prog)):
        if len(c) == 3 and c[2] == OP_EQ_I:
            kinds = (c[0] & 0xFF, c[1] & 0xFF)
            if kinds == (OP_EVT, OP_CAP):
                return c[0] >> 8, c[1] >> 8
            if kinds == (OP_CAP, OP_EVT):
                return c[1] >> 8, c[0] >> 8
    return -1, -1


def join_union_cap(b_n: int) -> int:
    """Entries of b's buffer that one union chunk holds in shared memory
    (ts, a key word and ``b_n`` program columns each), a multiple of 32."""
    return max(32, JOIN_UNION_WORDS // (2 + b_n) // 32 * 32)


@dataclass
class JoinDir:
    """One direction of a join's pair step: the arriving side ``a`` (its
    events on the tape) against the other side ``b`` (its combined buffer:
    the ring's ``C`` entries, then this batch's b-events compacted in tape
    order). Tensors on one device:

    - ``a_mask`` bool ``[E]``; ``a_cols`` int32 ``[a_n, E]`` (the program's
      event loads, float32 by bit pattern);
    - ``b_ts`` int32, ``b_valid`` bool, ``b_posid`` int32 (tape position,
      -1 for a ring entry) ``[Nb]``; ``b_cum`` int32 ``[E]`` (b-events up
      to and including tape position i, ``b_seen`` included); ``b_seen``
      int32 ``[1]`` (b-events before this batch; entry j is ordinal
      ``seen - C + j``); ``b_cols`` int32 ``[b_n, Nb]`` (the program's
      other loads);

    and the host values: ``prog`` (the linked ``on`` program, event loads
    from ``a_cols``, the other kind from ``b_cols``; empty for no
    condition) and its stack ``depth``; b's window (``mode_time``, ``n``
    the length, ``span`` the time span), ``C`` and whether a's unmatched
    events emit an outer row."""

    a_mask: torch.Tensor
    a_cols: torch.Tensor
    b_ts: torch.Tensor
    b_valid: torch.Tensor
    b_posid: torch.Tensor
    b_cum: torch.Tensor
    b_seen: torch.Tensor
    b_cols: torch.Tensor
    prog: Tuple[int, ...]
    depth: int
    mode_time: bool
    n: int
    span: int
    C: int
    outer: bool


def _join_member(d: JoinDir, ts: torch.Tensor, rows: torch.Tensor,
                 self_join: bool, within: Optional[int]) -> torch.Tensor:
    """The reference's pair mask (join.py:335-379) for tape rows
    ``rows``: bool ``[len(rows), Nb]``."""
    Nb = int(d.b_ts.shape[0])
    dev = ts.device
    base = d.b_seen.reshape(()) - d.C
    ords = base + torch.arange(Nb, dtype=torch.int32, device=dev)
    cum = d.b_cum[rows][:, None]
    ts_i = ts[rows][:, None]
    member = d.b_valid[None, :] & d.a_mask[rows][:, None]
    member = member & (ords[None, :] < cum)
    if self_join:
        member = member & (d.b_posid[None, :] != rows[:, None].to(torch.int32))
    if d.mode_time:
        member = member & (d.b_ts[None, :] > ts_i - d.span)
    else:
        member = member & (ords[None, :] >= cum - d.n)
    if within is not None:
        member = member & (torch.abs(ts_i - d.b_ts[None, :]) <= within)
    if d.prog:
        ok = eval_program(d.prog, lambda c: d.a_cols[c][rows][:, None],
                          lambda c: d.b_cols[c][None, :])
        member = member & (ok != 0)
    return member


def join_pairs_plain(dirs: Sequence[JoinDir], ts: torch.Tensor, cap: int,
                     self_join: bool, within: Optional[int]):
    """The plain version: the reference's dense pair masks per direction
    (l -> r, then r -> l) and its stable compaction, in torch (rows in
    chunks, so the mask never holds more than ``_PLAIN_CHUNK_CELLS`` cells
    at once; the order is the flattened mask's; pairs past ``cap`` are
    counted, not kept). Returns ``(i, j, seg, n)``: int32 ``[cap]`` ranks
    (zeros past ``n``) and ``n`` int32 ``[1]``, the count before the cut
    at ``cap``, saturated at ``N_MAX``."""
    E = int(ts.shape[0])
    dev = ts.device
    segs = []
    n = 0

    def keep(i, j, seg):
        nonlocal n
        if n < cap:
            k = cap - n
            segs.append((i[:k], j[:k], torch.full_like(i[:k], seg)))
        n += int(i.shape[0])

    for di, d in enumerate(dirs):
        Nb = int(d.b_ts.shape[0])
        step = max(1, _PLAIN_CHUNK_CELLS // max(Nb, 1))
        hit = []
        for r0 in range(0, E, step):
            rows = torch.arange(r0, min(r0 + step, E), device=dev)
            member = _join_member(d, ts, rows, self_join, within)
            hit.append(member.any(dim=1))
            if n < cap:
                nz = torch.nonzero(member)
                keep(rows[nz[:, 0]], nz[:, 1], 2 * di)
            else:
                n += int(member.sum())
        if d.outer:
            oi = torch.nonzero(d.a_mask & ~torch.cat(hit))[:, 0]
            keep(oi, torch.zeros_like(oi), 2 * di + 1)
    out = []
    for k in range(3):
        o = torch.zeros(cap, dtype=torch.int32, device=dev)
        if segs:
            v = torch.cat([s[k] for s in segs])
            o[:v.shape[0]] = v.to(torch.int32)
        out.append(o)
    return (*out, torch.tensor([min(n, N_MAX)], dtype=torch.int32,
                               device=dev))


_TABLE_DIR_FIXED: Dict[Tuple[int, int, str], Tuple[torch.Tensor, ...]] = {}


def _table_dir_fixed(E: int, C: int, dev) -> Tuple[torch.Tensor, ...]:
    """A table direction's fixed tensors (``b_ts`` zeros, ``b_posid`` -1,
    ``b_cum`` C at every position, ``b_seen`` C), read only, made once a
    (E, C, device) outside a CUDA graph capture (a tensor made inside one
    is filled only when the graph replays, so it is not kept)."""
    key = (E, C, str(dev))
    got = _TABLE_DIR_FIXED.get(key)
    if got is None:
        got = (torch.zeros(C, dtype=torch.int32, device=dev),
               torch.full((C,), -1, dtype=torch.int32, device=dev),
               torch.full((E,), C, dtype=torch.int32, device=dev),
               torch.full((1,), C, dtype=torch.int32, device=dev))
        if not _capturing(torch.device(dev)):
            _TABLE_DIR_FIXED[key] = got
    return got


def table_join_dir(a_mask: torch.Tensor, a_cols: torch.Tensor,
                   valid: torch.Tensor, b_cols: torch.Tensor,
                   prog: Tuple[int, ...], depth: int,
                   outer: bool) -> JoinDir:
    """A stream-table join as one ``JoinDir``: the stream's events
    (``a_mask``, ``a_cols``) arrive against a table of ``C`` slots
    (``valid`` bool ``[C]``, ``b_cols`` int32 ``[b_n, C]``). The table is
    b's "ring" and nothing arrives in the batch: a length window of ``C``
    with ``C`` events seen before and ``C`` at every position, so every
    valid slot is in every event's window, entry j at ordinal j, and the
    pairs come in (i, j) order with the outer rows after them."""
    E, C = int(a_mask.shape[0]), int(valid.shape[0])
    b_ts, b_posid, b_cum, b_seen = _table_dir_fixed(E, C, a_mask.device)
    return JoinDir(
        a_mask=a_mask, a_cols=a_cols, b_ts=b_ts, b_valid=valid,
        b_posid=b_posid, b_cum=b_cum, b_seen=b_seen, b_cols=b_cols,
        prog=tuple(prog), depth=depth, mode_time=False, n=C, span=0, C=C,
        outer=outer,
    )


class _DirArgs(ctypes.Structure):
    _fields_ = [(f, _P) for f in (
        "a_mask", "a_cols", "b_ts", "b_valid", "b_posid", "b_cum",
        "b_seen", "b_cols", "tsmax", "tmax", "prog")] + [(f, _I) for f in (
            "a_n", "b_n", "Nb", "Cb", "mode_time", "n", "span", "outer",
            "prog_len", "key_a", "key_b")]


class _JoinArgs(ctypes.Structure):
    _fields_ = [("d", _DirArgs * 2)] + [(f, _P) for f in (
        "ts", "tile", "meta", "pool_ctr", "pool", "cnt", "omask", "out_i",
        "out_j", "out_seg", "n_out", "visits", "rewalks", "stack")] + [
            (f, _I) for f in ("E", "cap", "self_join", "has_within",
                              "within", "depth", "ucap", "nt",
                              "pool_cap", "ndirs", "stack_x")]


class JoinPairs:
    """A join's pair step over one micro-batch: ``(i, j, seg, n)`` for the
    directions ``dirs`` (``JoinDir``, l -> r then r -> l; a stream-table
    join has one: ``table_join_dir``), the tape's
    ``ts`` int32 ``[E]``, the cut ``cap``, whether it is a self-join (an
    event never pairs with itself: same tape position) and ``within`` (ms,
    or None). ``seg`` is 0 / 2 for a pair of direction 0 / 1 (``i`` the
    arriving tape position, ``j`` the other side's combined entry), 1 / 3
    for an unmatched outer row (``j`` 0). Ranks past ``n`` are zeros;
    ``n`` saturates at ``N_MAX``.

    On CUDA one call launches the kernel's stages (a time window's
    running max; walk, scan, write) on the current stream, with no host
    read: ``n`` stays on the device.
    ``visits`` (an int64 ``[1]`` CUDA tensor, or None) adds the
    candidates in the arriving events' bands; ``rewalks`` (the same, or
    None) the tiles that walked their candidates again (a warp's pairs
    past its staging, a union of bands past one shared-memory chunk, or
    no room left in the pool)."""

    name = "join_pairs"
    source = "flink_siddhi_tpu_torch/csrc/join_pairs.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._prog = _DeviceInts("join_pairs: the program")

    def __call__(self, dirs: Sequence[JoinDir], ts: torch.Tensor, cap: int,
                 self_join: bool, within: Optional[int], visits=None,
                 rewalks=None):
        if _device_kind(ts, "ts") == "cpu":
            return join_pairs_plain(dirs, ts, cap, self_join, within)
        dev = ts.device
        E = int(ts.shape[0])
        _check(ts, "ts", torch.int32, dev, (E,))
        if len(dirs) not in (1, 2):
            raise ValueError("join_pairs: one or two directions")
        if not 1 <= E < 2 ** 29 or not 1 <= cap < 2 ** 31:
            raise ValueError(f"join_pairs: {E} events, cap {cap}")
        args = _JoinArgs()
        depth = 0
        keep = []
        for k, d in enumerate(dirs):
            Nb = int(d.b_ts.shape[0])
            _check(d.a_mask, "a_mask", torch.bool, dev, (E,))
            _check(d.b_ts, "b_ts", torch.int32, dev, (Nb,))
            _check(d.b_valid, "b_valid", torch.bool, dev, (Nb,))
            _check(d.b_posid, "b_posid", torch.int32, dev, (Nb,))
            _check(d.b_cum, "b_cum", torch.int32, dev, (E,))
            _check(d.b_seen, "b_seen", torch.int32, dev, (1,))
            a_n, b_n = int(d.a_cols.shape[0]), int(d.b_cols.shape[0])
            _check(d.a_cols, "a_cols", torch.int32, dev, (a_n, E))
            _check(d.b_cols, "b_cols", torch.int32, dev, (b_n, Nb))
            if not 1 <= d.C <= Nb:
                raise ValueError(f"join_pairs: ring {d.C} of {Nb} entries")
            prog = self._prog(d.prog, dev)
            keep.append(prog)
            depth = max(depth, d.depth if d.prog else 0)
            a = args.d[k]
            a.a_mask, a.a_cols = d.a_mask.data_ptr(), d.a_cols.data_ptr()
            a.b_ts, a.b_valid = d.b_ts.data_ptr(), d.b_valid.data_ptr()
            a.b_posid, a.b_cum = d.b_posid.data_ptr(), d.b_cum.data_ptr()
            a.b_seen, a.b_cols = d.b_seen.data_ptr(), d.b_cols.data_ptr()
            # the running max of a time window's valid ts (the kernel's
            # scratch: the entries, then the 4,096-entry tiles' maxima)
            tsmax = torch.empty(Nb + -(-Nb // JOIN_MAX_TILE),
                                dtype=torch.int32, device=dev)
            keep.append(tsmax)
            a.tsmax, a.tmax = tsmax.data_ptr(), tsmax[Nb:].data_ptr()
            a.prog = prog.data_ptr()
            a.a_n, a.b_n, a.Nb, a.Cb = a_n, b_n, Nb, d.C
            a.mode_time, a.n, a.span = int(d.mode_time), d.n, d.span
            a.outer, a.prog_len = int(d.outer), len(d.prog)
            a.key_a, a.key_b = join_key_hint(d.prog)
        for v in (visits, rewalks):
            if v is not None:
                _check(v, "visits/rewalks", torch.int64, dev, (1,))
        nt = -(-E // JOIN_TILE)
        S = len(dirs) * nt
        # the kernel's scratch: per tile (S) its sums, then offsets
        # (segment-major), its pool offset and pairs, its warps' outer
        # masks, each event's count (a tile walked again); the pool of
        # staged pairs (ranks below cap: at most cap of them) and its
        # counter
        tile = torch.empty(2 * S, dtype=torch.int64, device=dev)
        meta = torch.empty(2 * S, dtype=torch.int64, device=dev)
        omask = torch.empty(S * (JOIN_TILE // JOIN_WARP),
                            dtype=torch.int32, device=dev)
        cnt = torch.empty(S * JOIN_TILE, dtype=torch.int32, device=dev)
        pool = torch.empty((cap, 2), dtype=torch.int32, device=dev)
        pool_ctr = torch.zeros(1, dtype=torch.int64, device=dev)
        out = [torch.zeros(cap, dtype=torch.int32, device=dev)
               for _ in range(3)]
        n = torch.empty(1, dtype=torch.int32, device=dev)
        args.ts, args.tile, args.meta = (ts.data_ptr(), tile.data_ptr(),
                                         meta.data_ptr())
        args.pool_ctr, args.pool = pool_ctr.data_ptr(), pool.data_ptr()
        args.cnt, args.omask = cnt.data_ptr(), omask.data_ptr()
        args.out_i, args.out_j, args.out_seg = (o.data_ptr() for o in out)
        args.n_out = n.data_ptr()
        args.visits = visits.data_ptr() if visits is not None else 0
        args.rewalks = rewalks.data_ptr() if rewalks is not None else 0
        args.E, args.cap, args.self_join = E, cap, int(self_join)
        args.has_within = int(within is not None)
        args.within = int(within) if within is not None else 0
        args.depth = depth
        args.ucap = join_union_cap(max(int(d.b_cols.shape[0])
                                       for d in dirs))
        args.nt, args.pool_cap, args.ndirs = nt, cap, len(dirs)
        if depth > STACK_LOCAL_DEPTH:
            args.stack_x = max(1, min(nt, STACK_WORDS // (
                depth * len(dirs) * JOIN_TILE)))
            stack = torch.empty(depth * args.stack_x * len(dirs) * JOIN_TILE,
                                dtype=torch.int32, device=dev)
            args.stack = stack.data_ptr()
        with _on_device(dev):
            err = LIBRARIES.get("join_pairs").fst_join_pairs(
                ctypes.addressof(args), _stream(dev.index))
        _check_launch(self.name, err)
        self.launches += 1
        return (*out, n)


join_pairs = JoinPairs()

# --------------------------------------------------------------------------
# K6: the table mutation's match
# --------------------------------------------------------------------------

MUTATE_CHUNK = 2048  # table_mutate.cu's kChunk: tape positions a block
MUTATE_ROWS = 256  # table_mutate.cu's kRows: table rows a block


def table_mutate_plain(mask: torch.Tensor, a_cols: torch.Tensor,
                       valid: torch.Tensor, b_cols: torch.Tensor,
                       prog: Sequence[int], depth: int) -> torch.Tensor:
    """The plain version: the reference's dense (E, C) match (``mask[i] &
    valid[j] & on(i, j)``, ``flink_siddhi_tpu/compiler/table.py:362-408``)
    in row chunks of at most ``_PLAIN_CHUNK_CELLS`` cells, reduced to each
    table row's last matching tape position: int32 ``[C]``, -1 where no
    event matches."""
    E, C = int(mask.shape[0]), int(valid.shape[0])
    dev = mask.device
    last = torch.full((C,), -1, dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_CHUNK_CELLS // max(C, 1))
    for r0 in range(0, E, step):
        rows = torch.arange(r0, min(r0 + step, E), device=dev)
        match = mask[rows][:, None] & valid[None, :]
        if prog:
            ok = eval_program(prog, lambda c: a_cols[c][rows][:, None],
                              lambda c: b_cols[c][None, :])
            match = match & (ok != 0)
        at = torch.where(match, rows[:, None].to(torch.int32), -1)
        last = torch.maximum(last, at.amax(dim=0))
    return last


class _MutateArgs(ctypes.Structure):
    _fields_ = [(f, _P) for f in (
        "mask", "a_cols", "valid", "b_cols", "prog", "last", "visits",
        "stack")] + [
            (f, _I) for f in ("E", "C", "a_n", "b_n", "prog_len", "key_a",
                              "key_b", "depth", "stack_y")]


class TableMutate:
    """K6: each table row's last matching tape position for an update or
    delete, ``last`` int32 ``[C]`` (-1: no event matches). ``mask`` bool
    ``[E]`` (the query's events), ``a_cols`` int32 ``[a_n, E]`` (the
    program's event loads: stream columns and select outputs, float32 by
    bit pattern), ``valid`` bool ``[C]``, ``b_cols`` int32 ``[b_n, C]``
    (the table columns it loads), the linked ``on`` program ``prog`` and
    its stack ``depth``. Row j's candidate i matches when ``mask[i] &
    valid[j]`` and the program is true.

    On CUDA one call fills ``last`` with -1 and launches the kernel on the
    current stream, with no host read; a program deeper than
    ``STACK_LOCAL_DEPTH`` gets a global stack of depth words a thread and
    a grid of at most ``STACK_WORDS`` / depth threads. ``visits`` (an int64 ``[1]``
    CUDA tensor, or None) adds the candidates the kernel walked."""

    name = "table_mutate"
    source = "flink_siddhi_tpu_torch/csrc/table_mutate.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._prog = _DeviceInts("table_mutate: the program")

    def __call__(self, mask, a_cols, valid, b_cols, prog, depth,
                 visits=None) -> torch.Tensor:
        if _device_kind(mask, "mask") == "cpu":
            return table_mutate_plain(mask, a_cols, valid, b_cols, prog,
                                      depth)
        dev = mask.device
        E, C = int(mask.shape[0]), int(valid.shape[0])
        a_n, b_n = int(a_cols.shape[0]), int(b_cols.shape[0])
        _check(mask, "mask", torch.bool, dev, (E,))
        _check(a_cols, "a_cols", torch.int32, dev, (a_n, E))
        _check(valid, "valid", torch.bool, dev, (C,))
        _check(b_cols, "b_cols", torch.int32, dev, (b_n, C))
        if not 1 <= E <= 65535 * MUTATE_CHUNK or not 1 <= C < 2 ** 31:
            raise ValueError(f"table_mutate: {E} events, {C} rows")
        if visits is not None:
            _check(visits, "visits", torch.int64, dev, (1,))
        code = self._prog(prog, dev)
        last = torch.full((C,), -1, dtype=torch.int32, device=dev)
        args = _MutateArgs()
        args.mask, args.a_cols = mask.data_ptr(), a_cols.data_ptr()
        args.valid, args.b_cols = valid.data_ptr(), b_cols.data_ptr()
        args.prog, args.last = code.data_ptr(), last.data_ptr()
        args.visits = visits.data_ptr() if visits is not None else 0
        args.E, args.C, args.a_n, args.b_n = E, C, a_n, b_n
        args.prog_len = len(prog)
        args.key_a, args.key_b = join_key_hint(prog)
        args.depth = depth if prog else 0
        if args.depth > STACK_LOCAL_DEPTH:
            gx = -(-C // MUTATE_ROWS)
            args.stack_y = max(1, min(-(-E // MUTATE_CHUNK), STACK_WORDS // (
                depth * gx * MUTATE_ROWS)))
            stack = torch.empty(depth * gx * args.stack_y * MUTATE_ROWS,
                                dtype=torch.int32, device=dev)
            args.stack = stack.data_ptr()
        with _on_device(dev):
            err = LIBRARIES.get("table_mutate").fst_table_mutate(
                ctypes.addressof(args), _stream(dev.index))
        _check_launch(self.name, err)
        self.launches += 1
        return last


table_mutate = TableMutate()

# --------------------------------------------------------------------------
# K7-K9: the scan windows' per-event loops
# --------------------------------------------------------------------------

_ROW_KINDS = {"count": 0, "sum": 1, "avg": 2, "min": 3, "max": 4}
SCAN_MAX_SHARED = 227 * 1024  # a block's table staged in shared memory up to
SCAN_MAX_ARGS = 1024  # value columns a K8 / K9 call takes (their staging)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts (the reference's ``astype``):
    toward zero, saturating at the int32 range, NaN to 0."""
    return (x.to(torch.float64).nan_to_num(0.0).clamp(_INT_MIN, _INT_MAX)
            .trunc().to(torch.int32))


def _grouped(mask: torch.Tensor, keys: torch.Tensor, n: int):
    """The masked events grouped by ``keys`` (in [0, n)), tape order kept
    within a key: ``(order, starts)``, int64 ``[E]`` and ``[n + 1]`` (key
    k's events are ``order[starts[k]:starts[k + 1]]``; unmasked events sort
    last). A stable sort and a search: no host read."""
    k = torch.where(mask, keys.to(torch.int64), n)
    ks, order = torch.sort(k, stable=True)
    starts = torch.searchsorted(
        ks, torch.arange(n + 1, dtype=torch.int64, device=mask.device))
    return order, starts


def _rounds(mask: torch.Tensor, keys: torch.Tensor, n: int):
    """The plain versions' schedule: the masked events in rounds, round r
    holding the r-th event of every key that has one (so a round's keys
    are distinct and the rounds keep each key's order). Yields ``(events,
    keys)`` int64 index tensors. Reads counts on the host."""
    order, starts = _grouped(mask, keys, n)
    m = int(starts[-1])
    if not m:
        return
    order = order[:m]
    k = torch.where(mask, keys.to(torch.int64), n)[order]
    rank = torch.arange(m, device=mask.device) - starts[k]
    by_rank = torch.sort(rank, stable=True).indices
    off = 0
    for cnt in torch.bincount(rank).tolist():
        sel = by_rank[off:off + cnt]
        off += cnt
        yield order[sel], k[sel]


def _row_plan(slots, A: int, int_cols) -> Tuple[int, ...]:
    """warp_rows.cuh's slot plan: kind[S], arg[S], then per value column 1
    for an int32 column."""
    return (tuple(_ROW_KINDS[k] for k, _ in slots)
            + tuple(a for _, a in slots)
            + tuple(int(a in int_cols) for a in range(A)))


def _check_slots(slots, A: int, int_cols, who: str) -> None:
    if not slots:
        raise ValueError(f"{who}: no aggregate slot")
    for kind, a in slots:
        if kind not in _ROW_KINDS:
            raise ValueError(f"{who}: no {kind!r} aggregate")
        if kind != "count" and not 0 <= a < A:
            raise ValueError(f"{who}: slot column {a} out of range")
    if any(not 0 <= a < A for a in int_cols):
        raise ValueError(f"{who}: int column out of range")
    if A > SCAN_MAX_ARGS:
        raise ValueError(f"{who}: {A} value columns, at most {SCAN_MAX_ARGS}")


def _words(*parts: torch.Tensor) -> torch.Tensor:
    """Rows of 32-bit words (bool as 0/1, float32 by bit pattern) stacked
    along dimension -2."""
    return torch.stack([
        p.to(torch.int32) if p.dtype == torch.bool
        else (p.view(torch.int32) if p.dtype == torch.float32 else p)
        for p in parts], -2).contiguous()


class _SessionArgs(ctypes.Structure):
    _fields_ = [(f, _P) for f in (
        "order", "starts", "ts", "vals", "arg_int", "open", "last", "cnt",
        "s", "mn", "mx", "closes", "c_last", "c_cnt", "c_s", "c_mn",
        "c_mx")] + [(f, _I) for f in ("E", "G", "A", "gap")]


def session_scan_plain(mask, codes, ts, vals, open_, last, cnt, s, mn, mx,
                       gap, int_cols=()):
    """The plain version of ``session_scan``: the reference's per-event
    body (``SessionWindowArtifact.step``) run in rounds of ``_rounds`` (one
    event of every key a round, vectorized over the keys)."""
    E, G, A = int(mask.shape[0]), int(open_.shape[0]), int(vals.shape[0])
    dev = mask.device
    op, la, cn = open_.clone(), last.clone(), cnt.clone()
    s_ = s.clone()
    mn_w, mx_w = mn.view(torch.int32).clone(), mx.view(torch.int32).clone()
    mn_f, mx_f = mn_w.view(torch.float32), mx_w.view(torch.float32)
    closes = torch.zeros(E, dtype=torch.bool, device=dev)
    c_last = torch.zeros(E, dtype=torch.int32, device=dev)
    c_cnt = torch.zeros(E, dtype=torch.int32, device=dev)
    c_s = torch.zeros((A, E), dtype=torch.float32, device=dev)
    c_mn = torch.zeros((A, E), dtype=torch.int32, device=dev)
    c_mx = torch.zeros((A, E), dtype=torch.int32, device=dev)
    for t, c in _rounds(mask, codes.clamp(0, G - 1), G):
        tt, was, lc = ts[t], op[c], la[c]
        shut = was & (_wrap32(tt.long() - lc.long()) > gap)
        tc, cc = t[shut], c[shut]
        closes[tc] = True
        c_last[tc], c_cnt[tc] = la[cc], cn[cc]
        c_s[:, tc], c_mn[:, tc], c_mx[:, tc] = (s_[:, cc], mn_w[:, cc],
                                                mx_w[:, cc])
        fresh = shut | ~was
        op[c] = True
        la[c] = torch.maximum(lc, tt)
        cn[c] = torch.where(fresh, 0, cn[c]) + 1
        v = vals[:, t]
        s_[:, c] = torch.where(fresh, 0.0, s_[:, c]) + v
        for a in range(A):
            if a in int_cols:
                iv = f32_to_i32(v[a])
                mn_w[a, c] = torch.minimum(
                    torch.where(fresh, _INT_MAX, mn_w[a, c]), iv)
                mx_w[a, c] = torch.maximum(
                    torch.where(fresh, _INT_MIN, mx_w[a, c]), iv)
            else:
                mn_f[a, c] = torch.minimum(
                    torch.where(fresh, float("inf"), mn_f[a, c]), v[a])
                mx_f[a, c] = torch.maximum(
                    torch.where(fresh, float("-inf"), mx_f[a, c]), v[a])
    return (op, la, cn, s_, mn_f, mx_f, closes, c_last, c_cnt, c_s,
            c_mn.view(torch.float32), c_mx.view(torch.float32))


class SessionScan:
    """K7: one micro-batch of the session window, per key.

    ``mask`` bool, ``codes`` int32 (the session keys, in [0, G)) and
    ``ts`` int32 ``[E]``; ``vals`` float32 ``[A, E]`` (every argument cast
    to float32); the session table ``open`` bool, ``last`` and ``cnt``
    int32 ``[G]``, ``s`` float32 ``[A, G]``, ``mn`` / ``mx`` float32 ``[A,
    G]`` (an int column's by int32 bit pattern); ``gap`` ms; ``int_cols``
    the int columns. Returns the new table (the same six) and, per event,
    ``closes`` bool ``[E]`` (the event closed its key's open session) with
    that session's ``last``, ``cnt`` (int32 ``[E]``), sums, minima and
    maxima (float32 ``[A, E]``) before the event, zero elsewhere.

    On CUDA one call groups the events by key (a stable sort and a search)
    and launches csrc/session_scan.cu, one thread a key; ``launches``
    counts the calls."""

    name = "session_scan"
    source = "flink_siddhi_tpu_torch/csrc/session_scan.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._consts = _DeviceInts(f"{self.name}: the column types")

    def __call__(self, mask, codes, ts, vals, open_, last, cnt, s, mn, mx,
                 gap, int_cols=()):
        if _device_kind(mask, "mask") == "cpu":
            return session_scan_plain(mask, codes, ts, vals, open_, last,
                                      cnt, s, mn, mx, gap, int_cols)
        dev = mask.device
        E, G, A = int(mask.shape[0]), int(open_.shape[0]), int(vals.shape[0])
        if not 1 <= E < 2 ** 31 or G < 1 or any(
                not 0 <= a < A for a in int_cols):
            raise ValueError(f"session_scan: {E} events, {G} keys, int "
                             f"columns {tuple(int_cols)} of {A}")
        _check(mask, "mask", torch.bool, dev, (E,))
        _check(codes, "codes", torch.int32, dev, (E,))
        _check(ts, "ts", torch.int32, dev, (E,))
        _check(vals, "vals", torch.float32, dev, (A, E))
        _check(open_, "open", torch.bool, dev, (G,))
        for t, what in ((last, "last"), (cnt, "cnt")):
            _check(t, what, torch.int32, dev, (G,))
        for t, what in ((s, "s"), (mn, "mn"), (mx, "mx")):
            _check(t, what, torch.float32, dev, (A, G))
        arg_int = self._consts(
            tuple(int(a in int_cols) for a in range(A)), dev)
        order, starts = _grouped(mask, codes, G)
        st = [t.clone() for t in (open_, last, cnt, s, mn, mx)]
        closes = torch.zeros(E, dtype=torch.bool, device=dev)
        c_last = torch.zeros(E, dtype=torch.int32, device=dev)
        c_cnt = torch.zeros(E, dtype=torch.int32, device=dev)
        c_s, c_mn, c_mx = (torch.zeros((A, E), dtype=torch.float32,
                                       device=dev) for _ in range(3))
        args = _SessionArgs()
        for f, t in zip(
                ("order", "starts", "ts", "vals", "arg_int", "open", "last",
                 "cnt", "s", "mn", "mx", "closes", "c_last", "c_cnt", "c_s",
                 "c_mn", "c_mx"),
                (order, starts, ts, vals, arg_int, *st, closes, c_last,
                 c_cnt, c_s, c_mn, c_mx)):
            setattr(args, f, t.data_ptr())
        args.E, args.G, args.A, args.gap = E, G, A, int(gap)
        with _on_device(dev):
            err = LIBRARIES.get("session_scan").fst_session_scan(
                ctypes.addressof(args), _stream(dev.index))
        _check_launch(self.name, err)
        self.launches += 1
        return (*st, closes, c_last, c_cnt, c_s, c_mn, c_mx)


session_scan = SessionScan()


class _FreqArgs(ctypes.Structure):
    _fields_ = [(f, _P) for f in (
        "mask", "codes", "vals", "plan", "table", "seen", "map", "emit",
        "rows")] + [(f, _I) for f in (
            "E", "C", "A", "S", "K", "lossy", "width")] + [
        ("thresh_factor", ctypes.c_float), ("in_shared", _I),
        ("map_shared", _I)]


def frequency_scan_plain(mask, codes, vals, valid, code, freq, delta, seen,
                         bufs, slots, int_cols, lossy, width, thresh_factor,
                         n_codes):
    """The plain version of ``frequency_scan``: the reference's per-event
    body (``FrequencyWindowArtifact.step``), one masked event at a time,
    vectorized over the table's slots."""
    import numpy as np

    E, C, A = int(mask.shape[0]), int(valid.shape[0]), int(vals.shape[0])
    dev = mask.device
    int_cols = frozenset(int_cols)
    valid, code, freq = valid.clone(), code.clone(), freq.clone()
    delta = delta.clone()
    bw = bufs.view(torch.int32).clone()
    vw = vals.view(torch.int32)
    emit = torch.zeros(E, dtype=torch.bool, device=dev)
    rows = torch.zeros((len(slots), E), dtype=torch.float32, device=dev)
    n = int(seen)
    f32 = np.float32
    tf = f32(thresh_factor)
    for t in torch.nonzero(mask).flatten().tolist():
        c = int(codes[t])
        n = _wrap32(n + 1)
        eq = valid & (code == c)
        hit = bool(eq.any())
        free = ~valid
        slot = (int(eq.to(torch.uint8).argmax()) if hit
                else int(free.to(torch.uint8).argmax()) if bool(free.any())
                else -1)
        if lossy:
            bucket = int(np.ceil(f32(n) / f32(width)))
            if slot < 0:
                slot = int(torch.where(valid, freq + delta, _INT_MAX).argmin())
        if slot >= 0:
            freq[slot] = freq[slot] + 1 if hit else 1
            if lossy and not hit:
                delta[slot] = bucket - 1
            valid[slot], code[slot] = True, c
            bw[:, slot] = vw[:, t]
            if lossy and n % width == 0:
                valid &= freq + delta > bucket
        else:
            freq = torch.clamp(freq - 1, min=0)
            valid &= freq > 0
        member = valid
        ok = slot >= 0
        if lossy:
            thresh = tf * f32(n)
            ok = bool(valid[slot]) and f32(int(freq[slot])) >= thresh
            member = valid & (freq.to(torch.float32) >= float(thresh))
        if ok:
            emit[t] = True
            rows[:, t] = _fold_rows(
                member[None],
                [_typed(bw, a, int_cols)[None] for a in range(A)],
                slots, int_cols)[:, 0]
    seen_out = torch.tensor(n, dtype=torch.int32, device=dev)
    return (valid, code, freq, delta, seen_out, bw.view(torch.float32), emit,
            rows)


class FrequencyScan:
    """K8: one micro-batch of ``#window.frequent`` (``lossy`` False) or
    ``#window.lossyFrequent`` (True).

    ``mask`` bool and ``codes`` int32 ``[E]`` (the keys' codes);
    ``vals`` float32 ``[A, E]`` (an int column by int32 bit pattern); the
    table ``valid`` bool, ``code``, ``freq`` and ``delta`` int32 ``[C]``
    (``delta`` zero for ``frequent``), ``seen`` int32 ``[]``, ``bufs``
    float32 ``[A, C]``; ``slots`` ``(kind, arg)`` per aggregate;
    ``int_cols``; ``width`` (ceil(1 / error)) and ``thresh_factor``
    (float32(support - error)) for lossyFrequent; ``n_codes``, the key
    encoder's size (the lookup map's). Returns the new table (valid, code,
    freq, delta, seen, bufs), ``emit`` bool ``[E]`` and ``rows`` float32
    ``[S, E]`` (each emitting event's aggregates over the members, an int
    column's min and max by int32 bit pattern; zero elsewhere).

    On CUDA one call launches csrc/frequency_scan.cu once, one warp
    walking the batch (no host read): the slots below 32 (C <= 32) or 64
    in the lanes' registers with the rows folded a round of 32 events at a
    time; a table that grows past them (or whose registers' values would
    not fit in shared memory) in shared memory, device memory past it,
    with the code -> slot map beside it when the encoder's ``n_codes`` fit
    (device memory otherwise). ``launches`` counts the calls."""

    name = "frequency_scan"
    source = "flink_siddhi_tpu_torch/csrc/frequency_scan.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._consts = _DeviceInts(f"{self.name}: the slot plan")

    def __call__(self, mask, codes, vals, valid, code, freq, delta, seen,
                 bufs, slots, int_cols, lossy, width, thresh_factor,
                 n_codes):
        if _device_kind(mask, "mask") == "cpu":
            return frequency_scan_plain(
                mask, codes, vals, valid, code, freq, delta, seen, bufs,
                slots, int_cols, lossy, width, thresh_factor, n_codes)
        dev = mask.device
        E, C, A = int(mask.shape[0]), int(valid.shape[0]), int(vals.shape[0])
        S = len(slots)
        _check_slots(slots, A, int_cols, self.name)
        if not 1 <= E < 2 ** 31 or C < 1 or (lossy and width < 1):
            raise ValueError(f"frequency_scan: {E} events, {C} slots, "
                             f"width {width}")
        _check(mask, "mask", torch.bool, dev, (E,))
        _check(codes, "codes", torch.int32, dev, (E,))
        _check(vals, "vals", torch.float32, dev, (A, E))
        _check(valid, "valid", torch.bool, dev, (C,))
        for t, what in ((code, "code"), (freq, "freq"), (delta, "delta")):
            _check(t, what, torch.int32, dev, (C,))
        _check(seen, "seen", torch.int32, dev, ())
        _check(bufs, "bufs", torch.float32, dev, (A, C))
        plan = self._consts(_row_plan(slots, A, int_cols), dev)
        table = _words(valid, code, freq, delta, *bufs)
        seen_out = seen.clone()
        K = max(int(n_codes), 1)
        lib = LIBRARIES.get("frequency_scan")

        def fits(R, in_shared=0, map_shared=0):
            return lib.fst_frequency_smem(
                C, A, S, K, R, in_shared, map_shared) <= SCAN_MAX_SHARED

        # the fast table's tiers: slots [0, 32 R) in registers
        R = next(r for r in ((1 if C <= 32 else 2), 0) if fits(r))
        wide = C > 32 * R
        in_shared = int(wide and fits(R, 1))
        map_shared = int(wide and fits(R, in_shared, 1))
        cmap = (torch.full((K,), _INT_MAX, dtype=torch.int32, device=dev)
                if wide and not map_shared else None)
        emit = torch.zeros(E, dtype=torch.bool, device=dev)
        rows = torch.zeros((S, E), dtype=torch.float32, device=dev)
        args = _FreqArgs()
        for f, t in zip(("mask", "codes", "vals", "plan", "table", "seen",
                         "map", "emit", "rows"),
                        (mask, codes, vals, plan, table, seen_out, cmap, emit,
                         rows)):
            setattr(args, f, None if t is None else t.data_ptr())
        args.E, args.C, args.A, args.S, args.K = E, C, A, S, K
        args.lossy, args.width = int(bool(lossy)), int(width)
        args.thresh_factor = float(thresh_factor)
        args.in_shared, args.map_shared = in_shared, map_shared
        with _on_device(dev):
            err = lib.fst_frequency_scan(ctypes.addressof(args), R,
                                         _stream(dev.index))
        _check_launch(self.name, err)
        self.launches += 1
        return (table[0] != 0, table[1], table[2], table[3], seen_out,
                table[4:].view(torch.float32), emit, rows)


frequency_scan = FrequencyScan()


SORT_CHUNK = 2048  # sort_window.cu's chunks: positions of the grouped order


class _SortArgs(ctypes.Structure):
    _fields_ = [(f, _P) for f in (
        "order", "starts", "part", "keys", "vals", "plan", "buf_in", "buf",
        "rows", "chunks", "flags")] + [
            (f, _I) for f in ("E", "P", "C", "A", "S", "L", "in_shared")]


def sort_window_scan_plain(mask, part, keys, vals, valid, bkey, bufs, slots,
                           int_cols=()):
    """The plain version of ``sort_window_scan``: the reference's
    ``body_sort`` run in rounds of ``_rounds`` (one event of every
    partition a round, vectorized over the partitions)."""
    E, A = int(mask.shape[0]), int(vals.shape[0])
    P, C = int(valid.shape[0]), int(valid.shape[1])
    dev = mask.device
    int_cols = frozenset(int_cols)
    valid, bkey = valid.clone(), bkey.clone()
    bw = bufs.view(torch.int32).clone()
    vw = vals.view(torch.int32)
    rows = torch.zeros((len(slots), E), dtype=torch.float32, device=dev)
    iota = torch.arange(C, device=dev)[None, :]
    for t, p in _rounds(mask, part, P):
        k = keys[t]
        pos = (valid[p] & (bkey[p] < k[:, None])).sum(1)[:, None]
        do = pos < C
        src = torch.where(iota > pos, iota - 1, iota).expand(len(t), C)

        def ins(row, new):
            put = torch.where(iota == pos, new[:, None],
                              torch.gather(row, 1, src))
            return torch.where(do, put, row)

        valid[p] = ins(valid[p], torch.ones_like(k, dtype=torch.bool))
        bkey[p] = ins(bkey[p], k)
        for a in range(A):
            bw[a, p] = ins(bw[a, p], vw[a, t])
        rows[:, t] = _fold_rows(
            valid[p], [_typed(bw, a, int_cols)[p] for a in range(A)], slots,
            int_cols)
    return valid, bkey, bw.view(torch.float32), rows


class SortWindowScan:
    """K9: one micro-batch of ``#window.sort`` with aggregates.

    ``mask`` bool, ``part`` int32 (the partition, in [0, P); zeros when
    unpartitioned) and ``keys`` float32 ``[E]`` (negated for 'desc');
    ``vals`` float32 ``[A, E]`` (an int column by int32 bit pattern); the
    buffers ``valid`` bool and ``bkey`` float32 ``[P, C]``, ``bufs``
    float32 ``[A, P, C]``; ``slots`` and ``int_cols`` as ``frequency_scan``.
    Returns the new buffers (valid, bkey, bufs) and ``rows`` float32 ``[S,
    E]`` (each masked event's aggregates over its partition's valid slots;
    zero elsewhere).

    On CUDA one call groups the events by partition (a stable sort and a
    search) and runs csrc/sort_window.cu. For C <= 32 (a slot a lane) it
    cuts the grouped events into chunks of ``chunk`` positions
    (SORT_CHUNK; a smaller one only to test the chunk boundaries) and
    launches three kernels: each chunk's summary and NaN flags, one warp's
    scan of the carry-ins, then a warp a chunk walking its events (a
    partition flagged for a NaN key walked whole by one warp). For C > 32
    one kernel, a warp a partition. ``launches`` counts the calls."""

    name = "sort_window_scan"
    source = "flink_siddhi_tpu_torch/csrc/sort_window.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._consts = _DeviceInts(f"{self.name}: the slot plan")

    def __call__(self, mask, part, keys, vals, valid, bkey, bufs, slots,
                 int_cols=(), chunk=None):
        if _device_kind(mask, "mask") == "cpu":
            return sort_window_scan_plain(mask, part, keys, vals, valid,
                                          bkey, bufs, slots, int_cols)
        dev = mask.device
        E, A = int(mask.shape[0]), int(vals.shape[0])
        P, C = int(valid.shape[0]), int(valid.shape[1])
        S = len(slots)
        L = SORT_CHUNK if chunk is None else int(chunk)
        _check_slots(slots, A, int_cols, self.name)
        if not 1 <= E < 2 ** 31 or P < 1 or C < 1 or L < 1:
            raise ValueError(f"sort_window_scan: {E} events, {P} x {C}, "
                             f"chunks of {L}")
        _check(mask, "mask", torch.bool, dev, (E,))
        _check(part, "part", torch.int32, dev, (E,))
        _check(keys, "keys", torch.float32, dev, (E,))
        _check(vals, "vals", torch.float32, dev, (A, E))
        _check(valid, "valid", torch.bool, dev, (P, C))
        _check(bkey, "bkey", torch.float32, dev, (P, C))
        _check(bufs, "bufs", torch.float32, dev, (A, P, C))
        plan = self._consts(_row_plan(slots, A, int_cols), dev)
        order, starts = _grouped(mask, part, P)
        buf_in = _words(valid, bkey, *bufs)  # [P, 2 + A, C]
        buf = buf_in.clone()
        rows = torch.zeros((S, E), dtype=torch.float32, device=dev)
        lib = LIBRARIES.get("sort_window")
        chunked = (C <= 32 and lib.fst_sort_window_smem(C, A, S, 1, 0)
                   <= SCAN_MAX_SHARED)
        chunks = flags = None
        if chunked:
            chunks = torch.empty(
                (-(-E // L), lib.fst_sort_window_chunk_words()),
                dtype=torch.int32, device=dev)
            flags = torch.zeros(P, dtype=torch.int32, device=dev)
        args = _SortArgs()
        for f, t in zip(("order", "starts", "part", "keys", "vals", "plan",
                         "buf_in", "buf", "rows", "chunks", "flags"),
                        (order, starts, part, keys, vals, plan, buf_in, buf,
                         rows, chunks, flags)):
            setattr(args, f, None if t is None else t.data_ptr())
        args.E, args.P, args.C, args.A, args.S = E, P, C, A, S
        args.L = L if chunked else 0
        args.in_shared = int(not chunked and lib.fst_sort_window_smem(
            C, A, S, 0, 1) <= SCAN_MAX_SHARED)
        with _on_device(dev):
            err = lib.fst_sort_window(ctypes.addressof(args),
                                      _stream(dev.index))
        _check_launch(self.name, err)
        self.launches += 1
        return (buf[:, 0] != 0, buf[:, 1].contiguous().view(torch.float32),
                buf[:, 2:].permute(1, 0, 2).contiguous().view(torch.float32),
                rows)


sort_window_scan = SortWindowScan()

KERNELS = (multi_reverse_cummin, chain_advance, unique_window_fold,
           slot_nfa_scan, join_pairs, table_mutate, session_scan,
           frequency_scan, sort_window_scan)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
