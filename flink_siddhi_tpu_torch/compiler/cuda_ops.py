"""Hand-written CUDA kernels for the engine's hot scan primitives.

The counterpart of ``flink_siddhi_tpu/compiler/pallas_ops.py`` for an
NVIDIA Hopper card. Three kernels live here, all CUDA C++ under ``csrc/``:

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
  interval-stabbing trees over the event axis).

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
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# kernel name -> its source under csrc/
SOURCES = {
    "reverse_cummin": "reverse_cummin.cu",
    "chain_advance": "chain_advance.cu",
    "unique_fold": "unique_fold.cu",
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
    "fst_unique_fold": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
        _P, _I, _P, _P,
    ],
    "fst_unique_fold_scratch": [
        ctypes.c_longlong, ctypes.c_longlong, _I, _P, _I, _P,
    ],
}


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
    src = (CSRC / SOURCES[name]).read_bytes()
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
            if failed:
                raise KernelBuildError("\n".join(failed))
            for n in todo:
                lib = ctypes.CDLL(str(_lib_path(n)))
                for fn_name, argtypes in _ARGTYPES.items():
                    fn = getattr(lib, fn_name, None)
                    if fn is not None:
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
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


def _fold_rows(valid, bufs, slots):
    """Every aggregate slot over the valid slots of ``[T, C]`` tables:
    ``valid`` bool and ``bufs[a]`` float32. Returns float32 ``[S, T]``
    (the reference's ``ScanWindowArtifact._agg_rows``, per event row)."""
    cnt = valid.sum(1).to(torch.float32)
    sums: Dict[int, torch.Tensor] = {}
    out = []
    for kind, a in slots:
        if kind == "count":
            out.append(cnt)
        elif kind in ("sum", "avg"):
            if a not in sums:
                sums[a] = torch.where(valid, bufs[a], 0.0).sum(1)
            out.append(sums[a] if kind == "sum"
                       else sums[a] / torch.clamp(cnt, min=1.0))
        else:
            ident = float("inf") if kind == "min" else float("-inf")
            masked = torch.where(valid, bufs[a], ident)
            out.append(masked.amin(1) if kind == "min" else masked.amax(1))
    return torch.stack(out)


def unique_window_fold_plain(mask, codes, vals, valid0, bufs0, slots):
    """The plain version, in chunks of events: for T events at a time the
    ``[T, C]`` table of each slot's latest writer in the chunk comes from
    one scatter and a cummax down the chunk; the T table states follow by
    gathers, and masked reductions over C give the T aggregate rows."""
    E = int(mask.shape[0])
    C = int(valid0.shape[0])
    dev = mask.device
    rows = torch.empty((len(slots), E), dtype=torch.float32, device=dev)
    valid, bufs = valid0.clone(), bufs0.clone()
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
        rows[:, t0:t0 + n] = _fold_rows(v_t, b_t, slots)
        valid = v_t[-1].clone()
        for a, b in enumerate(b_t):
            bufs[a] = b[-1]
    return valid, bufs, rows


def _fold_plan(slots) -> list:
    """unique_fold.cu's plan: slot kinds, and the distinct statistics
    ``(op, column)`` the slots read (statistic 0 the count)."""
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
    )


class UniqueWindowFold:
    """Fold a micro-batch into a ``#window.unique`` table, as if in order.

    ``mask`` bool and ``codes`` int32 ``[E]``; ``vals`` float32 ``[A, E]``
    (the events' value columns); ``valid0`` bool ``[C]`` and ``bufs0``
    float32 ``[A, C]`` (the carried table); ``slots``: ``(kind, arg)`` per
    aggregate, kind one of count/sum/avg/min/max (arg -1 for count).
    Event t with ``mask[t]`` sets slot ``clip(codes[t], 0, C - 1)``; then
    every slot is computed over the valid slots. Returns ``(valid bool[C],
    bufs float32[A, C], rows float32[S, E])``.

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

    def __call__(self, mask, codes, vals, valid0, bufs0, slots):
        if _device_kind(mask, "mask") == "cpu":
            return unique_window_fold_plain(mask, codes, vals, valid0,
                                            bufs0, slots)
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
        plan = _fold_plan(slots)
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

KERNELS = (multi_reverse_cummin, chain_advance, unique_window_fold)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
