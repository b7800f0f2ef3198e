"""Where the slot NFA scan (K4) spends an event, on the card.

Run from the root of a checkout on a machine with a GPU and nvcc:

    python3 scripts/k4_phase_profile.py

It builds a copy of ``flink_siddhi_tpu_torch/csrc/slot_nfa.cu`` with
``clock64()`` markers between the phases of an event (thread 0's view) into
``build/k4/``, runs it on the third step of each of ``chip_smoke.py``'s
slot queries over the bench stream (S = 64: one warp, two slots a lane),
checks its outputs against the package's kernel, and prints the cycles an
event per phase, one JSON line a query (also written to
``build/k4/phases.json``).
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import flink_siddhi_tpu_torch as fpt  # noqa: E402
from flink_siddhi_tpu_torch.compiler import cuda_ops as co, nfa  # noqa: E402

OUT = os.path.join(ROOT, "build", "k4")
PHASES = ("tile loads and column staging", "idle skip and broadcast",
          "transition", "ranks (ballots)", "emission and captures",
          "forks", "arming and commit")
# (anchor in slot_nfa.cu, what the profiled copy puts there); acc[k] sums
# the cycles of PHASES[k]
MARKERS = (
    ("  for (int base = 0; base < n_ev; base += kTile) {\n",
     "  unsigned long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  for (int base = 0; base < n_ev; base += kTile) {\n"
     "    long long tc = clock64();\n"),
    ("    const int nin = min(kTile, n_ev - base);\n",
     "    const int nin = min(kTile, n_ev - base);\n"
     "    acc[0] += clock64() - tc; tc = clock64();\n"),
    ("          started = started && done;\n          break;\n",
     "          started = started && done;\n"
     "          acc[1] += clock64() - tc; tc = clock64();\n          break;\n"),
    ("      const int* ev = ct + j;  // column c of the event: ev[c * kTile]\n",
     "      const int* ev = ct + j;\n"
     "      acc[1] += clock64() - tc; tc = clock64();\n"),
    ("      // -- the pool-wide ranks, in slot order ---",
     "      acc[2] += clock64() - tc; tc = clock64();\n      // ---"),
    ("      // -- each slot's own captures, then emissions in slot order ---",
     "      acc[3] += clock64() - tc; tc = clock64();\n      // ---"),
    ("      n0 = min(n0 + n_emit, M);\n",
     "      n0 = min(n0 + n_emit, M);\n"
     "      acc[4] += clock64() - tc; tc = clock64();\n"),
    ("      // -- arming into the lowest free slot ---",
     "      acc[5] += clock64() - tc; tc = clock64();\n      // ---"),
    ("                          o.idxv};\n      }\n    }\n",
     "                          o.idxv};\n      }\n"
     "      acc[6] += clock64() - tc; tc = clock64();\n    }\n"),
    ("  if (tid == 0) {\n    scal_out[0]",
     "  if (tid == 0) for (int k = 0; k < 8; ++k) "
     "reinterpret_cast<unsigned long long*>(scal_out + 4)[k] = acc[k];\n"
     "  if (tid == 0) {\n    scal_out[0]"),
)


def build():
    """The profiled copy as a ctypes function (same C interface; it also
    writes its 8 cycle counters past the 4 scalars of ``scal_out``)."""
    with open(os.path.join(co.CSRC, "slot_nfa.cu")) as f:
        src = f.read()
    for anchor, text in MARKERS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"slot_nfa.cu changed: no single {anchor!r}")
        src = src.replace(anchor, text)
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "slot_nfa_prof.cu"), os.path.join(
        OUT, "libprof.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([co._nvcc(), *co.NVCC_FLAGS, "-o", so, cu], check=True)
    fn = ctypes.CDLL(so).fst_slot_nfa_scan
    fn.argtypes = co._ARGTYPES["fst_slot_nfa_scan"]
    fn.restype = ctypes.c_int
    return fn


def third_step(cql, schema, batches):
    """K4's arguments at the third step of a streaming Job over
    ``batches`` (bench settings)."""
    rec = cs.Recorder(co.slot_nfa_scan, keep=3)
    nfa.slot_nfa_scan = rec
    try:
        cs.run_job(fpt, cql, schema, batches, "cuda",
                   config=cs.bench_config(fpt))
    finally:
        nfa.slot_nfa_scan = co.slot_nfa_scan
    return rec.args


def profile(fn, args):
    """One call of the profiled copy: ms, events visited, cycles an event
    per phase, and whether its outputs equal the package kernel's."""
    plan, state, scal, ts, valid, mword, eword, cols, idx, cnt = args
    E, S = int(ts.shape[0]), plan.slots
    host, dev, aux, n_aux = co.slot_nfa_scan.plan_buffers(plan, ts.device)
    state_o = torch.empty_like(state)
    scal_o = torch.zeros(4 + 16, dtype=torch.int32, device=ts.device)
    buf = torch.zeros((plan.buf_rows, E + S), dtype=torch.int32,
                      device=ts.device)

    def call():
        err = fn(ctypes.addressof(host), len(host), dev.data_ptr(),
                 aux.data_ptr(), n_aux, state.data_ptr(), scal.data_ptr(), ts.data_ptr(),
                 valid.data_ptr(), mword.data_ptr(), eword.data_ptr(),
                 cols.data_ptr() if plan.n_cols else 0,
                 idx.data_ptr() if idx is not None else 0,
                 cnt.data_ptr() if cnt is not None else 0, E, S,
                 state_o.data_ptr(), scal_o.data_ptr(), buf.data_ptr(),
                 plan.state_rows, plan.buf_rows,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")

    call()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    call()
    b.record()
    b.synchronize()
    n = int(cnt[0]) if cnt is not None else E
    cycles = scal_o[4:].cpu().numpy().view(np.uint64)[:len(PHASES)]
    ref = co.slot_nfa_scan(*args)
    return {
        "ms": a.elapsed_time(b),
        "events": n,
        "exact": all(torch.equal(x, y) for x, y in
                     zip(ref, (state_o, scal_o[:4], buf))),
        "cycles_per_event": {k: float(c) / n
                             for k, c in zip(PHASES, cycles)},
        "total_cycles_per_event": float(cycles.sum()) / n,
    }


def main():
    if not torch.cuda.is_available():
        print("k4_phase_profile: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    fn = build()
    co.build()
    schema, batches = cs.bench_stream(fpt, cs.BATCH * 3, cs.BATCH)
    out = {}
    for name, cql in cs.SLOT_QUERIES:
        out[name] = profile(fn, third_step(cql, schema, batches))
        print(json.dumps({name: out[name]}), flush=True)
    with open(os.path.join(OUT, "phases.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
