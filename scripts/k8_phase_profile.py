"""Where the frequency-window scan (K8) spends an event, on the card.

Run from the root of a checkout on a machine with a GPU and nvcc:

    python3 scripts/k8_phase_profile.py

It builds a copy of ``flink_siddhi_tpu_torch/csrc/frequency_scan.cu`` with
``clock64()`` markers in the walk over the register table (thread 0's
view) into ``build/k8/``, runs it on steps shaped as ``chip_smoke.py``'s
F1 (``frequent(8)``) and F2 (``lossyFrequent(0.015, 0.0015)``, 4,096
slots) take them: 524,288 events, all masked, codes uniform over 50 ids,
a table carried from a first step. It checks the copy's outputs against
the package's kernel, times that kernel (CUDA events) and prints the
cycles an event per phase, one JSON line a shape (also written to
``build/k8/phases.json``).
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
from flink_siddhi_tpu_torch.compiler import cuda_ops as co  # noqa: E402

OUT = os.path.join(ROOT, "build", "k8")
E = 524_288
PHASES = ("staging and each lane's n, bucket, threshold",
          "the slot: code, hit and free ballots, victim",
          "the update and the members' ballot",
          "the round's rows (lane j folds event j) and values")
# (anchor in frequency_scan.cu, what the profiled copy puts there); acc[k]
# sums the cycles of PHASES[k]
MARKERS = (
    ("  for (long long base = 0; base < E; base += 32) {\n",
     "  unsigned long long acc[4] = {0, 0, 0, 0};\n"
     "  for (long long base = 0; base < E; base += 32) {\n"
     "    long long tc = clock64();\n"),
    ("    unsigned todo = bits;\n",
     "    acc[0] += clock64() - tc;\n    unsigned todo = bits;\n"),
    ("        while (todo) {\n          const int j = __ffs(todo) - 1;\n",
     "        while (todo) {\n          long long te = clock64();\n"
     "          const int j = __ffs(todo) - 1;\n"),
    ("          const bool admitted = slot >= 0;  // always for lossyFrequent\n"
     "          unsigned m[RT];\n",
     "          acc[1] += clock64() - te;\n          te = clock64();\n"
     "          const bool admitted = slot >= 0;\n          unsigned m[RT];\n"),
    ("          emit_bits |= static_cast<unsigned>(emit) << j;\n",
     "          emit_bits |= static_cast<unsigned>(emit) << j;\n"
     "          acc[2] += clock64() - te;\n"),
    ("        // the rows of the round's events, then its writes into the values\n",
     "        long long tf = clock64();\n"),
    ("        if (todo) {  // into the wide table, from this event on\n",
     "        acc[3] += clock64() - tf;\n"
     "        if (todo) {\n"),
    ("  if (lane == 0) *p.seen = seen;\n",
     "  if (lane == 0) for (int k = 0; k < 4; ++k) "
     "reinterpret_cast<unsigned long long*>(p.map)[k] = acc[k];\n"
     "  if (lane == 0) *p.seen = seen;\n"),
)


def build():
    """The profiled copy as a ctypes library (the same C interface; its
    cycle counters go to the ``map`` pointer, unused on these shapes)."""
    with open(os.path.join(co.CSRC, "frequency_scan.cu")) as f:
        src = f.read()
    for anchor, text in MARKERS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"frequency_scan.cu changed: no single "
                               f"{anchor!r}")
        src = src.replace(anchor, text)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "frequency_scan_phases.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(OUT, "libk8phases.so")
    subprocess.run([co._nvcc(), *co.NVCC_FLAGS, "-I", str(co.CSRC), "-o", so,
                    path], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    for name in ("fst_frequency_scan", "fst_frequency_smem"):
        fn = getattr(lib, name)
        fn.argtypes = co._ARGTYPES[name]
        fn.restype = co._RESTYPES.get(name, ctypes.c_int)
    return lib


def inputs(rng, C, lossy, support, error, slots, A):
    """F1- or F2-shaped kernel arguments on the card, the table carried
    from the package's kernel over a first step."""
    width = int(np.ceil(1.0 / error)) if lossy else 0
    factor = float(np.float32(support - error)) if lossy else 0.0

    def batch():
        return (torch.ones(E, dtype=torch.bool, device="cuda"),
                torch.from_numpy(rng.integers(0, 50, E).astype(np.int32))
                .cuda(),
                torch.from_numpy((rng.random((A, E)) * 100).astype(
                    np.float32)).cuda())

    state = (torch.zeros(C, dtype=torch.bool),
             torch.full((C,), -1, dtype=torch.int32),
             torch.zeros(C, dtype=torch.int32),
             torch.zeros(C, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32),
             torch.zeros((A, C), dtype=torch.float32))
    tail = (slots, (), lossy, width, factor, 50)
    first = co.frequency_scan(*batch(), *[t.cuda() for t in state],
                              *tail)[:6]
    return (*batch(), *first, *tail)


def profiled_call(lib, args):
    """The profiled copy on ``args``, as the wrapper lays them out (a
    register-table walk: no map). Returns its outputs and the counters."""
    (mask, codes, vals, valid, code, freq, delta, seen, bufs, slots,
     int_cols, lossy, width, factor, n_codes) = args
    C, A, S = int(valid.shape[0]), int(vals.shape[0]), len(slots)
    R = 1 if C <= 32 else 2
    counters = torch.zeros(4, dtype=torch.int64, device="cuda")
    plan = torch.tensor(co._row_plan(slots, A, int_cols), dtype=torch.int32,
                        device="cuda")
    table = co._words(valid, code, freq, delta, *bufs)
    seen_out = seen.clone()
    emit = torch.zeros(E, dtype=torch.bool, device="cuda")
    rows = torch.zeros((S, E), dtype=torch.float32, device="cuda")
    a = co._FreqArgs()
    for f, t in zip(("mask", "codes", "vals", "plan", "table", "seen", "map",
                     "emit", "rows"),
                    (mask, codes, vals, plan, table, seen_out, counters, emit,
                     rows)):
        setattr(a, f, t.data_ptr())
    a.E, a.C, a.A, a.S, a.K = E, C, A, S, max(int(n_codes), 1)
    a.lossy, a.width, a.thresh_factor = int(lossy), int(width), factor
    a.in_shared = a.map_shared = int(C > 32 * R)
    err = lib.fst_frequency_scan(ctypes.addressof(a), R,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"profiled K8: cudaError {err}")
    torch.cuda.synchronize()
    return (table[0] != 0, table[1], table[2], table[3], seen_out,
            table[4:].view(torch.float32), emit, rows), counters.tolist()


def main():
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    co.build(["frequency_scan"])
    lib = build()
    rng = np.random.default_rng(23)
    out = []
    for name, C, lossy, support, error, slots, A in (
            ("F1", 8, False, 0.0, 0.0, [("count", -1), ("sum", 0)], 1),
            ("F2", 4096, True, 0.015, 0.0015, [("count", -1)], 0)):
        args = inputs(rng, C, lossy, support, error, slots, A)
        ref = co.frequency_scan(*args)
        got, acc = profiled_call(lib, args)
        for g, r in zip(got, ref):
            cs.same_bits(g.cpu(), r.cpu(), f"K8 phases {name}")
        ms, _ = cs.timed_back_to_back(lambda: co.frequency_scan(*args), 3)
        n = int(args[0].sum())
        res = {"shape": name, "device": torch.cuda.get_device_name(0),
               "events": n, "kernel_ms": ms, "ns_per_event": ms * 1e6 / n,
               "emitted": int(ref[6].sum()),
               "cycles_per_event": {p: c / n for p, c in zip(PHASES, acc)}}
        print(json.dumps(res), flush=True)
        out.append(res)
    with open(os.path.join(OUT, "phases.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
