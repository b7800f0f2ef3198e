"""Where the join's pair step (K5) spends a tile, on the card.

Run from the root of a checkout on a machine with a GPU and nvcc:

    python3 scripts/k5_phase_profile.py [VARIANT ...]

(a VARIANT, such as ``kMinBlocks=6,kStage=64``, sets constants of the
copy; each variant is profiled on each shape).

It builds a copy of ``flink_siddhi_tpu_torch/csrc/join_pairs.cu`` with
``clock64()`` markers between the phases of a tile in its walk kernel
(thread 0's view, each after the block's barrier) and the global timer at
a tile's start and end
into ``build/k5/``, puts it in place of the package's library, and runs it
on J1-shaped steps (``chip_smoke.join_inputs``: a tape of 524,288 events,
two interleaved streams, one event a ms; ``s1.id == s2.id`` over 50 ids;
the r -> l direction a 100-event length window, the l -> r one a 100 ms
time window) and on variants of it that take one cost away: both windows
length windows (no binary search), and a program that is always false
(no pairs). For each: the call's ms (CUDA events), the device us of each
kernel (a profiler trace), each phase's mean cycles a tile, the tiles'
mean span and how many ran at once (the sum of their spans over the
kernel's), one JSON line a shape (also written to
``build/k5/phases.json``). The outputs are held to the package kernel's.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from flink_siddhi_tpu_torch.compiler import cuda_ops as co  # noqa: E402
from flink_siddhi_tpu_torch.compiler import slot_program as sp  # noqa: E402

OUT = os.path.join(ROOT, "build", "k5")
E = 524_288
PHASES = ("bands and union", "union load", "walk", "pool room",
          "staged copy")
MAX_TILES = 1 << 14
# (anchor in join_pairs.cu, what the profiled copy puts there)
MARKERS = (
    ("namespace {\n\nusing namespace fst_program;\n",
     "namespace {\n\nusing namespace fst_program;\n"
     f"__device__ long long k5_prof[{MAX_TILES}][8];\n"
     "__device__ __forceinline__ long long gtimer() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const Tile t = tile_layout(smem, p.ucap);\n  long long vis;\n"
     "  const Union u = tile_bands(p, d, t, t0, s_amask, vis);\n"
     "  if (p.visits",
     "  const Tile t = tile_layout(smem, p.ucap);\n  long long vis;\n"
     "  long long pc[6] = {clock64(), 0, 0, 0, 0, 0};\n"
     "  const long long g0 = gtimer();\n"
     "  const Union u = tile_bands(p, d, t, t0, s_amask, vis);\n"
     "  pc[1] = pc[2] = clock64();\n"
     "  if (p.visits"),
    ("    load_chunk(p, d, t, u.u0, u.u1);\n    wcount = walk<kStageMode>",
     "    load_chunk(p, d, t, u.u0, u.u1);\n    pc[2] = clock64();\n"
     "    wcount = walk<kStageMode>"),
    ("  __syncthreads();\n  if (tid == 0) {\n    long long tp = 0, to = 0;",
     "  __syncthreads();\n  pc[3] = clock64();\n"
     "  if (tid == 0) {\n    long long tp = 0, to = 0;"),
    ("  __syncthreads();\n  const long long po = s_pool;\n",
     "  __syncthreads();\n  pc[4] = clock64();\n"
     "  const long long po = s_pool;\n"),
    ("    p.cnt[static_cast<size_t>(seq) * kThreads + tid] = ev_cnt;\n  }\n}",
     "    p.cnt[static_cast<size_t>(seq) * kThreads + tid] = ev_cnt;\n  }\n"
     "  __syncthreads();\n  pc[5] = clock64();\n"
     f"  if (tid == 0 && seq < {MAX_TILES}) {{\n"
     "    for (int k = 0; k < 5; ++k) k5_prof[seq][k] = pc[k + 1] - pc[k];\n"
     "    k5_prof[seq][6] = g0;\n    k5_prof[seq][7] = gtimer();\n  }\n}"),
)
READER = """
extern "C" int fst_k5_prof(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, k5_prof, static_cast<size_t>(n) * 8 * sizeof(long long)));
}
"""


def build(variant=""):
    """The profiled copy as a loaded library (the package's C interface,
    and ``fst_k5_prof`` to read the tiles' records). ``variant``:
    "NAME=VALUE,..." sets the source's ``constexpr int NAME`` in the copy
    (its tile constants, e.g. ``kMinBlocks=6``)."""
    with open(os.path.join(co.CSRC, "join_pairs.cu")) as f:
        src = f.read()
    for anchor, text in MARKERS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"join_pairs.cu changed: no single {anchor!r}")
        src = src.replace(anchor, text)
    for item in filter(None, variant.split(",")):
        name, value = item.split("=")
        src, k = re.subn(rf"constexpr int {name} = [^;]*;",
                         f"constexpr int {name} = {int(value)};", src)
        if k != 1:
            raise RuntimeError(f"join_pairs.cu: no constexpr int {name}")
    tag = variant.replace("=", "").replace(",", "_") or "as_is"
    os.makedirs(OUT, exist_ok=True)
    cu, so = (os.path.join(OUT, f"join_pairs_{tag}.cu"),
              os.path.join(OUT, f"libk5prof_{tag}.so"))
    with open(cu, "w") as f:
        f.write(src + READER)
    subprocess.run([co._nvcc(), *co.NVCC_FLAGS, "-I", str(co.CSRC), "-o",
                    so, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.fst_join_pairs.argtypes = co._ARGTYPES["fst_join_pairs"]
    lib.fst_join_pairs.restype = ctypes.c_int
    lib.fst_k5_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fst_k5_prof.restype = ctypes.c_int
    return lib


def shapes():
    """(name, the call's arguments) of each shape profiled."""
    dev = torch.device("cuda")
    eq = (sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I)
    never = (sp.OP_LIT, 0)
    out = []
    for name, mode_time, prog, depth in (
            ("j1_shaped", True, eq, 2),
            ("length_windows", False, eq, 2),
            ("program_always_false", True, never, 1)):
        rng = np.random.default_rng(5)
        dirs, ts = cs.join_inputs(co, E, 128, rng, dev, mode_time=mode_time,
                                  sorted_ts=True, prog=prog, depth=depth)
        out.append((name, (dirs, ts, 4 * E, False, None)))
    return out


def profile(lib, ref_lib, args):
    """The profiled copy on ``args``: outputs against the package's
    kernel, ms, device us per kernel, cycles a tile per phase, spans."""
    co.LIBRARIES._libs["join_pairs"] = ref_lib
    ref = co.join_pairs(*args)
    v = torch.zeros(1, dtype=torch.int64, device="cuda")
    co.join_pairs(*args, visits=v)
    co.LIBRARIES._libs["join_pairs"] = lib
    got = co.join_pairs(*args)
    exact = all(torch.equal(a, b) for a, b in zip(ref, got))
    ms, call_ms = cs.timed_back_to_back(lambda: co.join_pairs(*args), 10)
    recs = cs.kernel_records(lambda: co.join_pairs(*args), 5)
    torch.cuda.synchronize()
    co.join_pairs(*args)
    torch.cuda.synchronize()
    tiles = 2 * -(-E // co.JOIN_TILE)
    rec = np.zeros((tiles, 8), np.int64)
    err = lib.fst_k5_prof(rec.ctypes.data, tiles)
    if err:
        raise RuntimeError(f"cudaError {err}")
    span = rec[:, 7] - rec[:, 6]
    wall = int(rec[:, 7].max() - rec[:, 6].min())
    return {
        "exact": exact, "pairs": int(ref[3][0]),
        "candidates_visited": int(v[0]),
        "ms": ms, "call_ms": call_ms,
        "kernel_records_and_us_a_call": {k: (n, us / 5)
                                         for k, (n, us) in recs.items()},
        "cycles_a_tile": {k: float(rec[:, i].mean())
                          for i, k in enumerate(PHASES)},
        "cycles_a_tile_by_direction": [
            {k: float(rec[d * tiles // 2:(d + 1) * tiles // 2, i].mean())
             for i, k in enumerate(PHASES)} for d in (0, 1)],
        "walk_cycles_p90": float(np.percentile(rec[:, 2], 90)),
        "tile_span_us_mean": float(span.mean()) / 1e3,
        "pair_kernel_span_us": wall / 1e3,
        "tiles_at_once": float(span.sum()) / max(wall, 1),
        "tiles": tiles,
    }


def main():
    if not torch.cuda.is_available():
        print("k5_phase_profile: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    co.build(["join_pairs"])
    ref_lib = co.LIBRARIES.get("join_pairs")
    variants = sys.argv[1:] or [""]
    libs = {v: build(v) for v in variants}
    out = {}
    try:
        for name, args in shapes():
            for v, lib in libs.items():
                key = f"{name} {v}".strip()
                out[key] = profile(lib, ref_lib, args)
                print(json.dumps({key: out[key]}), flush=True)
    finally:
        co.LIBRARIES._libs["join_pairs"] = ref_lib
    with open(os.path.join(OUT, "phases.json"), "w") as f:
        json.dump(out, f)
    return 0 if all(v["exact"] for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
