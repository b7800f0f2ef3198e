"""The join's pair step (K5) of one checkout, timed on a J1-shaped step.

Run from the root of a checkout on a machine with a GPU and nvcc:

    python3 scripts/k5_time.py [CHECKOUT]

It imports the port's package and ``chip_smoke.py`` from CHECKOUT (this
checkout by default: unpack another with ``git archive <commit> | tar -x
-C build/parent``), builds its K5, and times it with CUDA events around
20 back-to-back calls on ``chip_smoke.join_inputs``' J1-shaped step: a
tape of 524,288 events of two interleaved streams, one event a ms, the
l -> r direction against a 100 ms time window, the r -> l one against a
100-event length window, ``s1.id == s2.id`` over 50 ids (seed 5). Prints
one JSON line: the ms a call, the median single call, the candidates in
the bands, the pairs, and a checksum of the outputs, which two checkouts
must share. Compare two checkouts in one call, in turns (A B B A).
"""

import json
import os
import sys

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
sys.path.insert(0, TREE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from flink_siddhi_tpu_torch.compiler import cuda_ops as co  # noqa: E402
from flink_siddhi_tpu_torch.compiler import slot_program as sp  # noqa: E402

E = 524_288


def main():
    if not torch.cuda.is_available():
        print("k5_time: needs a CUDA device", file=sys.stderr)
        return 2
    if not co.__file__.startswith(TREE):
        raise RuntimeError(f"imported {co.__file__}, not {TREE}'s")
    co.build(["join_pairs"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    eq = (sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I)
    dirs, ts = cs.join_inputs(co, E, 128, rng, dev, mode_time=True,
                              sorted_ts=True, prog=eq, depth=2)
    cap = 4 * E

    def call():
        return co.join_pairs(dirs, ts, cap, False, None)

    res = call()
    ms, call_ms = cs.timed_back_to_back(call, 20)
    visits = torch.zeros(1, dtype=torch.int64, device=dev)
    co.join_pairs(dirs, ts, cap, False, None, visits=visits)
    print(json.dumps({
        "tree": TREE, "device": torch.cuda.get_device_name(0),
        "ms": ms, "call_ms": call_ms, "visits": int(visits[0]),
        "n": int(res[3][0]),
        "checksum": [int(x.double().sum()) for x in res[:3]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
