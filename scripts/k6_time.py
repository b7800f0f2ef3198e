"""The table mutation's match (K6) of one checkout, timed on the tables
path's update shape.

Run from the root of a checkout on a machine with a GPU and nvcc:

    python3 scripts/k6_time.py [CHECKOUT]

It imports the port's package and ``chip_smoke.py`` from CHECKOUT (this
checkout by default: unpack another with ``git archive <commit> | tar -x
-C build/parent``), builds its K6, and times it with CUDA events around
20 back-to-back calls on ``chip_smoke.mutate_inputs``' update shape: a
tape of 524,288 events, a quarter of them the query's, against a table
of 1,024 rows (70% valid) over 10,000 ids, ``T.id == id`` (seed 5).
Prints one JSON line: the ms a call, the median single call, the
candidates walked and a checksum of ``last``, which two checkouts must
share. Compare two checkouts in one call, in turns (A B B A).
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

E, C = 524_288, 1_024


def main():
    if not torch.cuda.is_available():
        print("k6_time: needs a CUDA device", file=sys.stderr)
        return 2
    if not co.__file__.startswith(TREE):
        raise RuntimeError(f"imported {co.__file__}, not {TREE}'s")
    co.build(["table_mutate"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    key = (sp.OP_CAP, sp.OP_EVT, sp.OP_EQ_I)
    args = (*cs.mutate_inputs(E, C, rng, dev, n_ids=10_000, p_mask=0.25),
            key, 2)

    def call():
        return co.table_mutate(*args)

    last = call()
    ms, call_ms = cs.timed_back_to_back(call, 20)
    visits = torch.zeros(1, dtype=torch.int64, device=dev)
    co.table_mutate(*args, visits=visits)
    print(json.dumps({
        "tree": TREE, "device": torch.cuda.get_device_name(0),
        "ms": ms, "call_ms": call_ms, "visits": int(visits[0]),
        "checksum": int(last.double().sum()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
