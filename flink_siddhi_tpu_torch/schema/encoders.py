"""Dense group-key encoding for group-by state tables.

Aggregation state on device is a dense table indexed by group code; arbitrary
group-by key values (ints, floats, multi-column tuples) are interned on the
host into stable dense codes, the same trick dictionary-coded strings use
(schema/strings.py). The reference keeps per-group aggregation state in JVM
hash maps inside siddhi-core; a dense code + fixed table is the TPU shape of
that state (SURVEY.md §7 hard part 1: data-dependent structures -> fixed
buffers).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


class GroupEncoder:
    """Append-only intern table over tuples of column values."""

    def __init__(self) -> None:
        self._codes: Dict[Tuple, int] = {}
        self._values: List[Tuple] = []

    def __len__(self) -> int:
        return len(self._values)

    def intern_rows(
        self, cols: Sequence[np.ndarray], select: np.ndarray
    ) -> np.ndarray:
        """Codes for each row of ``zip(*cols)``; rows where ``select`` is
        False get code 0 and are NOT interned (they belong to other streams
        and must not grow the table)."""
        n = len(select)
        out = np.zeros(n, dtype=np.int32)
        if not n:
            return out
        codes = self._codes
        values = self._values
        if len(cols) == 1 and cols[0].dtype != object:
            # vectorized single-column path: unique once (distinct group
            # count, not row count), Python only per NEW group — the
            # per-row loop below would dominate the host at bench batch
            # sizes (~500k rows/batch)
            col = cols[0]
            sel_vals = col[select]
            if not len(sel_vals):
                return out
            uniq = np.unique(sel_vals)
            ucodes = np.empty(len(uniq), dtype=np.int32)
            for u_i, u in enumerate(uniq.tolist()):
                key = (u,)
                code = codes.get(key)
                if code is None:
                    code = len(values)
                    codes[key] = code
                    values.append(key)
                ucodes[u_i] = code
            out[select] = ucodes[
                np.searchsorted(uniq, sel_vals)
            ]
            return out
        idx = np.nonzero(select)[0]
        for i in idx:
            key = tuple(c[i].item() for c in cols)
            code = codes.get(key)
            if code is None:
                code = len(values)
                codes[key] = code
                values.append(key)
            out[i] = code
        return out

    def value(self, code: int) -> Tuple:
        return self._values[code]

    # -- checkpoint support -------------------------------------------------
    def state_dict(self) -> dict:
        return {"values": list(self._values)}

    def load_state_dict(self, d: dict) -> None:
        self._values = [tuple(v) for v in d["values"]]
        self._codes = {v: i for i, v in enumerate(self._values)}
