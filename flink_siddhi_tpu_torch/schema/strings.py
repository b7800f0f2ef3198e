"""Dictionary encoding for STRING/OBJECT attributes.

The device only ever sees int32 codes; the host keeps the code<->value mapping.
Equality predicates on strings compile to integer comparisons against codes
interned at query-compile time, so the hot path never touches Python strings.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np

MISSING_CODE = -1  # code for "constant never seen in this table"


class StringTable:
    """Append-only intern table: value -> stable int32 code."""

    def __init__(self) -> None:
        self._codes: Dict[Any, int] = {}
        self._values: List[Any] = []
        self._values_arr: np.ndarray = None  # cache for values_array()

    def __len__(self) -> int:
        return len(self._values)

    def intern(self, value: Any) -> int:
        try:
            code = self._codes.get(value)
        except TypeError:  # unhashable OBJECT payload: no dedup, append-only
            code = len(self._values)
            self._values.append(value)
            return code
        if code is None:
            code = len(self._values)
            self._codes[value] = code
            self._values.append(value)
        return code

    def intern_many(self, values: Iterable[Any]) -> np.ndarray:
        return np.fromiter(
            (self.intern(v) for v in values), dtype=np.int32
        )

    def lookup(self, value: Any) -> int:
        """Code for a constant; MISSING_CODE if never interned (a predicate
        against it can still become true later — compile-time interning avoids
        that by interning query constants up front)."""
        return self._codes.get(value, MISSING_CODE)

    def value(self, code: int) -> Any:
        if 0 <= code < len(self._values):
            return self._values[code]
        return None

    def decode(self, codes: np.ndarray) -> List[Any]:
        return [self.value(int(c)) for c in codes]

    def values_array(self) -> np.ndarray:
        """The interned values as one object-dtype array, for vectorized
        whole-column decode (``np.take`` in the columnar sink fast lane).
        The table is append-only, so the cache is valid exactly while its
        length matches; a grown table rebuilds it lazily. Rebuild runs on
        the fetch thread while the run loop may be interning: the length
        is snapshotted ONCE and only that prefix is copied (appends are
        atomic under the GIL), so a concurrent intern can never push the
        copy out of bounds — and any code in drained device data was
        interned before its batch dispatched, hence always < n."""
        arr = self._values_arr
        vals = self._values
        n = len(vals)
        if arr is None or len(arr) != n:
            arr = np.empty(n, dtype=object)
            for i in range(n):
                arr[i] = vals[i]
            self._values_arr = arr
        return arr

    # -- checkpoint support -------------------------------------------------
    def state_dict(self) -> dict:
        return {"values": list(self._values)}

    @classmethod
    def from_state_dict(cls, state: dict) -> "StringTable":
        t = cls()
        t.load_state_dict(state)
        return t

    def load_state_dict(self, state: dict) -> None:
        """Restore in place (the shared dictionary object is referenced by
        every schema of an environment, so identity must be preserved)."""
        self._codes.clear()
        self._values.clear()
        self._values_arr = None  # same length != same values after restore
        for v in state["values"]:
            self.intern(v)
