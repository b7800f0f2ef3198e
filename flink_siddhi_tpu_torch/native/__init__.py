"""ctypes binding for the native host-side decode library.

The hot host path — newline-delimited JSON / CSV bytes -> columnar numpy
arrays with dictionary-interned strings — runs in C++ (fast_decode.cpp),
built on first use with the in-tree Makefile. Everything degrades to a
pure-Python decoder when no C++ toolchain is available (``available()``
tells you which path you are on).

String-code consistency: query compilation interns string constants into
the Python ``StringTable`` (schema/strings.py) and predicates compare
int32 codes, so the native interner must assign the *same* codes. The
sync protocol keeps a native interner as an exact mirror of its
StringTable: before a decode, any Python-side values the mirror has not
seen are pushed (same order => same codes); after a decode, any values
the native side newly interned are appended to the StringTable (again
same order, so codes match by construction).

The library is built with ``g++`` (the flags of the reference's
``native/Makefile``) into ``build/torch_native/`` beside the package, at
first use, under a name that carries a hash of the source: a changed
source builds anew, and a build writes a temporary file that
``os.replace`` moves into place, so processes building at once each load
a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..schema.strings import StringTable

_LOG = logging.getLogger(__name__)
_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fast_decode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "torch_native")
# the flags of the reference's native/Makefile
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

KIND_INT = 0
KIND_DOUBLE = 1
KIND_STRING = 2
KIND_BOOL = 3

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the library of the current source lives (built or not)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libfastdecode-{digest}.so")


def build() -> float:
    """Compile ``fast_decode.cpp`` unless its library exists; the seconds
    the compile took (0.0 when it was there). Raises when it fails."""
    so = library_path()
    if os.path.exists(so):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    try:
        subprocess.run(
            ["g++", *CXX_FLAGS, _SRC, "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0


def _build() -> bool:
    try:
        build()
        return True
    except Exception as e:  # toolchain missing / build failure
        _LOG.info("native decode build unavailable: %s", e)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(library_path())
        except OSError as e:
            _LOG.info("native decode load failed: %s", e)
            return None
        lib.fd_interner_new.restype = ctypes.c_void_p
        lib.fd_interner_free.argtypes = [ctypes.c_void_p]
        lib.fd_interner_add.restype = ctypes.c_longlong
        lib.fd_interner_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.fd_interner_size.restype = ctypes.c_longlong
        lib.fd_interner_size.argtypes = [ctypes.c_void_p]
        lib.fd_interner_get.restype = ctypes.POINTER(ctypes.c_char)
        lib.fd_interner_get.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.fd_decode_json.restype = ctypes.c_longlong
        lib.fd_decode_csv.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class _InternerMirror:
    """Native interner kept code-identical with a Python StringTable."""

    def __init__(self, lib, table: StringTable) -> None:
        self._lib = lib
        self.table = table
        self.handle = ctypes.c_void_p(lib.fd_interner_new())

    def __del__(self):
        try:
            self._lib.fd_interner_free(self.handle)
        except Exception:
            pass

    def pre_sync(self) -> None:
        """Push python-side values the native mirror hasn't seen."""
        lib = self._lib
        n_native = lib.fd_interner_size(self.handle)
        values = self.table._values
        for i in range(n_native, len(values)):
            v = values[i]
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            code = lib.fd_interner_add(self.handle, b, len(b))
            if code != i:
                raise RuntimeError(
                    f"interner mirror diverged: {code} != {i}"
                )

    def post_sync(self) -> None:
        """Append natively-discovered values to the python table."""
        lib = self._lib
        n_python = len(self.table)
        n_native = lib.fd_interner_size(self.handle)
        ln = ctypes.c_longlong()
        for i in range(n_python, n_native):
            ptr = lib.fd_interner_get(self.handle, i, ctypes.byref(ln))
            b = ctypes.string_at(ptr, ln.value)
            code = self.table.intern(b.decode("utf-8"))
            if code != i:
                raise RuntimeError(
                    f"interner mirror diverged: {code} != {i}"
                )


class ColumnDecoder:
    """Decodes record bytes into columns for a fixed field layout.

    ``fields``: [(name, kind, StringTable-or-None)]. Falls back to a
    pure-Python implementation when the native library is unavailable.
    """

    def __init__(
        self, fields: Sequence[Tuple[str, int, Optional[StringTable]]]
    ) -> None:
        self.fields = list(fields)
        self._lib = _load()
        self._mirrors: List[Optional[_InternerMirror]] = []
        if self._lib is not None:
            for _, kind, table in self.fields:
                if kind == KIND_STRING:
                    if table is None:
                        raise ValueError(
                            "string field requires a StringTable"
                        )
                    self._mirrors.append(_InternerMirror(self._lib, table))
                else:
                    self._mirrors.append(None)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def _alloc(self, max_rows: int):
        outs = []
        for _, kind, _t in self.fields:
            dt = np.float64 if kind == KIND_DOUBLE else np.int64
            outs.append(np.zeros(max_rows, dtype=dt))
        valid = np.zeros(max_rows, dtype=np.uint8)
        return outs, valid

    def _out_ptrs(self, outs):
        arr = (ctypes.c_void_p * len(outs))()
        for i, o in enumerate(outs):
            arr[i] = o.ctypes.data_as(ctypes.c_void_p).value
        return arr

    def _interner_ptrs(self):
        arr = (ctypes.c_void_p * len(self.fields))()
        for i, m in enumerate(self._mirrors):
            arr[i] = m.handle.value if m is not None else None
        return arr

    def decode_json(
        self, data: bytes, max_rows: int
    ) -> Tuple[List[np.ndarray], np.ndarray, int]:
        """(columns, valid, n_rows). Column dtypes: int64 for
        int/bool/string-code fields, float64 for double fields."""
        if self._lib is None:
            return self._decode_json_py(data, max_rows)
        for m in self._mirrors:
            if m is not None:
                m.pre_sync()
        outs, valid = self._alloc(max_rows)
        nf = len(self.fields)
        names = (ctypes.c_char_p * nf)(
            *[f[0].encode("utf-8") for f in self.fields]
        )
        name_lens = (ctypes.c_longlong * nf)(
            *[len(f[0].encode("utf-8")) for f in self.fields]
        )
        kinds = (ctypes.c_int * nf)(*[f[1] for f in self.fields])
        n = self._lib.fd_decode_json(
            data,
            ctypes.c_longlong(len(data)),
            names,
            name_lens,
            kinds,
            nf,
            self._interner_ptrs(),
            ctypes.c_longlong(max_rows),
            self._out_ptrs(outs),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        if n < 0:
            raise RuntimeError("native JSON decode failed")
        for m in self._mirrors:
            if m is not None:
                m.post_sync()
        return [o[:n] for o in outs], valid[:n], int(n)

    def decode_csv(
        self, data: bytes, max_rows: int, delim: str = ","
    ) -> Tuple[List[np.ndarray], np.ndarray, int]:
        if self._lib is None:
            return self._decode_csv_py(data, max_rows, delim)
        for m in self._mirrors:
            if m is not None:
                m.pre_sync()
        outs, valid = self._alloc(max_rows)
        nf = len(self.fields)
        kinds = (ctypes.c_int * nf)(*[f[1] for f in self.fields])
        n = self._lib.fd_decode_csv(
            data,
            ctypes.c_longlong(len(data)),
            kinds,
            nf,
            self._interner_ptrs(),
            ctypes.c_char(delim.encode()),
            ctypes.c_longlong(max_rows),
            self._out_ptrs(outs),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        if n < 0:
            raise RuntimeError("native CSV decode failed")
        for m in self._mirrors:
            if m is not None:
                m.post_sync()
        return [o[:n] for o in outs], valid[:n], int(n)

    # -- pure-Python fallback (same semantics) ---------------------------
    def _decode_json_py(self, data: bytes, max_rows: int):
        outs, valid = self._alloc(max_rows)
        row = 0
        for line in data.split(b"\n"):
            if row >= max_rows:
                break
            if not line.strip():
                continue
            ok = True
            rec = {}
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict):
                    ok = False
            except ValueError:
                ok = False
            for i, (name, kind, table) in enumerate(self.fields):
                v = rec.get(name) if ok else None
                try:
                    outs[i][row] = self._coerce(v, kind, table)
                except (TypeError, ValueError):
                    # type-mismatched value: row invalid, like the native
                    # decoder's failed parse
                    outs[i][row] = self._coerce(None, kind, table)
                    ok = False
            valid[row] = 1 if ok else 0
            row += 1
        return [o[:row] for o in outs], valid[:row], row

    @staticmethod
    def _split_csv_cells(line: str, delim: str, nf: int):
        """Mirror of the native cell walk: a leading double quote wraps a
        cell (embedded delimiters honored, no escape handling)."""
        cells, q, end = [], 0, len(line)
        for _ in range(nf):
            if q < end and line[q] == '"':
                close = line.find('"', q + 1)
                if close < 0:
                    return None  # unterminated quote: malformed
                cells.append(line[q + 1:close])
                q = close + 1
                if q < end and line[q] == delim:
                    q += 1
            else:
                d = line.find(delim, q)
                if d < 0:
                    cells.append(line[q:end])
                    q = end
                else:
                    cells.append(line[q:d])
                    q = d + 1
        return cells

    def _decode_csv_py(self, data: bytes, max_rows: int, delim: str):
        outs, valid = self._alloc(max_rows)
        row = 0
        for line in data.split(b"\n"):
            if row >= max_rows:
                break
            line = line.rstrip(b"\r")
            if not line:
                continue
            cells = self._split_csv_cells(
                line.decode("utf-8"), delim, len(self.fields)
            )
            ok = cells is not None
            for i, (name, kind, table) in enumerate(self.fields):
                cell = cells[i] if ok else None
                try:
                    if kind == KIND_STRING:
                        v = cell
                    elif kind == KIND_DOUBLE:
                        v = float(cell)  # '' / None invalid, like native
                    elif (
                        kind == KIND_BOOL
                        and cell is not None
                        and cell.strip().lower() in ("true", "false")
                    ):
                        # parity with the JSON path (and the native CSV
                        # decoder): bool cells accept the literals, not
                        # just 0/1
                        v = 1 if cell.strip().lower() == "true" else 0
                    else:
                        v = int(cell)
                except (TypeError, ValueError):
                    v, ok = None, False
                outs[i][row] = self._coerce(v, kind, table)
            valid[row] = 1 if ok else 0
            row += 1
        return [o[:row] for o in outs], valid[:row], row

    @staticmethod
    def _coerce(v, kind, table):
        if kind == KIND_STRING:
            return table.intern("" if v is None else str(v))
        if v is None:
            return 0
        if isinstance(v, str):
            # native decoder rejects quoted values for numeric fields
            raise ValueError(f"numeric field got string {v!r}")
        if kind == KIND_DOUBLE:
            return float(v)
        return int(v)
