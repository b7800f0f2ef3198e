"""K9's chunked design (csrc/sort_window.cu, C <= 32), modelled in torch.

The kernel cuts the partitions' grouped events into chunks of L positions
and runs three passes: (a) each chunk's summary (the C least of its last
piece under key ascending, arrival descending, when that piece's partition
goes on past the chunk) and a flag for each partition whose events hold a
NaN key or whose carried buffer is not a sorted prefix of valid slots;
(b) one warp's scan of the chunks, merging the summaries into each chunk's
carry-in; (c) each chunk walked from its carry-in with the skip (a full
buffer without NaN ignores a key above all of its keys), a flagged
partition walked whole from its carried buffer. ``chunk_model`` below
follows the kernel step by step (its ranks, its tags, its flags) on the
CPU; the kernel itself runs only on the card, where chip_smoke.py holds it
to the plain version.

The model must equal ``cuda_ops.sort_window_scan_plain`` bit for bit (the
buffers as stored, the rows too: the model folds each event's buffer with
the plain version's ``_fold_rows``, so no tolerance applies to sums) and,
through the port's plan, the JAX package's ``ScanWindowArtifact`` step
(rows within rtol 1e-5 for float sums, as tests/test_torch_scan_windows.py
holds them; the state as stored), at chunk lengths 1, 2, 7 and 64. Inputs
come from numpy seeds.
"""

import jax
import numpy as np
import pytest
import torch
from torch_windows_common import batches, stream
from test_torch_scan_windows import _rows, _same_state, assert_rows_close

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.tape import build_tape as jax_build_tape

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import cuda_ops, scan_windows
from flink_siddhi_tpu_torch.compiler.plan import state_to_numpy
from flink_siddhi_tpu_torch.runtime.tape import build_tape as torch_build_tape

torch.set_num_threads(2)

CHUNKS = (1, 2, 7, 64)


# -- the model -----------------------------------------------------------------

def chunk_model(mask, part, keys, vals, valid, bkey, bufs, slots,
                int_cols=(), L=2048):
    """sort_window.cu's passes (a)-(c) at chunk length ``L``: returns the
    new (valid, bkey, bufs), the rows and the partitions' flags. A slot is
    (valid, tag): a tag t >= 0 is event t, -1 - s the carried slot s, and
    its key and values follow from the tag."""
    E, A = int(mask.shape[0]), int(vals.shape[0])
    P, C = int(valid.shape[0]), int(valid.shape[1])
    assert C <= 32
    order, starts = cuda_ops._grouped(mask, part, P)
    order, starts = order.tolist(), starts.tolist()
    m = starts[-1]
    ev_key = keys.numpy()
    carried_key = bkey.numpy()
    carried_valid = valid.numpy()
    partof = part.numpy()

    def key(pi, tag):
        return ev_key[tag] if tag >= 0 else carried_key[pi, -1 - tag]

    def carried(pi):
        return [bool(carried_valid[pi, i]) for i in range(C)], \
            [-1 - i for i in range(C)]

    def chunkable(pi):
        v, tg = carried(pi)
        cnt = sum(v)
        if v != [True] * cnt + [False] * (C - cnt):
            return False
        ks = [key(pi, t) for t in tg[:cnt]]
        return not any(np.isnan(ks)) and all(
            a <= b for a, b in zip(ks, ks[1:]))

    def walk(pi, buf, q, qe, snaps=None):
        """Positions [q, qe) of ``order`` into ``buf`` (steps 1-2: the skip,
        then the insertion rule); ``snaps`` takes each event's buffer."""
        v, tg = buf
        for i in range(q, qe):
            t = order[i]
            k = ev_key[t]
            ks = [key(pi, x) for x in tg]
            full = all(v)
            nan = any(np.isnan(ks[s]) for s in range(C) if v[s])
            thr = max((ks[s] for s in range(C) if v[s]), default=-np.inf)
            if not (full and not nan and k > thr):
                pos = sum(1 for s in range(C) if v[s] and ks[s] < k)
                if pos < C:
                    v[pos + 1:] = v[pos:C - 1]
                    tg[pos + 1:] = tg[pos:C - 1]
                    v[pos], tg[pos] = True, t
            if snaps is not None:
                snaps[t] = (pi, list(v), list(tg))
        return v, tg

    def merge(pi, r, summ):
        """R (older) and a summary (newer): the kernel's ranks."""
        rv, rt = r
        sv, st = summ
        ns, nr = sum(sv), sum(rv)
        out = [None] * C
        for i in range(C):
            rank = i + (sum(1 for j in range(ns)
                            if key(pi, st[j]) <= key(pi, rt[i]))
                        if rv[i] else ns)
            if rank < C:
                out[rank] = (rv[i], rt[i])
        for j in range(ns):
            rank = j + sum(1 for i in range(nr)
                           if key(pi, rt[i]) < key(pi, st[j]))
            if rank < C:
                out[rank] = (True, st[j])
        assert None not in out
        return [o[0] for o in out], [o[1] for o in out]

    G = -(-E // L)
    flags = [False] * P
    rec = [dict() for _ in range(G)]
    # (a)
    for g in range(G):
        b0 = g * L
        if b0 >= m:
            continue
        e0, q, head = min(b0 + L, m), b0, None
        while q < e0:
            pi = int(partof[order[q]])
            ps, pa = starts[pi], starts[pi + 1]
            pe = min(pa, e0)
            bad = ps >= b0 and not chunkable(pi)
            bad |= bool(np.isnan(ev_key[order[q:pe]]).any())
            tail_on = pe == e0 and pa > e0
            if tail_on:
                rec[g]["sum"] = walk(pi, ([False] * C, [0] * C), q, pe)
            flags[pi] |= bad
            head = pi if head is None else head
            rec[g].update(tail=pi, tail_on=tail_on)
            q = pe
        rec[g].update(head=head, head_on=starts[head] < b0)
    # (b)
    r = None
    for g in range(-(-m // L)):
        c = rec[g]
        hon = c["head_on"] and not flags[c["head"]]
        ton = c["tail_on"] and not flags[c["tail"]]
        if hon:
            c["carry"] = (list(r[0]), list(r[1]))
        if ton:
            if not (hon and c["head"] == c["tail"]):
                r = carried(c["tail"])
            r = merge(c["tail"], r, c["sum"])
    # (c)
    snaps, final = {}, {}
    for g in range(G):
        b0 = g * L
        if b0 >= m:
            continue
        e0, q = min(b0 + L, m), b0
        while q < e0:
            pi = int(partof[order[q]])
            ps, pa = starts[pi], starts[pi + 1]
            pe = min(pa, e0)
            if flags[pi]:
                if ps >= b0:
                    final[pi] = walk(pi, carried(pi), ps, pa, snaps)
                q = pe
                continue
            buf = carried(pi) if ps >= b0 else rec[g]["carry"]
            buf = walk(pi, (list(buf[0]), list(buf[1])), q, pe, snaps)
            if pe == pa:
                final[pi] = buf
            q = pe
    # the buffers' words and the rows, from the tags
    ew = vals.view(torch.int32)
    cw = bufs.view(torch.int32)

    def words(pis, tags):
        """Value words [A, M, C] of M buffers (their partitions and tags)."""
        pis, tags = torch.tensor(pis), torch.tensor(tags)
        ev = ew[:, tags.clamp(min=0)]
        ca = cw[:, pis[:, None].expand(tags.shape), (-1 - tags).clamp(min=0)]
        return torch.where(tags >= 0, ev, ca)

    out_v, out_k = valid.clone(), bkey.clone()
    out_w = cw.clone()
    for pi, (v, tg) in final.items():
        out_v[pi] = torch.tensor(v)
        out_k[pi] = torch.tensor([key(pi, t) for t in tg],
                                 dtype=torch.float32)
        out_w[:, pi] = words([pi], [tg])[:, 0]
    rows = torch.zeros((len(slots), E), dtype=torch.float32)
    if snaps:
        ts = sorted(snaps)
        sv = torch.tensor([snaps[t][1] for t in ts])
        sw = words([snaps[t][0] for t in ts], [snaps[t][2] for t in ts])
        int_cols = frozenset(int_cols)
        rows[:, ts] = cuda_ops._fold_rows(
            sv, [cuda_ops._typed(sw, a, int_cols) for a in range(A)], slots,
            int_cols)
    return out_v, out_k, out_w.view(torch.float32), rows, flags


# -- the model against the plain version ------------------------------------------

SLOTS2 = [("count", -1), ("sum", 0), ("min", 0), ("max", 0), ("avg", 0),
          ("sum", 1), ("min", 1), ("max", 1)]


def _keys(rng, E, kind):
    if kind == "ties":  # a few values, -0.0 beside 0.0, +-inf
        k = rng.integers(0, 4, E).astype(np.float32)
        k[rng.random(E) < 0.15] = -0.0
        k[rng.random(E) < 0.03] = np.inf
        k[rng.random(E) < 0.03] = -np.inf
        return k
    return np.round(rng.random(E) * 100, 2).astype(np.float32)


def _inputs(seed, E, P, C, n_parts, kind="ties", desc=False, nan_part=None,
            single=None, carry_nan=False):
    """Kernel inputs (2 value columns, column 1 int32 by bit pattern) and a
    carried state from the plain version over a first batch; ``nan_part``
    gets NaN keys, ``single`` exactly one event, ``carry_nan`` a carried
    buffer that held a NaN key."""
    rng = np.random.default_rng(seed)

    def batch(with_nan):
        mask = rng.random(E) < 0.85
        part = rng.integers(0, n_parts, E).astype(np.int32)
        if single is not None:
            part[part == single] = (single + 1) % n_parts
            part[rng.integers(0, E)] = single
            mask[part == single] = True
        keys = _keys(rng, E, kind)
        if desc:
            keys = -keys
        if with_nan is not None:  # its last event's key among them
            where = (part == with_nan) & (rng.random(E) < 0.05)
            where[np.nonzero(mask & (part == with_nan))[0][-1]] = True
            keys[where] = np.nan
        v = np.round(rng.random((2, E)) * 499 + 1, 2).astype(np.float32)
        v[1] = rng.integers(-2 ** 31, 2 ** 31 - 1, E).astype(
            np.int32).view(np.float32)
        return (torch.from_numpy(mask), torch.from_numpy(part),
                torch.from_numpy(keys), torch.from_numpy(v))

    state = (torch.zeros((P, C), dtype=torch.bool),
             torch.zeros((P, C), dtype=torch.float32),
             torch.zeros((2, P, C), dtype=torch.float32))
    first = cuda_ops.sort_window_scan_plain(
        *batch(nan_part if carry_nan else None), *state, SLOTS2, (1,))[:3]
    return (*batch(None if carry_nan else nan_part), *first, SLOTS2, (1,))


CASES = {
    # one partition, heavy ties, -0.0 beside 0.0, +-inf, a full carried
    # buffer
    "one_buffer_ties": dict(seed=1, E=300, P=1, C=10, n_parts=1),
    "one_buffer_desc": dict(seed=2, E=300, P=1, C=7, n_parts=1, desc=True),
    "one_buffer_32": dict(seed=3, E=400, P=1, C=32, n_parts=1),
    "one_slot": dict(seed=4, E=120, P=1, C=1, n_parts=1),
    # 50 partitions (of 64 buffers), one of them a single event
    "fifty_parts": dict(seed=5, E=700, P=64, C=4, n_parts=50, single=17),
    "fifty_parts_distinct": dict(seed=6, E=500, P=50, C=3, n_parts=50,
                                 kind="distinct", desc=True, single=3),
    # a partition with NaN keys, another with a carried NaN buffer
    "nan_partition": dict(seed=7, E=500, P=6, C=5, n_parts=6, nan_part=2),
    "nan_carried": dict(seed=8, E=400, P=4, C=6, n_parts=4, nan_part=1,
                        carry_nan=True),
}


def _same_bits(g, r):
    """Equal as stored (float32 by bit pattern)."""
    if g.dtype == torch.float32:
        g, r = g.view(torch.int32), r.view(torch.int32)
    return torch.equal(g, r)


@pytest.mark.parametrize("L", CHUNKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_model_equals_the_plain_version(case, L):
    """Buffers, keys, value words and rows bit for bit."""
    spec = dict(CASES[case])
    args = _inputs(**spec)
    ref = cuda_ops.sort_window_scan_plain(*args)
    got = chunk_model(*args, L=L)
    for g, r, what in zip(got[:4], ref, ("valid", "bkey", "bufs", "rows")):
        assert _same_bits(g, r), f"{case} L={L}: {what}"
    flags = got[4]
    want = {spec["nan_part"]} if spec.get("nan_part") is not None else set()
    assert {p for p, f in enumerate(flags) if f} == want


def test_a_nan_partition_is_flagged_and_walked_whole():
    """The flag falls on the partition with a NaN key only (and on one
    whose carried buffer holds NaN), at every chunk length: the other
    partitions keep their chunks."""
    for spec in (CASES["nan_partition"], CASES["nan_carried"]):
        args = _inputs(**spec)
        for L in CHUNKS:
            flags = chunk_model(*args, L=L)[4]
            assert [p for p, f in enumerate(flags) if f] == \
                [spec["nan_part"]]
    # NaN-free inputs flag nothing, and the merge then decides each carry
    args = _inputs(**CASES["fifty_parts"])
    assert not any(chunk_model(*args, L=2)[4])


def test_an_unsorted_carried_buffer_is_flagged():
    """A carried buffer that is valid but out of key order (a state the
    serial rule can leave after a NaN key fell out) or has a hole takes
    the serial branch."""
    args = list(_inputs(**CASES["fifty_parts"]))
    valid, bkey = args[4].clone(), args[5].clone()
    valid[0] = True
    bkey[0] = torch.tensor([3.0, 1.0, 2.0, 4.0])
    valid[1] = torch.tensor([True, False, True, False])
    args[4], args[5] = valid, bkey
    ref = cuda_ops.sort_window_scan_plain(*args)
    for L in (2, 64):
        got = chunk_model(*args, L=L)
        assert got[4][0] and got[4][1]
        for g, r in zip(got[:4], ref):
            assert _same_bits(g, r)


# -- through the plans, against the JAX package -------------------------------------

def _ties(d):
    rng = np.random.default_rng(11)
    for b in d:
        n = len(b["price"])
        p = rng.integers(0, 5, n).astype(np.float64)
        p[rng.random(n) < 0.1] = -0.0
        p[rng.random(n) < 0.02] = np.inf
        p[rng.random(n) < 0.02] = -np.inf
        b["price"] = p
    return d


def _single_id(d):  # id 49 appears once
    for b in d:
        b["id"][b["id"] == 49] = 48
    d[1]["id"][100] = 49
    return d


def _nan_id(d):  # NaN prices under id 3 only
    for b in d:
        b["price"][(b["id"] == 3) & (np.arange(len(b["id"])) % 5 == 0)] = \
            np.nan
    return d


BIG_VOL = (lambda rng, m: rng.integers(0, 2 ** 31 - 1, m))
PLANS = {
    "asc_ties": (
        "from S#window.sort(6, price) select count() as c, sum(price) as s,"
        " min(vol) as lo, max(vol) as hi, avg(price) as a insert into out",
        20, None, _ties, ()),
    "desc_ties_int": (
        "from S#window.sort(5, price, 'desc') select min(vol) as lo, "
        "max(vol) as hi, sum(vol) as s, max(price) as m insert into out", 20,
        BIG_VOL, _ties, (2,)),
    "fifty_partitions": (
        "partition with (id of S) begin from S#window.sort(3, price) "
        "select id, min(price) as mn, sum(vol) as v, count() as c "
        "insert into out; end", 50, None, _single_id, (2,)),
    "nan_partition": (
        "partition with (id of S) begin from S#window.sort(4, price) "
        "select id, min(price) as mn, max(price) as mx, count() as c "
        "insert into out; end", 8, None, _nan_id, ()),
}
_JAX = {}


def _jax_steps(case):
    """The JAX plan's rows and states over three tapes of 512 (cached)."""
    if case not in _JAX:
        cql, n_ids, vol, hook, _ = PLANS[case]
        data = hook(stream(1536, 512, n_ids, seed=5, vol=vol))
        jschema, jb = batches("jax", data)
        jplan = jax_compile(cql, {"S": jschema})
        jstep = jax.jit(jplan.step_acc)
        jst, out = jplan.init_state(), []
        for i in range(3):
            jt, _ = jax_build_tape(jplan.spec, [jb[i]], 1000)
            jst, jacc = jstep(jplan.grow_state(jst), jplan.init_acc(), jt)
            out.append((_rows(jplan, jacc["meta"], jacc["buf"]),
                        jax.device_get(jst)["query_0"]))
        _JAX[case] = (data, out)
    return _JAX[case]


@pytest.mark.parametrize("L", CHUNKS)
@pytest.mark.parametrize("case", sorted(PLANS))
def test_the_model_in_the_plan_equals_the_reference(case, L, monkeypatch):
    """The port's plan with the model in place of K9's plain version, step
    by step against the JAX package's plan: rows and the whole state."""
    data, ref = _jax_steps(case)
    cql, *_, int_close = PLANS[case]
    flagged = []

    def model(*args):
        out = chunk_model(*args, L=L)
        flagged.append(any(out[4]))
        return out[:4]

    monkeypatch.setattr(scan_windows, "sort_window_scan", model)
    tschema, tb = batches("torch", data)
    tplan = fpt.compile_plan(cql, {"S": tschema})
    tst = tplan.init_state("cpu")
    for i in range(3):
        tt = torch_build_tape(tplan.spec, [tb[i]], 1000).to(
            torch.device("cpu"))
        tst, tacc = tplan.step_acc(tplan.grow_state(tst),
                                   tplan.init_acc("cpu"), tt)
        rows, state = ref[i]
        assert_rows_close(
            _rows(tplan, tacc["meta"].numpy(), tacc["buf"].numpy()), rows,
            int_close)
        _same_state(state_to_numpy(tst)["query_0"], state, case)
    assert flagged == [case == "nan_partition"] * 3
