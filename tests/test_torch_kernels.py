"""The torch port's kernels, held against the JAX package (CPU lane).

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there). Here, on the CPU, every wrapper
takes its plain PyTorch version, and these tests hold that plain version —
the kernel's specification in the port — to the JAX package's own CPU
path: ``lax.cummin(..., reverse=True)`` and the numpy oracle for the
reverse cummin, ``pallas_ops._ref_chain_advance`` for the chain advance,
and ``nfa._chain_core(..., use_pallas=False)`` for the whole chain core.
Inputs are made with numpy from a seed and handed to both packages. Every
comparison is exact: the data is int32 and bool, and captures copy float32
values without arithmetic. The unique-window fold's plain version is held
to the literal per-event fold of ``pallas_ops._warmup_fold``'s probe: the
table, counts, minima and maxima exactly, sums and averages within
``np.allclose``'s defaults (float32 sums added in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler import nfa as jnfa
from flink_siddhi_tpu.compiler import pallas_ops
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

from flink_siddhi_tpu_torch.compiler import cuda_ops
from flink_siddhi_tpu_torch.compiler import nfa as tnfa
from flink_siddhi_tpu_torch.compiler.plan import compile_plan as torch_compile
from flink_siddhi_tpu_torch.schema.stream_schema import (
    StreamSchema as TorchSchema,
)

torch.set_num_threads(2)

_FIELDS = [("id", "int"), ("price", "double"), ("timestamp", "long")]


# --------------------------------------------------------------------------
# K1: multi-channel reverse cummin
# --------------------------------------------------------------------------

@pytest.mark.parametrize("E", [1, 7, 1000, 4099])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_reverse_cummin_plain_matches_lax_and_numpy(C, E):
    rng = np.random.default_rng(C * 10_007 + E)
    x = rng.integers(0, 2 ** 30, (C, E)).astype(np.int32)
    got = cuda_ops.multi_reverse_cummin(torch.from_numpy(x))
    assert got.dtype == torch.int32
    ref_np = np.minimum.accumulate(x[:, ::-1], axis=1)[:, ::-1]
    ref_lax = np.stack(
        [np.asarray(jax.lax.cummin(jnp.asarray(r), axis=0, reverse=True))
         for r in x]
    )
    assert np.array_equal(got.numpy(), ref_np)
    assert np.array_equal(got.numpy(), ref_lax)


@pytest.mark.parametrize("E", [1, 7, 1000, 4099])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_reverse_cummin_pad_matches_lax(C, E):
    # pad=E appends the "no match" column the chain core reads at E
    rng = np.random.default_rng(C * 7_919 + E)
    x = rng.integers(0, E + 1, (C, E)).astype(np.int32)
    got = cuda_ops.multi_reverse_cummin(torch.from_numpy(x), pad=E)
    ref = np.stack(
        [np.append(np.asarray(jax.lax.cummin(jnp.asarray(r), axis=0,
                                             reverse=True)), E)
         for r in x]
    )
    assert got.dtype == torch.int32 and tuple(got.shape) == (C, E + 1)
    assert np.array_equal(got.numpy(), ref)


def test_reverse_cummin_plain_full_int32_range():
    # the CUDA kernel's identity is INT_MAX; the plain version must be
    # exact over the whole int32 range too (no 2**30 clamp)
    x = np.array([[2 ** 31 - 1, -(2 ** 31), 5, 2 ** 31 - 2]], np.int32)
    got = cuda_ops.reverse_cummin_plain(torch.from_numpy(x)).numpy()
    assert got.tolist() == [[-(2 ** 31), -(2 ** 31), 5, 2 ** 31 - 2]]


@pytest.mark.parametrize("C,E,tile,words", [
    (1, 1, 1024, 2),  # the ticket word and one tile
    (3, 0, 4096, 4),  # no events: still one tile a channel
    (2, 2048, 2048, 3),
    (2, 2049, 2048, 5),
    (2, 65_536, 2048, 65),
    (8, 1 << 24, 1024, 1 + 8 * 16_384),
])
def test_cummin_scratch_words(C, E, tile, words):
    assert cuda_ops.cummin_scratch_words(C, E, tile) == words


@pytest.mark.parametrize("E,ld", [(0, 4), (3, 4), (4, 8), (1023, 1024),
                                  (65_536, 65_540)])
def test_padded_stride_keeps_rows_16_byte_aligned(E, ld):
    assert cuda_ops.padded_stride(E) == ld
    assert ld >= E + 1 and ld % 4 == 0


def test_lookback_scratch_epoch_wrap_zeroes_exactly_once():
    # the kernel advances the epoch in the buffer's ticket word once a
    # call; the host mirrors it in ``used`` and zeroes the buffer once
    # before the epoch would pass the limit
    sc = cuda_ops.LookbackScratch(epoch_limit=3)
    dev = torch.device("cpu")
    epochs = []
    for _ in range(3):
        buf = sc.take(dev, 0, 10)
        epochs.append(buf.reserve(1))
    assert epochs == [1, 2, 3] and int(buf.words.abs().sum()) == 0
    buf.words.fill_(7)  # states the calls of epochs 1-3 left behind
    again = sc.take(dev, 0, 10)
    assert again is buf and again.reserve(1) == 1
    assert int(buf.words.abs().sum()) == 0
    buf.words.fill_(7)
    for want in (2, 3):
        again = sc.take(dev, 0, 10)
        assert again is buf and again.reserve(1) == want
        assert bool((buf.words == 7).all()), "zeroed again before the wrap"
    # a graph replay reserves all its calls at once: 3 + 2 > 3 zeroes
    assert buf.reserve(2) == 2 and int(buf.words.abs().sum()) == 0
    with pytest.raises(ValueError):
        buf.reserve(4)


def test_lookback_scratch_grows_and_is_kept_per_stream():
    sc = cuda_ops.LookbackScratch()
    dev = torch.device("cpu")
    a = sc.take(dev, 0, 10)
    assert a.reserve(1) == 1
    b = sc.take(dev, 0, 4)  # smaller: the same buffer, next epoch
    assert b is a and b.reserve(1) == 2
    c = sc.take(dev, 0, 11)  # larger: a new zeroed buffer
    assert c is not a and c.words.numel() >= 11 and c.reserve(1) == 1
    assert a.used == 2  # the old buffer keeps its own count
    d = sc.take(dev, 1, 4)  # another stream: its own buffer
    assert d is not c and d.reserve(1) == 1
    assert sc.take(dev, 0, 4) is c and c.reserve(1) == 2
    assert set(sc.buffers()) == {c, d}


def test_chain_plan_is_cached_per_layout():
    p1 = cuda_ops.chain_plan((0, 1), ((), ()), True)
    assert cuda_ops.chain_plan((0, 1), ((), ()), True) is p1
    p2 = cuda_ops.chain_plan((0, 1), ((), (2,)), True)
    p3 = cuda_ops.chain_plan((0, 1), ((), ()), False)
    assert p2 is not p1 and list(p2) != list(p1)
    assert p3 is not p1 and list(p3) != list(p1)
    # [n_steps, has_within, pos_row.., g_begin.., g_row..]
    assert list(p1) == [2, 1, 0, 1, 0, 0, 0]
    assert list(p2) == [2, 1, 0, 1, 0, 0, 1, 2]


def test_chain_plan_lays_out_each_steps_guards():
    # step k's guards are g_row[g_begin[k-1] : g_begin[k]], in step order
    pos_rows = (0, 1, 2, 3)
    guard_rows = ((9, 8), (7,), (), (6, 5, 4))
    plan = list(cuda_ops.chain_plan(pos_rows, guard_rows, False))
    n = len(pos_rows)
    assert plan[:2 + n] == [n, 0, 0, 1, 2, 3]
    g_begin, g_row = plan[2 + n:3 + 2 * n], plan[3 + 2 * n:]
    assert g_begin == [0, 2, 3, 3, 6]
    assert [g_row[g_begin[k]:g_begin[k + 1]] for k in range(n)] == \
        [list(g) for g in guard_rows]


# --------------------------------------------------------------------------
# K2: chain advance
# --------------------------------------------------------------------------

def _next_match_rows(rng, n_rows, E, density):
    """Next-match tables as the chain core builds them: reverse cummin of
    where(pred, position, E), padded with E."""
    rows = []
    for _ in range(n_rows):
        hits = rng.random(E) < density
        idx = np.where(hits, np.arange(E, dtype=np.int32), E).astype(np.int32)
        row = np.full(E + 1, E, np.int32)
        row[:E] = np.minimum.accumulate(idx[::-1])[::-1]
        rows.append(row)
    return np.stack(rows)


# (positive element ids, guards per positive step, within or None)
_ADVANCE_CASES = {
    "k2": ((0, 1), ((), ()), None),
    "k2_within": ((0, 1), ((), ()), 300),
    "k3": ((0, 1, 2), ((), (), ()), None),
    "k3_guard_within": ((0, 1, 3), ((), (), (2,)), 1 << 12),
    "k3_guards_first_step": ((0, 2, 3), ((), (1,), ()), None),
    "k4_two_guards_within": ((0, 1, 3, 5), ((), (), (2,), (4, 6)), 900),
}


@pytest.mark.parametrize("case", sorted(_ADVANCE_CASES))
def test_chain_advance_plain_matches_numpy_oracle(case):
    positive, guards, within = _ADVANCE_CASES[case]
    rng = np.random.default_rng(len(case) * 31 + len(positive))
    E, P = 1500, 64
    V = P + E
    K = len(positive)
    n_el = max(positive + tuple(g for gs in guards for g in gs)) + 1
    table = _next_match_rows(rng, n_el, E, 0.08)
    tsp = np.concatenate(
        [np.sort(rng.integers(0, 1 << 13, E)).astype(np.int32),
         np.zeros(1, np.int32)]
    )
    act = rng.random(V) < 0.6
    step = rng.integers(1, K, V).astype(np.int32)
    pos = rng.integers(0, E + 1, V).astype(np.int32)
    pos[:40] = E  # candidates whose search already ran off the batch
    start = rng.integers(0, 1 << 13, V).astype(np.int32)
    ref = pallas_ops._ref_chain_advance(
        positive, guards, within is not None,
        {e: table[e] for e in range(n_el)}, tsp, act, step, pos, start,
        np.int32(within or 0),
    )
    # the port addresses table rows by index; here row e is element e
    got = cuda_ops.chain_advance(
        torch.from_numpy(table),
        list(positive[1:]),
        [list(guards[k]) for k in range(1, K)],
        torch.from_numpy(tsp), torch.from_numpy(act),
        torch.from_numpy(step), torch.from_numpy(pos),
        torch.from_numpy(start), within,
    )
    for g, r, name in zip(got, ref, ("act", "step", "pos", "jmat")):
        assert np.array_equal(g.numpy(), np.asarray(r)), name


# --------------------------------------------------------------------------
# The chain core: port vs JAX (use_pallas=False), same preds/state/ts
# --------------------------------------------------------------------------

_CORE_CASES = {
    "every_within": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2] -> s3 = S[id == 3] "
        "within 400 milliseconds "
        "select s1.timestamp as t1, s3.price as p insert into out"
    ),
    "non_every": (
        "from s1 = S[id == 1] -> s2 = S[id == 2] "
        "select s1.price as p1, s2.timestamp as t2 insert into out"
    ),
    "mid_chain_absence": (
        "from every s1 = S[id == 1] -> not S[id == 4] -> s2 = S[id == 2] "
        "select s1.price as p1, s2.price as p2 insert into out"
    ),
    "timed_absence": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2] -> "
        "not S[id == 4] for 300 milliseconds "
        "select s1.price as p1, s2.timestamp as t2 insert into out"
    ),
    "timed_absence_non_every": (
        "from s1 = S[id == 1] -> not S[id == 4] for 200 milliseconds "
        "select s1.price as p1 insert into out"
    ),
    # R = 8 scan rows (4 positive targets, 4 guards), the most K1 takes
    # on the TPU
    "wide_eight_scan_rows": (
        "from every s1 = S[id == 1] -> not S[id == 6] -> s2 = S[id == 2] "
        "-> not S[id == 6] -> s3 = S[id == 3] -> not S[id == 6] -> "
        "s4 = S[id == 4] -> not S[id == 6] -> s5 = S[id == 5] "
        "within 2 sec "
        "select s1.timestamp as t1, s5.price as p insert into out"
    ),
}
# per case: (events, id probabilities: noise 0, positives 1.., absent last)
_CORE_DATA = {
    "wide_eight_scan_rows": (1500, [0.2, 0.15, 0.15, 0.15, 0.15, 0.15, 0.05]),
}
_CORE_DATA_DEFAULT = (700, [0.4, 0.2, 0.2, 0.18, 0.02])


def _artifacts(cql):
    ja = jax_compile(cql, {"S": JaxSchema(_FIELDS)}).artifacts[0]
    ta = torch_compile(cql, {"S": TorchSchema(_FIELDS)}).artifacts[0]
    return ja, ta


@pytest.mark.parametrize("case", sorted(_CORE_CASES))
def test_chain_core_matches_jax(case):
    ja, ta = _artifacts(_CORE_CASES[case])
    jcfg, tcfg = jnfa._ChainCfg.of(ja.spec), tnfa._ChainCfg.of(ta.spec)
    assert (jcfg.K, jcfg.positive, jcfg.guards, jcfg.t_guard, jcfg.pairs) \
        == (tcfg.K, tcfg.positive, tcfg.guards, tcfg.t_guard, tcfg.pairs)
    rng = np.random.default_rng(sorted(_CORE_CASES).index(case))
    E, probs = _CORE_DATA.get(case, _CORE_DATA_DEFAULT)
    P = 32
    K = jcfg.K
    n_el = ja.spec.n_elements
    ts = np.sort(rng.integers(0, 3000, E)).astype(np.int32)
    valid = np.ones(E, bool)
    valid[-25:] = False  # a padded tail, as the tape has
    ts[-25:] = ts[-26]
    # positive elements match ids 1, 2, ... in order; absent elements match
    # the rare last id, so some partials survive their guards
    ids = rng.choice(len(probs), E, p=probs)
    el_id, nxt_id = [], 1
    for el in ja.spec.elements:
        el_id.append(len(probs) - 1 if el.negated else nxt_id)
        nxt_id += 0 if el.negated else 1
    preds = np.stack([(ids == el_id[e]) & valid for e in range(n_el)])
    # carried pool: live partials at every positive step (timed absence
    # also carries partials waiting at step K)
    top = K + 1 if jcfg.t_guard is not None else K
    state = {
        "enabled": np.asarray(True),
        "active": rng.random(P) < 0.7,
        "step": rng.integers(1, max(top, 2), P).astype(np.int32),
        "start": rng.integers(0, 200, P).astype(np.int32),
        "done": np.asarray(False),
        "overflow": np.asarray(3, np.int32),
    }
    if jcfg.t_guard is not None:
        state["emit_ts"] = rng.integers(0, 400, P).astype(np.int32)
    srcs = {}
    for pair, dt in zip(jcfg.pairs, jcfg.cap_dtypes):
        if np.dtype(dt) == np.float32:
            state[f"cap:{pair[0]}:{pair[1]}"] = (
                rng.random(P) * 100).astype(np.float32)
            srcs[pair] = (rng.random(E) * 100).astype(np.float32)
        else:
            state[f"cap:{pair[0]}:{pair[1]}"] = rng.integers(
                0, 5000, P).astype(np.int32)
            srcs[pair] = rng.integers(0, 5000, E).astype(np.int32)
    within = ja.spec.within or 0
    tfor = ja._tfor_ms() or 0

    jout = jnfa._chain_core(
        jcfg, P, {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(preds), {k: jnp.asarray(v) for k, v in srcs.items()},
        jnp.int32(within), jnp.asarray(ts), jnp.asarray(valid),
        use_pallas=False, tfor_val=jnp.int32(tfor),
    )
    tout = tnfa._chain_core(
        tcfg, P, {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
        torch.from_numpy(preds),
        {k: torch.from_numpy(v) for k, v in srcs.items()},
        within, torch.from_numpy(ts), torch.from_numpy(valid),
        tfor_val=tfor,
    )
    jst, jcomplete, jemit, jcaps = jout
    tst, tcomplete, temit, tcaps = tout
    assert set(jst) == set(tst)
    for k in jst:
        assert np.array_equal(np.asarray(jst[k]), tst[k].numpy()), k
    assert np.asarray(jcomplete).any(), "case produced no completion"
    assert np.array_equal(np.asarray(jcomplete), tcomplete.numpy())
    assert np.array_equal(np.asarray(jemit), temit.numpy())
    for pair in jcaps:
        assert np.array_equal(
            np.asarray(jcaps[pair]), tcaps[pair].numpy()
        ), pair


def test_non_every_winner_takes_the_first_of_tied_minima():
    # several completions share the earliest start AND the earliest
    # completion ts: both frameworks' argmin pick the first index
    ja, ta = _artifacts(_CORE_CASES["non_every"])
    jcfg, tcfg = jnfa._ChainCfg.of(ja.spec), tnfa._ChainCfg.of(ta.spec)
    E, P = 16, 4
    ts = np.zeros(E, np.int32)  # every event at the same instant
    valid = np.ones(E, bool)
    ids = np.array([1, 1, 2, 2] * 4)
    preds = np.stack([ids == 1, ids == 2])
    state = {
        "enabled": np.asarray(True), "active": np.zeros(P, bool),
        "step": np.ones(P, np.int32), "start": np.zeros(P, np.int32),
        "done": np.asarray(False), "overflow": np.asarray(0, np.int32),
        "cap:0:price": np.zeros(P, np.float32),
        "cap:1:timestamp": np.zeros(P, np.int32),
    }
    srcs = {(0, "price"): np.arange(E, dtype=np.float32),
            (1, "timestamp"): np.arange(E, dtype=np.int32)}
    jst, jc, je, jcaps = jnfa._chain_core(
        jcfg, P, {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(preds), {k: jnp.asarray(v) for k, v in srcs.items()},
        jnp.int32(0), jnp.asarray(ts), jnp.asarray(valid),
    )
    tst, tc, te, tcaps = tnfa._chain_core(
        tcfg, P, {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
        torch.from_numpy(preds),
        {k: torch.from_numpy(v) for k, v in srcs.items()},
        0, torch.from_numpy(ts), torch.from_numpy(valid),
    )
    assert int(np.asarray(jc).sum()) == 1
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert bool(tst["done"]) and bool(np.asarray(jst["done"]))


# --------------------------------------------------------------------------
# K3: unique-window fold
# --------------------------------------------------------------------------

_FOLD_SLOTS = [("count", -1), ("sum", 0), ("avg", 0), ("min", 1),
               ("max", 1), ("sum", 1)]


def _literal_fold(mask, codes, vals, valid0, bufs0, slots):
    """The per-event fold, literally (pallas_ops._warmup_fold's oracle,
    with a carried-in table and any slot list)."""
    C = len(valid0)
    valid, bufs = valid0.copy(), bufs0.copy()
    rows = np.zeros((len(slots), len(mask)), np.float32)
    for t in range(len(mask)):
        if mask[t]:
            c = min(max(int(codes[t]), 0), C - 1)
            valid[c] = True
            bufs[:, c] = vals[:, t]
        cnt = np.float32(valid.sum())
        for s, (kind, a) in enumerate(slots):
            if kind == "count":
                rows[s, t] = cnt
            elif kind in ("sum", "avg"):
                v = np.float32(np.where(valid, bufs[a], 0).sum())
                rows[s, t] = v if kind == "sum" else v / max(cnt, 1)
            elif kind == "min":
                rows[s, t] = np.where(valid, bufs[a], np.inf).min()
            else:
                rows[s, t] = np.where(valid, bufs[a], -np.inf).max()
    return valid, bufs, rows


def _non_finite(vals, bufs0, valid0, kind, rng):
    """Non-finite values in the batch and the carried table: ``nan``,
    ``inf`` (+inf only), ``inf_ninf`` (+inf and -inf in one column, often
    valid at once) or ``nan_overwritten`` (a NaN that later events of its
    slot overwrite)."""
    E = vals.shape[1]
    r = rng.random(E)
    if kind == "nan":
        vals[1, r < 0.01] = np.nan
        bufs0[1, np.flatnonzero(valid0)[:2]] = np.nan
    elif kind == "inf":
        vals[0, r < 0.01] = np.inf
    elif kind == "inf_ninf":
        vals[0, r < 0.01] = np.inf
        vals[0, (r >= 0.01) & (r < 0.02)] = -np.inf
        bufs0[0, np.flatnonzero(valid0)[:1]] = -np.inf
    elif kind == "nan_overwritten":
        vals[:, :5] = np.nan
    return vals, bufs0


@pytest.mark.parametrize("E,C,chunk_cells,values", [
    # a single event
    pytest.param(1, 128, 1 << 22, None, id="1-128-4194304"),
    # E not a multiple of 1024, one chunk
    pytest.param(3001, 128, 1 << 22, None, id="3001-128-4194304"),
    # C not a power of two, 32-event chunks
    pytest.param(2500, 1000, 1 << 15, None, id="2500-1000-32768"),
    # non-finite values: they last only while their slot holds them
    pytest.param(3001, 128, 1 << 22, "nan", id="nan"),
    pytest.param(2500, 100, 1 << 14, "inf", id="inf"),
    pytest.param(3001, 128, 1 << 22, "inf_ninf", id="inf_and_ninf"),
    pytest.param(2500, 60, 1 << 13, "nan_overwritten",
                 id="nan_overwritten"),
])
def test_unique_window_fold_plain_matches_literal_fold(E, C, chunk_cells,
                                                       values, monkeypatch):
    monkeypatch.setattr(cuda_ops, "_PLAIN_CHUNK_CELLS", chunk_cells)
    rng = np.random.default_rng(E + C)
    mask = rng.random(E) < 0.7
    # codes past the table clip to its last slot, as in the reference
    codes = rng.integers(-2, C + 3, E).astype(np.int32)
    vals = np.stack([rng.random(E) * 100, rng.random(E) * 10]).astype(
        np.float32)
    valid0 = rng.random(C) < 0.3  # a carried, non-empty table
    bufs0 = np.where(valid0, rng.random((2, C)) * 50, 0).astype(np.float32)
    if values is not None:
        vals, bufs0 = _non_finite(vals, bufs0, valid0, values, rng)
    ref = _literal_fold(mask, codes, vals, valid0, bufs0, _FOLD_SLOTS)
    got = cuda_ops.unique_window_fold(
        torch.from_numpy(mask), torch.from_numpy(codes),
        torch.from_numpy(vals), torch.from_numpy(valid0),
        torch.from_numpy(bufs0), _FOLD_SLOTS,
    )
    assert np.array_equal(got[0].numpy(), ref[0])
    assert np.array_equal(got[1].numpy(), ref[1], equal_nan=True)
    rows, ref_rows = got[2].numpy(), ref[2]
    exact = [s for s, (k, _) in enumerate(_FOLD_SLOTS)
             if k in ("count", "min", "max")]
    close = [s for s in range(len(_FOLD_SLOTS)) if s not in exact]
    assert np.array_equal(rows[exact], ref_rows[exact], equal_nan=True)
    assert np.allclose(rows[close], ref_rows[close], equal_nan=True)
    if values is not None:
        # the non-finite values reach a row, and leave it again
        bad = ~np.isfinite(ref_rows)
        assert any(b.any() and not b[np.argmax(b):].all() for b in bad)
    assert cuda_ops.unique_window_fold.launches == 0


def test_unique_window_fold_plain_count_only_empty_table():
    # A = 0 (count() alone) from an empty table; masked events add nothing
    mask = np.array([False, True, True, False, True])
    codes = np.array([3, 3, 0, 1, 3], np.int32)
    got = cuda_ops.unique_window_fold_plain(
        torch.from_numpy(mask), torch.from_numpy(codes),
        torch.zeros((0, 5)), torch.zeros(128, dtype=torch.bool),
        torch.zeros((0, 128)), [("count", -1)],
    )
    assert got[2].tolist() == [[0.0, 1.0, 2.0, 2.0, 2.0]]
    assert got[0].nonzero().flatten().tolist() == [0, 3]


def test_unique_fold_plan_dedups_statistics():
    # avg and sum of one column share a statistic; the count is statistic 0
    plan = cuda_ops._fold_plan([("avg", 1), ("sum", 1), ("count", -1),
                                ("min", 0)])
    n_slots, n_stats = plan[:2]
    assert (n_slots, n_stats) == (4, 3)
    assert plan[2:6] == [2, 1, 0, 3]  # slot kinds
    assert plan[6:10] == [1, 1, 0, 2]  # statistic of each slot
    assert plan[10:13] == [0, 1, 2] and plan[13:16] == [-1, 1, 0]
