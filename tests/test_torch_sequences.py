"""The torch port's slot NFA against the JAX package's on the forms of
tests/test_logical_patterns.py, tests/test_sequence_combos.py and
tests/test_oracle_equivalence.py: 'and'/'or' groups, sequences (strict
continuity) with quantifiers, absence folded into sequences (entry guards),
cross-element filters and indexed captures (``s1[last]``), each CQL string
as written there, over seeded random input through both packages'
``compile_plan`` -> ``Job`` (tests/torch_slot_common.py), the port on the
CPU through the slot scan's plain version. Rows compared exactly: the
timestamps, the ints, the float captures bitwise, and None where an 'or'
member did not fire.
"""

import pytest
import torch

from torch_slot_common import artifact, assert_same_rows, columns

torch.set_num_threads(2)

# tests/test_logical_patterns.py's slot-NFA forms ('and'/'or' groups)
LOGICAL = [
    "from every s1 = S[id == 1] -> "
    "(a = S[id == 2] or b = S[id == 3]) -> s4 = S[id == 4] "
    "select s1.timestamp as t1, s4.timestamp as t4 insert into o",
    "from every s1 = S[id == 1] -> "
    "(a = S[id == 2] and b = S[id == 3]) "
    "select s1.timestamp as t1, a.timestamp as ta, "
    "b.timestamp as tb insert into o",
    "from every (a = S[id == 2] and b = S[id == 3]) -> s4 = S[id == 4] "
    "select a.timestamp as ta, b.timestamp as tb insert into o",
    "from every s1 = S[id == 1] -> (a = S[id == 2] or b = S[id == 3]) "
    "select s1.timestamp as t1, a.timestamp as ta, b.timestamp as tb "
    "insert into o",
]
# tests/test_sequence_combos.py's (the last one reads a second stream T)
SEQUENCE_COMBOS = [
    "from every s1 = S[id == 1] and s2 = S[id == 2], s3 = S[id == 3] "
    "select s1.timestamp as t1, s2.timestamp as t2, "
    "s3.timestamp as t3 insert into m",
    "from every s1 = S[id == 1] or s2 = S[id == 2], s3 = S[id == 3] "
    "select s3.timestamp as t3 insert into m",
    "from every s1 = S[id == 1], not S[price > 50.0], "
    "s3 = S[id == 3] "
    "select s1.timestamp as t1, s3.timestamp as t3 insert into m",
    "from every s1 = S[id == 1], not S[price > 50.0], "
    "not S[price < 10.0], s3 = S[id == 3] "
    "select s1.timestamp as t1, s3.timestamp as t3 insert into m",
    "from every s1 = S[id == 1], not T[id == 7], s3 = S[id == 3] "
    "select s1.timestamp as t1, s3.timestamp as t3 insert into m",
]
# tests/test_oracle_equivalence.py's
ORACLE = [
    "from every s1 = S[id == 1]+ , s2 = S[id == 2] "
    "select s1[0].timestamp as a, s1[last].timestamp as b, "
    "s2.timestamp as c insert into o",
    "from every s1 = S[id == 1] -> "
    "s2 = S[id == 2 and price > s1.price] "
    "select s1.price as p1, s2.price as p2 insert into o",
    "from every s1 = S[id == 1], "
    "s2 = S[id == 2 and price > s1.price] "
    "select s1.price as p1, s2.price as p2 insert into o",
    "from every s1 = S[id == 1]+, s2 = S[price > s1[last].price] "
    "select s1[0].price as first1, s1[last].price as last1, "
    "s2.price as p2 insert into o",
    "from every s1 = S[id == 1], s2 = S[id == 2]?, "
    "s3 = S[id == 3 and price > s2.price] "
    "select s1.price as p1, s3.price as p3 insert into o",
    "from every s1 = S[id == 1], not S[price > 50.0], "
    "s3 = S[id == 3]+ , s4 = S[id == 4] "
    "select s1.timestamp as t1, s3.timestamp as t3, "
    "s4.timestamp as t4 insert into m",
    "from every s1 = S[id == 1], not S[price > 50.0], "
    "s3 = S[id == 3]<2:4> "
    "select s1.timestamp as t1, s3.timestamp as t3 insert into m",
]


def _out(cql):
    return cql.rsplit("insert into ", 1)[1].split()[0]


def _run_cases(cql, n_ids, batch, n_events=1024, seed=41, min_rows=1):
    streams = {"S": columns(n_events, n_ids, seed)}
    if " T[" in cql:
        streams["T"] = columns(n_events // 4, 10, seed + 1, t0=1003,
                               step_ms=80)
    _, jjob, tjob = assert_same_rows(cql, streams, batch, out=_out(cql),
                                     min_rows=min_rows)
    assert type(artifact(tjob)).__name__ == "SlotNFAArtifact"
    assert type(artifact(jjob)).__name__ == "SlotNFAArtifact"


@pytest.mark.parametrize("batch", [7, 128])
@pytest.mark.parametrize("cql", LOGICAL,
                         ids=[f"logical{i}" for i in range(len(LOGICAL))])
def test_logical_forms_match_jax(cql, batch):
    _run_cases(cql, 5, batch, n_events=512, min_rows=10)


@pytest.mark.parametrize("cql", SEQUENCE_COMBOS,
                         ids=[f"combo{i}" for i in range(len(SEQUENCE_COMBOS))])
def test_sequence_combo_forms_match_jax(cql):
    # few ids and a price ramp: strict runs occur, and the absence guards
    # (price > 50, price < 10) hold for some events and not others
    _run_cases(cql, 4, 256, min_rows=5)


@pytest.mark.parametrize("cql", ORACLE,
                         ids=[f"oracle{i}" for i in range(len(ORACLE))])
def test_oracle_forms_match_jax(cql):
    _run_cases(cql, 5, 256, n_events=2048, min_rows=5)


def test_or_member_none_follows_the_emission_order():
    """A sequence ending in an optional element emits on its break at the
    PREVIOUS event's timestamp, so a block's rows are out of time order
    and decode reorders them: the mbits row must be permuted with them, or
    an 'or' member's None lands on another row."""
    cql = (
        "from every s1 = S[id == 1], (a = S[id == 2] or b = S[id == 3]), "
        "c = S[id == 4]* select s1.timestamp as t1, a.price as pa, "
        "b.price as pb, c[last].timestamp as tc insert into o"
    )
    rows, _, _ = assert_same_rows(cql, {"S": columns(2048, 5, seed=43)}, 512,
                                  min_rows=20)
    assert any(r[1] is None for _, r in rows)
    assert any(r[2] is None for _, r in rows)
    ts = [t for t, _ in rows]
    assert ts == sorted(ts)


@pytest.mark.parametrize("batch", [64, 8192], ids=["small", "compacted"])
def test_grouped_every_and_group_match_jax(batch):
    # a grouped every over an 'and' group: one instance in flight, any
    # member order, the completing event not re-arming
    cql = (
        "from every (s1 = S[id == 1] -> (a = S[id == 2] and b = S[id == 3])"
        " -> s4 = S[id == 4]) within 200 milliseconds select "
        "s1.timestamp as t1, a.price as pa, b.price as pb, "
        "s4.timestamp as t4 insert into o"
    )
    assert_same_rows(cql, {"S": columns(2 * 8192, 12, seed=47, step_ms=1)},
                     batch, min_rows=20)
