"""Transactions, access control and session property rules of
presto_tpu_torch on the CPU, each case run through presto_tpu and the
port on fresh sessions over the same memory tables (the cases of
tests/test_security_txn.py's transaction section and its access-control
and property-rule tests).  Rows, the error type and the error text must
be equal, exactly.
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import security as RS
from presto_tpu import transaction as RT
from presto_tpu import types as RTy
from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu.catalog import MemoryTable as RefMemoryTable
from presto_tpu_torch import security as PS
from presto_tpu_torch import statement_queries as SQ
from presto_tpu_torch import transaction as PT
from presto_tpu_torch import types as PTy
from presto_tpu_torch.catalog import Catalog, MemoryTable
from tests.torch_threads import torch_one_thread  # noqa: F401

TABLES = {"t1": {"x": np.arange(10)}, "secret": {"x": np.arange(5)},
          "metrics": {"read": np.arange(5), "write": np.arange(5) * 2}}


def _sessions(**kw):
    """(presto_tpu session, port session) over fresh copies of TABLES."""
    ref, port = RefCatalog(), Catalog()
    for name, cols in TABLES.items():
        ref.register(RefMemoryTable(name, {c: RTy.BIGINT for c in cols},
                                    {c: a.copy() for c, a in cols.items()}))
        port.register(MemoryTable(name, {c: PTy.BIGINT for c in cols},
                                  {c: a.copy() for c, a in cols.items()}))
    return (presto_tpu.connect(ref, **kw),
            presto_tpu_torch.connect(port, device="cpu", **kw))


def _outcome(session, sql):
    """(rows,) or (error type name, message)."""
    try:
        return (session.sql(sql).rows,)
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        return (type(e).__name__, str(e))


def _same(sessions, script):
    """Run `script` in both sessions, statement by statement: every
    outcome equal (SHOW TABLES without presto_tpu's system tables);
    returns the outcomes."""
    ref, port = sessions
    out = []
    for sql in script:
        a, b = _outcome(ref, sql), _outcome(port, sql)
        if sql == "SHOW TABLES" and len(a) == 1:
            a = ([r for r in a[0]
                  if not r[0].startswith(SQ.SYSTEM_TABLE_PREFIXES)],)
        assert a == b, (sql, a, b)
        out.append(b)
    return out


CASES = {
    "rollback_restores_writes": [
        "SELECT sum(x) FROM t1", "START TRANSACTION",
        "INSERT INTO t1 SELECT x FROM t1", "SELECT count(*) FROM t1",
        "ROLLBACK", "SELECT count(*) FROM t1", "SELECT sum(x) FROM t1"],
    "commit_keeps_writes": [
        "START TRANSACTION", "DELETE FROM t1 WHERE x >= 5", "COMMIT",
        "SELECT count(*) FROM t1", "COMMIT"],
    "ddl_rollback": [
        "START TRANSACTION", "CREATE TABLE tx1 AS SELECT 1 AS a",
        "DROP TABLE t1", "SHOW TABLES", "ROLLBACK", "SHOW TABLES",
        "SELECT count(*) FROM t1", "SELECT count(*) FROM tx1"],
    "read_only_blocks_writes": [
        "START TRANSACTION READ ONLY", "SELECT count(*) FROM t1",
        "INSERT INTO t1 SELECT x FROM t1", "DELETE FROM t1",
        "CREATE TABLE t2 (a bigint)", "DROP TABLE t1", "ROLLBACK",
        "SELECT count(*) FROM t1"],
    "words_usable_as_identifiers": [
        "SELECT read, write FROM metrics WHERE read > 2",
        "SELECT 1 AS start"],
    "nested_start_and_stray_ends": [
        "START TRANSACTION", "START TRANSACTION", "COMMIT", "COMMIT",
        "ROLLBACK"],
    "create_table_rollback_and_insert_commit": [
        "START TRANSACTION", "CREATE TABLE t2 (a bigint, b double)",
        "INSERT INTO t2 SELECT x, x * 0.5 FROM t1", "ROLLBACK",
        "SHOW TABLES", "START TRANSACTION",
        "CREATE TABLE t2 (a bigint, b double)",
        "INSERT INTO t2 SELECT x, x * 0.5 FROM t1", "COMMIT",
        "SELECT sum(a), sum(b) FROM t2"],
    "replace_rollback": [
        "CREATE TABLE r AS SELECT x FROM t1 WHERE x < 3",
        "START TRANSACTION",
        "CREATE OR REPLACE TABLE r AS SELECT x * 10 AS y FROM t1",
        "SELECT sum(y) FROM r", "ROLLBACK", "SELECT sum(x) FROM r",
        "CREATE OR REPLACE TABLE r AS SELECT x * 10 AS y FROM t1",
        "SELECT count(*), sum(y) FROM r", "SHOW COLUMNS FROM r"],
    "two_writes_one_preimage": [
        "START TRANSACTION", "INSERT INTO t1 SELECT x FROM t1",
        "DELETE FROM t1 WHERE x < 3", "INSERT INTO t1 SELECT 100",
        "SELECT count(*), sum(x) FROM t1", "ROLLBACK",
        "SELECT count(*), sum(x) FROM t1"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transactions_match_reference(case):
    _same(_sessions(), CASES[case])


def test_errors_are_transaction_errors():
    ref, port = _sessions()
    with pytest.raises(PT.TransactionError, match="no transaction"):
        port.sql("COMMIT")
    with pytest.raises(RT.TransactionError, match="no transaction"):
        ref.sql("COMMIT")
    port.sql("START TRANSACTION READ ONLY")
    with pytest.raises(PT.TransactionError, match="read-only"):
        port.sql("INSERT INTO t1 SELECT x FROM t1")
    assert port.txn.current is not None
    port.sql("ROLLBACK")
    assert port.txn.current is None


def test_rollback_bumps_the_catalog_version():
    """The compiled memo keys on the catalog version: a rollback that
    restores a table's arrays must bump it, or a graph built over the
    written rows would replay."""
    _ref, port = _sessions()
    port.sql("START TRANSACTION")
    port.sql("INSERT INTO t1 SELECT x FROM t1")
    v = port.catalog.version
    assert port.sql("SELECT count(*) FROM t1").rows == [(20,)]
    port.sql("ROLLBACK")
    assert port.catalog.version > v
    assert port.sql("SELECT count(*) FROM t1").rows == [(10,)]


# ---------------------------------------------------------------------------
# access control and session property rules
# ---------------------------------------------------------------------------

RULES = {"tables": [
    {"user": "etl.*", "table": "t1",
     "privileges": ["SELECT", "INSERT", "DELETE", "OWNERSHIP"]},
    {"user": "etl.*", "table": "tmp_.*", "privileges": ["OWNERSHIP"]},
    {"table": "t1", "privileges": ["SELECT"]}]}

ACCESS_SCRIPT = [
    "SELECT count(*) FROM t1", "SELECT count(*) FROM secret",
    "SELECT count(*) FROM t1 JOIN secret ON t1.x = secret.x",
    "SELECT count(*) FROM t1 WHERE x IN (SELECT x FROM secret)",
    "INSERT INTO t1 SELECT x FROM t1", "DELETE FROM t1 WHERE x > 7",
    "CREATE TABLE tmp_a AS SELECT x FROM t1", "CREATE TABLE b (a bigint)",
    "CREATE TABLE tmp_b (a bigint)", "DROP TABLE t1", "DROP TABLE secret",
    "EXPLAIN SELECT * FROM secret", "SET SESSION task_concurrency = 2",
    "SELECT count(*) FROM t1"]


@pytest.mark.parametrize("user", ["etl_1", "analyst"])
def test_file_based_access_control_matches_reference(user):
    ref, port = _sessions()
    ref.user = port.user = user
    ref.access_control = RS.FileBasedAccessControl(RULES)
    port.access_control = PS.FileBasedAccessControl(RULES)
    outcomes = _same((ref, port), ACCESS_SCRIPT)
    denied = [o for o in outcomes if o[0] == "AccessDeniedError"]
    assert denied  # each user meets at least one denial
    with pytest.raises(PS.AccessDeniedError, match="Access Denied"):
        port.sql("SELECT * FROM secret")


def test_property_rules_match_reference():
    rules = [{"user": "etl.*", "sessionProperties": {
                 "task_concurrency": 4, "hash_partition_count": 3}},
             {"source": "cli", "sessionProperties": {
                 "task_concurrency": 7}},
             {"user": "nobody", "sessionProperties": {
                 "hash_partition_count": 99}}]
    for user, source in (("etl_a", "cli"), ("etl_a", "embedded"),
                         ("bob", "cli"), ("bob", "x")):
        assert PS.SessionPropertyManager(rules).overrides(user, source) \
            == RS.SessionPropertyManager(rules).overrides(user, source)
    ref, port = _sessions(hash_partition_count=5)
    for s, mgr in ((ref, RS), (port, PS)):
        s.user, s.source = "etl_a", "cli"
        s.property_manager = mgr.SessionPropertyManager(rules)
        s.set("optimizer_enabled", True)
        s.apply_property_manager()
    # compiled_cache_max_bytes is the port's own property (its memo)
    assert ref.properties == {k: v for k, v in port.properties.items()
                              if k != "compiled_cache_max_bytes"}
    # explicit values outrank the rules
    assert port.properties["hash_partition_count"] == 5
    assert port.properties["task_concurrency"] == 7
