"""Transaction manager: autocommit and explicit transactions with
rollback (reference: presto_tpu/transaction.py; TransactionManager and
the access-mode checks of TransactionAccessControl).

START TRANSACTION [READ ONLY] / COMMIT / ROLLBACK; every other statement
autocommits.  Isolation is snapshot by undo: the first write to a table
inside a transaction records a copy of its host arrays (a memory
table's pre-image), and ROLLBACK replays the undo records in reverse.
The reference's second snapshot kind, a staged file sink's manifest,
waits for the file connectors; a table with no pre-image rejects
transactional writes, as the reference's connectors without transaction
support do.
"""

from __future__ import annotations

from typing import List, Optional


class TransactionError(Exception):
    pass


class Transaction:
    def __init__(self, read_only: bool = False):
        self.read_only = read_only
        self.undo: List[tuple] = []  # (kind, payload) in apply order
        self._snapshotted: set = set()


class TransactionManager:
    """One manager a session."""

    def __init__(self, session):
        self.session = session
        self.current: Optional[Transaction] = None

    # ---- statement surface ------------------------------------------
    def begin(self, read_only: bool = False) -> None:
        if self.current is not None:
            raise TransactionError("transaction already in progress")
        self.current = Transaction(read_only)

    def commit(self) -> None:
        if self.current is None:
            raise TransactionError("no transaction in progress")
        self.current = None  # writes already applied; drop the undo log

    def rollback(self) -> None:
        if self.current is None:
            raise TransactionError("no transaction in progress")
        txn, self.current = self.current, None
        cat = self.session.catalog
        for kind, payload in reversed(txn.undo):
            if kind == "table_preimage":
                table, data, rows = payload
                table.data = data
                table._rows = rows
                table._invalidate()
            elif kind == "uncreate":
                cat.drop(payload, if_exists=True)
            elif kind == "reregister":
                cat.register(payload)

    # ---- write hooks (called by the executor's write paths) ----------
    def check_write_allowed(self) -> None:
        if self.current is not None and self.current.read_only:
            raise TransactionError("read-only transaction")

    def record_table_write(self, table) -> None:
        """Before mutating `table`, copy its host arrays once."""
        self.check_write_allowed()
        if self.current is None:
            return  # autocommit
        if id(table) in self.current._snapshotted:
            return
        if not hasattr(table, "data"):
            raise TransactionError(
                f"table '{table.name}' does not support transactional "
                "writes (no pre-image or manifest snapshot)")
        self.current._snapshotted.add(id(table))
        self.current.undo.append(
            ("table_preimage",
             (table, {k: v.copy() for k, v in table.data.items()},
              table._rows)))

    def record_create(self, name: str) -> None:
        self.check_write_allowed()
        if self.current is not None:
            self.current.undo.append(("uncreate", name))

    def record_replace(self, name: str, old_table) -> None:
        """CREATE OR REPLACE undo: re-register the old table object over
        the new one."""
        self.check_write_allowed()
        if self.current is not None:
            self.current.undo.append(("reregister", old_table))

    def record_drop(self, table) -> None:
        self.check_write_allowed()
        if self.current is not None:
            if not hasattr(table, "data"):
                raise TransactionError(
                    f"DROP of '{table.name}' is not transactional "
                    "(storage would be deleted); COMMIT first")
            self.current.undo.append(("reregister", table))
