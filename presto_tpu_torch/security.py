"""Access control and session property managers (reference:
presto_tpu/security.py).

- security/AccessControlManager and the file-based access control of
  presto-plugin-toolkit: checks on table read, write and DDL, matched
  by (user, table-name regex), first match wins.
- presto-session-property-managers: rule-based session property
  defaults matched on (user, source), applied at query submit.

The password authenticators belong to the protocol server, which is not
ported.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional


class AccessDeniedError(Exception):
    pass


class AccessControl:
    """Interface (reference: spi/security/SystemAccessControl).  The
    default allows everything (the reference's AllowAllAccessControl)."""

    def check_can_select(self, user: str, table: str) -> None:
        pass

    def check_can_insert(self, user: str, table: str) -> None:
        pass

    def check_can_delete(self, user: str, table: str) -> None:
        pass

    def check_can_create_table(self, user: str, table: str) -> None:
        pass

    def check_can_drop_table(self, user: str, table: str) -> None:
        pass

    def check_can_set_session_property(self, user: str, name: str) -> None:
        pass


ALLOW_ALL = AccessControl()


class FileBasedAccessControl(AccessControl):
    """Ordered first-match rules (reference: FileBasedSystemAccessControl
    rules.json):

    {"tables": [{"user": "etl.*", "table": "tmp_.*",
                 "privileges": ["SELECT", "INSERT", "DELETE", "OWNERSHIP"]},
                {"table": ".*", "privileges": ["SELECT"]}]}

    Without a matching rule, access is denied (the reference's default)."""

    def __init__(self, config: dict):
        self.rules = []
        for r in config.get("tables", []):
            self.rules.append((
                re.compile(r.get("user", ".*")),
                re.compile(r.get("table", ".*")),
                frozenset(p.upper() for p in r.get("privileges", []))))

    def _privileges(self, user: str, table: str) -> frozenset:
        for user_re, table_re, privs in self.rules:
            if user_re.fullmatch(user or "") and table_re.fullmatch(table):
                return privs
        return frozenset()

    def _check(self, user, table, priv):
        if priv not in self._privileges(user, table):
            raise AccessDeniedError(
                f"Access Denied: user '{user}' cannot {priv} table '{table}'")

    def check_can_select(self, user, table):
        self._check(user, table, "SELECT")

    def check_can_insert(self, user, table):
        self._check(user, table, "INSERT")

    def check_can_delete(self, user, table):
        self._check(user, table, "DELETE")

    def check_can_create_table(self, user, table):
        self._check(user, table, "OWNERSHIP")

    def check_can_drop_table(self, user, table):
        self._check(user, table, "OWNERSHIP")


class SessionPropertyManager:
    """Rule-based property defaults applied at query submit (reference:
    AbstractSessionPropertyManager; the rules have the shape of
    session-property-config.json):

    [{"user": "etl.*", "source": null,
      "sessionProperties": {"spill_enabled": true}}]
    """

    def __init__(self, rules: Optional[List[dict]] = None):
        self.rules = []
        for r in rules or []:
            self.rules.append((
                re.compile(r["user"]) if r.get("user") else None,
                re.compile(r["source"]) if r.get("source") else None,
                dict(r.get("sessionProperties", {}))))

    def overrides(self, user: str = "", source: str = "") -> Dict[str, object]:
        """Every matching rule applies, later rules win (reference:
        SessionPropertyConfigurationManager)."""
        out: Dict[str, object] = {}
        for user_re, source_re, props in self.rules:
            if user_re is not None and not user_re.fullmatch(user or ""):
                continue
            if source_re is not None and not source_re.fullmatch(source or ""):
                continue
            out.update(props)
        return out
