"""The cases of tests/test_timezone.py through presto_tpu_torch and
presto_tpu on the CPU, in execution_mode "dynamic" and "auto": each
case's statements run in order in one session of each package (its
session zone set first), and every statement's record must be equal:
rows, column types, execution mode, the seven counters and the memo
entry (an error by its type and first line; a StaticFallback by type).
Python's zoneinfo is held to both for the literal and field cases, as
tests/test_timezone.py holds it to presto_tpu.  Also the session
constants (Z6 of presto_tpu_torch/zone_sketch_queries.py): one value
across a run's rows, inside the run's host-clock window, at the
session zone's wall clock, a new instant and a new memo entry every
run.
"""

import datetime as dt
import time
from zoneinfo import ZoneInfo

import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu_torch import zone_sketch_queries as ZQ
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto")
ZONES = ["America/New_York", "Europe/Berlin", "Asia/Kolkata",
         "Australia/Lord_Howe"]
PROBES = ["2024-01-15 12:00:00", "2024-03-10 01:59:59",
          "2024-03-10 03:00:00", "2024-03-31 03:00:00",
          "2024-11-03 00:30:00", "2024-10-27 03:00:00",
          "2024-02-29 23:59:59", "2024-07-04 00:00:00"]
FIELD_PROBES = ["2024-03-10 06:59:59", "2024-03-10 07:00:01",
                "2024-12-31 23:30:00", "2024-06-15 04:15:30"]
TRUNC_PROBES = ["2024-03-10 06:59:59", "2024-11-03 05:30:00",
                "2024-06-15 23:15:30"]


def _fields(zone):
    out = []
    for probe in FIELD_PROBES:
        lit = f"TIMESTAMP '{probe} UTC' AT TIME ZONE '{zone}'"
        out.append(f"SELECT year({lit}), month({lit}), day({lit}), "
                   f"hour({lit}), minute({lit}), second({lit})")
    return out


#: name -> (session zone, statements in order)
CASES = {
    **{f"literal_{z}": ("UTC", ["SELECT " + ", ".join(
        f"TIMESTAMP '{p} {z}'" for p in PROBES)]) for z in ZONES},
    **{f"fields_{z}": ("UTC", _fields(z)) for z in ZONES},
    **{f"trunc_{z}": ("UTC", ["SELECT " + ", ".join(
        f"date_trunc('day', TIMESTAMP '{p} UTC' AT TIME ZONE '{z}')"
        for p in TRUNC_PROBES)]) for z in ZONES},
    "at_timezone_preserves_instant": ("UTC", [
        "SELECT to_unixtime(TIMESTAMP '2024-06-01 12:00:00 UTC'), "
        "to_unixtime(TIMESTAMP '2024-06-01 12:00:00 UTC' "
        "AT TIME ZONE 'Asia/Kolkata')"]),
    "with_timezone_gap_and_overlap": ("UTC", [
        "SELECT to_unixtime(with_timezone(TIMESTAMP '2024-03-10 02:30:00', "
        "'America/New_York')), to_unixtime(with_timezone("
        "TIMESTAMP '2024-11-03 01:30:00', 'America/New_York'))"]),
    "session_zone": ("America/New_York", [
        "SELECT current_timezone()",
        "SELECT to_unixtime(CAST(TIMESTAMP '2024-06-01 12:00:00' "
        "AS TIMESTAMP WITH TIME ZONE))",
        "SET SESSION time_zone = 'Asia/Kolkata'",
        "SELECT current_timezone()"]),
    "timezone_hour_minute": ("UTC", [
        "SELECT timezone_hour(TIMESTAMP '2024-06-01 12:00:00 "
        "Australia/Lord_Howe'), timezone_minute(TIMESTAMP "
        "'2024-06-01 12:00:00 Australia/Lord_Howe'), "
        "timezone_hour(TIMESTAMP '2024-01-01 12:00:00 "
        "Australia/Lord_Howe')"]),
    "render_and_parse": ("UTC", [
        "SELECT CAST(TIMESTAMP '2024-06-01 10:30:00.250 Europe/Berlin' "
        "AS VARCHAR)",
        "SELECT to_unixtime(CAST('2024-06-01 10:30:00.250 Europe/Berlin' "
        "AS TIMESTAMP WITH TIME ZONE))"]),
    "time_type": ("UTC", [
        "SELECT CAST(TIME '09:05:07.123' AS VARCHAR)",
        "SELECT hour(TIME '09:05:07'), minute(TIME '09:05:07'), "
        "second(TIME '09:05:07')",
        "SELECT CAST('23:59:59' AS TIME)",
        "SELECT CAST(TIME '10:00:00 +05:30' AS VARCHAR)"]),
    "column_group_order": ("UTC", [
        "SELECT t.z, count(*) FROM (VALUES "
        "(TIMESTAMP '2024-06-01 12:00:00 UTC'), "
        "(TIMESTAMP '2024-06-01 08:00:00 America/New_York'), "
        "(TIMESTAMP '2024-06-01 13:00:00 UTC')) t(z) "
        "GROUP BY t.z ORDER BY t.z"]),
    "interval_arithmetic": ("UTC", [
        "SELECT CAST(TIMESTAMP '2020-01-01 10:00:00' + INTERVAL '3' HOUR "
        "AS VARCHAR)",
        "SELECT DATE '1998-12-01' - INTERVAL '90' DAY",
        "SELECT CAST(TIMESTAMP '2020-03-08 01:30:00 America/New_York' "
        "+ INTERVAL '1' HOUR AS VARCHAR)"]),
    "date_timestamp_scaling": ("UTC", [
        "SELECT CAST(CAST(DATE '2020-02-29' AS TIMESTAMP) AS VARCHAR)",
        "SELECT CAST(CAST(TIMESTAMP '2020-02-29 13:00:00' AS DATE) "
        "AS VARCHAR)"]),
    "mixed_comparison": ("America/New_York", [
        "SELECT TIMESTAMP '2020-06-01 12:00:00 America/New_York' "
        "= TIMESTAMP '2020-06-01 12:00:00'",
        "SELECT DATE '2020-06-02' > "
        "TIMESTAMP '2020-06-01 22:00:00 America/New_York'"]),
    "time_to_time_tz": ("Asia/Tokyo", [
        "SELECT CAST(CAST(TIME '12:00:00' AS TIME WITH TIME ZONE) "
        "AS VARCHAR)"]),
    "bare_tstz_cast": ("UTC", [
        "SELECT hour(CAST(TIMESTAMP '2020-06-01 12:00:00 "
        "America/New_York' AS TIMESTAMP WITH TIME ZONE))"]),
    "at_time_zone_precedence": ("UTC", [
        "SELECT CAST(TIMESTAMP '2020-06-01 12:00:00 UTC' AT "
        "TIME ZONE 'America/New_York' + INTERVAL '1' HOUR AS VARCHAR)"]),
    "from_unixtime_offset": ("UTC", [
        "SELECT CAST(from_unixtime(0, -5, 30) AS VARCHAR)"]),
    "current_user": ("UTC", ["SELECT current_user"]),
}


def _session(pkg, zone, mode):
    if pkg == "port":
        s = presto_tpu_torch.connect(Catalog(), device="cpu",
                                     execution_mode=mode)
    else:
        s = presto_tpu.connect(RefCatalog(), execution_mode=mode)
    s.set("time_zone", zone)
    return s


def _run(pkg, name, mode):
    zone, stmts = CASES[name]
    s = _session(pkg, zone, mode)
    return [ZQ.record(s, q, SORT_STATS_KEYS) for q in stmts]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_presto_tpu(name, mode):
    mine, theirs = _run("port", name, mode), _run("ref", name, mode)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert ZQ.mismatch(f"{name}[{i}]", a, b, 0.0) == ""


def _epoch_us(d: dt.datetime) -> int:
    return int(d.timestamp() * 1_000_000)


@pytest.mark.parametrize("zone", ZONES)
def test_literals_and_fields_match_zoneinfo(zone):
    zi = ZoneInfo(zone)
    lit = _run("port", f"literal_{zone}", "dynamic")[0]["rows"][0]
    for probe, got in zip(PROBES, lit):
        naive = dt.datetime.strptime(probe, "%Y-%m-%d %H:%M:%S")
        assert got == _epoch_us(naive.replace(tzinfo=zi)), probe
    for probe, rec in zip(FIELD_PROBES, _run("port", f"fields_{zone}",
                                             "dynamic")):
        local = dt.datetime.strptime(probe, "%Y-%m-%d %H:%M:%S").replace(
            tzinfo=dt.timezone.utc).astimezone(zi)
        assert rec["rows"][0] == [local.year, local.month, local.day,
                                  local.hour, local.minute, local.second]


@pytest.mark.parametrize("zone", ("UTC", "Asia/Kolkata"))
def test_session_constants_properties(zone):
    """Z6 in a session at `zone`: two runs, each inside its host-clock
    window, every row of a run the same, the wall-clock columns at the
    zone's reading of the instant, a new memo entry each run."""
    s = _session("port", zone, "auto")
    sql = ZQ.VOLATILE["Z6"].replace("FROM nation",
                                    "FROM (VALUES 1, 2, 3) t(n_nationkey)")
    runs, windows = [], []
    for _ in range(2):
        t0 = int(time.time() * 1e6)
        runs.append(s.sql(sql).rows)
        windows.append((t0, int(time.time() * 1e6)))
    off = int(ZoneInfo(zone).utcoffset(dt.datetime(2024, 1, 1))
              .total_seconds()) * 1_000_000  # no DST in either zone
    day = 86_400_000_000
    for rows, (t0, t1) in zip(runs, windows):
        first = rows[0][1:]
        assert all(r[1:] == first for r in rows)
        now_s, cur_s, date, ltime, lts = first
        assert now_s == cur_s
        assert t0 <= lts - off <= t1
        assert abs(now_s * 1e6 - (lts - off)) <= 1
        assert date == lts // day and ltime == lts % day
    assert runs[0][0][1] != runs[1][0][1]
    assert ZQ.memo_state(s, sql) == ["executable", "executable"]
