"""TIME / TIMESTAMP WITH TIME ZONE function surface.

Reference: presto_tpu/functions/datetime_tz.py (after presto-main's
DateTimeFunctions.java: at_timezone, with_timezone, the zone-aware
extract / date_trunc / date_format, timezone_hour/minute; and
spi/type/TimestampWithTimeZoneType, TimeWithTimeZoneType).

The zone rides the column TYPE (types.Type.tz) and the device lane is
pure UTC int64 micros.  A zone-dependent function LOCALIZES the lane (one
torch.searchsorted over the zone's transition table, tzdb.ZoneRules)
into a plain-TIMESTAMP wall clock, runs the zone-less emitter, and
converts back when the result is temporal.  A Python scalar (a folded
literal) converts on the host, a tensor on its device; integer division
and remainder floor (torch's `//` and `%`), as jnp.floor_divide and
jnp.mod do on negative micros.

This module registers last, after functions/scalar_ext.py and
scalar_ext2.py (imported at the end of functions/scalar.py), so that its
wrappers wrap their final registrations, as in the reference.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.exec.colval import ColVal, refuse_host_read
from presto_tpu_torch.functions import decimals as DEC
from presto_tpu_torch.functions import tzdb
from presto_tpu_torch.functions.scalar import (REGISTRY, _and_not, _f64,
                                               _f64_to_i64, _is_tensor,
                                               _literal_dictionary, _lookup,
                                               device_int64, register)

US_PER_DAY = 86_400_000_000


def _zone_of(v: ColVal) -> tzdb.ZoneRules:
    return tzdb.rules(v.type.tz or "UTC")


def _localize(v: ColVal) -> ColVal:
    """TIMESTAMP_TZ -> zone-less TIMESTAMP carrying the zone's wall
    clock; anything else passes through."""
    if v.type.name != "TIMESTAMP_TZ":
        return v
    r = _zone_of(v)
    if not _is_tensor(v.data):
        return ColVal(r.utc_to_local_scalar(int(v.data)), v.valid,
                      T.TIMESTAMP)
    return ColVal(r.utc_to_local(v.data), v.valid, T.TIMESTAMP)


def _delocalize(v: ColVal, zone: str) -> ColVal:
    """Zone-less wall-clock TIMESTAMP -> TIMESTAMP_TZ in `zone`."""
    r = tzdb.rules(zone)
    if not _is_tensor(v.data):
        return ColVal(r.local_to_utc_scalar(int(v.data)), v.valid,
                      T.timestamp_tz(zone))
    return ColVal(r.local_to_utc(v.data), v.valid, T.timestamp_tz(zone))


def _zone_arg(v: ColVal) -> str:
    if not isinstance(v.data, str) or v.dictionary is not None:
        raise NotImplementedError("time zone argument must be a literal")
    if not tzdb.is_valid_zone(v.data):
        raise ValueError(f"unknown time zone: {v.data!r}")
    return v.data


# ---- at_timezone / with_timezone -----------------------------------------


def _emit_at_timezone(args):
    v, zone = args[0], _zone_arg(args[1])
    if v.type.name == "TIMESTAMP":  # coerce via the session zone first
        v = _delocalize(v, session_ctx.current_zone())
    if v.type.name != "TIMESTAMP_TZ":
        raise NotImplementedError(f"at_timezone({v.type})")
    # same instant, new display zone: the lane is already UTC
    return ColVal(v.data, v.valid, T.timestamp_tz(zone), v.dictionary)


register("at_timezone",
         lambda args: (T.timestamp_tz() if len(args) == 2
                       and args[0].name in ("TIMESTAMP", "TIMESTAMP_TZ")
                       and args[1].is_string else None),
         _emit_at_timezone)


def _emit_with_timezone(args):
    v, zone = args[0], _zone_arg(args[1])
    if v.type.name != "TIMESTAMP":
        raise NotImplementedError(f"with_timezone({v.type})")
    return _delocalize(v, zone)


register("with_timezone",
         lambda args: (T.timestamp_tz() if len(args) == 2
                       and args[0].name == "TIMESTAMP"
                       and args[1].is_string else None),
         _emit_with_timezone)


# ---- session-dependent constants ------------------------------------------
# (now() and current_timestamp are TIMESTAMP WITH TIME ZONE at the
# session zone, one value for the whole query: the query's start)


def _now_tz_emit(args):
    return ColVal(session_ctx.query_start_us(), None,
                  T.timestamp_tz(session_ctx.current_zone()))


def _niladic(t: T.Type):
    return lambda args: t if not args else None


register("now", _niladic(T.timestamp_tz()), _now_tz_emit)
register("current_timestamp", _niladic(T.timestamp_tz()), _now_tz_emit)
register("localtimestamp", _niladic(T.TIMESTAMP),
         lambda args: _localize(_now_tz_emit(args)))
register("current_date", _niladic(T.DATE),
         lambda args: ColVal(
             int(_localize(_now_tz_emit(args)).data) // US_PER_DAY, None,
             T.DATE))
register("current_timezone", _niladic(T.VARCHAR),
         lambda args: ColVal(session_ctx.current_zone(), None, T.VARCHAR))
register("current_user", _niladic(T.VARCHAR),
         lambda args: ColVal(session_ctx.current_user(), None, T.VARCHAR))
register("localtime", _niladic(T.TIME),
         lambda args: ColVal(
             int(_localize(_now_tz_emit(args)).data) % US_PER_DAY, None,
             T.TIME))


def _current_time_emit(args):
    zone = session_ctx.current_zone()
    utc = session_ctx.query_start_us()
    off_us = tzdb.rules(zone).offset_at_utc_scalar(utc)
    return ColVal((utc + off_us) % US_PER_DAY, None,
                  T.time_tz(off_us // 60_000_000))


register("current_time", _niladic(T.time_tz()), _current_time_emit)


# ---- unix time ------------------------------------------------------------

register("to_unixtime",
         lambda args: (T.DOUBLE if args
                       and args[0].name in ("TIMESTAMP", "TIMESTAMP_TZ")
                       else None),
         lambda args: ColVal(DEC.true_div(
             device_int64(args[0].data).to(torch.float64), 1e6),
             args[0].valid, T.DOUBLE))

_prev_from_unixtime = REGISTRY["from_unixtime"]


def _host_int(v: ColVal) -> int:
    d = v.data
    if _is_tensor(d):
        refuse_host_read("from_unixtime's offset")
        d = d.reshape(-1)[0].item()
    return int(d)


def _emit_from_unixtime(args):
    if len(args) == 1:
        return _prev_from_unixtime.emit(args)
    x = args[0].data
    if not _is_tensor(x):
        x = torch.full((), float(x), dtype=torch.float64,
                       device=session_ctx.device())
    us = _f64_to_i64(_f64(x) * 1e6)
    if len(args) == 2:  # (unixtime, zone-string)
        return ColVal(us, args[0].valid, T.timestamp_tz(_zone_arg(args[1])))
    # (unixtime, hours, minutes) fixed offset: total = hours*60+minutes
    # (reference DateTimeFunctions.fromUnixTime(double, long, long))
    total = _host_int(args[1]) * 60 + _host_int(args[2])
    sign = "-" if total < 0 else "+"
    return ColVal(us, args[0].valid, T.timestamp_tz(
        f"{sign}{abs(total) // 60:02d}:{abs(total) % 60:02d}"))


register("from_unixtime",
         lambda args: (T.TIMESTAMP if len(args) == 1 and args[0].is_numeric
                       else T.timestamp_tz()
                       if (len(args) == 2 and args[0].is_numeric
                           and args[1].is_string)
                       or (len(args) == 3
                           and all(a.is_numeric for a in args))
                       else None),
         _emit_from_unixtime)


# ---- timezone_hour / timezone_minute --------------------------------------


def _tz_offset_us(v: ColVal):
    r = _zone_of(v)
    if not _is_tensor(v.data):
        return r.offset_at_utc_scalar(int(v.data))
    data = v.data.to(torch.int64)
    return r.utc_to_local(data) - data


def _tz_field(divisor, mod):
    def emit(args):
        v = args[0]
        data = device_int64(v.data)
        if v.type.name == "TIME_TZ":
            off = torch.full_like(data, int(v.type.tz or 0) * 60_000_000)
        elif v.type.name == "TIMESTAMP_TZ":
            off = device_int64(_tz_offset_us(v))
        else:
            off = torch.zeros_like(data)
        r = torch.sign(off) * ((off.abs() // divisor) % mod)
        return ColVal(r, v.valid, T.BIGINT)

    return emit


register("timezone_hour",
         lambda args: T.BIGINT if args and args[0].name in
         ("TIMESTAMP", "TIMESTAMP_TZ", "TIME_TZ") else None,
         _tz_field(3_600_000_000, 24))
register("timezone_minute",
         lambda args: T.BIGINT if args and args[0].name in
         ("TIMESTAMP", "TIMESTAMP_TZ", "TIME_TZ") else None,
         _tz_field(60_000_000, 60))


# ---- localizing adapters over the zone-less emitters ----------------------
# Every civil-field function keeps its single zone-less implementation;
# the adapter converts a TIMESTAMP_TZ argument to its wall clock first.


def _wrap_localize_arg(name, arg_idx=0, relocalize_result=False):
    prev = REGISTRY.get(name)
    if prev is None:
        return
    prev_resolve, prev_emit = prev.resolve, prev.emit

    def resolve(args):
        mapped = [T.TIMESTAMP if a.name == "TIMESTAMP_TZ"
                  and i == arg_idx else a for i, a in enumerate(args)]
        r = prev_resolve(mapped)
        if r is None:
            return None
        if relocalize_result and len(args) > arg_idx \
                and args[arg_idx].name == "TIMESTAMP_TZ" \
                and r.name == "TIMESTAMP":
            return args[arg_idx]
        return r

    def emit(args):
        src = args[arg_idx] if arg_idx < len(args) else None
        if src is not None and src.type.name == "TIMESTAMP_TZ":
            largs = list(args)
            largs[arg_idx] = _localize(src)
            out = prev_emit(largs)
            if relocalize_result and out.type.name == "TIMESTAMP":
                # the reference's date_trunc / date_add give a device
                # value, which it converts back on the device
                return _delocalize(ColVal(device_int64(out.data), out.valid,
                                          out.type), src.type.tz or "UTC")
            return out
        return prev_emit(args)

    prev.resolve = resolve
    prev.emit = emit


for _n in ("extract_year", "extract_month", "extract_day",
           "extract_quarter", "extract_dow", "extract_doy",
           "extract_week", "year", "month", "day", "quarter",
           "day_of_week", "day_of_month", "day_of_year", "week_of_year",
           "year_of_week", "yow", "date_format", "format_datetime",
           "to_iso8601", "to_char", "date"):
    _wrap_localize_arg(_n, 0)
for _n in ("hour", "minute", "second", "millisecond"):
    _wrap_localize_arg(_n, 0)
_wrap_localize_arg("date_trunc", 1, relocalize_result=True)
_wrap_localize_arg("date_add", 2, relocalize_result=True)
for _i in (1, 2):
    _wrap_localize_arg("date_diff", _i)


# ---- TIME field access ----------------------------------------------------
# hour/minute/second/millisecond over TIME / TIME_TZ: the lane is
# already local micros-since-midnight, so the field math is direct.


def _extend_time_fields():
    for name, div, mod in (("hour", 3_600_000_000, 24),
                           ("minute", 60_000_000, 60),
                           ("second", 1_000_000, 60),
                           ("millisecond", 1_000, 1000)):
        prev = REGISTRY[name]
        prev_resolve, prev_emit = prev.resolve, prev.emit

        def resolve(args, _pr=prev_resolve):
            if args and args[0].name in ("TIME", "TIME_TZ"):
                return T.BIGINT
            return _pr(args)

        def emit(args, _pe=prev_emit, _div=div, _mod=mod):
            v = args[0]
            if v.type.name in ("TIME", "TIME_TZ"):
                us = device_int64(v.data)
                return ColVal((us // _div) % _mod, v.valid, T.BIGINT)
            return _pe(args)

        prev.resolve = resolve
        prev.emit = emit


_extend_time_fields()


# ---- casts ---------------------------------------------------------------
# (reference: DateTimeOperators / the *CastTo* operators on
# TimestampWithTimeZoneType, TimeType, TimeWithTimeZoneType)


def _session_zone_of(t: T.Type) -> str:
    return t.tz or session_ctx.current_zone()


def _int64(x):
    return x.to(torch.int64) if _is_tensor(x) else int(x)


def emit_cast_tz(v: ColVal, to: T.Type, safe: bool):
    """Cast arms for the TZ family.  Returns None for combinations the
    generic emit_cast path already handles (rendering to VARCHAR)."""
    frm = v.type
    if to.is_string:
        return None  # _cast_to_varchar renders via _render_varchar
    if frm.name == "TIMESTAMP_TZ":
        if to.name == "TIMESTAMP_TZ":
            # zone-less target (bare CAST .. AS TIMESTAMP WITH TIME
            # ZONE) is the identity — keep the VALUE's zone; only an
            # explicit target zone retags (same instant either way)
            return ColVal(v.data, v.valid,
                          frm if to.tz is None else to, v.dictionary)
        if to.name == "TIMESTAMP":
            return _localize(v)
        loc = device_int64(_localize(v).data)
        if to.name == "DATE":
            return ColVal((loc // US_PER_DAY).to(torch.int32), v.valid,
                          T.DATE)
        if to.name == "TIME":
            return ColVal(loc % US_PER_DAY, v.valid, T.TIME)
        return None
    if to.name == "TIMESTAMP_TZ":
        zone = _session_zone_of(to)
        if frm.name == "TIMESTAMP":
            return _delocalize(v, zone)
        if frm.name == "DATE":
            wall = ColVal(_int64(v.data) * US_PER_DAY, v.valid, T.TIMESTAMP)
            return _delocalize(wall, zone)
        if frm.is_string:
            return _parse_tstz_strings(v, zone, safe)
        return None
    if frm.name == "TIME":
        if to.name == "TIME_TZ":
            off = int(to.tz) if to.tz is not None else \
                tzdb.rules(session_ctx.current_zone()).offset_at_utc_scalar(
                    session_ctx.query_start_us()) // 60_000_000
            return ColVal(v.data, v.valid, T.time_tz(off), v.dictionary)
        return None
    if frm.name == "TIME_TZ" and to.name == "TIME":
        return ColVal(v.data, v.valid, T.TIME, v.dictionary)
    if to.name == "TIME" and frm.is_string:
        return _parse_time_strings(v, safe)
    return None


def host_parse_lut(v: ColVal, parse_one, out_type: T.Type, safe: bool,
                   dtype=np.int64) -> ColVal:
    """Parse every dictionary entry on the host into a value table, looked
    up through the codes (a string literal as a one-entry dictionary); an
    entry that does not parse raises, or under TRY_CAST is NULL."""
    v = _literal_dictionary(v)
    vals = v.dictionary.values
    lut = np.zeros(max(len(vals), 1), dtype=dtype)
    bad = np.zeros(max(len(vals), 1), dtype=bool)
    for i, s in enumerate(vals):
        try:
            lut[i] = parse_one(str(s))
        except (ValueError, KeyError):
            if not safe:
                raise ValueError(f"cannot CAST {s!r} to {out_type}")
            bad[i] = True
    valid = v.valid
    if bad.any():
        valid = _and_not(valid, _lookup(v.data, bad))
    return ColVal(_lookup(v.data, lut), valid, out_type)


_TSTZ_TEXT = re.compile(r"^(\d{4}-\d{2}-\d{2})"
                        r"(?:[ T](\d{2}:\d{2}(?::\d{2}(?:\.\d{1,6})?)?))?"
                        r"(?:\s+(\S.*))?$")
_TIME_TEXT = re.compile(r"^(\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,6}))?)?$")


def _parse_tstz_strings(v: ColVal, default_zone: str, safe: bool):
    """VARCHAR -> TIMESTAMP WITH TIME ZONE.  A zone suffix in the text
    wins; otherwise the cast-target/session zone interprets the wall
    clock.  Mixed-zone inputs collapse to the FIRST zone seen (single
    zone per column — same instant, display zone approximated)."""
    zone_seen = [None]

    def parse_one(s):
        m = _TSTZ_TEXT.match(s.strip())
        if m is None:
            raise ValueError(s)
        civil = m.group(1) + ("T" + m.group(2) if m.group(2) else "")
        local_us = int((np.datetime64(civil)
                        - np.datetime64("1970-01-01T00:00:00"))
                       / np.timedelta64(1, "us"))
        zone = m.group(3) or default_zone
        if zone_seen[0] is None:
            zone_seen[0] = zone
        return tzdb.rules(zone).local_to_utc_scalar(local_us)

    out = host_parse_lut(v, parse_one, T.timestamp_tz(default_zone), safe)
    return ColVal(out.data, out.valid,
                  T.timestamp_tz(zone_seen[0] or default_zone))


def _parse_time_strings(v: ColVal, safe: bool):
    def parse_one(s):
        m = _TIME_TEXT.match(s.strip())
        if m is None:
            raise ValueError(s)
        frac = (m.group(4) or "").ljust(6, "0")
        return ((int(m.group(1)) * 3600 + int(m.group(2)) * 60
                 + int(m.group(3) or 0)) * 1_000_000 + int(frac or 0))

    return host_parse_lut(v, parse_one, T.TIME, safe)
