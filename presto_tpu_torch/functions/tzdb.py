"""Time-zone rules for the WITH TIME ZONE types.

Reference: presto_tpu/functions/tzdb.py (itself after presto-spi's
TimeZoneKey and the joda transition lookups of DateTimeFunctions.java).
The zone lives in the column TYPE (`types.timestamp_tz(zone)`) and the
device lane is pure UTC microseconds, so comparisons, joins, sorts and
GROUP BY run on the int64 lane; a zone conversion is one
`torch.searchsorted` over the zone's transition table (about 100 to 300
entries).

The rules come from the host's IANA tzdata: TZif files parsed directly
(RFC 8536), searched in /usr/share/zoneinfo, /usr/lib/zoneinfo,
/etc/zoneinfo and then the `tzdata` wheel.  Fixed-offset names
(`+05:30`, `UTC`) need no file.

Each zone's tables reach a device once (`ZoneRules.device_tables`,
cached per device through `batch.upload`, outside any capture).  A
conversion of a column through a zone with transitions runs in the
dynamic executor alone: the reference's static trace indexes the host
offset table with traced positions and falls back, and the port's
static pass raises StaticFallback at the same place.  Fixed offsets
(UTC, '+05:45') add a constant and run in both executors.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import upload
from presto_tpu_torch.exec.colval import refuse_host_read

_TZDIRS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo", "/etc/zoneinfo")

US = 1_000_000


class ZoneRules:
    """Sorted UTC transition instants + the offset in effect between
    them.  offs_us[i] applies to instants < trans_us[i] (i.e. the offset
    AFTER transition i-1); len(offs_us) == len(trans_us) + 1."""

    __slots__ = ("name", "trans_us", "offs_us", "_dev")

    def __init__(self, name: str, trans_us: np.ndarray, offs_us: np.ndarray):
        self.name = name
        self.trans_us = trans_us
        self.offs_us = offs_us
        self._dev: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def fixed(self) -> bool:
        return len(self.trans_us) == 0

    # ---- host-side scalar conversions --------------------------------
    def offset_at_utc_scalar(self, utc_us: int) -> int:
        i = int(np.searchsorted(self.trans_us, utc_us, side="right"))
        return int(self.offs_us[i])

    def utc_to_local_scalar(self, utc_us: int) -> int:
        return utc_us + self.offset_at_utc_scalar(utc_us)

    def local_to_utc_scalar(self, local_us: int) -> int:
        tl, offs = self._local_transitions()
        i = int(np.searchsorted(tl, local_us, side="right"))
        return local_us - int(offs[i])

    def _local_transitions(self) -> Tuple[np.ndarray, np.ndarray]:
        """Transition instants on the PRE-transition wall clock.  An
        ambiguous local time (fall-back overlap) resolves to the EARLIER
        offset; a nonexistent one (spring-forward gap) to the offset
        AFTER the gap, which lands it one gap-length earlier: New York's
        2020-03-08 02:30 reads back as 01:30 EST, as in the reference
        (Presto, through joda, gives 03:30 EDT; ROADMAP C)."""
        return self.trans_us + self.offs_us[:-1], self.offs_us

    # ---- device-side column conversions ------------------------------
    def device_tables(self, local: bool, device: torch.device):
        """The (transitions, offsets) int64 tensors on `device`, uploaded
        once per device and kept for the process (a captured graph reads
        them on every replay)."""
        key = (bool(local), str(device))
        hit = self._dev.get(key)
        if hit is None:
            trans, offs = self._local_transitions() if local \
                else (self.trans_us, self.offs_us)
            hit = self._dev[key] = (
                upload(np.ascontiguousarray(trans, np.int64), device),
                upload(np.ascontiguousarray(offs, np.int64), device))
        return hit

    def _shift(self, us: torch.Tensor, local: bool) -> torch.Tensor:
        """The offset in effect at each instant of `us` (on its wall
        clock when `local`).  The reference indexes its host table with
        the traced positions, which its static trace refuses, so the
        static pass falls back here too."""
        refuse_host_read("a time zone's offset table")
        trans, offs = self.device_tables(local, us.device)
        us = us.to(torch.int64)
        idx = torch.searchsorted(trans, us.contiguous(), right=True)
        return offs[idx]

    def utc_to_local(self, utc_us: torch.Tensor) -> torch.Tensor:
        """Columnar utc->wall-clock shift (device searchsorted)."""
        if self.fixed:
            return utc_us.to(torch.int64) + int(self.offs_us[0])
        return utc_us.to(torch.int64) + self._shift(utc_us, False)

    def local_to_utc(self, local_us: torch.Tensor) -> torch.Tensor:
        if self.fixed:
            return local_us.to(torch.int64) - int(self.offs_us[0])
        return local_us.to(torch.int64) - self._shift(local_us, True)


_CACHE: Dict[str, ZoneRules] = {}


def _parse_fixed(name: str) -> Optional[ZoneRules]:
    """`UTC`, `Z`, `+08:45`, `-05:00`, `+0530`, `UTC+5` style names."""
    up = name.strip()
    if up.upper() in ("UTC", "Z", "GMT", "UT"):
        return ZoneRules(name, np.empty(0, np.int64),
                         np.zeros(1, np.int64))
    s = up
    if s.upper().startswith(("UTC", "GMT")):
        s = s[3:]
    if not s or s[0] not in "+-":
        return None
    sign = -1 if s[0] == "-" else 1
    body = s[1:].replace(":", "")
    if not body.isdigit() or len(body) > 4:
        return None
    if len(body) <= 2:
        hh, mm = int(body), 0
    else:
        body = body.zfill(4)
        hh, mm = int(body[:2]), int(body[2:])
    if hh > 14 or mm > 59:
        return None
    off = sign * (hh * 3600 + mm * 60) * US
    return ZoneRules(name, np.empty(0, np.int64),
                     np.asarray([off], np.int64))


def tzif_path(name: str) -> Optional[str]:
    """Where a zone's TZif file lies: the first of the zoneinfo
    directories that holds it, else the `tzdata` wheel; None when none
    does."""
    if "/" in name and (".." in name or name.startswith("/")):
        return None  # no path escapes
    for d in _TZDIRS:
        p = os.path.join(d, name)
        if os.path.isfile(p):
            return p
    # the tzdata wheel (PEP 615 fallback) ships the same TZif files
    try:
        import importlib.resources as ir

        parts = name.split("/")
        trav = ir.files("tzdata").joinpath("zoneinfo", *parts)
        if trav.is_file():
            return str(trav)
    except (ImportError, ModuleNotFoundError, ValueError):
        pass
    return None


def _parse_tzif(name: str, raw: bytes) -> ZoneRules:
    """RFC 8536 TZif v1/2/3 -> transition arrays (64-bit block when
    present)."""

    def read_block(buf, pos, time_size):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack_from(">6I", buf, pos + 20)
        pos += 44
        fmt = ">%d%s" % (timecnt, "q" if time_size == 8 else "l")
        trans = struct.unpack_from(fmt, buf, pos)
        pos += timecnt * time_size
        idxs = struct.unpack_from(">%dB" % timecnt, buf, pos)
        pos += timecnt
        ttinfos = []
        for _ in range(typecnt):
            utoff, isdst, _desig = struct.unpack_from(">lBB", buf, pos)
            ttinfos.append((utoff, isdst))
            pos += 6
        pos += charcnt + leapcnt * (time_size + 4) + isstdcnt + isutcnt
        return trans, idxs, ttinfos, pos

    if raw[:4] != b"TZif":
        raise ValueError(f"{name}: not a TZif file")
    version = raw[4:5]
    trans, idxs, ttinfos, pos = read_block(raw, 0, 4)
    if version in (b"2", b"3", b"4") and raw[pos:pos + 4] == b"TZif":
        trans, idxs, ttinfos, pos = read_block(raw, pos, 8)
    if not ttinfos:
        raise ValueError(f"{name}: no time types")
    # initial offset: first standard (non-dst) type, else the first type
    first_std = next((o for o, dst in ttinfos if not dst), ttinfos[0][0])
    offs = [first_std] + [ttinfos[i][0] for i in idxs]
    return ZoneRules(
        name,
        np.asarray(trans, np.int64) * US,
        np.asarray(offs, np.int64) * US)


def rules(name: str) -> ZoneRules:
    """Resolve a zone name to its rules; raises ValueError for unknown
    zones (reference: TimeZoneKey.getTimeZoneKey throws
    TimeZoneNotSupportedException)."""
    z = _CACHE.get(name)
    if z is not None:
        return z
    z = _parse_fixed(name)
    if z is None:
        path = tzif_path(name)
        if path is None:
            raise ValueError(f"unknown time zone: {name!r}")
        with open(path, "rb") as f:
            z = _parse_tzif(name, f.read())
    _CACHE[name] = z
    return z


def is_valid_zone(name: str) -> bool:
    try:
        rules(name)
        return True
    except (ValueError, OSError):
        return False
