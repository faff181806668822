"""presto_tpu_torch/functions/tzdb.py against presto_tpu/functions/tzdb.py:
the parsed rules of ten zones (transition and offset tables equal), the
column conversions on seeded int64 instants from 1900 to 2100 with every
transition's neighbourhood (DST gaps and overlaps) equal bit for bit to
the reference's jnp conversions and to its host scalars, fixed offsets,
the zone file search order, an unknown zone's ValueError, and the
static pass's fallback where the reference's trace falls back.
"""

import numpy as np
import pytest
import torch

from presto_tpu.functions import tzdb as RZ
from presto_tpu_torch.exec.colval import StaticFallback, static_pass
from presto_tpu_torch.functions import tzdb as PZ
from tests.torch_threads import torch_one_thread  # noqa: F401

ZONES = ("America/New_York", "Europe/Berlin", "Asia/Kolkata",
         "Australia/Lord_Howe", "Asia/Kathmandu", "Asia/Tokyo",
         "America/Sao_Paulo", "Pacific/Apia", "Africa/Casablanca",
         "America/St_Johns")
FIXED = ("UTC", "Z", "GMT", "+05:45", "-03:30", "+0530", "UTC+5",
         "GMT-08:00", "+14:00")

_US = 1_000_000
_LO = -2_208_988_800 * _US  # 1900-01-01
_HI = 4_102_444_800 * _US  # 2100-01-01


def _instants(rules, seed: int) -> np.ndarray:
    """Seeded instants over 1900-2100 and one hour and one second around
    every transition (both clocks), in range or not."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(_LO, _HI, 4000)]
    t = rules.trans_us
    if len(t):
        for d in (-3_600, -1, 0, 1, 1_800, 3_600):
            out.append(t + d * _US)
            out.append(t + rules.offs_us[:-1] + d * _US)
    return np.concatenate(out).astype(np.int64)


@pytest.mark.parametrize("zone", ZONES)
def test_tables_equal_the_reference(zone):
    mine, theirs = PZ.rules(zone), RZ.rules(zone)
    assert np.array_equal(mine.trans_us, theirs.trans_us)
    assert np.array_equal(mine.offs_us, theirs.offs_us)
    assert len(mine.offs_us) == len(mine.trans_us) + 1
    assert PZ.tzif_path(zone) == RZ._tzif_path(zone)


@pytest.mark.parametrize("zone", ZONES + FIXED)
def test_conversions_bit_for_bit(zone):
    import jax.numpy as jnp

    mine, theirs = PZ.rules(zone), RZ.rules(zone)
    us = _instants(theirs, len(zone))
    x = torch.from_numpy(us)
    for ours, ref in ((mine.utc_to_local, theirs.utc_to_local),
                      (mine.local_to_utc, theirs.local_to_utc)):
        got = ours(x).numpy()
        want = np.asarray(ref(jnp.asarray(us)))
        assert got.dtype == np.int64
        assert np.array_equal(got, want), zone
    for u in us[::97].tolist():
        assert mine.utc_to_local_scalar(u) == theirs.utc_to_local_scalar(u)
        assert mine.local_to_utc_scalar(u) == theirs.local_to_utc_scalar(u)
        assert mine.offset_at_utc_scalar(u) == \
            theirs.offset_at_utc_scalar(u)


def test_new_york_gap_and_overlap_2020():
    """2020-03-08 02:30 does not exist in New York: it takes the offset
    after the gap (EDT), an instant that reads back as 01:30 EST; the
    repeated 2020-11-01 01:30 takes the earlier offset (EDT)."""
    z = PZ.rules("America/New_York")
    gap = 1583634600 * _US  # 2020-03-08 02:30 as a UTC wall clock
    utc = z.local_to_utc_scalar(gap)
    assert utc == gap + 4 * 3600 * _US
    assert z.utc_to_local_scalar(utc) == gap - 3600 * _US
    overlap = 1604194200 * _US  # 2020-11-01 01:30
    assert z.local_to_utc_scalar(overlap) == overlap + 4 * 3600 * _US
    cols = z.local_to_utc(torch.tensor([gap, overlap]))
    assert cols.tolist() == [utc, overlap + 4 * 3600 * _US]


def test_fixed_offsets_need_no_table():
    for name, minutes in (("+05:45", 345), ("-03:30", -210), ("UTC", 0),
                          ("+0530", 330), ("UTC+5", 300)):
        z = PZ.rules(name)
        assert z.fixed and z.offs_us.tolist() == [minutes * 60 * _US]
        with static_pass():  # a constant added: no table read
            assert z.utc_to_local(torch.tensor([0])).tolist() == \
                [minutes * 60 * _US]


@pytest.mark.parametrize("name", ("Mars/Olympus_Mons", "+15:00",
                                  "../etc/passwd", "/etc/localtime", ""))
def test_unknown_zone_raises_value_error(name):
    with pytest.raises(ValueError):
        PZ.rules(name)
    with pytest.raises(ValueError):
        RZ.rules(name)
    assert not PZ.is_valid_zone(name)


def test_zone_files_search_order():
    assert PZ._TZDIRS == RZ._TZDIRS
    p = PZ.tzif_path("Europe/Berlin")
    assert p is not None and p.endswith("Europe/Berlin")


def test_static_pass_falls_back_on_a_zone_table():
    """The reference's trace indexes its host offset table with traced
    positions and falls back: the port's static pass raises there."""
    z = PZ.rules("Asia/Kolkata")
    with static_pass():
        with pytest.raises(StaticFallback):
            z.utc_to_local(torch.tensor([0]))


def test_device_tables_are_cached_per_device():
    z = PZ.rules("Europe/Berlin")
    a = z.device_tables(False, torch.device("cpu"))
    b = z.device_tables(False, torch.device("cpu"))
    assert a[0] is b[0] and a[1] is b[1]
    assert torch.equal(a[0], torch.from_numpy(z.trans_us))
    loc = z.device_tables(True, torch.device("cpu"))
    assert torch.equal(loc[0], torch.from_numpy(z.trans_us
                                                + z.offs_us[:-1]))
