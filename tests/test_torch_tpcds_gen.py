"""presto_tpu_torch's TPC-DS generator (presto_tpu_torch/connectors/
tpcds.py) and TpcdsTable against presto_tpu's, on the CPU.

The port's copy must give the reference's columns bit for bit: every
table and column at SF0.01, with its dtype and NULL mask, and one split
[1000, 1500) of each sales table.  Row counts agree at SF 0.01, 1 and
10, and the metadata the planner reads (column statistics, unique keys,
orderings, rows per key, split ranges) is equal for every table, so
both packages plan the 99 queries the same way.
"""

import dataclasses

import numpy as np
import pytest

from presto_tpu.catalog import tpcds_catalog as ref_tpcds_catalog
from presto_tpu.connectors import tpcds as ref_gen
from presto_tpu.plan.stats import ColStats as RColStats
from presto_tpu_torch.catalog import TpcdsTable, tpcds_catalog
from presto_tpu_torch.connectors import tpcds as gen
from presto_tpu_torch.plan.stats import ColStats
from tests.torch_threads import torch_one_thread  # noqa: F401

SF = 0.01
TABLES = sorted(ref_gen.SCHEMAS)
SALES = ("store_sales", "catalog_sales", "web_sales")


@pytest.fixture(scope="module")
def generated():
    """{table: (the port's columns, presto_tpu's)} at SF0.01, each
    generated once on first use."""
    cache = {}

    def get(table):
        if table not in cache:
            cache[table] = (gen.generate(table, SF),
                            ref_gen.generate(table, SF))
        return cache[table]

    return get


def assert_columns_identical(mine, ref):
    assert list(mine) == list(ref)
    for name, a in mine.items():
        b = ref[name]
        assert type(a) is type(b), name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if isinstance(b, np.ma.MaskedArray):
            assert np.array_equal(np.ma.getmaskarray(a),
                                  np.ma.getmaskarray(b)), name
            a, b = np.ma.getdata(a), np.ma.getdata(b)
        if a.dtype.kind == "f":  # bit for bit, NaN included
            assert np.array_equal(a.view(np.int64) if a.itemsize == 8
                                  else a.view(np.int32),
                                  b.view(np.int64) if b.itemsize == 8
                                  else b.view(np.int32)), name
        else:
            assert np.array_equal(a, b), name


@pytest.mark.parametrize("table", TABLES)
def test_every_column_matches_reference(table, generated):
    mine, ref = generated(table)
    assert list(mine) == list(ref_gen.SCHEMAS[table])
    assert_columns_identical(mine, ref)
    assert len(next(iter(mine.values()))) == gen.row_count(table, SF)


@pytest.mark.parametrize("table", SALES)
def test_a_split_matches_reference(table, generated):
    lo, hi = 1000, 1500
    part = gen.generate(table, SF, lo, hi)
    assert_columns_identical(part, ref_gen.generate(table, SF, lo, hi))
    full = generated(table)[0]
    for name, col in part.items():  # split independence
        assert np.array_equal(col, full[name][lo:hi]), name


@pytest.mark.parametrize("sf", [0.01, 1, 10])
def test_row_counts_match_reference(sf):
    assert {t: gen.row_count(t, sf) for t in TABLES} \
        == {t: ref_gen.row_count(t, sf) for t in TABLES}


@pytest.mark.parametrize("table", TABLES)
def test_metadata_matches_reference(table):
    assert {c: str(t) for c, t in gen.SCHEMAS[table].items()} \
        == {c: str(t) for c, t in ref_gen.SCHEMAS[table].items()}
    assert gen.UNIQUE_KEYS.get(table) == ref_gen.UNIQUE_KEYS.get(table)
    assert gen.ORDERINGS.get(table) == ref_gen.ORDERINGS.get(table)
    assert gen.MAX_ROWS_PER_KEY.get(table) \
        == ref_gen.MAX_ROWS_PER_KEY.get(table)
    assert gen.PRIMARY_KEYS.get(table) == ref_gen.PRIMARY_KEYS.get(table)
    for sf in (SF, 1):
        for n in (1, 3, 8):
            assert gen.split_ranges(table, sf, n) \
                == ref_gen.split_ranges(table, sf, n)
        for column in gen.SCHEMAS[table]:
            mine = gen.column_stats(table, column, sf, ColStats)
            ref = ref_gen.column_stats(table, column, sf, RColStats)
            assert (mine is None) == (ref is None), column
            if mine is not None:
                assert dataclasses.astuple(mine) \
                    == dataclasses.astuple(ref), column


@pytest.fixture(scope="module")
def catalogs():
    return tpcds_catalog(SF), ref_tpcds_catalog(SF)


@pytest.mark.parametrize("table", TABLES)
def test_tpcds_table_matches_reference(table, catalogs):
    mine, ref = (c.get(table) for c in catalogs)
    assert isinstance(mine, TpcdsTable)
    assert list(mine.schema) == list(ref.schema)
    assert mine.row_count() == ref.row_count()
    assert mine.unique_keys() == ref.unique_keys()
    assert mine.max_rows_per_key() == ref.max_rows_per_key()
    assert mine.ordering() == ref.ordering()
    assert mine.splits(4) == ref.splits(4)
    assert mine.key_layout(next(iter(mine.schema))) is None
    assert mine.bucketing() is None  # chunked mode is not ported
    for column in mine.schema:
        a, b = mine.column_stats(column), ref.column_stats(column)
        assert (a is None) == (b is None), column
        if a is not None:
            assert dataclasses.astuple(a) == dataclasses.astuple(b), column
    split = mine.splits(3)[-1]
    cols = list(mine.schema)[:4]
    assert_columns_identical(mine.read(cols, split), ref.read(cols, split))


def test_cache_file_is_the_packages_own(tmp_path):
    table = TpcdsTable("income_band", SF, str(tmp_path))
    data = table.read()
    assert [p.name for p in tmp_path.iterdir()] \
        == [f"presto_tpu_torch_tpcds_income_band_sf{SF}_v2.pkl"]
    again = TpcdsTable("income_band", SF, str(tmp_path)).read()
    assert_columns_identical(again, data)
