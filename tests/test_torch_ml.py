"""functions/ml.py and the ML aggregates in presto_tpu_torch against
presto_tpu on the CPU.

- tests/test_ml.py's cases (its table: seed 12, n = 2000) through both
  packages in "dynamic", "auto" and "compiled": the same rows (doubles
  within rtol 1e-9: a model's product and an average's sum add in
  another order), model blobs byte for byte (training is the same numpy
  on the same rows in one process), the same error, execution mode,
  counters and memo entry;
- a blob trained by presto_tpu and stored in a memory table's VARBINARY
  column gives the port's classify and regress presto_tpu's outputs, and
  the reverse;
- the eight aggregates (learn_classifier, learn_regressor,
  evaluate_classifier_predictions and classification_{precision,
  recall, miss_rate, fall_out, thresholds}), grouped and with weights,
  and their errors;
- the M corpus of presto_tpu_torch/geo_ml_queries.py at SF0.01 against
  presto_tpu's records frozen in tests/torch_geo_ml_frozen.json.
"""

import numpy as np
import pytest

from presto_tpu_torch import geo_ml_queries as GQ
from presto_tpu_torch.catalog import tpch_catalog
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from tests import torch_geo_ml_common as C
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto", "compiled")


def _tables():
    """tests/test_ml.py's table."""
    rng = np.random.default_rng(12)
    n = 2000
    x1 = rng.normal(0, 1, n)
    x2 = rng.normal(0, 1, n)
    label = np.where(x1 + 2 * x2 > 0, "pos", "neg")
    y = 3.0 * x1 - 2.0 * x2 + 5.0 + rng.normal(0, 0.01, n)
    return {"d": ({"x1": "DOUBLE", "x2": "DOUBLE", "label": "VARCHAR",
                   "y": "DOUBLE"},
                  {"x1": x1, "x2": x2,
                   "label": np.asarray(label, dtype=object), "y": y})}


_NULLS = ("WITH t AS (SELECT y, x1, CASE WHEN x2 > 1.5 THEN "
          "CAST(NULL AS DOUBLE) ELSE x2 END AS x2n FROM d)")
_PRED = "CASE WHEN x2 < 0 THEN 0.2 ELSE 0.8 END"
_LEARNED = ("(SELECT learn_classifier(label, features(x1, x2)) AS model "
            "FROM d) m")

CASES = [
    # tests/test_ml.py
    "WITH m AS (SELECT learn_classifier(label, features(x1, x2)) AS model "
    "FROM d) SELECT avg(CASE WHEN classify(features(x1, x2), "
    "(SELECT model FROM m)) = label THEN 1.0 ELSE 0.0 END) FROM d",
    "WITH m AS (SELECT learn_regressor(y, features(x1, x2)) AS model "
    "FROM d) SELECT avg(abs(regress(features(x1, x2), "
    "(SELECT model FROM m)) - y)) FROM d",
    "SELECT sign, count(*) FROM (SELECT CASE WHEN x1 > 0 THEN 'r' ELSE 'l' "
    "END AS sign, label, x1, x2 FROM d) t GROUP BY sign ORDER BY sign",
    "SELECT sign, learn_regressor(x1, features(x2)) FROM (SELECT CASE "
    "WHEN x1 > 0 THEN 'r' ELSE 'l' END AS sign, x1, x2 FROM d) t "
    "GROUP BY sign ORDER BY sign",
    "SELECT avg(CASE WHEN classify(features(x1, x2), model) = label "
    f"THEN 1.0 ELSE 0.0 END) FROM d CROSS JOIN {_LEARNED}",
    "SELECT learn_regressor(label, features(x1)) FROM d",
    f"{_NULLS}, m AS (SELECT learn_regressor(y, features(x1, x2n)) AS model "
    "FROM t) SELECT avg(abs(regress(features(x1, x2n), "
    "(SELECT model FROM m)) - y)) FROM t WHERE x2n IS NOT NULL",
    # the blobs themselves, NULL features skipped
    "SELECT learn_classifier(label, features(x1, x2)), "
    "learn_regressor(y, features(x1, x2)) FROM d",
    f"{_NULLS} SELECT learn_regressor(y, features(x1, x2n)) FROM t",
    # the aggregates of evaluation
    f"SELECT classification_precision(4, x1 > 0, {_PRED}), "
    f"classification_recall(4, x1 > 0, {_PRED}), "
    "classification_thresholds(4, x1 > 0, 0.5), "
    "classification_miss_rate(5, x1 > 0, 0.3), "
    "classification_fall_out(5, x1 > 0, 0.7, 2.0) FROM d",
    f"SELECT label, classification_precision(3, x1 > 0, {_PRED}, x2 * x2) "
    "FROM d GROUP BY label ORDER BY label",
    "SELECT label, evaluate_classifier_predictions(label, "
    f"classify(features(x1, x2), model)) FROM d CROSS JOIN {_LEARNED} "
    "GROUP BY label ORDER BY label",
    "SELECT evaluate_classifier_predictions(label, CASE WHEN x1 > 0 THEN "
    "'pos' ELSE 'neg' END) FROM d",
    "SELECT classification_precision(1, x1 > 0, 0.5) FROM d",
    "SELECT classification_recall(4, x1 > 0, x2) FROM d",
    "SELECT classification_fall_out(4, x1 > 0, CASE WHEN x2 > 1 THEN nan() "
    "ELSE 0.5 END), classification_precision(4, x1 > 0, CASE WHEN x2 > 1 "
    "THEN nan() ELSE 0.25 END, 1.5) FROM d",
    "SELECT count(*), sum(regress(features(x1, x2), (SELECT "
    "learn_regressor(y, features(x1, x2)) FROM d))) FROM d",
    "SELECT x1 FROM d ORDER BY features(x1, x2) LIMIT 2",
]


@pytest.fixture(scope="module")
def sessions():
    out = {}
    for pkg in ("port", "ref"):
        cat = C.register(pkg, C.empty_catalog(pkg), _tables())
        for mode in MODES:
            out[pkg, mode] = C.connect(pkg, cat, mode)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", CASES)
def test_case_matches_reference(sql, mode, sessions):
    mine = GQ.record(sessions["port", mode], sql, SORT_STATS_KEYS)
    theirs = GQ.record(sessions["ref", mode], sql, SORT_STATS_KEYS)
    assert GQ.mismatch("case", mine, theirs) == ""


def test_blobs_are_byte_equal_in_one_process(sessions):
    sql = CASES[7]
    mine = sessions["port", "dynamic"].sql(sql).rows
    theirs = sessions["ref", "dynamic"].sql(sql).rows
    assert mine == theirs
    assert all(isinstance(b, bytes) and len(b) > 40 for b in mine[0])


@pytest.mark.parametrize("trained_by", ["ref", "port"])
def test_blobs_carry_across_packages(trained_by, sessions):
    """A blob trained by one package, stored in a memory table of the
    other's catalog (VARBINARY), gives that package the trainer's own
    classify and regress outputs."""
    blobs = sessions[trained_by, "dynamic"].sql(CASES[7]).rows[0]
    apply = ("SELECT classify(features(x1, x2), m.cm), count(*), "
             "sum(regress(features(x1, x2), m.rm)) FROM d CROSS JOIN "
             "models m GROUP BY 1 ORDER BY 1")
    got = {}
    for pkg in ("port", "ref"):
        cat = C.register(pkg, C.empty_catalog(pkg),
                         {**_tables(), "models": GQ.models_table(blobs)})
        got[pkg] = GQ.record(C.connect(pkg, cat, "auto"), apply,
                             SORT_STATS_KEYS)
    assert got["port"]["rows"][0][1] + got["port"]["rows"][1][1] == 2000
    assert GQ.mismatch("apply", got["port"], got["ref"]) == ""


def test_prediction_outside_the_unit_interval_raises(sessions):
    sql = "SELECT classification_recall(4, x1 > 0, x2) FROM d"
    for pkg in ("port", "ref"):
        with pytest.raises(Exception, match="predictions must be in"):
            sessions[pkg, "dynamic"].sql(sql)


# ---------------------------------------------------------------------------
# the M corpus at SF0.01
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    ref = C.frozen()["ml"]
    blobs = [text.encode() for text in ref["dynamic"]["M1"]["blobs"]]
    port = C.ml_runs("port", tpch_catalog(0.01), blobs)
    return {"port": port, "ref": ref}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sid", list(GQ.ML_QUERIES))
def test_corpus_matches_reference(sid, mode, corpus):
    mine, theirs = corpus["port"][mode][sid], corpus["ref"][mode][sid]
    assert GQ.mismatch(sid, mine, theirs) == ""
    if sid == "M1" and theirs["error"] is None:
        assert mine["blobs"] == theirs["blobs"]  # byte for byte


@pytest.mark.slow
def test_frozen_corpus_is_presto_tpus():
    cat = C.tpch("ref", 0.01, "/tmp/presto_tpu_cache")
    assert C.ml_runs("ref", cat, C.reference_blobs(cat)) \
        == C.frozen()["ml"]
