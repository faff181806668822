"""The relational corpus over TPC-H: window functions (W), set operations
and grouping sets (S), FULL and CROSS joins (J).  W3 to W6 are the
reference's window tests (tests/test_window.py: running_sum,
rows_frame_minmax, lag_lead, percent_cume) verbatim.  chip_smoke.py runs
these at SF1 and the tests at SF0.01, from these strings."""

QUERIES = {
    "W1": ("SELECT rn, count(*) FROM (SELECT row_number() OVER "
           "(PARTITION BY l_orderkey ORDER BY l_linenumber) rn "
           "FROM lineitem) t GROUP BY rn ORDER BY rn"),
    "W2": ("SELECT o_orderpriority, count(*), sum(o_totalprice) FROM "
           "(SELECT o_orderpriority, o_totalprice, rank() OVER "
           "(PARTITION BY o_custkey ORDER BY o_totalprice DESC) rk "
           "FROM orders) t WHERE rk <= 3 GROUP BY o_orderpriority "
           "ORDER BY o_orderpriority"),
    "W3": (
        "SELECT o_custkey, o_orderkey, "
        "sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderkey) rs "
        "FROM orders ORDER BY o_custkey, o_orderkey LIMIT 100"),
    "W4": (
        "SELECT o_orderkey, "
        "min(o_totalprice) OVER (ORDER BY o_orderkey ROWS BETWEEN 3 PRECEDING AND 2 FOLLOWING) mn, "
        "max(o_totalprice) OVER (ORDER BY o_orderkey ROWS BETWEEN 3 PRECEDING AND 2 FOLLOWING) mx "
        "FROM orders ORDER BY o_orderkey LIMIT 80"),
    "W5": (
        "SELECT o_custkey, o_orderkey, "
        "lag(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderkey) lg, "
        "lead(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderkey) ld "
        "FROM orders ORDER BY o_custkey, o_orderkey LIMIT 100"),
    "W6": (
        "SELECT c_custkey, "
        "percent_rank() OVER (PARTITION BY c_nationkey ORDER BY c_acctbal) pr, "
        "cume_dist() OVER (PARTITION BY c_nationkey ORDER BY c_acctbal) cd "
        "FROM customer ORDER BY c_custkey LIMIT 100"),
    "S1": ("SELECT l_returnflag, count(*), sum(l_quantity) FROM "
           "(SELECT l_returnflag, l_quantity FROM lineitem "
           "WHERE l_shipdate < DATE '1995-01-01' UNION ALL "
           "SELECT l_returnflag, l_quantity FROM lineitem "
           "WHERE l_shipdate >= DATE '1997-01-01') t "
           "GROUP BY l_returnflag ORDER BY l_returnflag"),
    "S2": ("SELECT l_returnflag, l_linestatus, sum(l_quantity), "
           "sum(l_extendedprice), count(*) FROM lineitem "
           "GROUP BY ROLLUP (l_returnflag, l_linestatus) "
           "ORDER BY l_returnflag, l_linestatus"),
    "S3": ("SELECT count(*) FROM (SELECT c_custkey FROM customer "
           "EXCEPT SELECT o_custkey FROM orders) t"),
    "S4": ("SELECT count(*) FROM (SELECT c_custkey FROM customer "
           "INTERSECT SELECT o_custkey FROM orders) t"),
    "J1": ("SELECT count(*), count(o_orderkey), count(c_custkey), "
           "sum(o_totalprice) FROM (SELECT o_orderkey, o_custkey, "
           "o_totalprice FROM orders WHERE o_orderdate < DATE '1993-01-01') o "
           "FULL JOIN (SELECT c_custkey FROM customer WHERE c_nationkey < 10) c "
           "ON o.o_custkey = c.c_custkey"),
    "J2": ("SELECT n_name, r_name FROM nation CROSS JOIN region "
           "ORDER BY n_name, r_name"),
    "J3": ("SELECT count(*), sum(p_retailprice * n_nationkey) FROM part "
           "CROSS JOIN nation WHERE n_regionkey = 1"),
}
