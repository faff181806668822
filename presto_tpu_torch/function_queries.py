"""The function corpus over TPC-H: the scalar functions of the port's
functions/scalar.py and the one-scalar-per-group aggregates of
exec/executor.py, each reached by at least one query.

F1 to F5 are aggregates (approx_distinct at several register counts and
over a string column, the WITH ERROR sample, checksum, approx_percentile,
min_by and max_by, the bivariate and central-moment family, the boolean
and bitwise aggregates, avg over both interval types); F6 to F11 are
scalar functions (strings, regular expressions, dates, math, bitwise,
JSON), summed or folded per group.  chip_smoke.py runs these at SF1 and
the tests at SF0.01, from these strings.
"""

QUERIES = {
    "F1": ("SELECT l_returnflag, l_linestatus, approx_distinct(l_orderkey), "
           "approx_distinct(l_partkey, 0.0040625), "
           "approx_distinct(l_comment), approx_distinct(l_shipdate), "
           "count(l_orderkey) WITH ERROR, sum(l_quantity) WITH ERROR, "
           "checksum(l_orderkey), count(*) FROM lineitem "
           "GROUP BY l_returnflag, l_linestatus "
           "ORDER BY l_returnflag, l_linestatus"),
    "F2": ("SELECT o_custkey, approx_distinct(o_orderdate), "
           "approx_distinct(o_clerk), approx_distinct(o_comment), "
           "count(*) AS n FROM orders "
           "GROUP BY o_custkey ORDER BY n DESC, o_custkey LIMIT 100"),
    "F3": ("SELECT l_shipmode, approx_percentile(l_extendedprice, 0.5), "
           "approx_percentile(l_quantity, 0.99), "
           "min_by(l_orderkey, l_extendedprice), "
           "max_by(l_comment, l_receiptdate), arbitrary(l_shipinstruct), "
           "any_value(l_linestatus), count(*) FROM lineitem "
           "GROUP BY l_shipmode ORDER BY l_shipmode"),
    "F4": ("SELECT l_returnflag, corr(l_extendedprice, l_quantity), "
           "covar_samp(l_extendedprice, l_quantity), "
           "covar_pop(l_extendedprice, l_quantity), "
           "regr_slope(l_extendedprice, l_quantity), "
           "regr_intercept(l_extendedprice, l_quantity), "
           "skewness(l_discount), kurtosis(l_tax), "
           "geometric_mean(l_extendedprice), entropy(l_quantity), "
           "sum(l_extendedprice), avg(l_discount) FROM lineitem "
           "GROUP BY l_returnflag ORDER BY l_returnflag"),
    "F5": ("SELECT c_mktsegment, bool_and(o_totalprice > 1000), "
           "bool_or(o_orderstatus = 'P'), "
           "every(o_orderdate >= DATE '1992-01-01'), "
           "bitwise_and_agg(o_orderkey), bitwise_or_agg(o_custkey), "
           "checksum(o_comment), "
           "avg(CASE WHEN o_orderpriority = '1-URGENT' "
           "THEN INTERVAL '2' DAY ELSE INTERVAL '3' HOUR END), "
           "avg(CASE WHEN o_shippriority = 0 THEN INTERVAL '1' MONTH "
           "ELSE INTERVAL '2' YEAR END), count(*) "
           "FROM customer JOIN orders ON c_custkey = o_custkey "
           "GROUP BY c_mktsegment ORDER BY c_mktsegment"),
    "F6": ("SELECT split_part(p_type, ' ', 2) AS material, count(*), "
           "sum(length(lower(p_name))), max(strpos(p_name, 'green')), "
           "sum(position(p_type, 'BRASS')), "
           "count_if(starts_with(p_brand, 'Brand#1')), "
           "count_if(ends_with(p_container, 'BOX')), "
           "count_if(contains_str(p_comment, 'fur')), "
           "max(trim(lpad(p_mfgr, 20, ' '))), "
           "min(ltrim(lpad(p_container, 12))), "
           "max(rtrim(rpad(p_brand, 10, '.-'))), min(reverse(p_brand)), "
           "max(replace(p_container, ' ', '_')), sum(codepoint(p_brand)), "
           "min(chr(65) || repeat(p_size_text, 2)) "
           "FROM (SELECT p_type, p_name, p_brand, p_container, p_comment, "
           "p_mfgr, substr(p_brand, 7) AS p_size_text FROM part) p "
           "GROUP BY split_part(p_type, ' ', 2) ORDER BY material"),
    "F7": ("SELECT c_nationkey, "
           "count_if(regexp_like(o_comment, 'special.*requests')), "
           "max(regexp_extract(o_clerk, '[0-9]+')), "
           "min(regexp_replace(c_phone, '-', '')), count(*) "
           "FROM orders JOIN customer ON o_custkey = c_custkey "
           "GROUP BY c_nationkey ORDER BY c_nationkey"),
    "F8": ("SELECT date_trunc('month', o_orderdate) AS month, count(*), "
           "max(date_add('day', 30, o_orderdate)), "
           "min(date_add('month', 1, o_orderdate)), "
           "sum(date_diff('day', o_orderdate, DATE '1998-12-31')), "
           "max(date_diff('month', o_orderdate, DATE '1998-12-31')), "
           "max(last_day_of_month(o_orderdate)), "
           "sum(day_of_week(o_orderdate)), sum(dow(o_orderdate)), "
           "max(day_of_year(o_orderdate)), min(doy(o_orderdate)), "
           "max(week_of_year(o_orderdate)), min(week(o_orderdate)), "
           "count_if(o_orderdate < date('1995-06-17')), "
           "max(to_unixtime(from_unixtime(o_totalprice))) FROM orders "
           "GROUP BY date_trunc('month', o_orderdate) ORDER BY month"),
    "F9": ("SELECT width_bucket(l_extendedprice, 0, 110000, 10) AS bucket, "
           "count(*), sum(floor(l_extendedprice / 100)), "
           "sum(ceil(l_discount * 100)), sum(ceiling(l_tax * 100)), "
           "sum(truncate(l_extendedprice, -2)), sum(sqrt(l_quantity)), "
           "sum(exp(l_discount)), sum(ln(l_quantity)), "
           "sum(log10(l_extendedprice)), sum(log(2, l_quantity)), "
           "sum(sign(l_discount - 0.05)), sum(power(l_discount, 2)), "
           "sum(pow(l_tax, 0.5)), sum(atan2(l_quantity, l_discount)), "
           "max(pi() * l_quantity), max(e() * l_tax), "
           "sum(greatest(l_quantity, 10, l_tax)), "
           "sum(least(l_discount, 0.05)) FROM lineitem "
           "GROUP BY width_bucket(l_extendedprice, 0, 110000, 10) "
           "ORDER BY bucket"),
    "F10": ("SELECT o_orderstatus, sum(bitwise_and(o_orderkey, 255)), "
            "sum(bitwise_or(o_custkey, 1024)), "
            "sum(bitwise_xor(o_orderkey, o_custkey)), "
            "max(bitwise_left_shift(o_orderkey, 3)), "
            "max(bitwise_left_shift(o_orderkey, 63)), "
            "max(bitwise_left_shift(o_orderkey, 64)), "
            "max(bitwise_right_shift(-o_orderkey, 60)), "
            "max(bitwise_right_shift(-o_orderkey, 0)), "
            "max(bitwise_right_shift(o_orderkey, 65)), "
            "count_if(bitwise_right_shift(-o_custkey, 63) = 1), "
            "max(bitwise_left_shift(o_custkey, -1)), "
            "min(bitwise_not(o_orderkey)) FROM orders "
            "GROUP BY o_orderstatus ORDER BY o_orderstatus"),
    "F11": ("SELECT json_extract_scalar(j, '$.p') AS p, count(*), "
            "max(json_extract(j, '$.tags')), "
            "min(json_format(json_parse(j))), "
            "sum(json_array_length(json_extract(j, '$.tags'))), "
            "max(json_size(j, '$.x')), "
            "count_if(is_json_scalar(json_extract(j, '$.p'))) "
            "FROM (SELECT CASE o_orderpriority "
            "WHEN '1-URGENT' THEN '{\"p\": 1, \"tags\": [\"a\", \"b\"]}' "
            "WHEN '2-HIGH' THEN '{\"p\": 2, \"tags\": []}' "
            "ELSE '{\"p\": 3, \"tags\": [\"c\"], \"x\": {\"y\": true}}' "
            "END AS j FROM orders) t "
            "GROUP BY json_extract_scalar(j, '$.p') ORDER BY p"),
}

#: float columns held exactly, not within a tolerance: approx_percentile
#: returns one of its inputs, and F1's sampled sum adds whole numbers
EXACT_FLOAT_COLUMNS = {"F1": (7,), "F3": (1, 2)}
