"""The collection corpus over TPC-H: ARRAY, MAP and ROW values, lambdas,
UNNEST and the aggregates that return collections, each of the port's
collection functions and aggregates reached by at least one query.

C1 and C2 expand rows with CROSS JOIN UNNEST (the words of p_name after
a join; a constant sequence over lineitem) and group the expansion, in
both executors as one captured program; C3 unnests array_agg's arrays
WITH ORDINALITY; C4 reads aggregated arrays with the element functions;
C5 to C7 build and read maps and sets (histogram, map_agg,
numeric_histogram, map_union, set_agg, set_union, multimap_agg,
array_agg DISTINCT); C8 runs the lambdas and the set functions over
split words; C9 the constructors, casts, subscripts and ROW fields.
chip_smoke.py runs these at SF1 and the tests at SF0.01, from these
strings.
"""

QUERIES = {
    "C1": ("SELECT w, count(*), sum(l_quantity) FROM lineitem JOIN part "
           "ON l_partkey = p_partkey CROSS JOIN UNNEST(split(p_name, ' ')) "
           "AS t(w) GROUP BY w ORDER BY w"),
    "C2": ("SELECT x, count(*), sum(l_extendedprice * x) FROM lineitem "
           "CROSS JOIN UNNEST(sequence(1, 3)) AS t(x) GROUP BY x "
           "ORDER BY x"),
    "C3": ("SELECT count(*), sum(o * x), max(n) FROM (SELECT o_custkey AS c, "
           "array_agg(o_orderkey) AS a, count(*) AS n FROM orders "
           "GROUP BY o_custkey) q CROSS JOIN UNNEST(q.a) WITH ORDINALITY "
           "AS u(x, o)"),
    "C4": ("SELECT count(*), sum(cardinality(a)), sum(array_max(a)), "
           "sum(array_min(a)), sum(element_at(a, -1)), "
           "sum(cardinality(slice(a, 2, 3))), count_if(contains(s, 'F')), "
           "sum(cardinality(array_distinct(s))), "
           "sum(array_position(s, 'O')), "
           "sum(cardinality(array_remove(s, 'P'))) FROM (SELECT o_custkey, "
           "array_agg(o_totalprice) AS a, array_agg(o_orderstatus) AS s "
           "FROM orders GROUP BY o_custkey)"),
    "C5": ("SELECT l_returnflag, histogram(l_shipmode), "
           "map_agg(l_linestatus, l_linenumber), "
           "numeric_histogram(4, l_discount) FROM lineitem "
           "GROUP BY l_returnflag ORDER BY 1"),
    "C6": ("SELECT map_keys(m), map_values(m), element_at(m, 'MAIL'), "
           "cardinality(map_filter(m, (k, v) -> v > 1000)), "
           "transform_values(m, (k, v) -> v * 2), map_entries(m) FROM "
           "(SELECT map_union(h) AS m FROM (SELECT l_returnflag, "
           "histogram(l_shipmode) AS h FROM lineitem GROUP BY l_returnflag))"),
    "C7": ("SELECT set_union(s), cardinality(set_union(s)), sum(n), "
           "max(cardinality(d)) FROM (SELECT o_orderstatus, "
           "set_agg(o_orderpriority) AS s, "
           "cardinality(multimap_agg(o_orderpriority, o_custkey)) AS n, "
           "array_agg(DISTINCT o_shippriority) AS d FROM orders "
           "GROUP BY o_orderstatus)"),
    "C8": ("SELECT p_brand, count(*), "
           "count_if(any_match(w, x -> length(x) > 8)), "
           "count_if(all_match(w, x -> length(x) > 2)), "
           "count_if(none_match(w, x -> x = 'red')), "
           "sum(reduce(w, 0, (s, x) -> s + length(x), s -> s)), "
           "sum(cardinality(filter(w, x -> x LIKE 'b%'))), "
           "max(array_join(array_sort(transform(w, x -> upper(x))), ',')), "
           "sum(cardinality(array_union(w, ARRAY['red', 'green', 'blue']))), "
           "sum(cardinality(array_intersect(w, "
           "ARRAY['red', 'green', 'blue']))), "
           "sum(cardinality(array_except(w, ARRAY['red', 'green', 'blue']))), "
           "count_if(arrays_overlap(w, ARRAY['red', 'green', 'blue'])), "
           "sum(cardinality(flatten(transform(w, x -> split(x, 'a'))))), "
           "max(array_join(zip_with(w, t, (a, b) -> concat(a, b)), ' ')) "
           "FROM (SELECT p_brand, split(p_name, ' ') AS w, "
           "split(lower(p_type), ' ') AS t FROM part) GROUP BY p_brand "
           "ORDER BY p_brand"),
    "C9": ("SELECT n_name, element_at(split(n_comment, ' '), 2), "
           "cardinality(map_concat(map(ARRAY['a'], ARRAY[1]), "
           "map(ARRAY['b'], ARRAY[2]))), "
           "map_from_entries(ARRAY[ROW('x', 1), ROW('y', 2)]), "
           "transform_keys(map(ARRAY[1, 2], ARRAY['u', 'v']), "
           "(k, v) -> k * 10), CAST(ARRAY[1, 2] AS ARRAY(DOUBLE)), "
           "ROW(1, 'z'), element_at(map(ARRAY['AFRICA', 'AMERICA'], "
           "ARRAY[1, 2]), 'ASIA'), split(n_comment, ' ')[1], "
           "CAST(ROW(1, 'z') AS ROW(k BIGINT, v VARCHAR)).v FROM nation "
           "JOIN region ON n_regionkey = r_regionkey ORDER BY n_name LIMIT 5"),
}

#: float columns held exactly, not within a tolerance (none: C2's and
#: C4's sums and C5's histogram means add floats)
EXACT_FLOAT_COLUMNS: dict = {}
