"""The 99 TPC-DS queries, copied from the reference's corpus
(tests/tpcds_queries.py: the official templates with widened
qualification parameters and explicit AS aliases) so that nothing
outside the package is needed to drive them.  Keyed by query number."""

QUERIES = {
1: """
WITH customer_total_return AS
 (SELECT sr_customer_sk AS ctr_customer_sk, sr_store_sk AS ctr_store_sk,
         sum(sr_return_amt) AS ctr_total_return
  FROM store_returns, date_dim
  WHERE sr_returned_date_sk = d_date_sk AND d_year = 2000
  GROUP BY sr_customer_sk, sr_store_sk)
SELECT c_customer_id
FROM customer_total_return ctr1, store, customer
WHERE ctr1.ctr_total_return >
      (SELECT avg(ctr_total_return) * 1.2 FROM customer_total_return ctr2
       WHERE ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  AND s_store_sk = ctr1.ctr_store_sk
  AND s_state IN ('TN', 'AL', 'AZ', 'CA', 'CO', 'FL', 'GA', 'IL', 'IN',
                  'IA', 'KS', 'KY', 'LA', 'MD', 'MI', 'MN', 'MO', 'NE',
                  'NJ', 'NY', 'OH', 'OK', 'PA', 'TX', 'VA', 'WA', 'WI')
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_id
LIMIT 100
""",
2: """
WITH wscs AS
 (SELECT sold_date_sk, sales_price FROM
   (SELECT ws_sold_date_sk AS sold_date_sk,
           ws_ext_sales_price AS sales_price FROM web_sales
    UNION ALL
    SELECT cs_sold_date_sk AS sold_date_sk,
           cs_ext_sales_price AS sales_price FROM catalog_sales) AS u),
 wswscs AS
 (SELECT d_week_seq,
         sum(CASE WHEN d_day_name = 'Sunday' THEN sales_price END)
             AS sun_sales,
         sum(CASE WHEN d_day_name = 'Monday' THEN sales_price END)
             AS mon_sales,
         sum(CASE WHEN d_day_name = 'Friday' THEN sales_price END)
             AS fri_sales,
         sum(CASE WHEN d_day_name = 'Saturday' THEN sales_price END)
             AS sat_sales
  FROM wscs, date_dim
  WHERE d_date_sk = sold_date_sk
  GROUP BY d_week_seq)
SELECT y.d_week_seq1 AS d_week_seq1,
       y.sun_sales1 / z.sun_sales2 AS sun_ratio,
       y.mon_sales1 / z.mon_sales2 AS mon_ratio,
       y.fri_sales1 / z.fri_sales2 AS fri_ratio,
       y.sat_sales1 / z.sat_sales2 AS sat_ratio
FROM (SELECT wswscs.d_week_seq AS d_week_seq1, sun_sales AS sun_sales1,
             mon_sales AS mon_sales1, fri_sales AS fri_sales1,
             sat_sales AS sat_sales1
      FROM wswscs, date_dim
      WHERE date_dim.d_week_seq = wswscs.d_week_seq AND d_year = 2000) y,
     (SELECT wswscs.d_week_seq AS d_week_seq2, sun_sales AS sun_sales2,
             mon_sales AS mon_sales2, fri_sales AS fri_sales2,
             sat_sales AS sat_sales2
      FROM wswscs, date_dim
      WHERE date_dim.d_week_seq = wswscs.d_week_seq AND d_year = 2001) z
WHERE d_week_seq1 = d_week_seq2 - 53
ORDER BY d_week_seq1
""",
3: """
SELECT dt.d_year AS d_year, item.i_brand_id AS brand_id,
       item.i_brand AS brand, sum(ss_ext_sales_price) AS sum_agg
FROM date_dim dt, store_sales, item
WHERE dt.d_date_sk = store_sales.ss_sold_date_sk
  AND store_sales.ss_item_sk = item.i_item_sk
  AND item.i_manufact_id BETWEEN 1 AND 100
  AND dt.d_moy = 11
GROUP BY dt.d_year, item.i_brand_id, item.i_brand
ORDER BY d_year, sum_agg DESC, brand_id
LIMIT 100
""",
4: """
WITH year_total AS
 (SELECT c_customer_id AS customer_id, c_first_name AS customer_first_name,
         c_last_name AS customer_last_name,
         c_preferred_cust_flag AS customer_preferred_cust_flag,
         c_birth_country AS customer_birth_country,
         c_login AS customer_login,
         c_email_address AS customer_email_address, d_year AS dyear,
         sum(((ss_ext_list_price - ss_ext_wholesale_cost
               - ss_ext_discount_amt) + ss_ext_sales_price) / 2)
             AS year_total,
         's' AS sale_type
  FROM customer, store_sales, date_dim
  WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
    AND d_year IN (2001, 2002)
  GROUP BY c_customer_id, c_first_name, c_last_name,
           c_preferred_cust_flag, c_birth_country, c_login,
           c_email_address, d_year
  UNION ALL
  SELECT c_customer_id AS customer_id, c_first_name AS customer_first_name,
         c_last_name AS customer_last_name,
         c_preferred_cust_flag AS customer_preferred_cust_flag,
         c_birth_country AS customer_birth_country,
         c_login AS customer_login,
         c_email_address AS customer_email_address, d_year AS dyear,
         sum((((cs_ext_list_price - cs_ext_wholesale_cost
                - cs_ext_discount_amt) + cs_ext_sales_price) / 2))
             AS year_total,
         'c' AS sale_type
  FROM customer, catalog_sales, date_dim
  WHERE c_customer_sk = cs_bill_customer_sk AND cs_sold_date_sk = d_date_sk
    AND d_year IN (2001, 2002)
  GROUP BY c_customer_id, c_first_name, c_last_name,
           c_preferred_cust_flag, c_birth_country, c_login,
           c_email_address, d_year
  UNION ALL
  SELECT c_customer_id AS customer_id, c_first_name AS customer_first_name,
         c_last_name AS customer_last_name,
         c_preferred_cust_flag AS customer_preferred_cust_flag,
         c_birth_country AS customer_birth_country,
         c_login AS customer_login,
         c_email_address AS customer_email_address, d_year AS dyear,
         sum((((ws_ext_list_price - ws_ext_wholesale_cost
                - ws_ext_discount_amt) + ws_ext_sales_price) / 2))
             AS year_total,
         'w' AS sale_type
  FROM customer, web_sales, date_dim
  WHERE c_customer_sk = ws_bill_customer_sk AND ws_sold_date_sk = d_date_sk
    AND d_year IN (2001, 2002)
  GROUP BY c_customer_id, c_first_name, c_last_name,
           c_preferred_cust_flag, c_birth_country, c_login,
           c_email_address, d_year)
SELECT t_s_secyear.customer_id AS customer_id,
       t_s_secyear.customer_first_name AS customer_first_name,
       t_s_secyear.customer_last_name AS customer_last_name,
       t_s_secyear.customer_email_address AS customer_email_address
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_c_firstyear, year_total t_c_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_c_secyear.customer_id
  AND t_s_firstyear.customer_id = t_c_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_c_firstyear.sale_type = 'c'
  AND t_w_firstyear.sale_type = 'w' AND t_s_secyear.sale_type = 's'
  AND t_c_secyear.sale_type = 'c' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.dyear = 2001 AND t_s_secyear.dyear = 2002
  AND t_c_firstyear.dyear = 2001 AND t_c_secyear.dyear = 2002
  AND t_w_firstyear.dyear = 2001 AND t_w_secyear.dyear = 2002
  AND t_s_firstyear.year_total > 0 AND t_c_firstyear.year_total > 0
  AND t_w_firstyear.year_total > 0
  AND CASE WHEN t_c_firstyear.year_total > 0
           THEN t_c_secyear.year_total / t_c_firstyear.year_total
           ELSE NULL END
      > CASE WHEN t_s_firstyear.year_total > 0
             THEN t_s_secyear.year_total / t_s_firstyear.year_total
             ELSE NULL END
  AND CASE WHEN t_c_firstyear.year_total > 0
           THEN t_c_secyear.year_total / t_c_firstyear.year_total
           ELSE NULL END
      > CASE WHEN t_w_firstyear.year_total > 0
             THEN t_w_secyear.year_total / t_w_firstyear.year_total
             ELSE NULL END
ORDER BY customer_id, customer_first_name, customer_last_name,
         customer_email_address
LIMIT 100
""",
5: """
SELECT channel, id, sum(sales) AS sales, sum(returns_amt) AS returns_amt,
       sum(profit) AS profit
FROM (
  SELECT 'store channel' AS channel, ss_store_sk AS id,
         ss_ext_sales_price AS sales, 0.0 AS returns_amt,
         ss_net_profit AS profit
  FROM store_sales
  UNION ALL
  SELECT 'store channel' AS channel, sr_store_sk AS id, 0.0 AS sales,
         sr_return_amt AS returns_amt, -sr_net_loss AS profit
  FROM store_returns
  UNION ALL
  SELECT 'catalog channel' AS channel, cs_call_center_sk AS id,
         cs_ext_sales_price AS sales, 0.0 AS returns_amt,
         cs_net_profit AS profit
  FROM catalog_sales
  UNION ALL
  SELECT 'web channel' AS channel, ws_web_site_sk AS id,
         ws_ext_sales_price AS sales, 0.0 AS returns_amt,
         ws_net_profit AS profit
  FROM web_sales
) AS x
GROUP BY channel, id
ORDER BY channel, id
LIMIT 100
""",
6: """SELECT a.ca_state AS state, count(*) AS cnt
FROM customer_address a, customer c, store_sales s, date_dim d, item i
WHERE a.ca_address_sk = c.c_current_addr_sk AND c.c_customer_sk = s.ss_customer_sk
  AND s.ss_sold_date_sk = d.d_date_sk AND s.ss_item_sk = i.i_item_sk
  AND d.d_month_seq = (SELECT DISTINCT d_month_seq FROM date_dim WHERE d_year = 2000 AND d_moy = 1)
  AND i.i_current_price > 1.2 * (SELECT avg(j.i_current_price) FROM item j WHERE j.i_category = i.i_category)
GROUP BY a.ca_state HAVING count(*) >= 2 ORDER BY cnt, state LIMIT 100""",
7: """
SELECT i_item_id, avg(ss_quantity) AS agg1, avg(ss_list_price) AS agg2,
       avg(ss_coupon_amt) AS agg3, avg(ss_sales_price) AS agg4
FROM store_sales, customer_demographics, date_dim, item, promotion
WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
  AND ss_cdemo_sk = cd_demo_sk AND ss_promo_sk = p_promo_sk
  AND cd_gender = 'M' AND cd_marital_status = 'S'
  AND cd_education_status = 'College'
  AND (p_channel_email = 'N' OR p_channel_event = 'N')
  AND d_year = 2000
GROUP BY i_item_id
ORDER BY i_item_id
LIMIT 100
""",
8: """
SELECT s_store_name, sum(ss_net_profit) AS total_profit
FROM store_sales, date_dim, store,
     (SELECT ca_zip FROM
       (SELECT substr(ca_zip, 1, 5) AS ca_zip FROM customer_address
        WHERE substr(ca_zip, 1, 1) IN ('1', '2', '3', '4', '5', '6', '7')
        INTERSECT
        SELECT ca_zip FROM
          (SELECT substr(ca_zip, 1, 5) AS ca_zip, count(*) AS cnt
           FROM customer_address, customer
           WHERE ca_address_sk = c_current_addr_sk
             AND c_preferred_cust_flag = 'Y'
           GROUP BY ca_zip HAVING count(*) > 1) AS a1) AS v1) AS v2
WHERE ss_store_sk = s_store_sk AND ss_sold_date_sk = d_date_sk
  AND d_qoy = 2 AND d_year = 1998
  AND substr(s_zip, 1, 2) = substr(v2.ca_zip, 1, 2)
GROUP BY s_store_name
ORDER BY s_store_name
LIMIT 100
""",
9: """
SELECT CASE WHEN (SELECT count(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20) > 10
            THEN (SELECT avg(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20)
            ELSE (SELECT avg(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20) END AS bucket1,
       CASE WHEN (SELECT count(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40) > 10
            THEN (SELECT avg(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40)
            ELSE (SELECT avg(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40) END AS bucket2,
       CASE WHEN (SELECT count(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60) > 10
            THEN (SELECT avg(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60)
            ELSE (SELECT avg(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60) END AS bucket3
FROM reason
WHERE r_reason_sk = 1
""",
10: """
SELECT cd_gender, cd_marital_status, cd_education_status,
       count(*) AS cnt1, cd_purchase_estimate, count(*) AS cnt2,
       cd_credit_rating, count(*) AS cnt3, cd_dep_count, count(*) AS cnt4,
       cd_dep_employed_count, count(*) AS cnt5, cd_dep_college_count,
       count(*) AS cnt6
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND ca_county IN ('Williamson County', 'Walker County', 'Ziebach County',
                    'Fairfield County', 'Bronx County', 'Franklin Parish',
                    'Barrow County', 'Daviess County', 'Luce County')
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT * FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk AND d_year = 2000
                AND d_moy BETWEEN 1 AND 4)
  AND (EXISTS (SELECT * FROM web_sales, date_dim
               WHERE c.c_customer_sk = ws_bill_customer_sk
                 AND ws_sold_date_sk = d_date_sk AND d_year = 2000
                 AND d_moy BETWEEN 1 AND 4)
       OR EXISTS (SELECT * FROM catalog_sales, date_dim
                  WHERE c.c_customer_sk = cs_ship_customer_sk
                    AND cs_sold_date_sk = d_date_sk AND d_year = 2000
                    AND d_moy BETWEEN 1 AND 4))
GROUP BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
ORDER BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
LIMIT 100
""",
11: """
WITH year_total AS
 (SELECT c_customer_id AS customer_id, c_first_name AS customer_first_name,
         c_last_name AS customer_last_name,
         c_preferred_cust_flag AS customer_preferred_cust_flag,
         c_birth_country AS customer_birth_country,
         c_login AS customer_login,
         c_email_address AS customer_email_address, d_year AS dyear,
         sum(ss_ext_list_price - ss_ext_discount_amt) AS year_total,
         's' AS sale_type
  FROM customer, store_sales, date_dim
  WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
    AND d_year IN (2001, 2002)
  GROUP BY c_customer_id, c_first_name, c_last_name,
           c_preferred_cust_flag, c_birth_country, c_login,
           c_email_address, d_year
  UNION ALL
  SELECT c_customer_id AS customer_id, c_first_name AS customer_first_name,
         c_last_name AS customer_last_name,
         c_preferred_cust_flag AS customer_preferred_cust_flag,
         c_birth_country AS customer_birth_country,
         c_login AS customer_login,
         c_email_address AS customer_email_address, d_year AS dyear,
         sum(ws_ext_list_price - ws_ext_discount_amt) AS year_total,
         'w' AS sale_type
  FROM customer, web_sales, date_dim
  WHERE c_customer_sk = ws_bill_customer_sk AND ws_sold_date_sk = d_date_sk
    AND d_year IN (2001, 2002)
  GROUP BY c_customer_id, c_first_name, c_last_name,
           c_preferred_cust_flag, c_birth_country, c_login,
           c_email_address, d_year)
SELECT t_s_secyear.customer_id AS customer_id,
       t_s_secyear.customer_first_name AS customer_first_name,
       t_s_secyear.customer_last_name AS customer_last_name,
       t_s_secyear.customer_preferred_cust_flag
           AS customer_preferred_cust_flag
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_w_firstyear.sale_type = 'w'
  AND t_s_secyear.sale_type = 's' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.dyear = 2001 AND t_s_secyear.dyear = 2002
  AND t_w_firstyear.dyear = 2001 AND t_w_secyear.dyear = 2002
  AND t_s_firstyear.year_total > 0 AND t_w_firstyear.year_total > 0
  AND CASE WHEN t_w_firstyear.year_total > 0
           THEN t_w_secyear.year_total / t_w_firstyear.year_total
           ELSE 0.0 END
      > CASE WHEN t_s_firstyear.year_total > 0
             THEN t_s_secyear.year_total / t_s_firstyear.year_total
             ELSE 0.0 END
ORDER BY customer_id, customer_first_name, customer_last_name,
         customer_preferred_cust_flag
LIMIT 100
""",
12: """
SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) AS itemrevenue
FROM web_sales, item, date_dim
WHERE ws_item_sk = i_item_sk
  AND i_category IN ('Sports', 'Books', 'Home')
  AND ws_sold_date_sk = d_date_sk
  AND d_year = 1999
GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
ORDER BY i_category, i_class, i_item_id, i_item_desc, itemrevenue
LIMIT 100
""",
13: """
SELECT avg(ss_quantity) AS avg_qty, avg(ss_ext_sales_price) AS avg_esp,
       avg(ss_ext_wholesale_cost) AS avg_ewc,
       sum(ss_ext_wholesale_cost) AS sum_ewc
FROM store_sales, store, customer_demographics, household_demographics,
     customer_address, date_dim
WHERE s_store_sk = ss_store_sk AND ss_sold_date_sk = d_date_sk
  AND d_year = 2001
  AND ss_hdemo_sk = hd_demo_sk AND cd_demo_sk = ss_cdemo_sk
  AND ((cd_marital_status = 'M' AND cd_education_status = 'College'
        AND ss_sales_price BETWEEN 10.00 AND 200.00
        AND hd_dep_count = 3)
    OR (cd_marital_status = 'S' AND cd_education_status = '2 yr Degree'
        AND ss_sales_price BETWEEN 5.00 AND 300.00
        AND hd_dep_count = 1))
  AND ss_addr_sk = ca_address_sk AND ca_country = 'United States'
""",
14: """
WITH cross_items AS
 (SELECT i_item_sk AS ss_item_sk
  FROM item,
   (SELECT iss.i_brand_id AS brand_id, iss.i_class_id AS class_id,
           iss.i_category_id AS category_id
    FROM store_sales, item iss, date_dim d1
    WHERE ss_item_sk = iss.i_item_sk AND ss_sold_date_sk = d1.d_date_sk
      AND d1.d_year BETWEEN 1999 AND 2001
    INTERSECT
    SELECT ics.i_brand_id AS brand_id, ics.i_class_id AS class_id,
           ics.i_category_id AS category_id
    FROM catalog_sales, item ics, date_dim d2
    WHERE cs_item_sk = ics.i_item_sk AND cs_sold_date_sk = d2.d_date_sk
      AND d2.d_year BETWEEN 1999 AND 2001
    INTERSECT
    SELECT iws.i_brand_id AS brand_id, iws.i_class_id AS class_id,
           iws.i_category_id AS category_id
    FROM web_sales, item iws, date_dim d3
    WHERE ws_item_sk = iws.i_item_sk AND ws_sold_date_sk = d3.d_date_sk
      AND d3.d_year BETWEEN 1999 AND 2001) AS x
  WHERE i_brand_id = brand_id AND i_class_id = class_id
    AND i_category_id = category_id),
 avg_sales AS
 (SELECT avg(quantity * list_price) AS average_sales FROM
   (SELECT ss_quantity AS quantity, ss_list_price AS list_price
    FROM store_sales, date_dim
    WHERE ss_sold_date_sk = d_date_sk AND d_year BETWEEN 1999 AND 2001
    UNION ALL
    SELECT cs_quantity AS quantity, cs_list_price AS list_price
    FROM catalog_sales, date_dim
    WHERE cs_sold_date_sk = d_date_sk AND d_year BETWEEN 1999 AND 2001
    UNION ALL
    SELECT ws_quantity AS quantity, ws_list_price AS list_price
    FROM web_sales, date_dim
    WHERE ws_sold_date_sk = d_date_sk
      AND d_year BETWEEN 1999 AND 2001) AS x)
SELECT channel, i_brand_id, i_class_id, i_category_id,
       sum(sales) AS sum_sales, sum(number_sales) AS sum_number_sales
FROM (SELECT 'store' AS channel, i_brand_id, i_class_id, i_category_id,
             sum(ss_quantity * ss_list_price) AS sales,
             count(*) AS number_sales
      FROM store_sales, item, date_dim
      WHERE ss_item_sk IN (SELECT ss_item_sk FROM cross_items)
        AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
        AND d_year = 2001 AND d_moy = 11
      GROUP BY i_brand_id, i_class_id, i_category_id
      HAVING sum(ss_quantity * ss_list_price) >
             (SELECT average_sales FROM avg_sales)
      UNION ALL
      SELECT 'catalog' AS channel, i_brand_id, i_class_id, i_category_id,
             sum(cs_quantity * cs_list_price) AS sales,
             count(*) AS number_sales
      FROM catalog_sales, item, date_dim
      WHERE cs_item_sk IN (SELECT ss_item_sk FROM cross_items)
        AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
        AND d_year = 2001 AND d_moy = 11
      GROUP BY i_brand_id, i_class_id, i_category_id
      HAVING sum(cs_quantity * cs_list_price) >
             (SELECT average_sales FROM avg_sales)
      UNION ALL
      SELECT 'web' AS channel, i_brand_id, i_class_id, i_category_id,
             sum(ws_quantity * ws_list_price) AS sales,
             count(*) AS number_sales
      FROM web_sales, item, date_dim
      WHERE ws_item_sk IN (SELECT ss_item_sk FROM cross_items)
        AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
        AND d_year = 2001 AND d_moy = 11
      GROUP BY i_brand_id, i_class_id, i_category_id
      HAVING sum(ws_quantity * ws_list_price) >
             (SELECT average_sales FROM avg_sales)) AS y
GROUP BY ROLLUP (channel, i_brand_id, i_class_id, i_category_id)
ORDER BY channel, i_brand_id, i_class_id, i_category_id
LIMIT 100
""",
15: """SELECT ca_zip AS ca_zip, sum(cs_sales_price) AS total
FROM catalog_sales, customer, customer_address, date_dim
WHERE cs_bill_customer_sk = c_customer_sk AND c_current_addr_sk = ca_address_sk
  AND (substr(ca_zip, 1, 5) IN ('85669','86197','88274','83405','86475','85392','85460','80348','81792')
       OR ca_state IN ('CA','WA','GA') OR cs_sales_price > 200)
  AND cs_sold_date_sk = d_date_sk AND d_qoy = 1 AND d_year = 2000
GROUP BY ca_zip ORDER BY ca_zip LIMIT 100""",
16: """
SELECT count(DISTINCT cs1.cs_order_number) AS order_count,
       sum(cs1.cs_ext_ship_cost) AS total_shipping_cost,
       sum(cs1.cs_net_profit) AS total_net_profit
FROM catalog_sales cs1, date_dim, customer_address, call_center
WHERE d_date BETWEEN DATE '2000-02-01' AND DATE '2000-06-01'
  AND cs1.cs_ship_date_sk = d_date_sk
  AND cs1.cs_ship_addr_sk = ca_address_sk
  AND ca_state IN ('GA', 'CA', 'TX', 'NY', 'OH')
  AND cs1.cs_call_center_sk = cc_call_center_sk
  AND EXISTS (SELECT 1 FROM catalog_sales cs2
              WHERE cs1.cs_order_number = cs2.cs_order_number
                AND cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
  AND NOT EXISTS (SELECT 1 FROM catalog_returns cr1
                  WHERE cs1.cs_order_number = cr1.cr_order_number)
""",
17: """
SELECT i_item_id, i_item_desc, s_state,
       count(ss_quantity) AS store_sales_quantitycount,
       avg(ss_quantity) AS store_sales_quantityave,
       stddev_samp(ss_quantity) AS store_sales_quantitystdev,
       count(sr_return_quantity) AS store_returns_quantitycount,
       avg(sr_return_quantity) AS store_returns_quantityave,
       count(cs_quantity) AS catalog_sales_quantitycount,
       avg(cs_quantity) AS catalog_sales_quantityave
FROM store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
WHERE d1.d_quarter_name = '2000Q1' AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
  AND ss_customer_sk = sr_customer_sk AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_quarter_name IN ('2000Q1', '2000Q2', '2000Q3')
  AND sr_customer_sk = cs_bill_customer_sk AND sr_item_sk = cs_item_sk
  AND cs_sold_date_sk = d3.d_date_sk
  AND d3.d_quarter_name IN ('2000Q1', '2000Q2', '2000Q3')
GROUP BY i_item_id, i_item_desc, s_state
ORDER BY i_item_id, i_item_desc, s_state
LIMIT 100
""",
18: """
SELECT i_item_id, ca_country, ca_state, ca_county,
       avg(cs_quantity) AS agg1, avg(cs_list_price) AS agg2,
       avg(cs_coupon_amt) AS agg3, avg(cs_sales_price) AS agg4
FROM catalog_sales, customer_demographics, customer, customer_address,
     date_dim, item
WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
  AND cs_bill_cdemo_sk = cd_demo_sk
  AND cs_bill_customer_sk = c_customer_sk
  AND cd_gender = 'F' AND cd_education_status = 'College'
  AND c_current_addr_sk = ca_address_sk AND d_year = 2001
  AND c_birth_month IN (1, 2, 3, 4, 5, 6)
GROUP BY ROLLUP (i_item_id, ca_country, ca_state, ca_county)
ORDER BY ca_country NULLS FIRST, ca_state NULLS FIRST,
         ca_county NULLS FIRST, i_item_id NULLS FIRST
LIMIT 100
""",
19: """
SELECT i_brand_id AS brand_id, i_brand AS brand, i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item, customer, customer_address, store
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id BETWEEN 1 AND 40 AND d_moy = 11 AND d_year = 1998
  AND ss_customer_sk = c_customer_sk AND c_current_addr_sk = ca_address_sk
  AND substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)
  AND ss_store_sk = s_store_sk
GROUP BY i_brand, i_brand_id, i_manufact_id, i_manufact
ORDER BY ext_price DESC, i_brand, i_brand_id, i_manufact_id, i_manufact
LIMIT 100
""",
20: """SELECT i_item_id AS i_item_id, i_item_desc AS i_item_desc, i_category AS i_category,
       i_class AS i_class, i_current_price AS i_current_price,
       sum(cs_ext_sales_price) AS itemrevenue
FROM catalog_sales, item, date_dim
WHERE cs_item_sk = i_item_sk AND i_category IN ('Sports', 'Books', 'Home')
  AND cs_sold_date_sk = d_date_sk AND d_year = 1999
GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
ORDER BY i_category, i_class, i_item_id, i_item_desc LIMIT 100""",
21: """
SELECT w_warehouse_name, i_item_id,
       sum(CASE WHEN d_date < DATE '2000-03-11' THEN inv_quantity_on_hand
                ELSE 0 END) AS inv_before,
       sum(CASE WHEN d_date >= DATE '2000-03-11' THEN inv_quantity_on_hand
                ELSE 0 END) AS inv_after
FROM inventory, warehouse, item, date_dim
WHERE i_item_sk = inv_item_sk AND inv_warehouse_sk = w_warehouse_sk
  AND inv_date_sk = d_date_sk
  AND i_current_price BETWEEN 0.99 AND 99.49
  AND d_date BETWEEN DATE '2000-02-10' AND DATE '2000-04-10'
GROUP BY w_warehouse_name, i_item_id
HAVING sum(CASE WHEN d_date < DATE '2000-03-11' THEN inv_quantity_on_hand
                ELSE 0 END) > 0
ORDER BY w_warehouse_name, i_item_id
LIMIT 100
""",
22: """
SELECT i_product_name, i_brand, i_class, i_category,
       avg(inv_quantity_on_hand) AS qoh
FROM inventory, date_dim, item
WHERE inv_date_sk = d_date_sk AND inv_item_sk = i_item_sk
  AND d_month_seq BETWEEN 1200 AND 1211
GROUP BY ROLLUP (i_product_name, i_brand, i_class, i_category)
ORDER BY qoh, i_product_name NULLS FIRST, i_brand NULLS FIRST,
         i_class NULLS FIRST, i_category NULLS FIRST
LIMIT 100
""",
23: """
WITH frequent_ss_items AS
 (SELECT substr(i_item_desc, 1, 30) AS itemdesc, i_item_sk AS item_sk,
         d_date AS solddate, count(*) AS cnt
  FROM store_sales, date_dim, item
  WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
    AND d_year IN (2000, 2001, 2002, 2003)
  GROUP BY substr(i_item_desc, 1, 30), i_item_sk, d_date
  HAVING count(*) > 2),
 max_store_sales AS
 (SELECT max(csales) AS tpcds_cmax FROM
   (SELECT c_customer_sk, sum(ss_quantity * ss_sales_price) AS csales
    FROM store_sales, customer, date_dim
    WHERE ss_customer_sk = c_customer_sk AND ss_sold_date_sk = d_date_sk
      AND d_year IN (2000, 2001, 2002, 2003)
    GROUP BY c_customer_sk) AS t),
 best_ss_customer AS
 (SELECT c_customer_sk, sum(ss_quantity * ss_sales_price) AS ssales
  FROM store_sales, customer
  WHERE ss_customer_sk = c_customer_sk
  GROUP BY c_customer_sk
  HAVING sum(ss_quantity * ss_sales_price) >
         0.5 * (SELECT tpcds_cmax FROM max_store_sales))
SELECT sum(sales) AS total_sales FROM
 (SELECT cs_quantity * cs_list_price AS sales
  FROM catalog_sales, date_dim
  WHERE d_year = 2000 AND d_moy = 2 AND cs_sold_date_sk = d_date_sk
    AND cs_item_sk IN (SELECT item_sk FROM frequent_ss_items)
    AND cs_bill_customer_sk IN (SELECT c_customer_sk
                                FROM best_ss_customer)
  UNION ALL
  SELECT ws_quantity * ws_list_price AS sales
  FROM web_sales, date_dim
  WHERE d_year = 2000 AND d_moy = 2 AND ws_sold_date_sk = d_date_sk
    AND ws_item_sk IN (SELECT item_sk FROM frequent_ss_items)
    AND ws_bill_customer_sk IN (SELECT c_customer_sk
                                FROM best_ss_customer)) AS u
""",
24: """
WITH ssales AS
 (SELECT c_last_name, c_first_name, s_store_name, ca_state, s_state,
         i_color, i_current_price, i_manager_id, i_units, i_size,
         sum(ss_net_paid) AS netpaid
  FROM store_sales, store_returns, store, item, customer, customer_address
  WHERE ss_ticket_number = sr_ticket_number AND ss_item_sk = sr_item_sk
    AND ss_customer_sk = c_customer_sk AND ss_item_sk = i_item_sk
    AND ss_store_sk = s_store_sk AND c_current_addr_sk = ca_address_sk
    AND c_birth_country = upper(ca_country)
    AND substr(s_zip, 1, 1) = substr(ca_zip, 1, 1)
  GROUP BY c_last_name, c_first_name, s_store_name, ca_state, s_state,
           i_color, i_current_price, i_manager_id, i_units, i_size)
SELECT c_last_name, c_first_name, s_store_name, sum(netpaid) AS paid
FROM ssales
WHERE i_color IN ('pale', 'red', 'blue', 'green', 'black', 'white')
GROUP BY c_last_name, c_first_name, s_store_name
HAVING sum(netpaid) > (SELECT 0.05 * avg(netpaid) FROM ssales)
ORDER BY c_last_name, c_first_name, s_store_name
""",
25: """
SELECT i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) AS store_sales_profit,
       sum(sr_net_loss) AS store_returns_loss,
       sum(cs_net_profit) AS catalog_sales_profit
FROM store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
WHERE d1.d_moy = 4 AND d1.d_year = 2001
  AND d1.d_date_sk = ss_sold_date_sk AND i_item_sk = ss_item_sk
  AND s_store_sk = ss_store_sk AND ss_customer_sk = sr_customer_sk
  AND ss_item_sk = sr_item_sk AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_moy BETWEEN 4 AND 10 AND d2.d_year = 2001
  AND sr_customer_sk = cs_bill_customer_sk AND sr_item_sk = cs_item_sk
  AND cs_sold_date_sk = d3.d_date_sk
  AND d3.d_moy BETWEEN 4 AND 10 AND d3.d_year = 2001
GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
ORDER BY i_item_id, i_item_desc, s_store_id, s_store_name
LIMIT 100
""",
26: """
SELECT i_item_id, avg(cs_quantity) AS agg1, avg(cs_list_price) AS agg2,
       avg(cs_coupon_amt) AS agg3, avg(cs_sales_price) AS agg4
FROM catalog_sales, customer_demographics, date_dim, item, promotion
WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
  AND cs_bill_cdemo_sk = cd_demo_sk AND cs_promo_sk = p_promo_sk
  AND cd_gender = 'M' AND cd_marital_status = 'S'
  AND cd_education_status = 'College'
  AND (p_channel_email = 'N' OR p_channel_event = 'N')
  AND d_year = 2000
GROUP BY i_item_id
ORDER BY i_item_id
LIMIT 100
""",
27: """SELECT i_item_id AS i_item_id, s_state AS s_state,
       avg(ss_quantity) AS agg1, avg(ss_list_price) AS agg2,
       avg(ss_coupon_amt) AS agg3, avg(ss_sales_price) AS agg4
FROM store_sales, customer_demographics, date_dim, store, item
WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
  AND ss_store_sk = s_store_sk AND ss_cdemo_sk = cd_demo_sk
  AND cd_gender = 'M' AND cd_marital_status = 'S' AND cd_education_status = 'College'
  AND d_year = 2000 AND s_state IN ('TN', 'SD')
GROUP BY i_item_id, s_state ORDER BY i_item_id, s_state LIMIT 100""",
28: """
SELECT b1.lp AS b1_lp, b1.cnt AS b1_cnt, b1.cntd AS b1_cntd,
       b2.lp AS b2_lp, b2.cnt AS b2_cnt, b2.cntd AS b2_cntd
FROM (SELECT avg(ss_list_price) AS lp, count(ss_list_price) AS cnt,
             count(DISTINCT ss_list_price) AS cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 0 AND 5) AS b1,
     (SELECT avg(ss_list_price) AS lp, count(ss_list_price) AS cnt,
             count(DISTINCT ss_list_price) AS cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 6 AND 10) AS b2
""",
29: """
SELECT i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) AS store_sales_quantity,
       sum(sr_return_quantity) AS store_returns_quantity
FROM store_sales, store_returns, store, item, date_dim d1, date_dim d2
WHERE d1.d_moy = 4 AND d1.d_year = 1999
  AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
  AND ss_customer_sk = sr_customer_sk AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_moy BETWEEN 4 AND 7 AND d2.d_year = 1999
GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
ORDER BY i_item_id, i_item_desc, s_store_id, s_store_name
LIMIT 100
""",
30: """
WITH customer_total_return AS
 (SELECT wr_returning_customer_sk AS ctr_customer_sk, ca_state AS ctr_state,
         sum(wr_return_amt) AS ctr_total_return
  FROM web_returns, date_dim, customer_address
  WHERE wr_returned_date_sk = d_date_sk AND d_year = 2000
    AND wr_returning_addr_sk = ca_address_sk
  GROUP BY wr_returning_customer_sk, ca_state)
SELECT c_customer_id, c_salutation, c_first_name, c_last_name,
       c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
       c_birth_country, c_login, c_email_address, c_last_review_date_sk,
       ctr_total_return
FROM customer_total_return ctr1, customer_address, customer
WHERE ctr1.ctr_total_return >
      (SELECT avg(ctr_total_return) * 1.2 FROM customer_total_return ctr2
       WHERE ctr1.ctr_state = ctr2.ctr_state)
  AND ca_address_sk = c_current_addr_sk
  AND ca_state IN ('GA', 'AL', 'CA', 'TX', 'NY', 'FL', 'IL', 'OH', 'PA',
                   'MI', 'NC', 'NJ', 'VA', 'WA', 'AZ', 'MA', 'IN', 'TN')
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_id, c_salutation, c_first_name, c_last_name,
         c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
         c_birth_country, c_login, c_email_address,
         c_last_review_date_sk, ctr_total_return
LIMIT 100
""",
31: """
WITH ss AS
 (SELECT ca_county, d_qoy, d_year, sum(ss_ext_sales_price) AS store_sales
  FROM store_sales, date_dim, customer_address
  WHERE ss_sold_date_sk = d_date_sk AND ss_addr_sk = ca_address_sk
  GROUP BY ca_county, d_qoy, d_year),
 ws AS
 (SELECT ca_county, d_qoy, d_year, sum(ws_ext_sales_price) AS web_sales
  FROM web_sales, date_dim, customer_address
  WHERE ws_sold_date_sk = d_date_sk AND ws_bill_addr_sk = ca_address_sk
  GROUP BY ca_county, d_qoy, d_year)
SELECT ss1.ca_county AS ca_county, ss1.d_year AS d_year,
       ws2.web_sales / ws1.web_sales AS web_q1_q2_increase,
       ss2.store_sales / ss1.store_sales AS store_q1_q2_increase,
       ws3.web_sales / ws2.web_sales AS web_q2_q3_increase,
       ss3.store_sales / ss2.store_sales AS store_q2_q3_increase
FROM ss ss1, ss ss2, ss ss3, ws ws1, ws ws2, ws ws3
WHERE ss1.d_qoy = 1 AND ss1.d_year = 2000
  AND ss1.ca_county = ss2.ca_county AND ss2.d_qoy = 2
  AND ss2.d_year = 2000 AND ss2.ca_county = ss3.ca_county
  AND ss3.d_qoy = 3 AND ss3.d_year = 2000
  AND ss1.ca_county = ws1.ca_county AND ws1.d_qoy = 1
  AND ws1.d_year = 2000 AND ws1.ca_county = ws2.ca_county
  AND ws2.d_qoy = 2 AND ws2.d_year = 2000
  AND ws1.ca_county = ws3.ca_county AND ws3.d_qoy = 3
  AND ws3.d_year = 2000
  AND CASE WHEN ws1.web_sales > 0 THEN ws2.web_sales / ws1.web_sales
           ELSE NULL END
      > CASE WHEN ss1.store_sales > 0
             THEN ss2.store_sales / ss1.store_sales ELSE NULL END
  AND CASE WHEN ws2.web_sales > 0 THEN ws3.web_sales / ws2.web_sales
           ELSE NULL END
      > CASE WHEN ss2.store_sales > 0
             THEN ss3.store_sales / ss2.store_sales ELSE NULL END
ORDER BY ss1.ca_county
""",
32: """
SELECT sum(cs_ext_discount_amt) AS excess_discount_amount
FROM catalog_sales, item, date_dim
WHERE i_manufact_id BETWEEN 1 AND 300
  AND i_item_sk = cs_item_sk
  AND d_date BETWEEN DATE '1999-01-01' AND DATE '1999-07-01'
  AND d_date_sk = cs_sold_date_sk
  AND cs_ext_discount_amt > (
    SELECT 1.3 * avg(cs2.cs_ext_discount_amt)
    FROM catalog_sales cs2, date_dim d2
    WHERE cs2.cs_item_sk = i_item_sk
      AND cs2.cs_sold_date_sk = d2.d_date_sk
      AND d2.d_date BETWEEN DATE '1999-01-01' AND DATE '1999-07-01')
""",
33: """
SELECT i_manufact_id, sum(total_sales) AS total_sales
FROM (
  SELECT i_manufact_id, ss_ext_sales_price AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_category = 'Electronics'
    AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 5
    AND ss_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
  UNION ALL
  SELECT i_manufact_id, cs_ext_sales_price AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_category = 'Electronics'
    AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 5
    AND cs_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
  UNION ALL
  SELECT i_manufact_id, ws_ext_sales_price AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_category = 'Electronics'
    AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 5
    AND ws_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
) AS tmp
GROUP BY i_manufact_id
ORDER BY total_sales, i_manufact_id
LIMIT 100
""",
34: """
SELECT c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
FROM (SELECT ss_ticket_number AS ss_ticket_number,
             ss_customer_sk AS ss_customer_sk, count(*) AS cnt
      FROM store_sales, date_dim, store, household_demographics
      WHERE store_sales.ss_sold_date_sk = date_dim.d_date_sk
        AND store_sales.ss_store_sk = store.s_store_sk
        AND store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        AND (date_dim.d_dom BETWEEN 1 AND 3
             OR date_dim.d_dom BETWEEN 25 AND 28)
        AND (household_demographics.hd_buy_potential = '>10000'
             OR household_demographics.hd_buy_potential = 'Unknown')
        AND household_demographics.hd_vehicle_count > 0
        AND date_dim.d_year IN (1999, 2000, 2001)
      GROUP BY ss_ticket_number, ss_customer_sk) AS dn, customer
WHERE ss_customer_sk = c_customer_sk AND cnt BETWEEN 1 AND 5
ORDER BY c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
         ss_ticket_number, cnt
LIMIT 1000
""",
35: """
SELECT ca_state, cd_gender, cd_marital_status, cd_dep_count,
       count(*) AS cnt1, avg(cd_dep_count) AS a1, max(cd_dep_count) AS m1,
       sum(cd_dep_count) AS s1, cd_dep_employed_count, count(*) AS cnt2,
       avg(cd_dep_employed_count) AS a2, max(cd_dep_employed_count) AS m2,
       sum(cd_dep_employed_count) AS s2, cd_dep_college_count,
       count(*) AS cnt3, avg(cd_dep_college_count) AS a3,
       max(cd_dep_college_count) AS m3, sum(cd_dep_college_count) AS s3
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT * FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk AND d_year = 2000
                AND d_qoy < 4)
  AND (EXISTS (SELECT * FROM web_sales, date_dim
               WHERE c.c_customer_sk = ws_bill_customer_sk
                 AND ws_sold_date_sk = d_date_sk AND d_year = 2000
                 AND d_qoy < 4)
       OR EXISTS (SELECT * FROM catalog_sales, date_dim
                  WHERE c.c_customer_sk = cs_ship_customer_sk
                    AND cs_sold_date_sk = d_date_sk AND d_year = 2000
                    AND d_qoy < 4))
GROUP BY ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
ORDER BY ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
LIMIT 100
""",
36: """
SELECT sum(ss_net_profit) / sum(ss_ext_sales_price) AS gross_margin,
       i_category, i_class,
       grouping(i_category) + grouping(i_class) AS lochierarchy,
       rank() OVER
           (PARTITION BY grouping(i_category) + grouping(i_class),
                         CASE WHEN grouping(i_class) = 0
                              THEN i_category END
            ORDER BY sum(ss_net_profit) / sum(ss_ext_sales_price) ASC)
           AS rank_within_parent
FROM store_sales, date_dim d1, item, store
WHERE d1.d_year = 2000 AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
GROUP BY ROLLUP (i_category, i_class)
ORDER BY lochierarchy DESC,
         CASE WHEN lochierarchy = 0 THEN i_category END,
         rank_within_parent, i_category, i_class
LIMIT 100
""",
37: """
SELECT i_item_id, i_item_desc, i_current_price
FROM item, inventory, date_dim, catalog_sales
WHERE i_current_price BETWEEN 10.0 AND 80.0
  AND inv_item_sk = i_item_sk AND d_date_sk = inv_date_sk
  AND d_date BETWEEN DATE '2000-02-01' AND DATE '2000-04-01'
  AND i_manufact_id BETWEEN 1 AND 300
  AND inv_quantity_on_hand BETWEEN 100 AND 500
  AND cs_item_sk = i_item_sk
GROUP BY i_item_id, i_item_desc, i_current_price
ORDER BY i_item_id
LIMIT 100
""",
38: """
SELECT count(*) AS cnt
FROM (
  (SELECT DISTINCT c_last_name, c_first_name, d_date
   FROM store_sales, date_dim, customer
   WHERE ss_sold_date_sk = d_date_sk AND ss_customer_sk = c_customer_sk
     AND d_month_seq BETWEEN 1200 AND 1211)
  INTERSECT
  (SELECT DISTINCT c_last_name, c_first_name, d_date
   FROM catalog_sales, date_dim, customer
   WHERE cs_sold_date_sk = d_date_sk AND cs_bill_customer_sk = c_customer_sk
     AND d_month_seq BETWEEN 1200 AND 1211)
  INTERSECT
  (SELECT DISTINCT c_last_name, c_first_name, d_date
   FROM web_sales, date_dim, customer
   WHERE ws_sold_date_sk = d_date_sk AND ws_bill_customer_sk = c_customer_sk
     AND d_month_seq BETWEEN 1200 AND 1211)
) AS hot_cust
""",
39: """
WITH inv AS
 (SELECT w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy, stdev, mean,
         CASE mean WHEN 0 THEN NULL ELSE stdev / mean END AS cov
  FROM (SELECT w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
               stddev_samp(inv_quantity_on_hand) AS stdev,
               avg(inv_quantity_on_hand) AS mean
        FROM inventory, item, warehouse, date_dim
        WHERE inv_item_sk = i_item_sk
          AND inv_warehouse_sk = w_warehouse_sk
          AND inv_date_sk = d_date_sk AND d_year = 2000
        GROUP BY w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy)
       AS foo
  WHERE CASE mean WHEN 0 THEN 0 ELSE stdev / mean END > 0.5)
SELECT inv1.w_warehouse_sk AS wsk1, inv1.i_item_sk AS isk1,
       inv1.d_moy AS moy1, inv1.mean AS mean1, inv1.cov AS cov1,
       inv2.w_warehouse_sk AS wsk2, inv2.i_item_sk AS isk2,
       inv2.d_moy AS moy2, inv2.mean AS mean2, inv2.cov AS cov2
FROM inv inv1, inv inv2
WHERE inv1.i_item_sk = inv2.i_item_sk
  AND inv1.w_warehouse_sk = inv2.w_warehouse_sk
  AND inv1.d_moy = 4 AND inv2.d_moy = 5
ORDER BY wsk1, isk1, moy1, mean1, cov1, wsk2, isk2, moy2, mean2, cov2
LIMIT 100
""",
40: """
SELECT w_state, i_item_id,
       sum(CASE WHEN d_date < DATE '2000-03-11'
                THEN cs_sales_price - coalesce(cr_refunded_cash, 0.0)
                ELSE 0.0 END) AS sales_before,
       sum(CASE WHEN d_date >= DATE '2000-03-11'
                THEN cs_sales_price - coalesce(cr_refunded_cash, 0.0)
                ELSE 0.0 END) AS sales_after
FROM catalog_sales
LEFT JOIN catalog_returns ON cs_order_number = cr_order_number
                         AND cs_item_sk = cr_item_sk
JOIN warehouse ON cs_warehouse_sk = w_warehouse_sk
JOIN item ON i_item_sk = cs_item_sk
JOIN date_dim ON cs_sold_date_sk = d_date_sk
WHERE i_current_price BETWEEN 0.99 AND 99.49
  AND d_date BETWEEN DATE '2000-02-10' AND DATE '2000-04-10'
GROUP BY w_state, i_item_id
ORDER BY w_state, i_item_id
LIMIT 100
""",
41: """
SELECT DISTINCT i_product_name
FROM item i1
WHERE i_manufact_id BETWEEN 1 AND 200
  AND (SELECT count(*) FROM item
       WHERE i_manufact = i1.i_manufact
         AND ((i_category = 'Women'
               AND i_color IN ('powder', 'khaki', 'brown', 'honeydew')
               AND i_units IN ('Ounce', 'Oz', 'Each', 'Ton'))
           OR (i_category = 'Men'
               AND i_color IN ('floral', 'deep', 'light', 'cornflower')
               AND i_units IN ('Box', 'Carton', 'Case', 'Dozen')))) > 0
ORDER BY i_product_name
LIMIT 100
""",
42: """
SELECT dt.d_year AS d_year, item.i_category_id AS i_category_id,
       item.i_category AS i_category,
       sum(ss_ext_sales_price) AS total_sales
FROM date_dim dt, store_sales, item
WHERE dt.d_date_sk = store_sales.ss_sold_date_sk
  AND store_sales.ss_item_sk = item.i_item_sk
  AND item.i_manager_id BETWEEN 1 AND 20
  AND dt.d_moy = 11 AND dt.d_year = 2000
GROUP BY dt.d_year, item.i_category_id, item.i_category
ORDER BY total_sales DESC, d_year, i_category_id, i_category
LIMIT 100
""",
43: """SELECT s_store_name AS s_store_name, s_store_id AS s_store_id,
       sum(CASE WHEN (d_day_name = 'Sunday') THEN ss_sales_price ELSE NULL END) AS sun_sales,
       sum(CASE WHEN (d_day_name = 'Monday') THEN ss_sales_price ELSE NULL END) AS mon_sales,
       sum(CASE WHEN (d_day_name = 'Friday') THEN ss_sales_price ELSE NULL END) AS fri_sales
FROM date_dim, store_sales, store
WHERE d_date_sk = ss_sold_date_sk AND s_store_sk = ss_store_sk AND d_year = 2000
GROUP BY s_store_name, s_store_id ORDER BY s_store_name, s_store_id LIMIT 100""",
44: """
SELECT asceding.rnk AS rnk, i1.i_product_name AS best_performing,
       i2.i_product_name AS worst_performing
FROM (
  SELECT item_sk, rnk FROM (
    SELECT ss_item_sk AS item_sk, avg(ss_net_profit) AS rank_col,
           rank() OVER (ORDER BY avg(ss_net_profit) DESC, ss_item_sk) AS rnk
    FROM store_sales
    WHERE ss_store_sk = 4
    GROUP BY ss_item_sk) AS v1
  WHERE rnk < 11) AS asceding,
  (SELECT item_sk, rnk FROM (
    SELECT ss_item_sk AS item_sk, avg(ss_net_profit) AS rank_col,
           rank() OVER (ORDER BY avg(ss_net_profit) ASC, ss_item_sk) AS rnk
    FROM store_sales
    WHERE ss_store_sk = 4
    GROUP BY ss_item_sk) AS v2
  WHERE rnk < 11) AS descending,
  item i1, item i2
WHERE asceding.rnk = descending.rnk
  AND i1.i_item_sk = asceding.item_sk
  AND i2.i_item_sk = descending.item_sk
ORDER BY asceding.rnk
LIMIT 100
""",
45: """
SELECT ca_zip, ca_city, sum(ws_sales_price) AS total_sales
FROM web_sales
JOIN customer ON ws_bill_customer_sk = c_customer_sk
JOIN customer_address ON c_current_addr_sk = ca_address_sk
JOIN item ON ws_item_sk = i_item_sk
JOIN date_dim ON ws_sold_date_sk = d_date_sk
LEFT JOIN (SELECT DISTINCT i2.i_item_id AS flag_item_id FROM item i2
           WHERE i2.i_item_sk IN (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)) AS f
       ON f.flag_item_id = i_item_id
WHERE (substr(ca_zip, 1, 5) IN
        ('85669', '86197', '88274', '83405', '86475',
         '85392', '85460', '80348', '81792')
       OR f.flag_item_id IS NOT NULL)
  AND d_qoy = 2 AND d_year = 2001
GROUP BY ca_zip, ca_city
ORDER BY ca_zip, ca_city
LIMIT 100
""",
46: """
SELECT c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       amt, profit
FROM (SELECT ss_ticket_number AS ss_ticket_number,
             ss_customer_sk AS ss_customer_sk, ca_city AS bought_city,
             sum(ss_coupon_amt) AS amt, sum(ss_net_profit) AS profit
      FROM store_sales, date_dim, store, household_demographics,
           customer_address
      WHERE store_sales.ss_sold_date_sk = date_dim.d_date_sk
        AND store_sales.ss_store_sk = store.s_store_sk
        AND store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        AND store_sales.ss_addr_sk = customer_address.ca_address_sk
        AND (household_demographics.hd_dep_count = 4
             OR household_demographics.hd_vehicle_count = 3)
        AND date_dim.d_dow IN (6, 0)
        AND date_dim.d_year IN (1999, 2000, 2001)
      GROUP BY ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) AS dn,
     customer, customer_address AS current_addr
WHERE ss_customer_sk = c_customer_sk
  AND customer.c_current_addr_sk = current_addr.ca_address_sk
  AND current_addr.ca_city <> bought_city
ORDER BY c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number
LIMIT 100
""",
47: """
WITH v1 AS
 (SELECT i_category, i_brand, s_store_name, s_company_name, d_year, d_moy,
         sum(ss_sales_price) AS sum_sales,
         avg(sum(ss_sales_price)) OVER
             (PARTITION BY i_category, i_brand, s_store_name,
                           s_company_name, d_year) AS avg_monthly_sales,
         rank() OVER
             (PARTITION BY i_category, i_brand, s_store_name,
                           s_company_name
              ORDER BY d_year, d_moy) AS rn
  FROM item, store_sales, date_dim, store
  WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND (d_year = 2000 OR (d_year = 1999 AND d_moy = 12)
         OR (d_year = 2001 AND d_moy = 1))
  GROUP BY i_category, i_brand, s_store_name, s_company_name,
           d_year, d_moy),
 v2 AS
 (SELECT v1.i_category AS i_category, v1.i_brand AS i_brand,
         v1.s_store_name AS s_store_name,
         v1.s_company_name AS s_company_name, v1.d_year AS d_year,
         v1.d_moy AS d_moy, v1.avg_monthly_sales AS avg_monthly_sales,
         v1.sum_sales AS sum_sales, v1_lag.sum_sales AS psum,
         v1_lead.sum_sales AS nsum
  FROM v1, v1 v1_lag, v1 v1_lead
  WHERE v1.i_category = v1_lag.i_category
    AND v1.i_category = v1_lead.i_category
    AND v1.i_brand = v1_lag.i_brand AND v1.i_brand = v1_lead.i_brand
    AND v1.s_store_name = v1_lag.s_store_name
    AND v1.s_store_name = v1_lead.s_store_name
    AND v1.s_company_name = v1_lag.s_company_name
    AND v1.s_company_name = v1_lead.s_company_name
    AND v1.rn = v1_lag.rn + 1 AND v1.rn = v1_lead.rn - 1)
SELECT i_category, i_brand, s_store_name, s_company_name, d_year, d_moy,
       avg_monthly_sales, sum_sales, psum, nsum
FROM v2
WHERE d_year = 2000 AND avg_monthly_sales > 0
  AND CASE WHEN avg_monthly_sales > 0
           THEN abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           ELSE NULL END > 0.1
ORDER BY sum_sales - avg_monthly_sales, s_store_name, i_category,
         i_brand, s_company_name, d_year, d_moy
LIMIT 100
""",
48: """SELECT sum(ss_quantity) AS total
FROM store_sales, store, customer_demographics, customer_address, date_dim
WHERE s_store_sk = ss_store_sk AND ss_sold_date_sk = d_date_sk AND d_year = 2000
  AND ((cd_demo_sk = ss_cdemo_sk AND cd_marital_status = 'M' AND cd_education_status = '4 yr Degree'
        AND ss_sales_price BETWEEN 100.00 AND 150.00)
    OR (cd_demo_sk = ss_cdemo_sk AND cd_marital_status = 'D' AND cd_education_status = '2 yr Degree'
        AND ss_sales_price BETWEEN 50.00 AND 100.00))
  AND ((ss_addr_sk = ca_address_sk AND ca_country = 'United States' AND ca_state IN ('CO','OH','TX')
        AND ss_net_profit BETWEEN 0 AND 2000)
    OR (ss_addr_sk = ca_address_sk AND ca_country = 'United States' AND ca_state IN ('OR','MN','KY')
        AND ss_net_profit BETWEEN 150 AND 3000))""",
49: """
SELECT channel, item, return_ratio, return_rank, currency_rank FROM
 (SELECT 'web' AS channel, web.item AS item,
         web.return_ratio AS return_ratio,
         web.return_rank AS return_rank,
         web.currency_rank AS currency_rank
  FROM (SELECT item, return_ratio, currency_ratio,
               rank() OVER (ORDER BY return_ratio) AS return_rank,
               rank() OVER (ORDER BY currency_ratio) AS currency_rank
        FROM (SELECT ws.ws_item_sk AS item,
                     cast(sum(coalesce(wr.wr_return_quantity, 0))
                          AS DOUBLE)
                     / cast(sum(coalesce(ws.ws_quantity, 0)) AS DOUBLE)
                         AS return_ratio,
                     cast(sum(coalesce(wr.wr_return_amt, 0)) AS DOUBLE)
                     / cast(sum(coalesce(ws.ws_net_paid, 0)) AS DOUBLE)
                         AS currency_ratio
              FROM web_sales ws
                   LEFT OUTER JOIN web_returns wr
                        ON (ws.ws_order_number = wr.wr_order_number
                            AND ws.ws_item_sk = wr.wr_item_sk),
                   date_dim
              WHERE wr.wr_return_amt > 100 AND ws.ws_net_profit > 1
                AND ws.ws_net_paid > 0 AND ws.ws_quantity > 0
                AND ws_sold_date_sk = d_date_sk AND d_year = 2000
                AND d_moy = 12
              GROUP BY ws.ws_item_sk) AS in_web) AS web
  WHERE web.return_rank <= 10 OR web.currency_rank <= 10
  UNION
  SELECT 'catalog' AS channel, cat.item AS item,
         cat.return_ratio AS return_ratio,
         cat.return_rank AS return_rank,
         cat.currency_rank AS currency_rank
  FROM (SELECT item, return_ratio, currency_ratio,
               rank() OVER (ORDER BY return_ratio) AS return_rank,
               rank() OVER (ORDER BY currency_ratio) AS currency_rank
        FROM (SELECT cs.cs_item_sk AS item,
                     cast(sum(coalesce(cr.cr_return_quantity, 0))
                          AS DOUBLE)
                     / cast(sum(coalesce(cs.cs_quantity, 0)) AS DOUBLE)
                         AS return_ratio,
                     cast(sum(coalesce(cr.cr_return_amount, 0))
                          AS DOUBLE)
                     / cast(sum(coalesce(cs.cs_net_paid, 0)) AS DOUBLE)
                         AS currency_ratio
              FROM catalog_sales cs
                   LEFT OUTER JOIN catalog_returns cr
                        ON (cs.cs_order_number = cr.cr_order_number
                            AND cs.cs_item_sk = cr.cr_item_sk),
                   date_dim
              WHERE cr.cr_return_amount > 100 AND cs.cs_net_profit > 1
                AND cs.cs_net_paid > 0 AND cs.cs_quantity > 0
                AND cs_sold_date_sk = d_date_sk AND d_year = 2000
                AND d_moy = 12
              GROUP BY cs.cs_item_sk) AS in_cat) AS cat
  WHERE cat.return_rank <= 10 OR cat.currency_rank <= 10
  UNION
  SELECT 'store' AS channel, store.item AS item,
         store.return_ratio AS return_ratio,
         store.return_rank AS return_rank,
         store.currency_rank AS currency_rank
  FROM (SELECT item, return_ratio, currency_ratio,
               rank() OVER (ORDER BY return_ratio) AS return_rank,
               rank() OVER (ORDER BY currency_ratio) AS currency_rank
        FROM (SELECT sts.ss_item_sk AS item,
                     cast(sum(coalesce(sr.sr_return_quantity, 0))
                          AS DOUBLE)
                     / cast(sum(coalesce(sts.ss_quantity, 0)) AS DOUBLE)
                         AS return_ratio,
                     cast(sum(coalesce(sr.sr_return_amt, 0)) AS DOUBLE)
                     / cast(sum(coalesce(sts.ss_net_paid, 0)) AS DOUBLE)
                         AS currency_ratio
              FROM store_sales sts
                   LEFT OUTER JOIN store_returns sr
                        ON (sts.ss_ticket_number = sr.sr_ticket_number
                            AND sts.ss_item_sk = sr.sr_item_sk),
                   date_dim
              WHERE sr.sr_return_amt > 100 AND sts.ss_net_profit > 1
                AND sts.ss_net_paid > 0 AND sts.ss_quantity > 0
                AND ss_sold_date_sk = d_date_sk AND d_year = 2000
                AND d_moy = 12
              GROUP BY sts.ss_item_sk) AS in_store) AS store
  WHERE store.return_rank <= 10 OR store.currency_rank <= 10) AS w2
ORDER BY channel, return_rank, currency_rank, item
LIMIT 100
""",
50: """
SELECT s_store_name, s_company_id, s_street_number, s_street_name,
       s_street_type, s_suite_number, s_city, s_county, s_state, s_zip,
       sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS days_30,
       sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 30
                 AND sr_returned_date_sk - ss_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS days_31_60,
       sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 60
                THEN 1 ELSE 0 END) AS days_over_60
FROM store_sales, store_returns, store, date_dim d2
WHERE ss_ticket_number = sr_ticket_number AND ss_item_sk = sr_item_sk
  AND ss_customer_sk = sr_customer_sk
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_year = 1999 AND d2.d_moy = 8
  AND ss_store_sk = s_store_sk
GROUP BY s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
ORDER BY s_store_name, s_company_id
LIMIT 100
""",
51: """
WITH web_v1 AS
 (SELECT ws_item_sk AS item_sk, d_date,
         sum(sum(ws_sales_price)) OVER
             (PARTITION BY ws_item_sk ORDER BY d_date
              ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
             AS cume_sales
  FROM web_sales, date_dim
  WHERE ws_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 1200 AND 1211
  GROUP BY ws_item_sk, d_date),
 store_v1 AS
 (SELECT ss_item_sk AS item_sk, d_date,
         sum(sum(ss_sales_price)) OVER
             (PARTITION BY ss_item_sk ORDER BY d_date
              ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
             AS cume_sales
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 1200 AND 1211
  GROUP BY ss_item_sk, d_date)
SELECT item_sk, d_date, web_sales, store_sales, web_cumulative,
       store_cumulative
FROM (SELECT item_sk, d_date, web_sales, store_sales,
             max(web_sales) OVER
                 (PARTITION BY item_sk ORDER BY d_date
                  ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
                 AS web_cumulative,
             max(store_sales) OVER
                 (PARTITION BY item_sk ORDER BY d_date
                  ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
                 AS store_cumulative
      FROM (SELECT CASE WHEN web.item_sk IS NOT NULL THEN web.item_sk
                        ELSE store.item_sk END AS item_sk,
                   CASE WHEN web.d_date IS NOT NULL THEN web.d_date
                        ELSE store.d_date END AS d_date,
                   web.cume_sales AS web_sales,
                   store.cume_sales AS store_sales
            FROM web_v1 web FULL OUTER JOIN store_v1 store
                 ON (web.item_sk = store.item_sk
                     AND web.d_date = store.d_date)) AS x) AS y
WHERE web_cumulative > store_cumulative
ORDER BY item_sk, d_date
LIMIT 100
""",
52: """
SELECT dt.d_year AS d_year, item.i_brand_id AS brand_id,
       item.i_brand AS brand, sum(ss_ext_sales_price) AS ext_price
FROM date_dim dt, store_sales, item
WHERE dt.d_date_sk = store_sales.ss_sold_date_sk
  AND store_sales.ss_item_sk = item.i_item_sk
  AND item.i_manager_id BETWEEN 1 AND 20
  AND dt.d_moy = 11 AND dt.d_year = 2000
GROUP BY dt.d_year, item.i_brand, item.i_brand_id
ORDER BY d_year, ext_price DESC, brand_id
LIMIT 100
""",
53: """
SELECT manufact_id, sum_sales, avg_quarterly
FROM (
  SELECT i_manufact_id AS manufact_id,
         sum(ss_sales_price) AS sum_sales,
         avg(sum(ss_sales_price)) OVER (PARTITION BY i_manufact_id)
           AS avg_quarterly
  FROM item, store_sales, date_dim, store
  WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND d_month_seq BETWEEN 1200 AND 1211
    AND i_category IN ('Books', 'Children', 'Electronics')
  GROUP BY i_manufact_id, d_qoy
) AS tmp
WHERE avg_quarterly > 0 AND abs(sum_sales - avg_quarterly) / avg_quarterly > 0.1
ORDER BY avg_quarterly, sum_sales, manufact_id
LIMIT 100
""",
54: """
WITH my_customers AS
 (SELECT DISTINCT c_customer_sk, c_current_addr_sk
  FROM (SELECT cs_sold_date_sk AS sold_date_sk,
               cs_bill_customer_sk AS customer_sk,
               cs_item_sk AS item_sk FROM catalog_sales
        UNION ALL
        SELECT ws_sold_date_sk AS sold_date_sk,
               ws_bill_customer_sk AS customer_sk,
               ws_item_sk AS item_sk FROM web_sales) AS cs_or_ws_sales,
       item, date_dim, customer
  WHERE sold_date_sk = d_date_sk AND item_sk = i_item_sk
    AND i_category = 'Women'
    AND i_class IN ('dresses', 'pants', 'shirts', 'accessories')
    AND c_customer_sk = cs_or_ws_sales.customer_sk
    AND d_moy = 12 AND d_year = 2000),
 my_revenue AS
 (SELECT c_customer_sk, sum(ss_ext_sales_price) AS revenue
  FROM my_customers, store_sales, customer_address, store, date_dim
  WHERE c_current_addr_sk = ca_address_sk
    AND ca_state = s_state
    AND ss_customer_sk = c_customer_sk AND ss_sold_date_sk = d_date_sk
    AND d_month_seq BETWEEN
        (SELECT DISTINCT d_month_seq + 1 FROM date_dim
         WHERE d_year = 2000 AND d_moy = 12)
        AND
        (SELECT DISTINCT d_month_seq + 3 FROM date_dim
         WHERE d_year = 2000 AND d_moy = 12)
  GROUP BY c_customer_sk)
SELECT segment, count(*) AS num_customers, segment * 50 AS segment_base
FROM (SELECT cast(revenue / 50 AS integer) AS segment
      FROM my_revenue) AS segments
GROUP BY segment
ORDER BY segment, num_customers
LIMIT 100
""",
55: """
SELECT i_brand_id AS brand_id, i_brand AS brand,
       sum(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id BETWEEN 1 AND 30 AND d_moy = 11 AND d_year = 1999
GROUP BY i_brand, i_brand_id
ORDER BY ext_price DESC, brand_id
LIMIT 100
""",
56: """
SELECT i_item_id, sum(total_sales) AS total_sales
FROM (
  SELECT i_item_id, ss_ext_sales_price AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_color IN ('slate', 'blanched', 'burnished')
    AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND d_year = 2001 AND d_moy = 2
    AND ss_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
  UNION ALL
  SELECT i_item_id, cs_ext_sales_price AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_color IN ('slate', 'blanched', 'burnished')
    AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND d_year = 2001 AND d_moy = 2
    AND cs_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
  UNION ALL
  SELECT i_item_id, ws_ext_sales_price AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_color IN ('slate', 'blanched', 'burnished')
    AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
    AND d_year = 2001 AND d_moy = 2
    AND ws_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
) AS tmp
GROUP BY i_item_id
ORDER BY total_sales, i_item_id
LIMIT 100
""",
57: """
WITH v1 AS
 (SELECT i_category, i_brand, cc_name, d_year, d_moy,
         sum(cs_sales_price) AS sum_sales,
         avg(sum(cs_sales_price)) OVER
             (PARTITION BY i_category, i_brand, cc_name, d_year)
             AS avg_monthly_sales,
         rank() OVER
             (PARTITION BY i_category, i_brand, cc_name
              ORDER BY d_year, d_moy) AS rn
  FROM item, catalog_sales, date_dim, call_center
  WHERE cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND cc_call_center_sk = cs_call_center_sk
    AND (d_year = 2000 OR (d_year = 1999 AND d_moy = 12)
         OR (d_year = 2001 AND d_moy = 1))
  GROUP BY i_category, i_brand, cc_name, d_year, d_moy),
 v2 AS
 (SELECT v1.i_category AS i_category, v1.i_brand AS i_brand,
         v1.cc_name AS cc_name, v1.d_year AS d_year, v1.d_moy AS d_moy,
         v1.avg_monthly_sales AS avg_monthly_sales,
         v1.sum_sales AS sum_sales, v1_lag.sum_sales AS psum,
         v1_lead.sum_sales AS nsum
  FROM v1, v1 v1_lag, v1 v1_lead
  WHERE v1.i_category = v1_lag.i_category
    AND v1.i_category = v1_lead.i_category
    AND v1.i_brand = v1_lag.i_brand AND v1.i_brand = v1_lead.i_brand
    AND v1.cc_name = v1_lag.cc_name AND v1.cc_name = v1_lead.cc_name
    AND v1.rn = v1_lag.rn + 1 AND v1.rn = v1_lead.rn - 1)
SELECT i_category, i_brand, cc_name, d_year, d_moy, avg_monthly_sales,
       sum_sales, psum, nsum
FROM v2
WHERE d_year = 2000 AND avg_monthly_sales > 0
  AND CASE WHEN avg_monthly_sales > 0
           THEN abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           ELSE NULL END > 0.1
ORDER BY sum_sales - avg_monthly_sales, cc_name, i_category, i_brand,
         d_year, d_moy
LIMIT 100
""",
58: """
SELECT ss_items.item_id AS item_id, ss_item_rev, cs_item_rev, ws_item_rev
FROM
  (SELECT i_item_id AS item_id, sum(ss_ext_sales_price) AS ss_item_rev
   FROM store_sales, item, date_dim
   WHERE ss_item_sk = i_item_sk AND d_date_sk = ss_sold_date_sk
     AND d_moy = 3 AND d_year = 2000
   GROUP BY i_item_id) AS ss_items,
  (SELECT i_item_id AS item_id, sum(cs_ext_sales_price) AS cs_item_rev
   FROM catalog_sales, item, date_dim
   WHERE cs_item_sk = i_item_sk AND d_date_sk = cs_sold_date_sk
     AND d_moy = 3 AND d_year = 2000
   GROUP BY i_item_id) AS cs_items,
  (SELECT i_item_id AS item_id, sum(ws_ext_sales_price) AS ws_item_rev
   FROM web_sales, item, date_dim
   WHERE ws_item_sk = i_item_sk AND d_date_sk = ws_sold_date_sk
     AND d_moy = 3 AND d_year = 2000
   GROUP BY i_item_id) AS ws_items
WHERE ss_items.item_id = cs_items.item_id
  AND ss_items.item_id = ws_items.item_id
  AND ss_item_rev BETWEEN 0.9 * cs_item_rev AND 1.1 * cs_item_rev
  AND ss_item_rev BETWEEN 0.9 * ws_item_rev AND 1.1 * ws_item_rev
ORDER BY item_id, ss_item_rev
LIMIT 100
""",
59: """
WITH wss AS (
  SELECT d_week_seq, ss_store_sk,
         sum(CASE WHEN d_dow = 0 THEN ss_sales_price ELSE 0.0 END) AS sun_sales,
         sum(CASE WHEN d_dow = 1 THEN ss_sales_price ELSE 0.0 END) AS mon_sales,
         sum(CASE WHEN d_dow = 5 THEN ss_sales_price ELSE 0.0 END) AS fri_sales
  FROM store_sales, date_dim
  WHERE d_date_sk = ss_sold_date_sk
  GROUP BY d_week_seq, ss_store_sk
)
SELECT s_store_name, s_store_id,
       y.sun_sales / x.sun_sales AS r_sun,
       y.mon_sales / x.mon_sales AS r_mon,
       y.fri_sales / x.fri_sales AS r_fri
FROM wss x, wss y, store, date_dim d
WHERE d.d_week_seq = x.d_week_seq
  AND d.d_month_seq BETWEEN 1200 AND 1211
  AND x.ss_store_sk = s_store_sk
  AND y.ss_store_sk = x.ss_store_sk
  AND y.d_week_seq = x.d_week_seq + 52
  AND x.sun_sales > 0 AND x.mon_sales > 0 AND x.fri_sales > 0
GROUP BY s_store_name, s_store_id, y.sun_sales / x.sun_sales,
         y.mon_sales / x.mon_sales, y.fri_sales / x.fri_sales
ORDER BY s_store_name, s_store_id, r_sun, r_mon, r_fri
LIMIT 100
""",
60: """
SELECT i_item_id, sum(total_sales) AS total_sales
FROM (
  SELECT i_item_id, ss_ext_sales_price AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_category = 'Music'
    AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 9
    AND ss_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
  UNION ALL
  SELECT i_item_id, cs_ext_sales_price AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_category = 'Music'
    AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 9
    AND cs_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
  UNION ALL
  SELECT i_item_id, ws_ext_sales_price AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_category = 'Music'
    AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 9
    AND ws_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5.0
) AS tmp
GROUP BY i_item_id
ORDER BY i_item_id, total_sales
LIMIT 100
""",
61: """
SELECT promotions, total,
       CAST(promotions AS DOUBLE) / CAST(total AS DOUBLE) * 100 AS pct
FROM
  (SELECT sum(ss_ext_sales_price) AS promotions
   FROM store_sales, store, promotion, date_dim, customer,
        customer_address, item
   WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
     AND ss_promo_sk = p_promo_sk AND ss_customer_sk = c_customer_sk
     AND ca_address_sk = c_current_addr_sk AND ss_item_sk = i_item_sk
     AND ca_gmt_offset = -5.0 AND i_category = 'Jewelry'
     AND (p_channel_dmail = 'Y' OR p_channel_email = 'Y'
          OR p_channel_tv = 'Y')
     AND d_year = 1998 AND d_moy = 11) AS promotional_sales,
  (SELECT sum(ss_ext_sales_price) AS total
   FROM store_sales, store, date_dim, customer, customer_address, item
   WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
     AND ss_customer_sk = c_customer_sk
     AND ca_address_sk = c_current_addr_sk AND ss_item_sk = i_item_sk
     AND ca_gmt_offset = -5.0 AND i_category = 'Jewelry'
     AND d_year = 1998 AND d_moy = 11) AS all_sales
ORDER BY promotions, total
LIMIT 100
""",
62: """
SELECT substr(w_warehouse_name, 1, 20) AS wh, sm_type, web_name,
       sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS d30,
       sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 30
                 AND ws_ship_date_sk - ws_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS d60,
       sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 60
                THEN 1 ELSE 0 END) AS dmore
FROM web_sales, warehouse, ship_mode, web_site, date_dim
WHERE d_month_seq BETWEEN 1200 AND 1211
  AND ws_ship_date_sk = d_date_sk
  AND ws_warehouse_sk = w_warehouse_sk
  AND ws_ship_mode_sk = sm_ship_mode_sk
  AND ws_web_site_sk = web_site_sk
GROUP BY substr(w_warehouse_name, 1, 20), sm_type, web_name
ORDER BY wh, sm_type, web_name
LIMIT 100
""",
63: """
SELECT manager_id, sum_sales, avg_monthly
FROM (
  SELECT i_manager_id AS manager_id, sum(ss_sales_price) AS sum_sales,
         avg(sum(ss_sales_price)) OVER (PARTITION BY i_manager_id)
           AS avg_monthly
  FROM item, store_sales, date_dim, store
  WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND d_month_seq BETWEEN 1200 AND 1211
    AND i_category IN ('Books', 'Children', 'Electronics', 'Home')
  GROUP BY i_manager_id, d_moy
) AS tmp
WHERE avg_monthly > 0 AND abs(sum_sales - avg_monthly) / avg_monthly > 0.1
ORDER BY manager_id, avg_monthly, sum_sales
LIMIT 100
""",
64: """
WITH cs_ui AS
 (SELECT cs_item_sk,
         sum(cs_ext_list_price) AS sale,
         sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit) AS refund
  FROM catalog_sales, catalog_returns
  WHERE cs_item_sk = cr_item_sk AND cs_order_number = cr_order_number
  GROUP BY cs_item_sk
  HAVING sum(cs_ext_list_price) >
         2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)),
cross_sales AS
 (SELECT i_product_name AS product_name, i_item_sk AS item_sk,
         s_store_name AS store_name, s_zip AS store_zip,
         ad1.ca_street_number AS b_street_number,
         ad1.ca_street_name AS b_street_name,
         ad1.ca_city AS b_city, ad1.ca_zip AS b_zip,
         ad2.ca_street_number AS c_street_number,
         ad2.ca_street_name AS c_street_name,
         ad2.ca_city AS c_city, ad2.ca_zip AS c_zip,
         d1.d_year AS syear, d2.d_year AS fsyear, d3.d_year AS s2year,
         count(*) AS cnt,
         sum(ss_wholesale_cost) AS s1, sum(ss_list_price) AS s2,
         sum(ss_coupon_amt) AS s3
  FROM store_sales, store_returns, cs_ui,
       date_dim d1, date_dim d2, date_dim d3,
       store, customer, customer_demographics cd1, customer_demographics cd2,
       promotion, household_demographics hd1, household_demographics hd2,
       customer_address ad1, customer_address ad2,
       income_band ib1, income_band ib2, item
  WHERE ss_store_sk = s_store_sk
    AND ss_sold_date_sk = d1.d_date_sk
    AND ss_customer_sk = c_customer_sk
    AND ss_cdemo_sk = cd1.cd_demo_sk
    AND ss_hdemo_sk = hd1.hd_demo_sk
    AND ss_addr_sk = ad1.ca_address_sk
    AND ss_item_sk = i_item_sk
    AND ss_item_sk = sr_item_sk
    AND ss_ticket_number = sr_ticket_number
    AND ss_item_sk = cs_ui.cs_item_sk
    AND c_current_cdemo_sk = cd2.cd_demo_sk
    AND c_current_hdemo_sk = hd2.hd_demo_sk
    AND c_current_addr_sk = ad2.ca_address_sk
    AND c_first_sales_date_sk = d2.d_date_sk
    AND c_first_shipto_date_sk = d3.d_date_sk
    AND ss_promo_sk = p_promo_sk
    AND hd1.hd_income_band_sk = ib1.ib_income_band_sk
    AND hd2.hd_income_band_sk = ib2.ib_income_band_sk
    AND cd1.cd_marital_status <> cd2.cd_marital_status
    AND i_color IN ('purple', 'burlywood', 'indian', 'spring',
                    'floral', 'medium', 'red', 'blue', 'green', 'black',
                    'white', 'yellow', 'pink', 'brown', 'orange')
    AND i_current_price BETWEEN 10 AND 800
  GROUP BY i_product_name, i_item_sk, s_store_name, s_zip,
           ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city, ad1.ca_zip,
           ad2.ca_street_number, ad2.ca_street_name, ad2.ca_city, ad2.ca_zip,
           d1.d_year, d2.d_year, d3.d_year)
SELECT cs1.product_name AS product_name, cs1.store_name AS store_name,
       cs1.store_zip AS store_zip,
       cs1.b_street_number AS b_street_number,
       cs1.b_street_name AS b_street_name,
       cs1.b_city AS b_city, cs1.b_zip AS b_zip,
       cs1.c_street_number AS c_street_number,
       cs1.c_street_name AS c_street_name,
       cs1.c_city AS c_city, cs1.c_zip AS c_zip,
       cs1.syear AS syear, cs1.cnt AS cnt,
       cs1.s1 AS s11, cs1.s2 AS s21, cs1.s3 AS s31,
       cs2.s1 AS s12, cs2.s2 AS s22, cs2.s3 AS s32,
       cs2.syear AS syear2, cs2.cnt AS cnt2
FROM cross_sales cs1, cross_sales cs2
WHERE cs1.item_sk = cs2.item_sk
  AND cs1.syear = 1999 AND cs2.syear = 1999 + 1
  AND cs2.cnt <= cs1.cnt
  AND cs1.store_name = cs2.store_name
  AND cs1.store_zip = cs2.store_zip
ORDER BY product_name, store_name, cnt2, s11, s21, s22
""",
65: """SELECT s_store_name AS s_store_name, i_item_desc AS i_item_desc, sc.revenue AS revenue
FROM store, item,
     (SELECT ss_store_sk, avg(revenue) AS ave
      FROM (SELECT ss_store_sk, ss_item_sk, sum(ss_sales_price) AS revenue
            FROM store_sales, date_dim
            WHERE ss_sold_date_sk = d_date_sk AND d_year = 2000
            GROUP BY ss_store_sk, ss_item_sk) sa
      GROUP BY ss_store_sk) sb,
     (SELECT ss_store_sk, ss_item_sk, sum(ss_sales_price) AS revenue
      FROM store_sales, date_dim
      WHERE ss_sold_date_sk = d_date_sk AND d_year = 2000
      GROUP BY ss_store_sk, ss_item_sk) sc
WHERE sb.ss_store_sk = sc.ss_store_sk AND sc.revenue <= 0.1 * sb.ave
  AND s_store_sk = sc.ss_store_sk AND i_item_sk = sc.ss_item_sk
ORDER BY s_store_name, i_item_desc LIMIT 100""",
66: """
SELECT w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
       w_country, ship_carriers, year1,
       sum(jan_sales) AS jan_sales, sum(feb_sales) AS feb_sales,
       sum(mar_sales) AS mar_sales, sum(apr_sales) AS apr_sales,
       sum(may_sales) AS may_sales, sum(jun_sales) AS jun_sales,
       sum(jan_net) AS jan_net, sum(feb_net) AS feb_net,
       sum(mar_net) AS mar_net
FROM (SELECT w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
             w_state, w_country,
             'UPS' || ',' || 'FEDEX' AS ship_carriers, d_year AS year1,
             sum(CASE WHEN d_moy = 1 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS jan_sales,
             sum(CASE WHEN d_moy = 2 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS feb_sales,
             sum(CASE WHEN d_moy = 3 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS mar_sales,
             sum(CASE WHEN d_moy = 4 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS apr_sales,
             sum(CASE WHEN d_moy = 5 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS may_sales,
             sum(CASE WHEN d_moy = 6 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS jun_sales,
             sum(CASE WHEN d_moy = 1
                      THEN ws_net_paid_inc_tax * ws_quantity ELSE 0 END)
                 AS jan_net,
             sum(CASE WHEN d_moy = 2
                      THEN ws_net_paid_inc_tax * ws_quantity ELSE 0 END)
                 AS feb_net,
             sum(CASE WHEN d_moy = 3
                      THEN ws_net_paid_inc_tax * ws_quantity ELSE 0 END)
                 AS mar_net
      FROM web_sales, warehouse, date_dim, time_dim, ship_mode
      WHERE ws_warehouse_sk = w_warehouse_sk
        AND ws_sold_date_sk = d_date_sk AND ws_sold_time_sk = t_time_sk
        AND ws_ship_mode_sk = sm_ship_mode_sk AND d_year = 2000
        AND t_time BETWEEN 30838 AND 30838 + 28800
        AND sm_carrier IN ('UPS', 'FEDEX', 'AIRBORNE', 'USPS')
      GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
               w_state, w_country, d_year
      UNION ALL
      SELECT w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
             w_state, w_country,
             'UPS' || ',' || 'FEDEX' AS ship_carriers, d_year AS year1,
             sum(CASE WHEN d_moy = 1 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS jan_sales,
             sum(CASE WHEN d_moy = 2 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS feb_sales,
             sum(CASE WHEN d_moy = 3 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS mar_sales,
             sum(CASE WHEN d_moy = 4 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS apr_sales,
             sum(CASE WHEN d_moy = 5 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS may_sales,
             sum(CASE WHEN d_moy = 6 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS jun_sales,
             sum(CASE WHEN d_moy = 1
                      THEN cs_net_paid_inc_tax * cs_quantity ELSE 0 END)
                 AS jan_net,
             sum(CASE WHEN d_moy = 2
                      THEN cs_net_paid_inc_tax * cs_quantity ELSE 0 END)
                 AS feb_net,
             sum(CASE WHEN d_moy = 3
                      THEN cs_net_paid_inc_tax * cs_quantity ELSE 0 END)
                 AS mar_net
      FROM catalog_sales, warehouse, date_dim, time_dim, ship_mode
      WHERE cs_warehouse_sk = w_warehouse_sk
        AND cs_sold_date_sk = d_date_sk AND cs_sold_time_sk = t_time_sk
        AND cs_ship_mode_sk = sm_ship_mode_sk AND d_year = 2000
        AND t_time BETWEEN 30838 AND 30838 + 28800
        AND sm_carrier IN ('UPS', 'FEDEX', 'AIRBORNE', 'USPS')
      GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
               w_state, w_country, d_year) AS x
GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country, ship_carriers, year1
ORDER BY w_warehouse_name
LIMIT 100
""",
67: """
SELECT i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
       d_moy, s_store_id, sumsales, rk
FROM (SELECT i_category, i_class, i_brand, i_product_name, d_year,
             d_qoy, d_moy, s_store_id, sumsales,
             rank() OVER (PARTITION BY i_category
                          ORDER BY sumsales DESC) AS rk
      FROM (SELECT i_category, i_class, i_brand, i_product_name,
                   d_year, d_qoy, d_moy, s_store_id,
                   sum(coalesce(ss_sales_price * ss_quantity, 0))
                       AS sumsales
            FROM store_sales, date_dim, store, item
            WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
              AND ss_store_sk = s_store_sk
              AND d_month_seq BETWEEN 1200 AND 1205
            GROUP BY ROLLUP (i_category, i_class, i_brand,
                             i_product_name, d_year, d_qoy, d_moy,
                             s_store_id)) AS dw1) AS dw2
WHERE rk <= 100
ORDER BY i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_id, sumsales, rk
LIMIT 100
""",
68: """
SELECT c_last_name, c_first_name, ca_city, bought_city,
       ss_ticket_number, extended_price, extended_tax, list_price
FROM (SELECT ss_ticket_number AS ss_ticket_number,
             ss_customer_sk AS ss_customer_sk,
             ca_city AS bought_city,
             sum(ss_ext_sales_price) AS extended_price,
             sum(ss_ext_list_price) AS list_price,
             sum(ss_ext_tax) AS extended_tax
      FROM store_sales, date_dim, store, household_demographics,
           customer_address
      WHERE store_sales.ss_sold_date_sk = date_dim.d_date_sk
        AND store_sales.ss_store_sk = store.s_store_sk
        AND store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        AND store_sales.ss_addr_sk = customer_address.ca_address_sk
        AND date_dim.d_dom BETWEEN 1 AND 2
        AND (household_demographics.hd_dep_count = 4
             OR household_demographics.hd_vehicle_count = 3)
        AND date_dim.d_year IN (1999, 2000, 2001)
      GROUP BY ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) AS dn,
     customer, customer_address AS current_addr
WHERE ss_customer_sk = c_customer_sk
  AND customer.c_current_addr_sk = current_addr.ca_address_sk
  AND current_addr.ca_city <> bought_city
ORDER BY c_last_name, ss_ticket_number
LIMIT 100
""",
69: """
SELECT cd_gender, cd_marital_status, cd_education_status,
       count(*) AS cnt1, cd_purchase_estimate, count(*) AS cnt2
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND ca_state IN ('KY', 'GA', 'NM')
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT 1 FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk AND d_year = 2001
                AND d_moy BETWEEN 4 AND 6)
  AND NOT EXISTS (SELECT 1 FROM web_sales, date_dim
                  WHERE c.c_customer_sk = ws_bill_customer_sk
                    AND ws_sold_date_sk = d_date_sk AND d_year = 2001
                    AND d_moy BETWEEN 4 AND 6)
GROUP BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate
ORDER BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate
LIMIT 100
""",
70: """
SELECT sum(ss_net_profit) AS total_sum, s_state, s_county,
       grouping(s_state) + grouping(s_county) AS lochierarchy,
       rank() OVER
           (PARTITION BY grouping(s_state) + grouping(s_county),
                         CASE WHEN grouping(s_county) = 0
                              THEN s_state END
            ORDER BY sum(ss_net_profit) DESC) AS rank_within_parent
FROM store_sales, date_dim d1, store
WHERE d1.d_month_seq BETWEEN 1200 AND 1211
  AND d1.d_date_sk = ss_sold_date_sk AND s_store_sk = ss_store_sk
  AND s_state IN
      (SELECT s_state FROM
        (SELECT s_state AS s_state,
                rank() OVER (PARTITION BY s_state
                             ORDER BY sum(ss_net_profit) DESC) AS ranking
         FROM store_sales, store, date_dim
         WHERE d_month_seq BETWEEN 1200 AND 1211
           AND d_date_sk = ss_sold_date_sk AND s_store_sk = ss_store_sk
         GROUP BY s_state) AS tmp1
       WHERE ranking <= 5)
GROUP BY ROLLUP (s_state, s_county)
ORDER BY lochierarchy DESC,
         CASE WHEN lochierarchy = 0 THEN s_state END,
         rank_within_parent, s_state, s_county
LIMIT 100
""",
71: """
SELECT i_brand_id AS brand_id, i_brand AS brand, t_hour, t_minute,
       sum(ext_price) AS ext_price
FROM item,
     (SELECT ws_ext_sales_price AS ext_price,
             ws_sold_date_sk AS sold_date_sk, ws_item_sk AS sold_item_sk,
             ws_sold_time_sk AS time_sk
      FROM web_sales, date_dim
      WHERE d_date_sk = ws_sold_date_sk AND d_moy = 11 AND d_year = 1999
      UNION ALL
      SELECT cs_ext_sales_price AS ext_price,
             cs_sold_date_sk AS sold_date_sk, cs_item_sk AS sold_item_sk,
             cs_sold_time_sk AS time_sk
      FROM catalog_sales, date_dim
      WHERE d_date_sk = cs_sold_date_sk AND d_moy = 11 AND d_year = 1999
      UNION ALL
      SELECT ss_ext_sales_price AS ext_price,
             ss_sold_date_sk AS sold_date_sk, ss_item_sk AS sold_item_sk,
             ss_sold_time_sk AS time_sk
      FROM store_sales, date_dim
      WHERE d_date_sk = ss_sold_date_sk AND d_moy = 11 AND d_year = 1999
     ) AS tmp,
     time_dim
WHERE sold_item_sk = i_item_sk AND i_manager_id = 1
  AND time_sk = t_time_sk
  AND (t_meal_time = 'breakfast' OR t_meal_time = 'dinner')
GROUP BY i_brand, i_brand_id, t_hour, t_minute
ORDER BY ext_price DESC, i_brand_id, t_hour, t_minute
LIMIT 100
""",
72: """
SELECT i_item_desc, w_warehouse_name, d1.d_week_seq,
       sum(CASE WHEN p_promo_sk IS NULL THEN 1 ELSE 0 END) AS no_promo,
       sum(CASE WHEN p_promo_sk IS NOT NULL THEN 1 ELSE 0 END) AS promo,
       count(*) AS total_cnt
FROM catalog_sales
JOIN inventory ON cs_item_sk = inv_item_sk
JOIN warehouse ON w_warehouse_sk = inv_warehouse_sk
JOIN item ON i_item_sk = cs_item_sk
JOIN date_dim d1 ON cs_sold_date_sk = d1.d_date_sk
JOIN date_dim d2 ON inv_date_sk = d2.d_date_sk
LEFT JOIN promotion ON cs_promo_sk = p_promo_sk
WHERE d1.d_week_seq = d2.d_week_seq
  AND inv_quantity_on_hand < cs_quantity
  AND d1.d_year = 1999 AND d1.d_moy = 2
GROUP BY i_item_desc, w_warehouse_name, d1.d_week_seq
ORDER BY total_cnt DESC, i_item_desc, w_warehouse_name, d1.d_week_seq
LIMIT 100
""",
73: """
SELECT c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
FROM (SELECT ss_ticket_number AS ss_ticket_number,
             ss_customer_sk AS ss_customer_sk, count(*) AS cnt
      FROM store_sales, date_dim, store, household_demographics
      WHERE store_sales.ss_sold_date_sk = date_dim.d_date_sk
        AND store_sales.ss_store_sk = store.s_store_sk
        AND store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        AND date_dim.d_dom BETWEEN 1 AND 2
        AND (household_demographics.hd_buy_potential = '>10000'
             OR household_demographics.hd_buy_potential = 'Unknown')
        AND household_demographics.hd_vehicle_count > 0
        AND date_dim.d_year IN (1999, 2000, 2001)
      GROUP BY ss_ticket_number, ss_customer_sk) AS dj, customer
WHERE ss_customer_sk = c_customer_sk AND cnt BETWEEN 1 AND 5
ORDER BY cnt DESC, c_last_name ASC
LIMIT 1000
""",
74: """
WITH year_total AS
 (SELECT c_customer_id AS customer_id, c_first_name AS customer_first_name,
         c_last_name AS customer_last_name, d_year AS year1,
         sum(ss_net_paid) AS year_total, 's' AS sale_type
  FROM customer, store_sales, date_dim
  WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
    AND d_year IN (2001, 2002)
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year
  UNION ALL
  SELECT c_customer_id AS customer_id, c_first_name AS customer_first_name,
         c_last_name AS customer_last_name, d_year AS year1,
         sum(ws_net_paid) AS year_total, 'w' AS sale_type
  FROM customer, web_sales, date_dim
  WHERE c_customer_sk = ws_bill_customer_sk AND ws_sold_date_sk = d_date_sk
    AND d_year IN (2001, 2002)
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year)
SELECT t_s_secyear.customer_id AS customer_id,
       t_s_secyear.customer_first_name AS customer_first_name,
       t_s_secyear.customer_last_name AS customer_last_name
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_w_firstyear.sale_type = 'w'
  AND t_s_secyear.sale_type = 's' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.year1 = 2001 AND t_s_secyear.year1 = 2002
  AND t_w_firstyear.year1 = 2001 AND t_w_secyear.year1 = 2002
  AND t_s_firstyear.year_total > 0 AND t_w_firstyear.year_total > 0
  AND CASE WHEN t_w_firstyear.year_total > 0
           THEN t_w_secyear.year_total / t_w_firstyear.year_total
           ELSE NULL END
      > CASE WHEN t_s_firstyear.year_total > 0
             THEN t_s_secyear.year_total / t_s_firstyear.year_total
             ELSE NULL END
ORDER BY customer_id, customer_first_name, customer_last_name
LIMIT 100
""",
75: """
WITH all_sales AS
 (SELECT d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
         sum(sales_cnt) AS sales_cnt, sum(sales_amt) AS sales_amt
  FROM (SELECT d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               cs_quantity - coalesce(cr_return_quantity, 0) AS sales_cnt,
               cs_ext_sales_price - coalesce(cr_return_amount, 0.0)
                   AS sales_amt
        FROM catalog_sales
             JOIN item ON i_item_sk = cs_item_sk
             JOIN date_dim ON d_date_sk = cs_sold_date_sk
             LEFT JOIN catalog_returns
                  ON (cs_order_number = cr_order_number
                      AND cs_item_sk = cr_item_sk)
        WHERE i_category = 'Books'
        UNION
        SELECT d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               ss_quantity - coalesce(sr_return_quantity, 0) AS sales_cnt,
               ss_ext_sales_price - coalesce(sr_return_amt, 0.0)
                   AS sales_amt
        FROM store_sales
             JOIN item ON i_item_sk = ss_item_sk
             JOIN date_dim ON d_date_sk = ss_sold_date_sk
             LEFT JOIN store_returns
                  ON (ss_ticket_number = sr_ticket_number
                      AND ss_item_sk = sr_item_sk)
        WHERE i_category = 'Books'
        UNION
        SELECT d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               ws_quantity - coalesce(wr_return_quantity, 0) AS sales_cnt,
               ws_ext_sales_price - coalesce(wr_return_amt, 0.0)
                   AS sales_amt
        FROM web_sales
             JOIN item ON i_item_sk = ws_item_sk
             JOIN date_dim ON d_date_sk = ws_sold_date_sk
             LEFT JOIN web_returns
                  ON (ws_order_number = wr_order_number
                      AND ws_item_sk = wr_item_sk)
        WHERE i_category = 'Books') AS sales_detail
  GROUP BY d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id)
SELECT prev_yr.d_year AS prev_year, curr_yr.d_year AS year1,
       curr_yr.i_brand_id AS i_brand_id, curr_yr.i_class_id AS i_class_id,
       curr_yr.i_category_id AS i_category_id,
       curr_yr.i_manufact_id AS i_manufact_id,
       prev_yr.sales_cnt AS prev_yr_cnt, curr_yr.sales_cnt AS curr_yr_cnt,
       curr_yr.sales_cnt - prev_yr.sales_cnt AS sales_cnt_diff,
       curr_yr.sales_amt - prev_yr.sales_amt AS sales_amt_diff
FROM all_sales curr_yr, all_sales prev_yr
WHERE curr_yr.i_brand_id = prev_yr.i_brand_id
  AND curr_yr.i_class_id = prev_yr.i_class_id
  AND curr_yr.i_category_id = prev_yr.i_category_id
  AND curr_yr.i_manufact_id = prev_yr.i_manufact_id
  AND curr_yr.d_year = 2001 AND prev_yr.d_year = 2000
  AND cast(curr_yr.sales_cnt AS DOUBLE)
      / cast(prev_yr.sales_cnt AS DOUBLE) < 0.9
ORDER BY sales_cnt_diff, sales_amt_diff
LIMIT 100
""",
76: """
SELECT channel, col_name, d_year, d_qoy, i_category,
       count(*) AS sales_cnt, sum(ext_sales_price) AS sales_amt
FROM (
  SELECT 'store' AS channel, 'ss_hdemo_sk' AS col_name, d_year, d_qoy,
         i_category, ss_ext_sales_price AS ext_sales_price
  FROM store_sales, item, date_dim
  WHERE ss_hdemo_sk % 7 = 0
    AND ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
  UNION ALL
  SELECT 'web' AS channel, 'ws_ship_hdemo_sk' AS col_name, d_year, d_qoy,
         i_category, ws_ext_sales_price AS ext_sales_price
  FROM web_sales, item, date_dim
  WHERE ws_ship_hdemo_sk % 7 = 0
    AND ws_sold_date_sk = d_date_sk AND ws_item_sk = i_item_sk
  UNION ALL
  SELECT 'catalog' AS channel, 'cs_warehouse_sk' AS col_name, d_year, d_qoy,
         i_category, cs_ext_sales_price AS ext_sales_price
  FROM catalog_sales, item, date_dim
  WHERE cs_warehouse_sk % 3 = 0
    AND cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
) AS foo
GROUP BY channel, col_name, d_year, d_qoy, i_category
ORDER BY channel, col_name, d_year, d_qoy, i_category
LIMIT 100
""",
77: """
WITH ss AS
 (SELECT s_store_sk, sum(ss_ext_sales_price) AS sales,
         sum(ss_net_profit) AS profit
  FROM store_sales, date_dim, store
  WHERE ss_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-03' AND DATE '2000-09-02'
    AND ss_store_sk = s_store_sk
  GROUP BY s_store_sk),
 sr AS
 (SELECT s_store_sk, sum(sr_return_amt) AS returns1,
         sum(sr_net_loss) AS profit_loss
  FROM store_returns, date_dim, store
  WHERE sr_returned_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-03' AND DATE '2000-09-02'
    AND sr_store_sk = s_store_sk
  GROUP BY s_store_sk),
 cs AS
 (SELECT cs_call_center_sk, sum(cs_ext_sales_price) AS sales,
         sum(cs_net_profit) AS profit
  FROM catalog_sales, date_dim
  WHERE cs_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-03' AND DATE '2000-09-02'
  GROUP BY cs_call_center_sk),
 cr AS
 (SELECT cr_call_center_sk, sum(cr_return_amount) AS returns1,
         sum(cr_net_loss) AS profit_loss
  FROM catalog_returns, date_dim
  WHERE cr_returned_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-03' AND DATE '2000-09-02'
  GROUP BY cr_call_center_sk),
 ws AS
 (SELECT wp_web_page_sk, sum(ws_ext_sales_price) AS sales,
         sum(ws_net_profit) AS profit
  FROM web_sales, date_dim, web_page
  WHERE ws_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-03' AND DATE '2000-09-02'
    AND ws_web_page_sk = wp_web_page_sk
  GROUP BY wp_web_page_sk),
 wr AS
 (SELECT wp_web_page_sk, sum(wr_return_amt) AS returns1,
         sum(wr_net_loss) AS profit_loss
  FROM web_returns, date_dim, web_page
  WHERE wr_returned_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-03' AND DATE '2000-09-02'
    AND wr_web_page_sk = wp_web_page_sk
  GROUP BY wp_web_page_sk)
SELECT channel, id, sum(sales) AS sales, sum(returns1) AS returns1,
       sum(profit) AS profit
FROM (SELECT 'store channel' AS channel, ss.s_store_sk AS id, sales,
             coalesce(returns1, 0) AS returns1,
             profit - coalesce(profit_loss, 0) AS profit
      FROM ss LEFT JOIN sr ON ss.s_store_sk = sr.s_store_sk
      UNION ALL
      SELECT 'catalog channel' AS channel, cs_call_center_sk AS id,
             sales, returns1, profit - profit_loss AS profit
      FROM cs, cr
      UNION ALL
      SELECT 'web channel' AS channel, ws.wp_web_page_sk AS id, sales,
             coalesce(returns1, 0) AS returns1,
             profit - coalesce(profit_loss, 0) AS profit
      FROM ws LEFT JOIN wr ON ws.wp_web_page_sk = wr.wp_web_page_sk
     ) AS x
GROUP BY ROLLUP (channel, id)
ORDER BY channel, id
LIMIT 100
""",
78: """
WITH ws AS
 (SELECT d_year AS ws_sold_year, ws_item_sk,
         ws_bill_customer_sk AS ws_customer_sk, sum(ws_quantity) AS ws_qty,
         sum(ws_wholesale_cost) AS ws_wc, sum(ws_sales_price) AS ws_sp
  FROM web_sales
       LEFT JOIN web_returns ON (wr_order_number = ws_order_number
                                 AND ws_item_sk = wr_item_sk)
       JOIN date_dim ON ws_sold_date_sk = d_date_sk
  WHERE wr_order_number IS NULL
  GROUP BY d_year, ws_item_sk, ws_bill_customer_sk),
 cs AS
 (SELECT d_year AS cs_sold_year, cs_item_sk,
         cs_bill_customer_sk AS cs_customer_sk, sum(cs_quantity) AS cs_qty,
         sum(cs_wholesale_cost) AS cs_wc, sum(cs_sales_price) AS cs_sp
  FROM catalog_sales
       LEFT JOIN catalog_returns ON (cr_order_number = cs_order_number
                                     AND cs_item_sk = cr_item_sk)
       JOIN date_dim ON cs_sold_date_sk = d_date_sk
  WHERE cr_order_number IS NULL
  GROUP BY d_year, cs_item_sk, cs_bill_customer_sk),
 ss AS
 (SELECT d_year AS ss_sold_year, ss_item_sk,
         ss_customer_sk, sum(ss_quantity) AS ss_qty,
         sum(ss_wholesale_cost) AS ss_wc, sum(ss_sales_price) AS ss_sp
  FROM store_sales
       LEFT JOIN store_returns ON (sr_ticket_number = ss_ticket_number
                                   AND ss_item_sk = sr_item_sk)
       JOIN date_dim ON ss_sold_date_sk = d_date_sk
  WHERE sr_ticket_number IS NULL
  GROUP BY d_year, ss_item_sk, ss_customer_sk)
SELECT ss_customer_sk,
       round(ss_qty / (coalesce(ws_qty, 0) + coalesce(cs_qty, 0)), 2)
           AS ratio,
       ss_qty AS store_qty, ss_wc AS store_wholesale_cost,
       ss_sp AS store_sales_price,
       coalesce(ws_qty, 0) + coalesce(cs_qty, 0) AS other_chan_qty,
       coalesce(ws_wc, 0) + coalesce(cs_wc, 0)
           AS other_chan_wholesale_cost,
       coalesce(ws_sp, 0) + coalesce(cs_sp, 0) AS other_chan_sales_price
FROM ss
     LEFT JOIN ws ON (ws_sold_year = ss_sold_year
                      AND ws_item_sk = ss_item_sk
                      AND ws_customer_sk = ss_customer_sk)
     LEFT JOIN cs ON (cs_sold_year = ss_sold_year
                      AND cs_item_sk = ss_item_sk
                      AND cs_customer_sk = ss_customer_sk)
WHERE (coalesce(ws_qty, 0) > 0 OR coalesce(cs_qty, 0) > 0)
  AND ss_sold_year = 2000
ORDER BY ss_customer_sk, ss_qty DESC, ss_wc DESC, ss_sp DESC,
         other_chan_qty, other_chan_wholesale_cost,
         other_chan_sales_price, ratio
LIMIT 100
""",
79: """
SELECT c_last_name, c_first_name, substr(s_city, 1, 30) AS city,
       ss_ticket_number, amt, profit
FROM (SELECT ss_ticket_number AS ss_ticket_number,
             ss_customer_sk AS ss_customer_sk, s_city AS s_city,
             sum(ss_coupon_amt) AS amt, sum(ss_net_profit) AS profit
      FROM store_sales, date_dim, store, household_demographics
      WHERE store_sales.ss_sold_date_sk = date_dim.d_date_sk
        AND store_sales.ss_store_sk = store.s_store_sk
        AND store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        AND (household_demographics.hd_dep_count = 6
             OR household_demographics.hd_vehicle_count > 2)
        AND date_dim.d_dow = 1
        AND date_dim.d_year IN (1999, 2000, 2001)
      GROUP BY ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city) AS ms,
     customer
WHERE ss_customer_sk = c_customer_sk
ORDER BY c_last_name, c_first_name, city, profit, ss_ticket_number
LIMIT 100
""",
80: """
WITH ssr AS
 (SELECT s_store_id, sum(ss_ext_sales_price) AS sales,
         sum(coalesce(sr_return_amt, 0)) AS returns1,
         sum(ss_net_profit - coalesce(sr_net_loss, 0)) AS profit
  FROM store_sales
       LEFT OUTER JOIN store_returns
            ON (ss_item_sk = sr_item_sk
                AND ss_ticket_number = sr_ticket_number),
       date_dim, store, item, promotion
  WHERE ss_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23' AND DATE '2000-09-22'
    AND ss_store_sk = s_store_sk AND ss_item_sk = i_item_sk
    AND i_current_price > 50 AND ss_promo_sk = p_promo_sk
    AND p_channel_tv = 'N'
  GROUP BY s_store_id),
 csr AS
 (SELECT cp_catalog_page_id, sum(cs_ext_sales_price) AS sales,
         sum(coalesce(cr_return_amount, 0)) AS returns1,
         sum(cs_net_profit - coalesce(cr_net_loss, 0)) AS profit
  FROM catalog_sales
       LEFT OUTER JOIN catalog_returns
            ON (cs_item_sk = cr_item_sk
                AND cs_order_number = cr_order_number),
       date_dim, catalog_page, item, promotion
  WHERE cs_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23' AND DATE '2000-09-22'
    AND cs_catalog_page_sk = cp_catalog_page_sk AND cs_item_sk = i_item_sk
    AND i_current_price > 50 AND cs_promo_sk = p_promo_sk
    AND p_channel_tv = 'N'
  GROUP BY cp_catalog_page_id),
 wsr AS
 (SELECT web_site_id, sum(ws_ext_sales_price) AS sales,
         sum(coalesce(wr_return_amt, 0)) AS returns1,
         sum(ws_net_profit - coalesce(wr_net_loss, 0)) AS profit
  FROM web_sales
       LEFT OUTER JOIN web_returns
            ON (ws_item_sk = wr_item_sk
                AND ws_order_number = wr_order_number),
       date_dim, web_site, item, promotion
  WHERE ws_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23' AND DATE '2000-09-22'
    AND ws_web_site_sk = web_site_sk AND ws_item_sk = i_item_sk
    AND i_current_price > 50 AND ws_promo_sk = p_promo_sk
    AND p_channel_tv = 'N'
  GROUP BY web_site_id)
SELECT channel, id, sum(sales) AS sales, sum(returns1) AS returns1,
       sum(profit) AS profit
FROM (SELECT 'store channel' AS channel, 'store' || s_store_id AS id,
             sales, returns1, profit FROM ssr
      UNION ALL
      SELECT 'catalog channel' AS channel,
             'catalog_page' || cp_catalog_page_id AS id, sales, returns1,
             profit FROM csr
      UNION ALL
      SELECT 'web channel' AS channel, 'web_site' || web_site_id AS id,
             sales, returns1, profit FROM wsr) AS x
GROUP BY ROLLUP (channel, id)
ORDER BY channel, id
LIMIT 100
""",
81: """
WITH customer_total_return AS
 (SELECT cr_returning_customer_sk AS ctr_customer_sk, ca_state AS ctr_state,
         sum(cr_return_amt_inc_tax) AS ctr_total_return
  FROM catalog_returns, date_dim, customer_address
  WHERE cr_returned_date_sk = d_date_sk AND d_year = 2000
    AND cr_returning_addr_sk = ca_address_sk
  GROUP BY cr_returning_customer_sk, ca_state)
SELECT c_customer_id, c_salutation, c_first_name, c_last_name,
       ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
       ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
       ca_location_type, ctr_total_return
FROM customer_total_return ctr1, customer_address, customer
WHERE ctr1.ctr_total_return >
      (SELECT avg(ctr_total_return) * 1.2 FROM customer_total_return ctr2
       WHERE ctr1.ctr_state = ctr2.ctr_state)
  AND ca_address_sk = c_current_addr_sk
  AND ca_state IN ('GA', 'AL', 'CA', 'TX', 'NY', 'FL', 'IL', 'OH', 'PA',
                   'MI', 'NC', 'NJ', 'VA', 'WA', 'AZ', 'MA', 'IN', 'TN')
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_id, c_salutation, c_first_name, c_last_name,
         ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
         ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
         ca_location_type, ctr_total_return
LIMIT 100
""",
82: """
SELECT i_item_id, i_item_desc, i_current_price
FROM item, inventory, date_dim, store_sales
WHERE i_current_price BETWEEN 10.0 AND 90.0
  AND inv_item_sk = i_item_sk AND d_date_sk = inv_date_sk
  AND d_date BETWEEN DATE '2000-02-01' AND DATE '2000-04-01'
  AND i_manufact_id BETWEEN 1 AND 400
  AND inv_quantity_on_hand BETWEEN 100 AND 500
  AND ss_item_sk = i_item_sk
GROUP BY i_item_id, i_item_desc, i_current_price
ORDER BY i_item_id
LIMIT 100
""",
83: """
WITH sr_items AS
 (SELECT i_item_id AS item_id, sum(sr_return_quantity) AS sr_item_qty
  FROM store_returns, item, date_dim
  WHERE sr_item_sk = i_item_sk
    AND d_date IN (SELECT d_date FROM date_dim
                   WHERE d_week_seq IN
                         (SELECT d_week_seq FROM date_dim
                          WHERE d_date IN (DATE '2000-06-30',
                                           DATE '2000-09-27',
                                           DATE '2000-11-17')))
    AND sr_returned_date_sk = d_date_sk
  GROUP BY i_item_id),
 cr_items AS
 (SELECT i_item_id AS item_id, sum(cr_return_quantity) AS cr_item_qty
  FROM catalog_returns, item, date_dim
  WHERE cr_item_sk = i_item_sk
    AND d_date IN (SELECT d_date FROM date_dim
                   WHERE d_week_seq IN
                         (SELECT d_week_seq FROM date_dim
                          WHERE d_date IN (DATE '2000-06-30',
                                           DATE '2000-09-27',
                                           DATE '2000-11-17')))
    AND cr_returned_date_sk = d_date_sk
  GROUP BY i_item_id),
 wr_items AS
 (SELECT i_item_id AS item_id, sum(wr_return_quantity) AS wr_item_qty
  FROM web_returns, item, date_dim
  WHERE wr_item_sk = i_item_sk
    AND d_date IN (SELECT d_date FROM date_dim
                   WHERE d_week_seq IN
                         (SELECT d_week_seq FROM date_dim
                          WHERE d_date IN (DATE '2000-06-30',
                                           DATE '2000-09-27',
                                           DATE '2000-11-17')))
    AND wr_returned_date_sk = d_date_sk
  GROUP BY i_item_id)
SELECT sr_items.item_id AS item_id, sr_item_qty,
       sr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
           * 100 AS sr_dev,
       cr_item_qty,
       cr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
           * 100 AS cr_dev,
       wr_item_qty,
       wr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
           * 100 AS wr_dev,
       (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 AS average
FROM sr_items, cr_items, wr_items
WHERE sr_items.item_id = cr_items.item_id
  AND sr_items.item_id = wr_items.item_id
ORDER BY item_id, sr_item_qty
LIMIT 100
""",
84: """
SELECT c_customer_id AS customer_id,
       c_last_name || ', ' || c_first_name AS customername
FROM customer, customer_address, customer_demographics,
     household_demographics, income_band, store_returns
WHERE ca_city = 'Fairview'
  AND c_current_addr_sk = ca_address_sk
  AND ib_lower_bound >= 0
  AND ib_upper_bound <= 200000
  AND ib_income_band_sk = hd_income_band_sk
  AND cd_demo_sk = c_current_cdemo_sk
  AND hd_demo_sk = c_current_hdemo_sk
  AND sr_cdemo_sk = cd_demo_sk
ORDER BY c_customer_id
LIMIT 100
""",
85: """
SELECT substr(r_reason_desc, 1, 20) AS reason_d,
       avg(ws_quantity) AS avg_q, avg(wr_refunded_cash) AS avg_c,
       avg(wr_fee) AS avg_f
FROM web_sales, web_returns, web_page, customer_demographics cd1,
     customer_demographics cd2, customer_address, date_dim, reason
WHERE ws_web_page_sk = wp_web_page_sk AND ws_item_sk = wr_item_sk
  AND ws_order_number = wr_order_number
  AND ws_sold_date_sk = d_date_sk AND d_year = 2000
  AND cd1.cd_demo_sk = wr_refunded_cdemo_sk
  AND cd2.cd_demo_sk = wr_returning_cdemo_sk
  AND ca_address_sk = wr_refunded_addr_sk
  AND r_reason_sk = wr_reason_sk
  AND ((cd1.cd_marital_status = 'M'
        AND cd1.cd_marital_status = cd2.cd_marital_status
        AND cd1.cd_education_status = '4 yr Degree'
        AND cd1.cd_education_status = cd2.cd_education_status
        AND ws_sales_price BETWEEN 100 AND 150)
    OR (cd1.cd_marital_status = 'S'
        AND cd1.cd_marital_status = cd2.cd_marital_status
        AND cd1.cd_education_status = 'College'
        AND cd1.cd_education_status = cd2.cd_education_status
        AND ws_sales_price BETWEEN 50 AND 100)
    OR (cd1.cd_marital_status = 'W'
        AND cd1.cd_marital_status = cd2.cd_marital_status
        AND cd1.cd_education_status = '2 yr Degree'
        AND cd1.cd_education_status = cd2.cd_education_status
        AND ws_sales_price BETWEEN 150 AND 200))
  AND ((ca_country = 'United States'
        AND ca_state IN ('IN', 'OH', 'NJ', 'CA', 'TX', 'FL')
        AND ws_net_profit BETWEEN 100 AND 200)
    OR (ca_country = 'United States'
        AND ca_state IN ('WI', 'CT', 'KY', 'NY', 'GA', 'WA')
        AND ws_net_profit BETWEEN 150 AND 300)
    OR (ca_country = 'United States'
        AND ca_state IN ('LA', 'IA', 'AR', 'AL', 'MI', 'PA')
        AND ws_net_profit BETWEEN 50 AND 250))
GROUP BY r_reason_desc
ORDER BY reason_d, avg_q, avg_c, avg_f
LIMIT 100
""",
86: """
SELECT sum(ws_net_paid) AS total_sum, i_category, i_class,
       (CASE WHEN i_category IS NULL THEN 1 ELSE 0 END)
       + (CASE WHEN i_class IS NULL THEN 1 ELSE 0 END) AS lochierarchy
FROM web_sales, date_dim d1, item
WHERE d1.d_month_seq BETWEEN 1200 AND 1211
  AND d1.d_date_sk = ws_sold_date_sk AND i_item_sk = ws_item_sk
GROUP BY ROLLUP (i_category, i_class)
ORDER BY lochierarchy DESC,
         i_category NULLS FIRST, i_class NULLS FIRST, total_sum
LIMIT 100
""",
87: """
SELECT count(*) AS cnt
FROM (
  (SELECT DISTINCT c_last_name, c_first_name, d_date
   FROM store_sales, date_dim, customer
   WHERE ss_sold_date_sk = d_date_sk
     AND ss_customer_sk = c_customer_sk
     AND d_month_seq BETWEEN 1200 AND 1211)
  EXCEPT
  (SELECT DISTINCT c_last_name, c_first_name, d_date
   FROM catalog_sales, date_dim, customer
   WHERE cs_sold_date_sk = d_date_sk
     AND cs_bill_customer_sk = c_customer_sk
     AND d_month_seq BETWEEN 1200 AND 1211)
  EXCEPT
  (SELECT DISTINCT c_last_name, c_first_name, d_date
   FROM web_sales, date_dim, customer
   WHERE ws_sold_date_sk = d_date_sk
     AND ws_bill_customer_sk = c_customer_sk
     AND d_month_seq BETWEEN 1200 AND 1211)
) AS cool_cust
""",
88: """SELECT * FROM
 (SELECT count(*) AS h8_30_to_9 FROM store_sales, household_demographics, store
  WHERE ss_hdemo_sk = hd_demo_sk AND ss_store_sk = s_store_sk
    AND hd_dep_count = 2 AND s_store_name = 'ese') s1,
 (SELECT count(*) AS h9_to_9_30 FROM store_sales, household_demographics, store
  WHERE ss_hdemo_sk = hd_demo_sk AND ss_store_sk = s_store_sk
    AND hd_dep_count = 1 AND s_store_name = 'ese') s2""",
89: """
SELECT i_category, i_class, i_brand, s_store_name, s_company_name, d_moy,
       sum_sales, avg_monthly_sales
FROM (SELECT i_category, i_class, i_brand, s_store_name, s_company_name,
             d_moy, sum(ss_sales_price) AS sum_sales,
             avg(sum(ss_sales_price)) OVER
                 (PARTITION BY i_category, i_brand, s_store_name,
                               s_company_name) AS avg_monthly_sales
      FROM item, store_sales, date_dim, store
      WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
        AND ss_store_sk = s_store_sk AND d_year = 2000
        AND ((i_category IN ('Home', 'Music', 'Books')
              AND i_class IN ('accessories', 'classical', 'pants'))
          OR (i_category IN ('Shoes', 'Jewelry', 'Men')
              AND i_class IN ('shirts', 'dresses', 'birdal')))
      GROUP BY i_category, i_class, i_brand, s_store_name, s_company_name,
               d_moy) tmp1
WHERE CASE WHEN avg_monthly_sales <> 0
           THEN abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           ELSE NULL END > 0.1
ORDER BY sum_sales - avg_monthly_sales, s_store_name, sum_sales,
         i_category, i_class, i_brand, s_company_name, d_moy
LIMIT 100
""",
90: """
SELECT CAST(amc AS DOUBLE) / CAST(pmc AS DOUBLE) AS am_pm_ratio
FROM (SELECT count(*) AS amc FROM web_sales, household_demographics,
             time_dim, web_page
      WHERE ws_sold_time_sk = t_time_sk
        AND ws_ship_hdemo_sk = hd_demo_sk
        AND ws_web_page_sk = wp_web_page_sk
        AND t_hour BETWEEN 8 AND 9
        AND hd_dep_count = 6
        AND wp_char_count BETWEEN 100 AND 7000) AS at_shift,
     (SELECT count(*) AS pmc FROM web_sales, household_demographics,
             time_dim, web_page
      WHERE ws_sold_time_sk = t_time_sk
        AND ws_ship_hdemo_sk = hd_demo_sk
        AND ws_web_page_sk = wp_web_page_sk
        AND t_hour BETWEEN 19 AND 20
        AND hd_dep_count = 6
        AND wp_char_count BETWEEN 100 AND 7000) AS pm_shift
""",
91: """
SELECT cc_call_center_id, cc_name, cc_manager,
       sum(cr_net_loss) AS returns_loss
FROM call_center, catalog_returns, date_dim, customer,
     customer_address, customer_demographics, household_demographics
WHERE cr_call_center_sk = cc_call_center_sk
  AND cr_returned_date_sk = d_date_sk
  AND cr_returning_customer_sk = c_customer_sk
  AND cd_demo_sk = c_current_cdemo_sk
  AND hd_demo_sk = c_current_hdemo_sk
  AND ca_address_sk = c_current_addr_sk
  AND d_year = 1998 AND d_moy = 11
  AND ((cd_marital_status = 'M' AND cd_education_status = 'Unknown')
       OR (cd_marital_status = 'W' AND cd_education_status = 'Advanced Degree'))
  AND hd_buy_potential LIKE 'Unknown%'
  AND ca_gmt_offset = -7.0
GROUP BY cc_call_center_id, cc_name, cc_manager
ORDER BY returns_loss DESC, cc_call_center_id
LIMIT 100
""",
92: """
SELECT sum(ws_ext_discount_amt) AS excess_discount_amount
FROM web_sales, item, date_dim
WHERE i_manufact_id BETWEEN 1 AND 350
  AND i_item_sk = ws_item_sk
  AND d_date BETWEEN DATE '2000-01-01' AND DATE '2000-04-01'
  AND d_date_sk = ws_sold_date_sk
  AND ws_ext_discount_amt > (
    SELECT 1.3 * avg(ws2.ws_ext_discount_amt)
    FROM web_sales ws2, date_dim d2
    WHERE ws2.ws_item_sk = i_item_sk
      AND ws2.ws_sold_date_sk = d2.d_date_sk
      AND d2.d_date BETWEEN DATE '2000-01-01' AND DATE '2000-04-01')
""",
93: """
SELECT ss_customer_sk, sum(act_sales) AS sumsales
FROM (SELECT ss_item_sk, ss_ticket_number, ss_customer_sk,
             CASE WHEN sr_return_quantity IS NOT NULL
                  THEN (ss_quantity - sr_return_quantity) * ss_sales_price
                  ELSE ss_quantity * ss_sales_price END AS act_sales
      FROM store_sales
      LEFT JOIN store_returns ON sr_item_sk = ss_item_sk
                             AND sr_ticket_number = ss_ticket_number
      LEFT JOIN reason ON sr_reason_sk = r_reason_sk) AS t
GROUP BY ss_customer_sk
ORDER BY sumsales DESC, ss_customer_sk
LIMIT 100
""",
94: """
SELECT count(DISTINCT ws1.ws_order_number) AS order_count,
       sum(ws1.ws_ext_ship_cost) AS total_shipping_cost,
       sum(ws1.ws_net_profit) AS total_net_profit
FROM web_sales ws1, date_dim, customer_address, web_site
WHERE d_date BETWEEN DATE '1999-02-01' AND DATE '1999-06-01'
  AND ws1.ws_ship_date_sk = d_date_sk
  AND ws1.ws_ship_addr_sk = ca_address_sk
  AND ca_state IN ('GA', 'CA', 'TX', 'NY', 'OH')
  AND ws1.ws_web_site_sk = web_site_sk
  AND EXISTS (SELECT 1 FROM web_sales ws2
              WHERE ws1.ws_order_number = ws2.ws_order_number
                AND ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  AND NOT EXISTS (SELECT 1 FROM web_returns wr1
                  WHERE ws1.ws_order_number = wr1.wr_order_number)
""",
95: """
WITH ws_wh AS
 (SELECT ws1.ws_order_number AS ws_order_number,
         ws1.ws_warehouse_sk AS wh1, ws2.ws_warehouse_sk AS wh2
  FROM web_sales ws1, web_sales ws2
  WHERE ws1.ws_order_number = ws2.ws_order_number
    AND ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
SELECT count(DISTINCT ws1.ws_order_number) AS order_count,
       sum(ws_ext_ship_cost) AS total_shipping_cost,
       sum(ws_net_profit) AS total_net_profit
FROM web_sales ws1, date_dim, customer_address, web_site
WHERE d_date BETWEEN DATE '2000-02-01' AND DATE '2000-05-31'
  AND ws1.ws_ship_date_sk = d_date_sk
  AND ws1.ws_ship_addr_sk = ca_address_sk
  AND ca_state IN ('GA', 'AL', 'CA', 'TX', 'NY', 'FL', 'IL', 'OH')
  AND ws1.ws_web_site_sk = web_site_sk
  AND ws1.ws_order_number IN (SELECT ws_order_number FROM ws_wh)
  AND ws1.ws_order_number IN
      (SELECT wr_order_number FROM web_returns, ws_wh
       WHERE wr_order_number = ws_wh.ws_order_number)
ORDER BY order_count
""",
96: """
SELECT count(*) AS cnt
FROM store_sales, household_demographics, time_dim, store
WHERE ss_sold_time_sk = t_time_sk
  AND ss_hdemo_sk = hd_demo_sk
  AND ss_store_sk = s_store_sk
  AND t_hour = 20 AND t_minute >= 30
  AND hd_dep_count = 7
  AND s_store_name = 'ese'
""",
97: """
WITH ssci AS (
  SELECT ss_customer_sk AS customer_sk, ss_item_sk AS item_sk
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 1200 AND 1211
  GROUP BY ss_customer_sk, ss_item_sk
), csci AS (
  SELECT cs_bill_customer_sk AS customer_sk, cs_item_sk AS item_sk
  FROM catalog_sales, date_dim
  WHERE cs_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 1200 AND 1211
  GROUP BY cs_bill_customer_sk, cs_item_sk
)
SELECT sum(CASE WHEN ssci.customer_sk IS NOT NULL
                 AND csci.customer_sk IS NULL THEN 1 ELSE 0 END)
         AS store_only,
       sum(CASE WHEN ssci.customer_sk IS NULL
                 AND csci.customer_sk IS NOT NULL THEN 1 ELSE 0 END)
         AS catalog_only,
       sum(CASE WHEN ssci.customer_sk IS NOT NULL
                 AND csci.customer_sk IS NOT NULL THEN 1 ELSE 0 END)
         AS store_and_catalog
FROM ssci FULL JOIN csci ON ssci.customer_sk = csci.customer_sk
                         AND ssci.item_sk = csci.item_sk
""",
98: """
SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) AS itemrevenue
FROM store_sales, item, date_dim
WHERE ss_item_sk = i_item_sk
  AND i_category IN ('Sports', 'Books', 'Home')
  AND ss_sold_date_sk = d_date_sk
  AND d_date BETWEEN DATE '1999-02-22' AND DATE '1999-03-24'
GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
ORDER BY i_category, i_class, i_item_id, i_item_desc, itemrevenue
LIMIT 100
""",
99: """
SELECT substr(w_warehouse_name, 1, 20) AS wh, sm_type, cc_name,
       sum(CASE WHEN cs_ship_date_sk - cs_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS d30,
       sum(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 30
                 AND cs_ship_date_sk - cs_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS d60,
       sum(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 60
                THEN 1 ELSE 0 END) AS dmore
FROM catalog_sales, warehouse, ship_mode, call_center, date_dim
WHERE d_month_seq BETWEEN 1200 AND 1211
  AND cs_ship_date_sk = d_date_sk
  AND cs_warehouse_sk = w_warehouse_sk
  AND cs_ship_mode_sk = sm_ship_mode_sk
  AND cs_call_center_sk = cc_call_center_sk
GROUP BY substr(w_warehouse_name, 1, 20), sm_type, cc_name
ORDER BY wh, sm_type, cc_name
LIMIT 100
""",
}
