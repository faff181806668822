"""TPC-DS data generator connector.

Reference parity: presto-tpcds (TpcdsConnectorFactory, TpcdsRecordSet —
the reference wraps the Teradata dsdgen library).  Like the TPC-H
connector (connectors/tpch.py) this is a deterministic *counter-based*
vectorized generator: every (table, column, row) maps to one splitmix64
draw, so any row range of any table is independently generable (the
split-parallel scan property).  Faithful to the TPC-DS schema (column
names/types per the spec) and key relationships (valid FK ranges;
returns reference their parent sale's item/ticket/customer/prices); NOT
bit-identical to dsdgen — correctness testing is differential against
sqlite over identical generated data.

presto_tpu_torch's copy of presto_tpu/connectors/tpcds.py: numpy only,
every table and column equal to the reference's bit for bit
(tests/test_torch_tpcds_gen.py).

Covered tables: ALL 24 of the TPC-DS schema — every dimension
(date_dim, time_dim, item, customer, customer_address,
customer_demographics, household_demographics, income_band, promotion,
reason, ship_mode, store, warehouse, web_site, web_page, call_center,
catalog_page) and every fact channel (store_sales/store_returns,
catalog_sales/catalog_returns, web_sales/web_returns, inventory),
enough for the full 99-query differential corpus.

Row counts at SF1 follow the spec (store_sales 2,880,404; catalog_sales
1,441,548; returns ~10% of sales).  Fixed-size dimensions
(date_dim, household_demographics, income_band) do not scale;
customer_demographics (spec-fixed 1,920,800) is scaled below SF1 to keep
test fixtures small — FK validity is preserved at every scale.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import _colkey, _splitmix64

# ---------------------------------------------------------------------------
# counter-based draw helpers (distinct key-space from TPC-H via "tpcds/")
# ---------------------------------------------------------------------------


def _round(x, decimals=2):
    """np.round with explicit scale / rint / reciprocal-multiply.
    XLA rewrites division by a constant into multiplication by its
    reciprocal under jit; the reference's device fact generator
    (presto_tpu/connectors/tpcds_device.py) therefore multiplies by
    0.01, and this copy does the SAME so that its columns stay equal to
    the reference's bit for bit (np.round divides)."""
    s = 10.0 ** decimals
    return np.rint(x * s) * (1.0 / s)


def _raw_at(table, col, rows, k=1):
    """(len(rows), k) uniform doubles in [0,1) for explicit row indices —
    the strided-access generalization the returns tables need to read
    their parent sale's draws."""
    with np.errstate(over="ignore"):
        r = np.asarray(rows, dtype=np.uint64)[:, None]
        draws = np.arange(k, dtype=np.uint64)[None, :]
        ctr = (r * np.uint64(k) + draws
               + _colkey("tpcds/" + table, col) * np.uint64(0x632BE59BD9B4E019))
        u = _splitmix64(ctr)
    return (u >> np.uint64(11)).astype(np.float64) * (2.0**-53)


def _raw(table, col, row0, n, k=1):
    return _raw_at(table, col, np.arange(row0, row0 + n, dtype=np.uint64), k)


def _u_at(table, col, rows, lo, hi, dtype=np.int64):
    return (lo + np.floor(_raw_at(table, col, rows)[:, 0] * (hi - lo + 1))).astype(dtype)


def _u(table, col, row0, n, lo, hi, dtype=np.int64):
    return _u_at(table, col, np.arange(row0, row0 + n, dtype=np.uint64), lo, hi, dtype)


def _money_at(table, col, rows, lo_cents, hi_cents):
    return _u_at(table, col, rows, lo_cents, hi_cents) * 0.01


def _money(table, col, row0, n, lo_cents, hi_cents):
    return _u(table, col, row0, n, lo_cents, hi_cents) * 0.01


def _pick_at(table, col, rows, choices):
    idx = _u_at(table, col, rows, 0, len(choices) - 1, np.int32)
    return np.asarray(choices, dtype=object)[idx]


def _pick(table, col, row0, n, choices):
    return _pick_at(table, col, np.arange(row0, row0 + n, dtype=np.uint64), choices)


def _numbered(prefix: str, keys: np.ndarray, width: int = 16) -> np.ndarray:
    return np.char.add(prefix, np.char.zfill(keys.astype(str), width)).astype(object)


# ---------------------------------------------------------------------------
# vocabularies (spec-flavored)
# ---------------------------------------------------------------------------

COLORS = ("almond antique aquamarine azure beige bisque black blanched blue "
          "blush brown burlywood burnished chartreuse chiffon chocolate coral "
          "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
          "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
          "hot indian ivory khaki lace lavender lawn lemon light lime linen "
          "magenta maroon medium metallic midnight mint misty moccasin navajo "
          "navy olive orange orchid pale papaya peach peru pink plum powder "
          "puff purple red rose rosy royal saddle salmon sandy seashell sienna "
          "sky slate smoke snow spring steel tan thistle tomato turquoise "
          "violet wheat white yellow").split()
CATEGORIES = ["Women", "Men", "Children", "Shoes", "Music", "Jewelry",
              "Home", "Sports", "Books", "Electronics"]
CLASSES = ["accessories", "classical", "pants", "shirts", "dresses",
           "earings", "bedding", "fishing", "mystery", "portable",
           "athletic", "maternity", "country", "swimwear", "romance"]
BRAND_SYL = ["amalg", "edu pack", "exporti", "importo", "scholar",
             "brand", "corp", "maxi", "univ", "nameless"]
UNITS = ["Unknown", "Each", "Dozen", "Case", "Pallet", "Gross", "Box",
         "Pound", "Ounce", "Ton", "Tbl", "Oz", "Lb", "Dram", "Carton",
         "Cup", "Gram", "Bunch", "Tsp", "N/A", "Bundle"]
CONTAINERS = ["Unknown"]
SALUTATIONS = ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"]
FIRST_NAMES = ("James John Robert Michael William David Richard Charles "
               "Joseph Thomas Mary Patricia Linda Barbara Elizabeth Jennifer "
               "Maria Susan Margaret Dorothy Lisa Nancy Karen Betty Helen "
               "Sandra Donna Carol Ruth Sharon").split()
LAST_NAMES = ("Smith Johnson Williams Jones Brown Davis Miller Wilson Moore "
              "Taylor Anderson Thomas Jackson White Harris Martin Thompson "
              "Garcia Martinez Robinson Clark Rodriguez Lewis Lee Walker "
              "Hall Allen Young Hernandez King").split()
COUNTRIES = ["UNITED STATES"]
STATES = ("AL AK AZ AR CA CO CT DE FL GA HI ID IL IN IA KS KY LA ME MD MA MI "
          "MN MS MO MT NE NV NH NJ NM NY NC ND OH OK OR PA RI SC SD TN TX UT "
          "VT VA WA WV WI WY").split()
CITIES = ("Midway Fairview Oakland Salem Franklin Greenville Bridgeport "
          "Springdale Oak_Grove Centerville Riverside Clinton Georgetown "
          "Marion Five_Points Liberty Greenwood Oakdale Glendale Union "
          "Pleasant_Hill Lebanon Summit Ashland Lakeview").split()
STREET_NAMES = ("Main Oak Park First Second Third Fourth Fifth Sixth Seventh "
                "Eighth Ninth Tenth Elm Maple Cedar Pine Spruce Walnut Lake "
                "Hill River Ridge View Sunset Washington Jefferson Lincoln "
                "Jackson Williams Smith Davis College Church Center Mill "
                "Railroad Dogwood Birch Hickory Laurel Willow Broadway Green "
                "Forest Meadow Highland Valley Spring North South East West "
                "Locust Chestnut Poplar Sycamore Johnson Franklin Madison "
                "Adams 1st 2nd 3rd 4th 5th 6th 7th 8th 9th 10th 11th 12th "
                "13th 14th 15th Wilson Lee College_Park").split()
STREET_TYPES = ["Street", "Ave", "Blvd", "Boulevard", "Circle", "Cir", "Court",
                "Ct", "Drive", "Dr", "Lane", "Ln", "Parkway", "Pkwy", "Road",
                "RD", "ST", "Way", "Wy"]
GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
                 "Unknown"]
REASONS = ["Package was damaged", "Stopped working", "Did not fit",
           "Not the product that was ordred", "Parts missing",
           "Does not work with a product that I have",
           "Gift exchange", "Did not like the color",
           "Did not like the model", "Did not like the make",
           "Found a better price in a store", "Found a better extension",
           "Not working any more", "unauthoized purchase",
           "duplicate purchase", "no service location",
           "wrong size", "lost my job", "it is a boring product",
           "found a better price elsewhere", "reason 21", "reason 22",
           "reason 23", "reason 24", "reason 25", "reason 26", "reason 27",
           "reason 28", "reason 29", "reason 30", "reason 31", "reason 32",
           "reason 33", "reason 34", "reason 35"]
SHIP_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"]
SHIP_CODES = ["AIR", "SURFACE", "SEA"]
CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
            "ZOUROS", "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN",
            "BOXBUNDLES", "GERMA", "HARMSTORF", "PRIVATECARRIER", "DIAMOND",
            "RUPEKSA", "GREAT EASTERN"]
PROMO_PURPOSE = ["Unknown"]

EPOCH = np.datetime64("1970-01-01", "D")
DATE_DIM_START = np.datetime64("1900-01-01", "D")
DATE_DIM_ROWS = 73049  # 1900-01-01 .. 2099-12-31 per spec
JULIAN_OF_START = 2415021  # d_date_sk of 1900-01-01 (Julian day number)
# sales span: 1998-01-01 .. 2002-12-31 (spec's active range)
SALES_DATE_LO = JULIAN_OF_START + int(
    (np.datetime64("1998-01-01") - DATE_DIM_START) / np.timedelta64(1, "D"))
SALES_DATE_HI = JULIAN_OF_START + int(
    (np.datetime64("2002-12-31") - DATE_DIM_START) / np.timedelta64(1, "D"))

ITEMS_PER_TICKET = 3      # store_sales rows sharing one ticket/customer
ITEMS_PER_ORDER = 4       # catalog_sales rows sharing one order/customer
RETURN_EVERY = 10         # every 10th sale row is returned

_SF1_ROWS = {
    "store_sales": 2_880_404,
    "catalog_sales": 1_441_548,
    "web_sales": 719_384,
    "customer": 100_000,
    "customer_address": 50_000,
    "item": 18_000,
    "store": 12,
    "promotion": 300,
    "warehouse": 5,
    "web_site": 30,
    "web_page": 60,
    "call_center": 6,
    "catalog_page": 11_718,
}
_FIXED_ROWS = {
    "date_dim": DATE_DIM_ROWS,
    "household_demographics": 7_200,
    "income_band": 20,
    "reason": 35,
    "ship_mode": 20,
    "time_dim": 86_400,
}
CD_CROSS = 1_920_800  # spec-fixed cross product of the 7 cd attributes


def row_count(table: str, sf: float) -> int:
    if table in _FIXED_ROWS:
        return _FIXED_ROWS[table]
    if table == "customer_demographics":
        return CD_CROSS if sf >= 1 else max(7_200, int(CD_CROSS * sf))
    if table == "store_returns":
        return row_count("store_sales", sf) // RETURN_EVERY
    if table == "catalog_returns":
        return row_count("catalog_sales", sf) // RETURN_EVERY
    if table == "web_returns":
        return row_count("web_sales", sf) // RETURN_EVERY
    if table == "inventory":
        # weekly snapshots; items capped sub-linearly like the spec
        # (inventory is ~400M at SF100, not items*weeks*warehouses linear)
        return INV_WEEKS * _inv_items(sf) * row_count("warehouse", sf)
    base = _SF1_ROWS[table]
    if table in ("store", "warehouse", "promotion", "web_site", "web_page",
                 "call_center"):
        return max(base, int(base * max(sf, 1) ** 0.5))
    if table == "catalog_page":
        return base  # spec: page count grows sub-linearly; fixed here
    return max(1, int(base * sf))


SCHEMAS = {
    "date_dim": {
        "d_date_sk": T.BIGINT, "d_date_id": T.VARCHAR, "d_date": T.DATE,
        "d_month_seq": T.INTEGER, "d_week_seq": T.INTEGER,
        "d_quarter_seq": T.INTEGER, "d_year": T.INTEGER, "d_dow": T.INTEGER,
        "d_moy": T.INTEGER, "d_dom": T.INTEGER, "d_qoy": T.INTEGER,
        "d_fy_year": T.INTEGER, "d_fy_quarter_seq": T.INTEGER,
        "d_fy_week_seq": T.INTEGER, "d_day_name": T.VARCHAR,
        "d_quarter_name": T.VARCHAR, "d_holiday": T.VARCHAR,
        "d_weekend": T.VARCHAR, "d_following_holiday": T.VARCHAR,
        "d_first_dom": T.INTEGER, "d_last_dom": T.INTEGER,
        "d_same_day_ly": T.INTEGER, "d_same_day_lq": T.INTEGER,
        "d_current_day": T.VARCHAR, "d_current_week": T.VARCHAR,
        "d_current_month": T.VARCHAR, "d_current_quarter": T.VARCHAR,
        "d_current_year": T.VARCHAR,
    },
    "item": {
        "i_item_sk": T.BIGINT, "i_item_id": T.VARCHAR,
        "i_rec_start_date": T.DATE, "i_rec_end_date": T.DATE,
        "i_item_desc": T.VARCHAR, "i_current_price": T.DOUBLE,
        "i_wholesale_cost": T.DOUBLE, "i_brand_id": T.INTEGER,
        "i_brand": T.VARCHAR, "i_class_id": T.INTEGER, "i_class": T.VARCHAR,
        "i_category_id": T.INTEGER, "i_category": T.VARCHAR,
        "i_manufact_id": T.INTEGER, "i_manufact": T.VARCHAR,
        "i_size": T.VARCHAR, "i_formulation": T.VARCHAR, "i_color": T.VARCHAR,
        "i_units": T.VARCHAR, "i_container": T.VARCHAR,
        "i_manager_id": T.INTEGER, "i_product_name": T.VARCHAR,
    },
    "customer": {
        "c_customer_sk": T.BIGINT, "c_customer_id": T.VARCHAR,
        "c_current_cdemo_sk": T.BIGINT, "c_current_hdemo_sk": T.BIGINT,
        "c_current_addr_sk": T.BIGINT, "c_first_shipto_date_sk": T.BIGINT,
        "c_first_sales_date_sk": T.BIGINT, "c_salutation": T.VARCHAR,
        "c_first_name": T.VARCHAR, "c_last_name": T.VARCHAR,
        "c_preferred_cust_flag": T.VARCHAR, "c_birth_day": T.INTEGER,
        "c_birth_month": T.INTEGER, "c_birth_year": T.INTEGER,
        "c_birth_country": T.VARCHAR, "c_login": T.VARCHAR,
        "c_email_address": T.VARCHAR, "c_last_review_date_sk": T.BIGINT,
    },
    "customer_address": {
        "ca_address_sk": T.BIGINT, "ca_address_id": T.VARCHAR,
        "ca_street_number": T.VARCHAR, "ca_street_name": T.VARCHAR,
        "ca_street_type": T.VARCHAR, "ca_suite_number": T.VARCHAR,
        "ca_city": T.VARCHAR, "ca_county": T.VARCHAR, "ca_state": T.VARCHAR,
        "ca_zip": T.VARCHAR, "ca_country": T.VARCHAR,
        "ca_gmt_offset": T.DOUBLE, "ca_location_type": T.VARCHAR,
    },
    "customer_demographics": {
        "cd_demo_sk": T.BIGINT, "cd_gender": T.VARCHAR,
        "cd_marital_status": T.VARCHAR, "cd_education_status": T.VARCHAR,
        "cd_purchase_estimate": T.INTEGER, "cd_credit_rating": T.VARCHAR,
        "cd_dep_count": T.INTEGER, "cd_dep_employed_count": T.INTEGER,
        "cd_dep_college_count": T.INTEGER,
    },
    "household_demographics": {
        "hd_demo_sk": T.BIGINT, "hd_income_band_sk": T.BIGINT,
        "hd_buy_potential": T.VARCHAR, "hd_dep_count": T.INTEGER,
        "hd_vehicle_count": T.INTEGER,
    },
    "income_band": {
        "ib_income_band_sk": T.BIGINT, "ib_lower_bound": T.INTEGER,
        "ib_upper_bound": T.INTEGER,
    },
    "promotion": {
        "p_promo_sk": T.BIGINT, "p_promo_id": T.VARCHAR,
        "p_start_date_sk": T.BIGINT, "p_end_date_sk": T.BIGINT,
        "p_item_sk": T.BIGINT, "p_cost": T.DOUBLE,
        "p_response_target": T.INTEGER, "p_promo_name": T.VARCHAR,
        "p_channel_dmail": T.VARCHAR, "p_channel_email": T.VARCHAR,
        "p_channel_catalog": T.VARCHAR, "p_channel_tv": T.VARCHAR,
        "p_channel_radio": T.VARCHAR, "p_channel_press": T.VARCHAR,
        "p_channel_event": T.VARCHAR, "p_channel_demo": T.VARCHAR,
        "p_channel_details": T.VARCHAR, "p_purpose": T.VARCHAR,
        "p_discount_active": T.VARCHAR,
    },
    "store": {
        "s_store_sk": T.BIGINT, "s_store_id": T.VARCHAR,
        "s_rec_start_date": T.DATE, "s_rec_end_date": T.DATE,
        "s_closed_date_sk": T.BIGINT, "s_store_name": T.VARCHAR,
        "s_number_employees": T.INTEGER, "s_floor_space": T.INTEGER,
        "s_hours": T.VARCHAR, "s_manager": T.VARCHAR, "s_market_id": T.INTEGER,
        "s_geography_class": T.VARCHAR, "s_market_desc": T.VARCHAR,
        "s_market_manager": T.VARCHAR, "s_division_id": T.INTEGER,
        "s_division_name": T.VARCHAR, "s_company_id": T.INTEGER,
        "s_company_name": T.VARCHAR, "s_street_number": T.VARCHAR,
        "s_street_name": T.VARCHAR, "s_street_type": T.VARCHAR,
        "s_suite_number": T.VARCHAR, "s_city": T.VARCHAR, "s_county": T.VARCHAR,
        "s_state": T.VARCHAR, "s_zip": T.VARCHAR, "s_country": T.VARCHAR,
        "s_gmt_offset": T.DOUBLE, "s_tax_precentage": T.DOUBLE,
    },
    "reason": {
        "r_reason_sk": T.BIGINT, "r_reason_id": T.VARCHAR,
        "r_reason_desc": T.VARCHAR,
    },
    "ship_mode": {
        "sm_ship_mode_sk": T.BIGINT, "sm_ship_mode_id": T.VARCHAR,
        "sm_type": T.VARCHAR, "sm_code": T.VARCHAR, "sm_carrier": T.VARCHAR,
        "sm_contract": T.VARCHAR,
    },
    "warehouse": {
        "w_warehouse_sk": T.BIGINT, "w_warehouse_id": T.VARCHAR,
        "w_warehouse_name": T.VARCHAR, "w_warehouse_sq_ft": T.INTEGER,
        "w_street_number": T.VARCHAR, "w_street_name": T.VARCHAR,
        "w_street_type": T.VARCHAR, "w_suite_number": T.VARCHAR,
        "w_city": T.VARCHAR, "w_county": T.VARCHAR, "w_state": T.VARCHAR,
        "w_zip": T.VARCHAR, "w_country": T.VARCHAR, "w_gmt_offset": T.DOUBLE,
    },
    "store_sales": {
        "ss_sold_date_sk": T.BIGINT, "ss_sold_time_sk": T.BIGINT,
        "ss_item_sk": T.BIGINT, "ss_customer_sk": T.BIGINT,
        "ss_cdemo_sk": T.BIGINT, "ss_hdemo_sk": T.BIGINT,
        "ss_addr_sk": T.BIGINT, "ss_store_sk": T.BIGINT,
        "ss_promo_sk": T.BIGINT, "ss_ticket_number": T.BIGINT,
        "ss_quantity": T.INTEGER, "ss_wholesale_cost": T.DOUBLE,
        "ss_list_price": T.DOUBLE, "ss_sales_price": T.DOUBLE,
        "ss_ext_discount_amt": T.DOUBLE, "ss_ext_sales_price": T.DOUBLE,
        "ss_ext_wholesale_cost": T.DOUBLE, "ss_ext_list_price": T.DOUBLE,
        "ss_ext_tax": T.DOUBLE, "ss_coupon_amt": T.DOUBLE,
        "ss_net_paid": T.DOUBLE, "ss_net_paid_inc_tax": T.DOUBLE,
        "ss_net_profit": T.DOUBLE,
    },
    "store_returns": {
        "sr_returned_date_sk": T.BIGINT, "sr_return_time_sk": T.BIGINT,
        "sr_item_sk": T.BIGINT, "sr_customer_sk": T.BIGINT,
        "sr_cdemo_sk": T.BIGINT, "sr_hdemo_sk": T.BIGINT,
        "sr_addr_sk": T.BIGINT, "sr_store_sk": T.BIGINT,
        "sr_reason_sk": T.BIGINT, "sr_ticket_number": T.BIGINT,
        "sr_return_quantity": T.INTEGER, "sr_return_amt": T.DOUBLE,
        "sr_return_tax": T.DOUBLE, "sr_return_amt_inc_tax": T.DOUBLE,
        "sr_fee": T.DOUBLE, "sr_return_ship_cost": T.DOUBLE,
        "sr_refunded_cash": T.DOUBLE, "sr_reversed_charge": T.DOUBLE,
        "sr_store_credit": T.DOUBLE, "sr_net_loss": T.DOUBLE,
    },
    "catalog_sales": {
        "cs_sold_date_sk": T.BIGINT, "cs_sold_time_sk": T.BIGINT,
        "cs_ship_date_sk": T.BIGINT, "cs_bill_customer_sk": T.BIGINT,
        "cs_bill_cdemo_sk": T.BIGINT, "cs_bill_hdemo_sk": T.BIGINT,
        "cs_bill_addr_sk": T.BIGINT, "cs_ship_customer_sk": T.BIGINT,
        "cs_ship_cdemo_sk": T.BIGINT, "cs_ship_hdemo_sk": T.BIGINT,
        "cs_ship_addr_sk": T.BIGINT, "cs_call_center_sk": T.BIGINT,
        "cs_catalog_page_sk": T.BIGINT, "cs_ship_mode_sk": T.BIGINT,
        "cs_warehouse_sk": T.BIGINT, "cs_item_sk": T.BIGINT,
        "cs_promo_sk": T.BIGINT, "cs_order_number": T.BIGINT,
        "cs_quantity": T.INTEGER, "cs_wholesale_cost": T.DOUBLE,
        "cs_list_price": T.DOUBLE, "cs_sales_price": T.DOUBLE,
        "cs_ext_discount_amt": T.DOUBLE, "cs_ext_sales_price": T.DOUBLE,
        "cs_ext_wholesale_cost": T.DOUBLE, "cs_ext_list_price": T.DOUBLE,
        "cs_ext_tax": T.DOUBLE, "cs_coupon_amt": T.DOUBLE,
        "cs_ext_ship_cost": T.DOUBLE, "cs_net_paid": T.DOUBLE,
        "cs_net_paid_inc_tax": T.DOUBLE, "cs_net_paid_inc_ship": T.DOUBLE,
        "cs_net_paid_inc_ship_tax": T.DOUBLE, "cs_net_profit": T.DOUBLE,
    },
    "catalog_returns": {
        "cr_returned_date_sk": T.BIGINT, "cr_returned_time_sk": T.BIGINT,
        "cr_item_sk": T.BIGINT, "cr_refunded_customer_sk": T.BIGINT,
        "cr_refunded_cdemo_sk": T.BIGINT, "cr_refunded_hdemo_sk": T.BIGINT,
        "cr_refunded_addr_sk": T.BIGINT, "cr_returning_customer_sk": T.BIGINT,
        "cr_returning_cdemo_sk": T.BIGINT, "cr_returning_hdemo_sk": T.BIGINT,
        "cr_returning_addr_sk": T.BIGINT, "cr_call_center_sk": T.BIGINT,
        "cr_catalog_page_sk": T.BIGINT, "cr_ship_mode_sk": T.BIGINT,
        "cr_warehouse_sk": T.BIGINT, "cr_reason_sk": T.BIGINT,
        "cr_order_number": T.BIGINT, "cr_return_quantity": T.INTEGER,
        "cr_return_amount": T.DOUBLE, "cr_return_tax": T.DOUBLE,
        "cr_return_amt_inc_tax": T.DOUBLE, "cr_fee": T.DOUBLE,
        "cr_return_ship_cost": T.DOUBLE, "cr_refunded_cash": T.DOUBLE,
        "cr_reversed_charge": T.DOUBLE, "cr_store_credit": T.DOUBLE,
        "cr_net_loss": T.DOUBLE,
    },
    "web_sales": {
        "ws_sold_date_sk": T.BIGINT, "ws_sold_time_sk": T.BIGINT,
        "ws_ship_date_sk": T.BIGINT, "ws_item_sk": T.BIGINT,
        "ws_bill_customer_sk": T.BIGINT, "ws_bill_cdemo_sk": T.BIGINT,
        "ws_bill_hdemo_sk": T.BIGINT, "ws_bill_addr_sk": T.BIGINT,
        "ws_ship_customer_sk": T.BIGINT, "ws_ship_cdemo_sk": T.BIGINT,
        "ws_ship_hdemo_sk": T.BIGINT, "ws_ship_addr_sk": T.BIGINT,
        "ws_web_page_sk": T.BIGINT, "ws_web_site_sk": T.BIGINT,
        "ws_ship_mode_sk": T.BIGINT, "ws_warehouse_sk": T.BIGINT,
        "ws_promo_sk": T.BIGINT, "ws_order_number": T.BIGINT,
        "ws_quantity": T.INTEGER, "ws_wholesale_cost": T.DOUBLE,
        "ws_list_price": T.DOUBLE, "ws_sales_price": T.DOUBLE,
        "ws_ext_discount_amt": T.DOUBLE, "ws_ext_sales_price": T.DOUBLE,
        "ws_ext_wholesale_cost": T.DOUBLE, "ws_ext_list_price": T.DOUBLE,
        "ws_ext_tax": T.DOUBLE, "ws_coupon_amt": T.DOUBLE,
        "ws_ext_ship_cost": T.DOUBLE, "ws_net_paid": T.DOUBLE,
        "ws_net_paid_inc_tax": T.DOUBLE, "ws_net_paid_inc_ship": T.DOUBLE,
        "ws_net_paid_inc_ship_tax": T.DOUBLE, "ws_net_profit": T.DOUBLE,
    },
    "web_returns": {
        "wr_returned_date_sk": T.BIGINT, "wr_returned_time_sk": T.BIGINT,
        "wr_item_sk": T.BIGINT, "wr_refunded_customer_sk": T.BIGINT,
        "wr_refunded_cdemo_sk": T.BIGINT, "wr_refunded_hdemo_sk": T.BIGINT,
        "wr_refunded_addr_sk": T.BIGINT, "wr_returning_customer_sk": T.BIGINT,
        "wr_returning_cdemo_sk": T.BIGINT, "wr_returning_hdemo_sk": T.BIGINT,
        "wr_returning_addr_sk": T.BIGINT, "wr_web_page_sk": T.BIGINT,
        "wr_reason_sk": T.BIGINT, "wr_order_number": T.BIGINT,
        "wr_return_quantity": T.INTEGER, "wr_return_amt": T.DOUBLE,
        "wr_return_tax": T.DOUBLE, "wr_return_amt_inc_tax": T.DOUBLE,
        "wr_fee": T.DOUBLE, "wr_return_ship_cost": T.DOUBLE,
        "wr_refunded_cash": T.DOUBLE, "wr_reversed_charge": T.DOUBLE,
        "wr_account_credit": T.DOUBLE, "wr_net_loss": T.DOUBLE,
    },
    "web_site": {
        "web_site_sk": T.BIGINT, "web_site_id": T.VARCHAR,
        "web_name": T.VARCHAR, "web_manager": T.VARCHAR,
        "web_market_manager": T.VARCHAR, "web_company_id": T.INTEGER,
        "web_company_name": T.VARCHAR, "web_street_name": T.VARCHAR,
        "web_street_type": T.VARCHAR, "web_city": T.VARCHAR,
        "web_county": T.VARCHAR, "web_state": T.VARCHAR,
        "web_zip": T.VARCHAR, "web_country": T.VARCHAR,
        "web_gmt_offset": T.DOUBLE, "web_tax_percentage": T.DOUBLE,
    },
    "web_page": {
        "wp_web_page_sk": T.BIGINT, "wp_web_page_id": T.VARCHAR,
        "wp_creation_date_sk": T.BIGINT, "wp_access_date_sk": T.BIGINT,
        "wp_autogen_flag": T.VARCHAR, "wp_url": T.VARCHAR,
        "wp_type": T.VARCHAR, "wp_char_count": T.INTEGER,
        "wp_link_count": T.INTEGER, "wp_image_count": T.INTEGER,
        "wp_max_ad_count": T.INTEGER,
    },
    "call_center": {
        "cc_call_center_sk": T.BIGINT, "cc_call_center_id": T.VARCHAR,
        "cc_name": T.VARCHAR, "cc_class": T.VARCHAR,
        "cc_employees": T.INTEGER, "cc_sq_ft": T.INTEGER,
        "cc_hours": T.VARCHAR, "cc_manager": T.VARCHAR,
        "cc_mkt_id": T.INTEGER, "cc_mkt_class": T.VARCHAR,
        "cc_market_manager": T.VARCHAR, "cc_county": T.VARCHAR,
        "cc_state": T.VARCHAR, "cc_country": T.VARCHAR,
        "cc_gmt_offset": T.DOUBLE, "cc_tax_percentage": T.DOUBLE,
    },
    "catalog_page": {
        "cp_catalog_page_sk": T.BIGINT, "cp_catalog_page_id": T.VARCHAR,
        "cp_start_date_sk": T.BIGINT, "cp_end_date_sk": T.BIGINT,
        "cp_department": T.VARCHAR, "cp_catalog_number": T.INTEGER,
        "cp_catalog_page_number": T.INTEGER, "cp_description": T.VARCHAR,
        "cp_type": T.VARCHAR,
    },
    "time_dim": {
        "t_time_sk": T.BIGINT, "t_time_id": T.VARCHAR, "t_time": T.INTEGER,
        "t_hour": T.INTEGER, "t_minute": T.INTEGER, "t_second": T.INTEGER,
        "t_am_pm": T.VARCHAR, "t_shift": T.VARCHAR,
        "t_sub_shift": T.VARCHAR, "t_meal_time": T.VARCHAR,
    },
    "inventory": {
        "inv_date_sk": T.BIGINT, "inv_item_sk": T.BIGINT,
        "inv_warehouse_sk": T.BIGINT, "inv_quantity_on_hand": T.INTEGER,
    },
}


# ---------------------------------------------------------------------------
# dimension generators
# ---------------------------------------------------------------------------


def _gen_date_dim(sf, row0, row1):
    i = np.arange(row0, row1, dtype=np.int64)
    dates = DATE_DIM_START + i.astype("timedelta64[D]")
    days = ((dates - EPOCH) / np.timedelta64(1, "D")).astype(np.int32)
    y = dates.astype("datetime64[Y]")
    m = dates.astype("datetime64[M]")
    year = y.astype(int) + 1970
    moy = (m - y).astype(int) + 1
    dom = (dates - m).astype(int) + 1
    qoy = (moy - 1) // 3 + 1
    # 1900-01-01 was a Monday; spec d_dow: 0 = Sunday
    dow = (i + 1) % 7
    month_seq = (year - 1900) * 12 + moy - 1
    week_seq = (i + 1) // 7 + 1
    quarter_seq = (year - 1900) * 4 + qoy - 1
    first_dom = (JULIAN_OF_START + i - (dom - 1)).astype(np.int64)
    last_dom = first_dom + (((m + 1).astype("datetime64[D]") - m.astype("datetime64[D]"))
                            / np.timedelta64(1, "D")).astype(np.int64) - 1
    day_names = np.asarray(["Sunday", "Monday", "Tuesday", "Wednesday",
                            "Thursday", "Friday", "Saturday"], dtype=object)
    return {
        "d_date_sk": JULIAN_OF_START + i,
        "d_date_id": _numbered("AAAAAAAA", JULIAN_OF_START + i, 8),
        "d_date": days,
        "d_month_seq": month_seq.astype(np.int32),
        "d_week_seq": week_seq.astype(np.int32),
        "d_quarter_seq": quarter_seq.astype(np.int32),
        "d_year": year.astype(np.int32),
        "d_dow": dow.astype(np.int32),
        "d_moy": moy.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": qoy.astype(np.int32),
        "d_fy_year": year.astype(np.int32),
        "d_fy_quarter_seq": quarter_seq.astype(np.int32),
        "d_fy_week_seq": week_seq.astype(np.int32),
        "d_day_name": day_names[dow],
        "d_quarter_name": np.char.add(np.char.add(year.astype(str), "Q"),
                                      qoy.astype(str)).astype(object),
        "d_holiday": np.where((moy == 12) & (dom == 25), "Y", "N").astype(object),
        "d_weekend": np.where((dow == 0) | (dow == 6), "Y", "N").astype(object),
        "d_following_holiday": np.where((moy == 12) & (dom == 26), "Y", "N").astype(object),
        "d_first_dom": first_dom.astype(np.int32),
        "d_last_dom": last_dom.astype(np.int32),
        "d_same_day_ly": (JULIAN_OF_START + i - 365).astype(np.int32),
        "d_same_day_lq": (JULIAN_OF_START + i - 91).astype(np.int32),
        "d_current_day": np.full(len(i), "N", dtype=object),
        "d_current_week": np.full(len(i), "N", dtype=object),
        "d_current_month": np.full(len(i), "N", dtype=object),
        "d_current_quarter": np.full(len(i), "N", dtype=object),
        "d_current_year": np.full(len(i), "N", dtype=object),
    }


def _gen_item(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    cat_id = _u("item", "cat", row0, n, 1, len(CATEGORIES))
    class_id = _u("item", "class", row0, n, 1, len(CLASSES))
    manufact_id = _u("item", "manu", row0, n, 1, 1000)
    brand_id = cat_id * 1_000_000 + class_id * 1000 + manufact_id % 1000
    brand = np.char.add(
        np.char.add(_pick("item", "brand1", row0, n, BRAND_SYL).astype(str), " #"),
        (brand_id % 10000).astype(str)).astype(object)
    price = _money("item", "price", row0, n, 9, 99_999)
    start = np.datetime64("1997-10-27", "D") - EPOCH
    return {
        "i_item_sk": k,
        "i_item_id": _numbered("AAAAAAAA", k, 8),
        "i_rec_start_date": np.full(n, int(start / np.timedelta64(1, "D")),
                                    np.int32),
        "i_rec_end_date": np.full(n, int(start / np.timedelta64(1, "D")) + 3650,
                                  np.int32),
        "i_item_desc": _pick("item", "desc", row0, n, COLORS),
        "i_current_price": price,
        "i_wholesale_cost": _round(price * 0.6, 2),
        "i_brand_id": brand_id.astype(np.int32),
        "i_brand": brand,
        "i_class_id": class_id.astype(np.int32),
        "i_class": np.asarray(CLASSES, object)[class_id - 1],
        "i_category_id": cat_id.astype(np.int32),
        "i_category": np.asarray(CATEGORIES, object)[cat_id - 1],
        "i_manufact_id": manufact_id.astype(np.int32),
        "i_manufact": _numbered("manufact#", manufact_id, 4),
        "i_size": _pick("item", "size", row0, n,
                        ["small", "medium", "large", "extra large", "petite",
                         "economy", "N/A"]),
        "i_formulation": _numbered("formulation", k % 100000, 6),
        "i_color": _pick("item", "color", row0, n, COLORS),
        "i_units": _pick("item", "units", row0, n, UNITS),
        "i_container": np.full(n, "Unknown", dtype=object),
        "i_manager_id": _u("item", "mgr", row0, n, 1, 100, np.int32),
        "i_product_name": _numbered("product", k, 9),
    }


def _gen_customer(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    n_cd = row_count("customer_demographics", sf)
    n_hd = _FIXED_ROWS["household_demographics"]
    n_addr = row_count("customer_address", sf)
    first_sales = _u("customer", "fsales", row0, n,
                     SALES_DATE_LO - 3650, SALES_DATE_LO)
    return {
        "c_customer_sk": k,
        "c_customer_id": _numbered("AAAAAAAA", k, 8),
        "c_current_cdemo_sk": _u("customer", "cdemo", row0, n, 1, n_cd),
        "c_current_hdemo_sk": _u("customer", "hdemo", row0, n, 1, n_hd),
        "c_current_addr_sk": _u("customer", "addr", row0, n, 1, n_addr),
        "c_first_shipto_date_sk": first_sales + 30,
        "c_first_sales_date_sk": first_sales,
        "c_salutation": _pick("customer", "salut", row0, n, SALUTATIONS),
        "c_first_name": _pick("customer", "fname", row0, n, FIRST_NAMES),
        "c_last_name": _pick("customer", "lname", row0, n, LAST_NAMES),
        "c_preferred_cust_flag": _pick("customer", "pref", row0, n, ["Y", "N"]),
        "c_birth_day": _u("customer", "bday", row0, n, 1, 28, np.int32),
        "c_birth_month": _u("customer", "bmon", row0, n, 1, 12, np.int32),
        "c_birth_year": _u("customer", "byear", row0, n, 1924, 1992, np.int32),
        "c_birth_country": np.full(n, "UNITED STATES", dtype=object),
        "c_login": np.full(n, "", dtype=object),
        "c_email_address": np.char.add(
            _numbered("Customer", k, 9).astype(str),
            "@example.com").astype(object),
        "c_last_review_date_sk": _u("customer", "review", row0, n,
                                    SALES_DATE_LO, SALES_DATE_HI),
    }


def _gen_customer_address(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    return {
        "ca_address_sk": k,
        "ca_address_id": _numbered("AAAAAAAA", k, 8),
        "ca_street_number": _u("ca", "stno", row0, n, 1, 999).astype(str).astype(object),
        "ca_street_name": _pick("ca", "stname", row0, n, STREET_NAMES),
        "ca_street_type": _pick("ca", "sttype", row0, n, STREET_TYPES),
        "ca_suite_number": _numbered("Suite ", _u("ca", "suite", row0, n, 0, 99), 2),
        "ca_city": _pick("ca", "city", row0, n, CITIES),
        "ca_county": _pick("ca", "county", row0, n,
                           ["Williamson County", "Walker County", "Ziebach County",
                            "Fairfield County", "Bronx County", "Franklin Parish",
                            "Barrow County", "Daviess County", "Luce County",
                            "Richland County", "San Miguel County", "Dauphin County",
                            "Mobile County", "Maverick County", "Huron County"]),
        "ca_state": _pick("ca", "state", row0, n, STATES),
        "ca_zip": np.char.zfill(_u("ca", "zip", row0, n, 601, 99950).astype(str),
                                5).astype(object),
        "ca_country": np.full(n, "United States", dtype=object),
        "ca_gmt_offset": _u("ca", "gmt", row0, n, -10, -5).astype(np.float64),
        "ca_location_type": _pick("ca", "loctype", row0, n,
                                  ["apartment", "condo", "single family"]),
    }


def _gen_customer_demographics(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    # mixed-radix decode of (sk-1) over the spec's attribute cross product
    x = k - 1
    gender = x % 2; x = x // 2
    marital = x % 5; x = x // 5
    edu = x % 7; x = x // 7
    purchase = x % 20; x = x // 20
    credit = x % 4; x = x // 4
    dep = x % 7; x = x // 7
    dep_emp = x % 7; x = x // 7
    return {
        "cd_demo_sk": k,
        "cd_gender": np.asarray(GENDERS, object)[gender],
        "cd_marital_status": np.asarray(MARITAL, object)[marital],
        "cd_education_status": np.asarray(EDUCATION, object)[edu],
        "cd_purchase_estimate": ((purchase + 1) * 500).astype(np.int32),
        "cd_credit_rating": np.asarray(CREDIT, object)[credit],
        "cd_dep_count": dep.astype(np.int32),
        "cd_dep_employed_count": dep_emp.astype(np.int32),
        "cd_dep_college_count": (x % 7).astype(np.int32),
    }


def _gen_household_demographics(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    x = k - 1
    ib = x % 20; x = x // 20
    buy = x % 6; x = x // 6
    dep = x % 10; x = x // 10
    veh = x % 6
    return {
        "hd_demo_sk": k,
        "hd_income_band_sk": ib + 1,
        "hd_buy_potential": np.asarray(BUY_POTENTIAL, object)[buy],
        "hd_dep_count": dep.astype(np.int32),
        "hd_vehicle_count": veh.astype(np.int32),
    }


def _gen_income_band(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    lower = (k - 1) * 10000
    return {
        "ib_income_band_sk": k,
        "ib_lower_bound": (lower + (k > 1)).astype(np.int32),
        "ib_upper_bound": (k * 10000).astype(np.int32),
    }


def _gen_promotion(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    n_item = row_count("item", sf)
    start = _u("promotion", "start", row0, n, SALES_DATE_LO, SALES_DATE_HI - 60)
    yn = lambda col: _pick("promotion", col, row0, n, ["N", "N", "N", "Y"])
    return {
        "p_promo_sk": k,
        "p_promo_id": _numbered("AAAAAAAA", k, 8),
        "p_start_date_sk": start,
        "p_end_date_sk": start + _u("promotion", "len", row0, n, 10, 60),
        "p_item_sk": _u("promotion", "item", row0, n, 1, n_item),
        "p_cost": _round(1000.0 * _u("promotion", "cost", row0, n, 1, 1000), 2),
        "p_response_target": np.ones(n, np.int32),
        "p_promo_name": _pick("promotion", "name", row0, n,
                              ["anti", "bar", "ese", "ought", "able", "pri",
                               "pres", "ation", "eing", "callly"]),
        "p_channel_dmail": yn("dmail"),
        "p_channel_email": np.full(n, "N", dtype=object),
        "p_channel_catalog": np.full(n, "N", dtype=object),
        "p_channel_tv": yn("tv"),
        "p_channel_radio": np.full(n, "N", dtype=object),
        "p_channel_press": np.full(n, "N", dtype=object),
        "p_channel_event": yn("event"),
        "p_channel_demo": np.full(n, "N", dtype=object),
        "p_channel_details": _numbered("promo details ", k, 6),
        "p_purpose": np.full(n, "Unknown", dtype=object),
        "p_discount_active": np.full(n, "N", dtype=object),
    }


def _gen_store(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    start = np.datetime64("1997-03-13", "D") - EPOCH
    return {
        "s_store_sk": k,
        "s_store_id": _numbered("AAAAAAAA", (k + 1) // 2, 8),  # SCD pairs share id
        "s_rec_start_date": np.full(n, int(start / np.timedelta64(1, "D")), np.int32),
        "s_rec_end_date": np.full(n, int(start / np.timedelta64(1, "D")) + 3650,
                                  np.int32),
        "s_closed_date_sk": np.zeros(n, np.int64),
        "s_store_name": _pick("store", "name", row0, n,
                              ["ought", "able", "pri", "ese", "anti", "cally",
                               "ation", "eing", "bar"]),
        "s_number_employees": _u("store", "emp", row0, n, 200, 300, np.int32),
        "s_floor_space": _u("store", "floor", row0, n, 5_000_000, 10_000_000,
                            np.int32),
        "s_hours": _pick("store", "hours", row0, n, ["8AM-8AM", "8AM-4PM", "8AM-12AM"]),
        "s_manager": _pick("store", "mgr", row0, n, FIRST_NAMES),
        "s_market_id": _u("store", "mktid", row0, n, 1, 10, np.int32),
        "s_geography_class": np.full(n, "Unknown", dtype=object),
        "s_market_desc": _numbered("market number ", k % 10 + 1, 2),
        "s_market_manager": _pick("store", "mktmgr", row0, n, FIRST_NAMES),
        "s_division_id": np.ones(n, np.int32),
        "s_division_name": np.full(n, "Unknown", dtype=object),
        "s_company_id": np.ones(n, np.int32),
        "s_company_name": np.full(n, "Unknown", dtype=object),
        "s_street_number": _u("store", "stno", row0, n, 1, 999).astype(str).astype(object),
        "s_street_name": _pick("store", "stname", row0, n, STREET_NAMES),
        "s_street_type": _pick("store", "sttype", row0, n, STREET_TYPES),
        "s_suite_number": _numbered("Suite ", _u("store", "suite", row0, n, 0, 99), 2),
        "s_city": _pick("store", "city", row0, n, CITIES[:6]),
        "s_county": _pick("store", "county", row0, n, ["Williamson County"]),
        "s_state": _pick("store", "state", row0, n, STATES[:9]),
        "s_zip": np.char.zfill(_u("store", "zip", row0, n, 601, 99950).astype(str),
                               5).astype(object),
        "s_country": np.full(n, "United States", dtype=object),
        "s_gmt_offset": _u("store", "gmt", row0, n, -10, -5).astype(np.float64),
        "s_tax_precentage": _round(_u("store", "tax", row0, n, 0, 11) / 100.0, 2),
    }


def _gen_reason(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    return {
        "r_reason_sk": k,
        "r_reason_id": _numbered("AAAAAAAA", k, 8),
        "r_reason_desc": np.asarray(REASONS, object)[(k - 1) % len(REASONS)],
    }


def _gen_ship_mode(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    return {
        "sm_ship_mode_sk": k,
        "sm_ship_mode_id": _numbered("AAAAAAAA", k, 8),
        "sm_type": np.asarray(SHIP_TYPES, object)[(k - 1) % len(SHIP_TYPES)],
        "sm_code": np.asarray(SHIP_CODES, object)[(k - 1) % len(SHIP_CODES)],
        "sm_carrier": np.asarray(CARRIERS, object)[(k - 1) % len(CARRIERS)],
        "sm_contract": _numbered("contract", k, 6),
    }


def _gen_warehouse(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    return {
        "w_warehouse_sk": k,
        "w_warehouse_id": _numbered("AAAAAAAA", k, 8),
        "w_warehouse_name": _pick("warehouse", "name", row0, n,
                                  ["Conventional childr", "Important issues liv",
                                   "Doors canno", "Bad cards must make.",
                                   "Rooms cook "]),
        "w_warehouse_sq_ft": _u("warehouse", "sqft", row0, n, 50_000, 1_000_000,
                                np.int32),
        "w_street_number": _u("warehouse", "stno", row0, n, 1, 999)
            .astype(str).astype(object),
        "w_street_name": _pick("warehouse", "stname", row0, n, STREET_NAMES),
        "w_street_type": _pick("warehouse", "sttype", row0, n, STREET_TYPES),
        "w_suite_number": _numbered("Suite ", _u("warehouse", "suite", row0, n, 0, 99), 2),
        "w_city": _pick("warehouse", "city", row0, n, CITIES[:6]),
        "w_county": _pick("warehouse", "county", row0, n, ["Williamson County"]),
        "w_state": _pick("warehouse", "state", row0, n, STATES[:9]),
        "w_zip": np.char.zfill(_u("warehouse", "zip", row0, n, 601, 99950)
                               .astype(str), 5).astype(object),
        "w_country": np.full(n, "United States", dtype=object),
        "w_gmt_offset": _u("warehouse", "gmt", row0, n, -10, -5).astype(np.float64),
    }


# ---------------------------------------------------------------------------
# fact generators — store & catalog channels
# ---------------------------------------------------------------------------


def _store_sales_cols(sf, rows):
    """store_sales columns for explicit row indices (shared by the sales
    generator and the returns generator reading parent rows)."""
    t = "store_sales"
    n_item = row_count("item", sf)
    n_cust = row_count("customer", sf)
    n_cd = row_count("customer_demographics", sf)
    n_hd = _FIXED_ROWS["household_demographics"]
    n_addr = row_count("customer_address", sf)
    n_store = row_count("store", sf)
    n_promo = row_count("promotion", sf)
    ticket = np.asarray(rows, np.int64) // ITEMS_PER_TICKET + 1
    # per-ticket attributes: drawn from the ticket counter, not the row
    cust = _u_at(t, "cust", ticket, 1, n_cust)
    hdemo = _u_at(t, "hdemo", ticket, 1, n_hd)
    addr = _u_at(t, "addr", ticket, 1, n_addr)
    store = _u_at(t, "store", ticket, 1, n_store)
    sold_date = _u_at(t, "date", ticket, SALES_DATE_LO, SALES_DATE_HI)
    # per-row attributes
    item = _u_at(t, "item", rows, 1, n_item)
    cdemo = _u_at(t, "cdemo", rows, 1, n_cd)
    promo = _u_at(t, "promo", rows, 1, n_promo)
    qty = _u_at(t, "qty", rows, 1, 100, np.int32)
    wholesale = _money_at(t, "wholesale", rows, 100, 10_000)
    markup = _raw_at(t, "markup", rows)[:, 0] * 1.0  # 0..100% markup
    discount = _raw_at(t, "discount", rows)[:, 0]    # 0..100% discount
    list_price = _round(wholesale * (1.0 + markup), 2)
    sales_price = _round(list_price * (1.0 - discount), 2)
    qf = qty.astype(np.float64)
    ext_list = _round(list_price * qf, 2)
    ext_sales = _round(sales_price * qf, 2)
    ext_wholesale = _round(wholesale * qf, 2)
    ext_discount = _round(ext_list - ext_sales, 2)
    coupon = _round(ext_sales * (_raw_at(t, "coupon", rows)[:, 0] < 0.2)
                      * _raw_at(t, "coupamt", rows)[:, 0] * 0.5, 2)
    net_paid = _round(ext_sales - coupon, 2)
    tax = _round(net_paid * 0.08, 2)
    return {
        "ss_sold_date_sk": sold_date,
        "ss_sold_time_sk": _u_at(t, "time", rows, 28800, 75600),
        "ss_item_sk": item,
        "ss_customer_sk": cust,
        "ss_cdemo_sk": cdemo,
        "ss_hdemo_sk": hdemo,
        "ss_addr_sk": addr,
        "ss_store_sk": store,
        "ss_promo_sk": promo,
        "ss_ticket_number": ticket,
        "ss_quantity": qty,
        "ss_wholesale_cost": wholesale,
        "ss_list_price": list_price,
        "ss_sales_price": sales_price,
        "ss_ext_discount_amt": ext_discount,
        "ss_ext_sales_price": ext_sales,
        "ss_ext_wholesale_cost": ext_wholesale,
        "ss_ext_list_price": ext_list,
        "ss_ext_tax": tax,
        "ss_coupon_amt": coupon,
        "ss_net_paid": net_paid,
        "ss_net_paid_inc_tax": _round(net_paid + tax, 2),
        "ss_net_profit": _round(net_paid - ext_wholesale, 2),
    }


def _gen_store_sales(sf, row0, row1):
    return _store_sales_cols(sf, np.arange(row0, row1, dtype=np.int64))


def _gen_store_returns(sf, row0, row1):
    t = "store_returns"
    j = np.arange(row0, row1, dtype=np.int64)
    parent = j * RETURN_EVERY
    ss = _store_sales_cols(sf, parent)
    ret_qty = np.minimum(
        _u_at(t, "qty", j, 1, 100, np.int32), ss["ss_quantity"])
    amt = _round(ss["ss_sales_price"] * ret_qty, 2)
    tax = _round(amt * 0.08, 2)
    fee = _money_at(t, "fee", j, 50, 10_000)
    ship = _money_at(t, "ship", j, 0, 10_000)
    frac = _raw_at(t, "cashfrac", j)[:, 0]
    cash = _round(amt * frac, 2)
    charge = _round((amt - cash) * _raw_at(t, "chargefrac", j)[:, 0], 2)
    credit = _round(amt - cash - charge, 2)
    return {
        "sr_returned_date_sk": ss["ss_sold_date_sk"]
            + _u_at(t, "lag", j, 1, 60),
        "sr_return_time_sk": _u_at(t, "time", j, 28800, 75600),
        "sr_item_sk": ss["ss_item_sk"],
        "sr_customer_sk": ss["ss_customer_sk"],
        "sr_cdemo_sk": ss["ss_cdemo_sk"],
        "sr_hdemo_sk": ss["ss_hdemo_sk"],
        "sr_addr_sk": ss["ss_addr_sk"],
        "sr_store_sk": ss["ss_store_sk"],
        "sr_reason_sk": _u_at(t, "reason", j, 1, _FIXED_ROWS["reason"]),
        "sr_ticket_number": ss["ss_ticket_number"],
        "sr_return_quantity": ret_qty,
        "sr_return_amt": amt,
        "sr_return_tax": tax,
        "sr_return_amt_inc_tax": _round(amt + tax, 2),
        "sr_fee": fee,
        "sr_return_ship_cost": ship,
        "sr_refunded_cash": cash,
        "sr_reversed_charge": charge,
        "sr_store_credit": credit,
        "sr_net_loss": _round(fee + ship + tax, 2),
    }


def _catalog_sales_cols(sf, rows):
    t = "catalog_sales"
    n_item = row_count("item", sf)
    n_cust = row_count("customer", sf)
    n_cd = row_count("customer_demographics", sf)
    n_hd = _FIXED_ROWS["household_demographics"]
    n_addr = row_count("customer_address", sf)
    n_promo = row_count("promotion", sf)
    n_wh = row_count("warehouse", sf)
    order = np.asarray(rows, np.int64) // ITEMS_PER_ORDER + 1
    bill_cust = _u_at(t, "bcust", order, 1, n_cust)
    ship_cust = _u_at(t, "scust", order, 1, n_cust)
    sold_date = _u_at(t, "date", order, SALES_DATE_LO, SALES_DATE_HI)
    item = _u_at(t, "item", rows, 1, n_item)
    m = _sales_money_cols(t, sf, rows)
    out = {
        "cs_sold_date_sk": sold_date,
        "cs_sold_time_sk": _u_at(t, "time", rows, 28800, 75600),
        "cs_ship_date_sk": sold_date + _u_at(t, "shiplag", rows, 2, 90),
        "cs_bill_customer_sk": bill_cust,
        "cs_bill_cdemo_sk": _u_at(t, "bcdemo", rows, 1, n_cd),
        "cs_bill_hdemo_sk": _u_at(t, "bhdemo", order, 1, n_hd),
        "cs_bill_addr_sk": _u_at(t, "baddr", order, 1, n_addr),
        "cs_ship_customer_sk": ship_cust,
        "cs_ship_cdemo_sk": _u_at(t, "scdemo", rows, 1, n_cd),
        "cs_ship_hdemo_sk": _u_at(t, "shdemo", order, 1, n_hd),
        "cs_ship_addr_sk": _u_at(t, "saddr", order, 1, n_addr),
        "cs_call_center_sk": _u_at(t, "cc", rows, 1, 6),
        "cs_catalog_page_sk": _u_at(t, "cp", rows, 1, 11_718),
        "cs_ship_mode_sk": _u_at(t, "sm", rows, 1, _FIXED_ROWS["ship_mode"]),
        "cs_warehouse_sk": _u_at(t, "wh", rows, 1, n_wh),
        "cs_item_sk": item,
        "cs_promo_sk": _u_at(t, "promo", rows, 1, n_promo),
        "cs_order_number": order,
    }
    for k, v in m.items():
        out["cs_" + k] = v
    return out


def _gen_catalog_sales(sf, row0, row1):
    return _catalog_sales_cols(sf, np.arange(row0, row1, dtype=np.int64))


def _gen_catalog_returns(sf, row0, row1):
    t = "catalog_returns"
    j = np.arange(row0, row1, dtype=np.int64)
    parent = j * RETURN_EVERY
    cs = _catalog_sales_cols(sf, parent)
    r = _returns_money_cols(t, j, cs["cs_sales_price"], cs["cs_quantity"])
    return {
        "cr_returned_date_sk": cs["cs_sold_date_sk"] + _u_at(t, "lag", j, 1, 60),
        "cr_returned_time_sk": _u_at(t, "time", j, 28800, 75600),
        "cr_item_sk": cs["cs_item_sk"],
        "cr_refunded_customer_sk": cs["cs_bill_customer_sk"],
        "cr_refunded_cdemo_sk": cs["cs_bill_cdemo_sk"],
        "cr_refunded_hdemo_sk": cs["cs_bill_hdemo_sk"],
        "cr_refunded_addr_sk": cs["cs_bill_addr_sk"],
        "cr_returning_customer_sk": cs["cs_ship_customer_sk"],
        "cr_returning_cdemo_sk": cs["cs_ship_cdemo_sk"],
        "cr_returning_hdemo_sk": cs["cs_ship_hdemo_sk"],
        "cr_returning_addr_sk": cs["cs_ship_addr_sk"],
        "cr_call_center_sk": cs["cs_call_center_sk"],
        "cr_catalog_page_sk": cs["cs_catalog_page_sk"],
        "cr_ship_mode_sk": cs["cs_ship_mode_sk"],
        "cr_warehouse_sk": cs["cs_warehouse_sk"],
        "cr_reason_sk": _u_at(t, "reason", j, 1, _FIXED_ROWS["reason"]),
        "cr_order_number": cs["cs_order_number"],
        "cr_return_quantity": r["return_quantity"],
        "cr_return_amount": r["return_amt"],
        "cr_return_tax": r["return_tax"],
        "cr_return_amt_inc_tax": r["return_amt_inc_tax"],
        "cr_fee": r["fee"],
        "cr_return_ship_cost": r["return_ship_cost"],
        "cr_refunded_cash": r["refunded_cash"],
        "cr_reversed_charge": r["reversed_charge"],
        "cr_store_credit": r["credit"],
        "cr_net_loss": r["net_loss"],
    }


# ---------------------------------------------------------------------------
# web channel + inventory + small dims (reference: presto-tpcds covers the
# full 24-table schema; these complete the web_sales/web_returns channel,
# weekly inventory snapshots, and the remaining dimensions)
# ---------------------------------------------------------------------------


def _sales_money_cols(t, sf, rows):
    """Channel-shared pricing math (quantity, wholesale/list/sales price,
    ext_* amounts, coupon, shipping, tax, net paid/profit) keyed by the
    channel's table name so draws stay independent per channel."""
    qty = _u_at(t, "qty", rows, 1, 100, np.int32)
    wholesale = _money_at(t, "wholesale", rows, 100, 10_000)
    markup = _raw_at(t, "markup", rows)[:, 0]
    discount = _raw_at(t, "discount", rows)[:, 0]
    list_price = _round(wholesale * (1.0 + markup), 2)
    sales_price = _round(list_price * (1.0 - discount), 2)
    qf = qty.astype(np.float64)
    ext_list = _round(list_price * qf, 2)
    ext_sales = _round(sales_price * qf, 2)
    ext_wholesale = _round(wholesale * qf, 2)
    coupon = _round(ext_sales * (_raw_at(t, "coupon", rows)[:, 0] < 0.2)
                      * _raw_at(t, "coupamt", rows)[:, 0] * 0.5, 2)
    ship_cost = _money_at(t, "shipc", rows, 0, 5_000) * qf
    net_paid = _round(ext_sales - coupon, 2)
    tax = _round(net_paid * 0.08, 2)
    return {
        "quantity": qty, "wholesale_cost": wholesale,
        "list_price": list_price, "sales_price": sales_price,
        "ext_discount_amt": _round(ext_list - ext_sales, 2),
        "ext_sales_price": ext_sales, "ext_wholesale_cost": ext_wholesale,
        "ext_list_price": ext_list, "ext_tax": tax, "coupon_amt": coupon,
        "ext_ship_cost": _round(ship_cost, 2), "net_paid": net_paid,
        "net_paid_inc_tax": _round(net_paid + tax, 2),
        "net_paid_inc_ship": _round(net_paid + ship_cost, 2),
        "net_paid_inc_ship_tax": _round(net_paid + ship_cost + tax, 2),
        "net_profit": _round(net_paid - ext_wholesale, 2),
    }


def _returns_money_cols(t, rows_j, sales_price, sale_qty):
    """Channel-shared returns math (returned quantity, amounts, fee,
    shipping, cash/charge/credit split)."""
    ret_qty = np.minimum(_u_at(t, "qty", rows_j, 1, 100, np.int32), sale_qty)
    amt = _round(sales_price * ret_qty, 2)
    tax = _round(amt * 0.08, 2)
    fee = _money_at(t, "fee", rows_j, 50, 10_000)
    ship = _money_at(t, "ship", rows_j, 0, 10_000)
    frac = _raw_at(t, "cashfrac", rows_j)[:, 0]
    cash = _round(amt * frac, 2)
    charge = _round((amt - cash) * _raw_at(t, "chargefrac", rows_j)[:, 0], 2)
    credit = _round(amt - cash - charge, 2)
    return {
        "return_quantity": ret_qty, "return_amt": amt, "return_tax": tax,
        "return_amt_inc_tax": _round(amt + tax, 2), "fee": fee,
        "return_ship_cost": ship, "refunded_cash": cash,
        "reversed_charge": charge, "credit": credit,
        "net_loss": _round(fee + ship + tax, 2),
    }


def _web_sales_cols(sf, rows):
    t = "web_sales"
    n_item = row_count("item", sf)
    n_cust = row_count("customer", sf)
    n_cd = row_count("customer_demographics", sf)
    n_hd = _FIXED_ROWS["household_demographics"]
    n_addr = row_count("customer_address", sf)
    n_promo = row_count("promotion", sf)
    n_wh = row_count("warehouse", sf)
    order = np.asarray(rows, np.int64) // ITEMS_PER_ORDER + 1
    bill_cust = _u_at(t, "bcust", order, 1, n_cust)
    ship_cust = _u_at(t, "scust", order, 1, n_cust)
    sold_date = _u_at(t, "date", order, SALES_DATE_LO, SALES_DATE_HI)
    item = _u_at(t, "item", rows, 1, n_item)
    m = _sales_money_cols(t, sf, rows)
    out = {
        "ws_sold_date_sk": sold_date,
        "ws_sold_time_sk": _u_at(t, "time", rows, 28800, 75600),
        "ws_ship_date_sk": sold_date + _u_at(t, "shiplag", rows, 2, 90),
        "ws_item_sk": item,
        "ws_bill_customer_sk": bill_cust,
        "ws_bill_cdemo_sk": _u_at(t, "bcdemo", rows, 1, n_cd),
        "ws_bill_hdemo_sk": _u_at(t, "bhdemo", order, 1, n_hd),
        "ws_bill_addr_sk": _u_at(t, "baddr", order, 1, n_addr),
        "ws_ship_customer_sk": ship_cust,
        "ws_ship_cdemo_sk": _u_at(t, "scdemo", rows, 1, n_cd),
        "ws_ship_hdemo_sk": _u_at(t, "shdemo", order, 1, n_hd),
        "ws_ship_addr_sk": _u_at(t, "saddr", order, 1, n_addr),
        "ws_web_page_sk": _u_at(t, "wp", rows, 1, row_count("web_page", sf)),
        "ws_web_site_sk": _u_at(t, "wsite", order, 1,
                                row_count("web_site", sf)),
        "ws_ship_mode_sk": _u_at(t, "sm", rows, 1, _FIXED_ROWS["ship_mode"]),
        "ws_warehouse_sk": _u_at(t, "wh", rows, 1, n_wh),
        "ws_promo_sk": _u_at(t, "promo", rows, 1, n_promo),
        "ws_order_number": order,
    }
    for k, v in m.items():
        out["ws_" + k] = v
    return out


def _gen_web_sales(sf, row0, row1):
    return _web_sales_cols(sf, np.arange(row0, row1, dtype=np.int64))


def _gen_web_returns(sf, row0, row1):
    t = "web_returns"
    j = np.arange(row0, row1, dtype=np.int64)
    parent = j * RETURN_EVERY
    ws = _web_sales_cols(sf, parent)
    r = _returns_money_cols(t, j, ws["ws_sales_price"], ws["ws_quantity"])
    return {
        "wr_returned_date_sk": ws["ws_sold_date_sk"] + _u_at(t, "lag", j, 1, 60),
        "wr_returned_time_sk": _u_at(t, "time", j, 28800, 75600),
        "wr_item_sk": ws["ws_item_sk"],
        "wr_refunded_customer_sk": ws["ws_bill_customer_sk"],
        "wr_refunded_cdemo_sk": ws["ws_bill_cdemo_sk"],
        "wr_refunded_hdemo_sk": ws["ws_bill_hdemo_sk"],
        "wr_refunded_addr_sk": ws["ws_bill_addr_sk"],
        "wr_returning_customer_sk": ws["ws_ship_customer_sk"],
        "wr_returning_cdemo_sk": ws["ws_ship_cdemo_sk"],
        "wr_returning_hdemo_sk": ws["ws_ship_hdemo_sk"],
        "wr_returning_addr_sk": ws["ws_ship_addr_sk"],
        "wr_web_page_sk": ws["ws_web_page_sk"],
        "wr_reason_sk": _u_at(t, "reason", j, 1, _FIXED_ROWS["reason"]),
        "wr_order_number": ws["ws_order_number"],
        "wr_return_quantity": r["return_quantity"],
        "wr_return_amt": r["return_amt"],
        "wr_return_tax": r["return_tax"],
        "wr_return_amt_inc_tax": r["return_amt_inc_tax"],
        "wr_fee": r["fee"],
        "wr_return_ship_cost": r["return_ship_cost"],
        "wr_refunded_cash": r["refunded_cash"],
        "wr_reversed_charge": r["reversed_charge"],
        "wr_account_credit": r["credit"],
        "wr_net_loss": r["net_loss"],
    }


def _gen_web_site(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    t = "web_site"
    return {
        "web_site_sk": k,
        "web_site_id": _numbered("AAAAAAAA", k, 8),
        "web_name": np.char.add("site_", ((k - 1) // 6).astype(str)
                                ).astype(object),
        "web_manager": _pick(t, "mgr", row0, n, FIRST_NAMES[:20]),
        "web_market_manager": _pick(t, "mmgr", row0, n, FIRST_NAMES[20:40]),
        "web_company_id": _u(t, "coid", row0, n, 1, 6, np.int32),
        "web_company_name": _pick(t, "coname", row0, n,
                                  ["pri", "able", "ought", "bar", "cally",
                                   "ation"]),
        "web_street_name": _pick(t, "stname", row0, n, STREET_NAMES),
        "web_street_type": _pick(t, "sttype", row0, n, STREET_TYPES),
        "web_city": _pick(t, "city", row0, n, CITIES[:6]),
        "web_county": _pick(t, "county", row0, n, ["Williamson County"]),
        "web_state": _pick(t, "state", row0, n, STATES[:9]),
        "web_zip": np.char.zfill(_u(t, "zip", row0, n, 601, 99950)
                                 .astype(str), 5).astype(object),
        "web_country": np.full(n, "United States", dtype=object),
        "web_gmt_offset": _u(t, "gmt", row0, n, -10, -5).astype(np.float64),
        "web_tax_percentage": _u(t, "taxp", row0, n, 0, 12) / 100.0,
    }


def _gen_web_page(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    t = "web_page"
    return {
        "wp_web_page_sk": k,
        "wp_web_page_id": _numbered("AAAAAAAA", k, 8),
        "wp_creation_date_sk": _u(t, "cdate", row0, n,
                                  SALES_DATE_LO - 1000, SALES_DATE_LO),
        "wp_access_date_sk": _u(t, "adate", row0, n,
                                SALES_DATE_LO, SALES_DATE_HI),
        "wp_autogen_flag": _pick(t, "auto", row0, n, ["Y", "N"]),
        "wp_url": np.full(n, "http://www.foo.com", dtype=object),
        "wp_type": _pick(t, "type", row0, n,
                         ["welcome", "protected", "dynamic", "feedback",
                          "general", "ad", "order"]),
        "wp_char_count": _u(t, "chars", row0, n, 100, 8000, np.int32),
        "wp_link_count": _u(t, "links", row0, n, 2, 25, np.int32),
        "wp_image_count": _u(t, "imgs", row0, n, 1, 7, np.int32),
        "wp_max_ad_count": _u(t, "ads", row0, n, 0, 4, np.int32),
    }


def _gen_call_center(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    t = "call_center"
    return {
        "cc_call_center_sk": k,
        "cc_call_center_id": _numbered("AAAAAAAA", k, 8),
        "cc_name": np.char.add("call center ", k.astype(str)).astype(object),
        "cc_class": _pick(t, "class", row0, n, ["small", "medium", "large"]),
        "cc_employees": _u(t, "emp", row0, n, 10, 7000, np.int32),
        "cc_sq_ft": _u(t, "sqft", row0, n, 5000, 50000, np.int32),
        "cc_hours": _pick(t, "hours", row0, n,
                          ["8AM-4PM", "8AM-12AM", "8AM-8AM"]),
        "cc_manager": _pick(t, "mgr", row0, n, FIRST_NAMES[:20]),
        "cc_mkt_id": _u(t, "mkt", row0, n, 1, 6, np.int32),
        "cc_mkt_class": _pick(t, "mktclass", row0, n,
                              ["A bit narrow forms matter animals. Consist",
                               "Largely blank forms m", "Sales expect "]),
        "cc_market_manager": _pick(t, "mmgr", row0, n, FIRST_NAMES[20:40]),
        "cc_county": _pick(t, "county", row0, n, ["Williamson County"]),
        "cc_state": _pick(t, "state", row0, n, STATES[:9]),
        "cc_country": np.full(n, "United States", dtype=object),
        "cc_gmt_offset": _u(t, "gmt", row0, n, -10, -5).astype(np.float64),
        "cc_tax_percentage": _u(t, "taxp", row0, n, 0, 12) / 100.0,
    }


def _gen_catalog_page(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64) + 1
    n = len(k)
    t = "catalog_page"
    return {
        "cp_catalog_page_sk": k,
        "cp_catalog_page_id": _numbered("AAAAAAAA", k, 8),
        "cp_start_date_sk": _u(t, "sdate", row0, n,
                               SALES_DATE_LO - 30, SALES_DATE_LO + 330),
        "cp_end_date_sk": _u(t, "edate", row0, n,
                             SALES_DATE_LO + 360, SALES_DATE_HI),
        "cp_department": np.full(n, "DEPARTMENT", dtype=object),
        "cp_catalog_number": ((k - 1) // 108 + 1).astype(np.int32),
        "cp_catalog_page_number": ((k - 1) % 108 + 1).astype(np.int32),
        "cp_description": _pick(t, "desc", row0, n,
                                ["Early important ways", "Flat, united",
                                 "Young, valid", "Also southern cars"]),
        "cp_type": _pick(t, "type", row0, n,
                         ["bi-annual", "quarterly", "monthly"]),
    }


def _gen_time_dim(sf, row0, row1):
    sec = np.arange(row0, row1, dtype=np.int64)
    h = sec // 3600
    mi = (sec // 60) % 60
    s = sec % 60
    shift = np.where(h < 8, "third", np.where(h < 16, "first", "second"))
    sub = np.where(h % 8 < 3, "morning",
                   np.where(h % 8 < 6, "afternoon", "evening"))
    meal = np.where((h >= 6) & (h <= 8), "breakfast",
                    np.where((h >= 11) & (h <= 13), "lunch",
                             np.where((h >= 17) & (h <= 19), "dinner", "")))
    return {
        "t_time_sk": sec,
        "t_time_id": _numbered("AAAAAAAA", sec + 1, 8),
        "t_time": sec.astype(np.int32),
        "t_hour": h.astype(np.int32),
        "t_minute": mi.astype(np.int32),
        "t_second": s.astype(np.int32),
        "t_am_pm": np.where(h < 12, "AM", "PM").astype(object),
        "t_shift": shift.astype(object),
        "t_sub_shift": sub.astype(object),
        "t_meal_time": meal.astype(object),
    }


INV_WEEKS = 261  # weekly snapshots over the 5-year sales window


def _inv_items(sf: float) -> int:
    """Items covered by inventory snapshots: capped at 45k (official
    inventory grows sub-linearly: 11.7M/133M/399M at SF1/10/100)."""
    return min(row_count("item", sf), 45_000)


def _gen_inventory(sf, row0, row1):
    """Row r = (week w, item i, warehouse h) in row-major (w, i, h) order;
    inv date = first sales date + 7*w."""
    n_item = _inv_items(sf)
    n_wh = row_count("warehouse", sf)
    r = np.arange(row0, row1, dtype=np.int64)
    per_week = n_item * n_wh
    w = r // per_week
    i = (r % per_week) // n_wh
    h = r % n_wh
    return {
        "inv_date_sk": SALES_DATE_LO + 7 * w,
        "inv_item_sk": i + 1,
        "inv_warehouse_sk": h + 1,
        "inv_quantity_on_hand": _u_at("inventory", "qty", r, 0, 1000,
                                      np.int32),
    }


_GENERATORS = {
    "date_dim": _gen_date_dim,
    "item": _gen_item,
    "customer": _gen_customer,
    "customer_address": _gen_customer_address,
    "customer_demographics": _gen_customer_demographics,
    "household_demographics": _gen_household_demographics,
    "income_band": _gen_income_band,
    "promotion": _gen_promotion,
    "store": _gen_store,
    "reason": _gen_reason,
    "ship_mode": _gen_ship_mode,
    "warehouse": _gen_warehouse,
    "store_sales": _gen_store_sales,
    "store_returns": _gen_store_returns,
    "catalog_sales": _gen_catalog_sales,
    "catalog_returns": _gen_catalog_returns,
    "web_sales": _gen_web_sales,
    "web_returns": _gen_web_returns,
    "web_site": _gen_web_site,
    "web_page": _gen_web_page,
    "call_center": _gen_call_center,
    "catalog_page": _gen_catalog_page,
    "time_dim": _gen_time_dim,
    "inventory": _gen_inventory,
}


# ---------------------------------------------------------------------------
# statistics (arithmetic, no scanning) — reference: presto-tpcds
# TpcdsMetadata.getTableStatistics; derivable from the generator
# formulas.  Feeds the CBO (plan/stats.py) AND the static-shape bounds
# of compiled/chunked execution (join fanout, agg capacities).
# ---------------------------------------------------------------------------

PRIMARY_KEYS = {
    "date_dim": "d_date_sk", "item": "i_item_sk",
    "customer": "c_customer_sk", "customer_address": "ca_address_sk",
    "customer_demographics": "cd_demo_sk",
    "household_demographics": "hd_demo_sk",
    "income_band": "ib_income_band_sk", "promotion": "p_promo_sk",
    "store": "s_store_sk", "reason": "r_reason_sk",
    "ship_mode": "sm_ship_mode_sk", "warehouse": "w_warehouse_sk",
    "web_site": "web_site_sk", "web_page": "wp_web_page_sk",
    "call_center": "cc_call_center_sk",
    "catalog_page": "cp_catalog_page_sk", "time_dim": "t_time_sk",
}

# returns are unique on the ticket/order alone: parent sales rows are
# every RETURN_EVERY-th row and RETURN_EVERY (10) exceeds the rows per
# ticket (3) / order (4), so no two returns share a parent unit
UNIQUE_KEYS = {
    **{t: [(k,)] for t, k in PRIMARY_KEYS.items()},
    "store_returns": [("sr_ticket_number",),
                      ("sr_item_sk", "sr_ticket_number")],
    "catalog_returns": [("cr_order_number",),
                        ("cr_item_sk", "cr_order_number")],
    "web_returns": [("wr_order_number",),
                    ("wr_item_sk", "wr_order_number")],
    "inventory": [("inv_date_sk", "inv_item_sk", "inv_warehouse_sk")],
}

# physical row ordering the generator emits (ordering-properties SPI,
# plan/properties.py): dimensions in surrogate-key order; sales in
# ticket/order-number order (unit = row // items-per-unit + 1); returns
# inherit their parent sale's unit, sampled every RETURN_EVERY rows in
# row order.  Validated against generated data in
# tests/test_ordering_properties.py; consumed behind monotonicity
# guards.
ORDERINGS = {
    **{t: [(k, True)] for t, k in PRIMARY_KEYS.items()},
    "store_sales": [("ss_ticket_number", True)],
    "store_returns": [("sr_ticket_number", True)],
    "catalog_sales": [("cs_order_number", True)],
    "catalog_returns": [("cr_order_number", True)],
    "web_sales": [("ws_order_number", True)],
    "web_returns": [("wr_order_number", True)],
    "inventory": [("inv_date_sk", True), ("inv_item_sk", True)],
}

# max rows sharing one value of the key set (join fanout upper bounds)
MAX_ROWS_PER_KEY = {
    "store_sales": {("ss_ticket_number",): ITEMS_PER_TICKET,
                    ("ss_item_sk", "ss_ticket_number"): ITEMS_PER_TICKET},
    "catalog_sales": {("cs_order_number",): ITEMS_PER_ORDER,
                      ("cs_item_sk", "cs_order_number"): ITEMS_PER_ORDER},
    "web_sales": {("ws_order_number",): ITEMS_PER_ORDER,
                  ("ws_item_sk", "ws_order_number"): ITEMS_PER_ORDER},
}


def _fk_targets(sf: float):
    """FK column suffix -> (lo, hi) of the referenced key range."""
    return {
        "_date_sk": (JULIAN_OF_START, JULIAN_OF_START + DATE_DIM_ROWS - 1),
        "_time_sk": (0, 86_399),
        "_item_sk": (1, row_count("item", sf)),
        "_customer_sk": (1, row_count("customer", sf)),
        "_cdemo_sk": (1, row_count("customer_demographics", sf)),
        "_hdemo_sk": (1, _FIXED_ROWS["household_demographics"]),
        "_addr_sk": (1, row_count("customer_address", sf)),
        "_store_sk": (1, row_count("store", sf)),
        "_promo_sk": (1, row_count("promotion", sf)),
        "_warehouse_sk": (1, row_count("warehouse", sf)),
        "_call_center_sk": (1, 6),
        "_catalog_page_sk": (1, 11_718),
        "_ship_mode_sk": (1, _FIXED_ROWS["ship_mode"]),
        "_reason_sk": (1, _FIXED_ROWS["reason"]),
        "_income_band_sk": (1, _FIXED_ROWS["income_band"]),
        "_web_page_sk": (1, row_count("web_page", sf)),
        "_web_site_sk": (1, row_count("web_site", sf)),
    }


def column_stats(table: str, column: str, sf: float, ColStats):
    """(min, max, ndv) per column from the generator formulas — exact
    bounds, approximate ndv."""
    rows = row_count(table, sf)
    if column == "d_date_sk":
        return ColStats(min=float(JULIAN_OF_START),
                        max=float(JULIAN_OF_START + rows - 1), ndv=rows)
    if column == "t_time_sk":
        return ColStats(min=0.0, max=float(rows - 1), ndv=rows)
    if column == PRIMARY_KEYS.get(table):  # k = row + 1
        return ColStats(min=1.0, max=float(rows), ndv=rows)
    # fact-table unit numbers
    if column in ("ss_ticket_number",):
        n = row_count("store_sales", sf) // ITEMS_PER_TICKET + 1
        return ColStats(min=1.0, max=float(n), ndv=n)
    if column in ("cs_order_number", "cr_order_number"):
        n = row_count("catalog_sales", sf) // ITEMS_PER_ORDER + 1
        return ColStats(min=1.0, max=float(n), ndv=n)
    if column in ("ws_order_number", "wr_order_number"):
        n = row_count("web_sales", sf) // ITEMS_PER_ORDER + 1
        return ColStats(min=1.0, max=float(n), ndv=n)
    if column == "sr_ticket_number":
        n = row_count("store_sales", sf) // ITEMS_PER_TICKET + 1
        return ColStats(min=1.0, max=float(n), ndv=min(rows, n))
    # sold/returned/ship dates on fact tables: the 5-year sales window
    if column.endswith("sold_date_sk") or column.endswith(
            "returned_date_sk") or column.endswith("ship_date_sk"):
        # ship/returned lag up to 90/60 days past the sold window: the
        # +150 widening must cover ndv too (group capacities sized from
        # ndv must never undershoot)
        return ColStats(min=float(SALES_DATE_LO),
                        max=float(SALES_DATE_HI + 150),
                        ndv=SALES_DATE_HI + 150 - SALES_DATE_LO + 1)
    if column.endswith("sold_time_sk") or column.endswith(
            "return_time_sk") or column.endswith("returned_time_sk"):
        return ColStats(min=28800.0, max=75600.0, ndv=46801)
    # FK columns by suffix
    for suffix, (lo, hi) in _fk_targets(sf).items():
        if column.endswith(suffix):
            return ColStats(min=float(lo), max=float(hi),
                            ndv=min(rows, hi - lo + 1))
    # date_dim derived columns queries filter on constantly
    D = {
        "d_year": (1900, 2099, 200), "d_moy": (1, 12, 12),
        "d_dom": (1, 31, 31), "d_qoy": (1, 4, 4), "d_dow": (0, 6, 7),
        "d_month_seq": (0, 2399, 2400), "d_week_seq": (1, 10436, 10436),
        "d_quarter_seq": (0, 799, 800),
        "d_date": (-25567, 47481, DATE_DIM_ROWS),
        "i_manager_id": (1, 100, 100), "i_manufact_id": (1, 1000, 1000),
        "i_brand_id": (1_001_000,
                       len(CATEGORIES) * 1_000_000 + len(CLASSES) * 1000
                       + 999, len(CATEGORIES) * len(CLASSES) * 1000),
        "i_class_id": (1, len(CLASSES), len(CLASSES)),
        "i_category_id": (1, len(CATEGORIES), len(CATEGORIES)),
        "i_current_price": (0.09, 999.99, 99_991),
        "cd_purchase_estimate": (500, 10000, 20),
        "cd_dep_count": (0, 6, 7), "cd_dep_employed_count": (0, 6, 7),
        "cd_dep_college_count": (0, 6, 7),
        "hd_dep_count": (0, 9, 10), "hd_vehicle_count": (0, 5, 6),
        "ib_lower_bound": (0, 190001, 20),
        "ib_upper_bound": (10000, 200000, 20),
        "c_birth_day": (1, 28, 28), "c_birth_month": (1, 12, 12),
        "c_birth_year": (1924, 1992, 69),
        "ca_gmt_offset": (-10, -5, 6),
        "inv_quantity_on_hand": (0, 1000, 1001),
    }
    if column in D:
        lo, hi, ndv = D[column]
        return ColStats(min=float(lo), max=float(hi), ndv=ndv)
    # quantities / money on fact tables: exact generator ranges.
    # ext_* amounts are unit price x quantity (<=100), so their bounds
    # and ndvs are ~100x the unit-price rules — match the ext_ prefix
    # FIRST or group capacities sized from ndv undershoot by 100x
    if column.endswith("_quantity"):
        return ColStats(min=0.0 if "return" in column else 1.0,
                        max=100.0, ndv=101)
    if column == "i_wholesale_cost":  # price * 0.6, price <= 999.99
        return ColStats(min=0.05, max=600.0, ndv=60_000)
    if "_ext_" in column or column.endswith("_paid") \
            or "_paid_inc" in column or column.endswith("_profit") \
            or column.endswith("_coupon_amt"):
        # worst case list_price(200) x qty(100), plus ship (<=5000/unit
        # x qty via ext_ship_cost) and tax on the _inc_ variants; profit
        # can go negative.  Bounds here must never undershoot (they feed
        # range selectivity AND static range-narrowing)
        lo = -20_000.0 if "profit" in column or "discount" in column \
            else 0.0
        return ColStats(min=lo, max=27_000.0, ndv=2_000_000)
    if column.endswith("wholesale_cost"):
        return ColStats(min=1.0, max=100.0, ndv=9901)
    if column.endswith("list_price") and table != "item":
        return ColStats(min=1.0, max=200.0, ndv=19901)
    if column.endswith("sales_price") and table != "item":
        return ColStats(min=0.0, max=200.0, ndv=20001)
    typ = SCHEMAS[table].get(column)
    if typ is not None and typ.name == "VARCHAR":
        # string ndvs: enum picks are tiny, ids/names scale with rows
        return ColStats(ndv=min(rows, 100_000))
    return ColStats()


def generate(table: str, sf: float = 1.0, row0: int = 0,
             row1: int | None = None):
    n = row_count(table, sf)
    if row1 is None:
        row1 = n
    row1 = min(row1, n)
    return _GENERATORS[table](sf, row0, row1)


def split_ranges(table: str, sf: float, n_splits: int):
    n = row_count(table, sf)
    edges = np.linspace(0, n, n_splits + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if a < b]
