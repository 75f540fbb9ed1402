"""Where the native columnar scan of the templates' read spends its time.

The implicit templates' `find_columnar` (user → item views and buys of
one app, default channel) hands `native/pio_scan.cpp` one SQL query.
This prints sqlite's plan for that query and the seconds Python's
sqlite3 takes to fetch its rows by that plan, against a sequential scan
of the table (`NOT INDEXED`), on a pio.db opened read-only:

    python3 predictionio_torch/tools/scan_plan.py --db BASE/pio.db \\
        --app Shop

Prints one JSON object: the plan's lines, the row count and both
seconds.
"""

from __future__ import annotations

import argparse
import json
import sqlite3
import sys
import time

SQL = ("SELECT entity_id, target_entity_id, event, properties, event_time "
       "FROM events {}WHERE app_id=? AND channel_id IS NULL "
       "AND entity_type=? AND target_entity_type=? AND event IN (?,?)")


def scan_plan(db: str, app_name: str) -> dict:
    """The plan, the rows and the seconds of both fetches."""
    conn = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
    try:
        (app_id,), = conn.execute("SELECT id FROM apps WHERE name=?",
                                  (app_name,)).fetchall()
        params = (app_id, "user", "item", "view", "buy")
        plan = [row[3] for row in conn.execute(
            "EXPLAIN QUERY PLAN " + SQL.format(""), params)]
        seconds = {}
        for name, hint in (("planned", ""), ("table_scan", "NOT INDEXED ")):
            t0 = time.perf_counter()
            rows = sum(1 for _ in conn.execute(SQL.format(hint), params))
            seconds[f"rows_{name}_s"] = time.perf_counter() - t0
    finally:
        conn.close()
    return {"scan_plan": plan, "scan_rows": rows, **seconds}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--db", required=True, help="the pio.db to read")
    parser.add_argument("--app", required=True, help="the app's name")
    args = parser.parse_args(argv)
    print(json.dumps(scan_plan(args.db, args.app)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
