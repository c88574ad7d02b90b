"""SQL-backed SpanStore on stdlib sqlite3 (the anormdb-role backend).

The port's copy of ``zipkin_tpu/store/sql.py``: host-only, no tensor
anywhere, the same schema and SQL.

Reference role: zipkin-anormdb (AnormSpanStore.scala:28, DB.scala:88-146)
— the "runs anywhere, no cluster" durable backend next to the device
store. The schema is redesigned rather than transcribed: spans get a
surrogate row key so annotations join to the *stored span occurrence*
(the reference joins on (span_id, trace_id), which conflates re-applied
spans), and write-time policy columns (lowercased names, indexability)
make the read queries pure SQL.

Tables:
  spans(row, trace_id, span_id, parent_id, has_parent, name, name_lc,
        debug, indexable, ts_first, ts_last, duration)
  annotations(span_row, seq, ts, value, is_core, service_lc, ipv4, port,
              service_raw, has_host)
  binary_annotations(span_row, seq, key, value BLOB, value_is_text,
                     ann_type, service_lc, ipv4, port, service_raw,
                     has_host)
  ttls(trace_id, ttl)
  dependencies(id, start_ts, end_ts) + dependency_links(dep_id, parent,
  child, m0..m4) — the Moments wire form (zipkinDependencies.thrift).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from zipkin_tpu_torch.models.constants import CORE_ANNOTATIONS
from zipkin_tpu_torch.models.dependencies import (
    Dependencies,
    DependencyLink,
    Moments,
)
from zipkin_tpu_torch.models.span import (
    Annotation,
    AnnotationType,
    BinaryAnnotation,
    Endpoint,
    Span,
)
from zipkin_tpu_torch.store.base import (
    IndexedTraceId,
    SpanStore,
    TraceIdDuration,
    as_bytes,
    should_index,
)

_DDL = """
CREATE TABLE IF NOT EXISTS spans (
  row INTEGER PRIMARY KEY AUTOINCREMENT,
  trace_id INTEGER NOT NULL,
  span_id INTEGER NOT NULL,
  parent_id INTEGER,
  name TEXT NOT NULL,
  name_lc TEXT NOT NULL,
  debug INTEGER NOT NULL,
  indexable INTEGER NOT NULL,
  ts_first INTEGER,
  ts_last INTEGER,
  duration INTEGER
);
CREATE INDEX IF NOT EXISTS idx_spans_trace ON spans (trace_id);
CREATE TABLE IF NOT EXISTS annotations (
  span_row INTEGER NOT NULL,
  seq INTEGER NOT NULL,
  ts INTEGER NOT NULL,
  value TEXT NOT NULL,
  is_core INTEGER NOT NULL,
  has_host INTEGER NOT NULL,
  service_lc TEXT,
  service_raw TEXT,
  ipv4 INTEGER,
  port INTEGER
);
CREATE INDEX IF NOT EXISTS idx_ann_span ON annotations (span_row);
CREATE INDEX IF NOT EXISTS idx_ann_service ON annotations (service_lc);
CREATE TABLE IF NOT EXISTS binary_annotations (
  span_row INTEGER NOT NULL,
  seq INTEGER NOT NULL,
  key TEXT NOT NULL,
  value BLOB NOT NULL,
  value_is_text INTEGER NOT NULL,
  ann_type INTEGER NOT NULL,
  has_host INTEGER NOT NULL,
  service_lc TEXT,
  service_raw TEXT,
  ipv4 INTEGER,
  port INTEGER
);
CREATE INDEX IF NOT EXISTS idx_bann_span ON binary_annotations (span_row);
CREATE TABLE IF NOT EXISTS ttls (
  trace_id INTEGER PRIMARY KEY,
  ttl REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS dependencies (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  start_ts INTEGER NOT NULL,
  end_ts INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS dependency_links (
  dep_id INTEGER NOT NULL,
  parent TEXT NOT NULL,
  child TEXT NOT NULL,
  m0 REAL NOT NULL, m1 REAL NOT NULL, m2 REAL NOT NULL,
  m3 REAL NOT NULL, m4 REAL NOT NULL
);
"""


class SqliteSpanStore(SpanStore):
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)  # guarded-by: _lock
        self._lock = threading.Lock()  # lock-order: 10 encode
        with self._lock:
            self._conn.executescript(_DDL)
            self._conn.commit()
            # Monotonic admit counter for the flow estimator — COUNT(*)
            # would scan the whole table under the lock on every control
            # tick. Seeded from the table so reopened stores keep counting.
            row = self._conn.execute("SELECT COUNT(*) FROM spans").fetchone()
            self._stored = int(row[0])  # guarded-by: _lock

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def stored_span_count(self) -> float:
        with self._lock:
            return float(self._stored)

    # -- writes ---------------------------------------------------------

    def apply(self, spans: Sequence[Span]) -> None:
        with self._lock:
            cur = self._conn.cursor()
            for s in spans:
                cur.execute(
                    "INSERT OR REPLACE INTO ttls (trace_id, ttl) VALUES (?, "
                    "COALESCE((SELECT ttl FROM ttls WHERE trace_id = ?), 1.0))",
                    (s.trace_id, s.trace_id),
                )
                cur.execute(
                    "INSERT INTO spans (trace_id, span_id, parent_id, name,"
                    " name_lc, debug, indexable, ts_first, ts_last, duration)"
                    " VALUES (?,?,?,?,?,?,?,?,?,?)",
                    (
                        s.trace_id, s.id, s.parent_id, s.name, s.name.lower(),
                        int(s.debug), int(should_index(s)),
                        s.first_timestamp, s.last_timestamp, s.duration,
                    ),
                )
                row = cur.lastrowid
                for i, a in enumerate(s.annotations):
                    cur.execute(
                        "INSERT INTO annotations (span_row, seq, ts, value,"
                        " is_core, has_host, service_lc, service_raw, ipv4,"
                        " port) VALUES (?,?,?,?,?,?,?,?,?,?)",
                        (
                            row, i, a.timestamp, a.value,
                            int(a.value in CORE_ANNOTATIONS),
                            int(a.host is not None),
                            a.host.service_name.lower() if a.host else None,
                            a.host.service_name if a.host else None,
                            a.host.ipv4 if a.host else None,
                            a.host.port if a.host else None,
                        ),
                    )
                for i, b in enumerate(s.binary_annotations):
                    is_text = isinstance(b.value, str)
                    cur.execute(
                        "INSERT INTO binary_annotations (span_row, seq, key,"
                        " value, value_is_text, ann_type, has_host,"
                        " service_lc, service_raw, ipv4, port)"
                        " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                        (
                            row, i, b.key, as_bytes(b.value), int(is_text),
                            int(b.annotation_type),
                            int(b.host is not None),
                            b.host.service_name.lower() if b.host else None,
                            b.host.service_name if b.host else None,
                            b.host.ipv4 if b.host else None,
                            b.host.port if b.host else None,
                        ),
                    )
            self._conn.commit()
            # Count only after the batch committed — a failed apply()
            # must not inflate the adaptive controller's flow source.
            self._stored += len(spans)

    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO ttls (trace_id, ttl) VALUES (?, ?)",
                (trace_id, ttl_seconds),
            )
            self._conn.commit()

    def get_time_to_live(self, trace_id: int) -> float:
        with self._lock:
            row = self._conn.execute(
                "SELECT ttl FROM ttls WHERE trace_id = ?", (trace_id,)
            ).fetchone()
        if row is None:
            raise KeyError(trace_id)
        return row[0]

    # -- reads ----------------------------------------------------------

    def traces_exist(self, trace_ids: Sequence[int]) -> Set[int]:
        if not trace_ids:
            return set()
        marks = ",".join("?" * len(trace_ids))
        with self._lock:
            rows = self._conn.execute(
                f"SELECT DISTINCT trace_id FROM spans WHERE trace_id IN ({marks})",
                list(trace_ids),
            ).fetchall()
        return {r[0] for r in rows}

    def _spans_for_rows(self, rows: List[tuple]) -> List[Span]:
        if not rows:
            return []
        row_ids = [r[0] for r in rows]
        marks = ",".join("?" * len(row_ids))
        with self._lock:
            anns = self._conn.execute(
                f"SELECT span_row, ts, value, has_host, service_raw, ipv4,"
                f" port FROM annotations WHERE span_row IN ({marks})"
                f" ORDER BY span_row, seq",
                row_ids,
            ).fetchall()
            banns = self._conn.execute(
                f"SELECT span_row, key, value, value_is_text, ann_type,"
                f" has_host, service_raw, ipv4, port FROM binary_annotations"
                f" WHERE span_row IN ({marks}) ORDER BY span_row, seq",
                row_ids,
            ).fetchall()
        ann_by_row: Dict[int, List[Annotation]] = {}
        for sr, ts, value, has_host, svc, ipv4, port in anns:
            host = Endpoint(ipv4, port, svc) if has_host else None
            ann_by_row.setdefault(sr, []).append(Annotation(ts, value, host))
        bann_by_row: Dict[int, List[BinaryAnnotation]] = {}
        for sr, key, value, is_text, ann_type, has_host, svc, ipv4, port in banns:
            host = Endpoint(ipv4, port, svc) if has_host else None
            v = bytes(value).decode("utf-8") if is_text else bytes(value)
            bann_by_row.setdefault(sr, []).append(
                BinaryAnnotation(key, v, AnnotationType(ann_type), host)
            )
        out = []
        for row, trace_id, span_id, parent_id, name, debug in rows:
            out.append(Span(
                trace_id=trace_id, name=name, id=span_id,
                parent_id=parent_id,
                annotations=tuple(ann_by_row.get(row, ())),
                binary_annotations=tuple(bann_by_row.get(row, ())),
                debug=bool(debug),
            ))
        return out

    def get_spans_by_trace_ids(self, trace_ids: Sequence[int]) -> List[List[Span]]:
        out = []
        for tid in trace_ids:
            with self._lock:
                rows = self._conn.execute(
                    "SELECT row, trace_id, span_id, parent_id, name, debug"
                    " FROM spans WHERE trace_id = ? ORDER BY row",
                    (tid,),
                ).fetchall()
            spans = self._spans_for_rows(rows)
            if spans:
                out.append(spans)
        return out

    def get_trace_ids_by_name(
        self, service_name: str, span_name: Optional[str],
        end_ts: int, limit: int,
    ) -> List[IndexedTraceId]:
        # One row per TRACE (max ts_last), so a hot trace fills one limit
        # slot — same dedup-before-limit semantics as the other stores.
        q = (
            "SELECT s.trace_id, MAX(s.ts_last) AS mts FROM spans s"
            " JOIN annotations a ON a.span_row = s.row"
            " WHERE s.indexable = 1 AND a.service_lc = ?"
            " AND s.ts_last IS NOT NULL AND s.ts_last <= ?"
        )
        args: List = [service_name.lower(), end_ts]
        if span_name is not None:
            q += " AND s.name_lc = ?"
            args.append(span_name.lower())
        q += " GROUP BY s.trace_id ORDER BY mts DESC LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [IndexedTraceId(tid, ts) for tid, ts in rows]

    def get_trace_ids_by_annotation(
        self, service_name: str, annotation: str, value: Optional[bytes],
        end_ts: int, limit: int,
    ) -> List[IndexedTraceId]:
        if annotation in CORE_ANNOTATIONS:
            return []
        svc = service_name.lower()
        base = (
            " FROM spans s WHERE s.indexable = 1"
            " AND s.ts_last IS NOT NULL AND s.ts_last <= ?"
            " AND EXISTS (SELECT 1 FROM annotations sv"
            "   WHERE sv.span_row = s.row AND sv.service_lc = ?)"
        )
        if value is not None:
            match = (
                " AND EXISTS (SELECT 1 FROM binary_annotations b"
                "   WHERE b.span_row = s.row AND b.key = ? AND b.value = ?)"
            )
            args: List = [end_ts, svc, annotation, as_bytes(value)]
        else:
            match = (
                " AND (EXISTS (SELECT 1 FROM annotations a"
                "   WHERE a.span_row = s.row AND a.value = ?)"
                " OR EXISTS (SELECT 1 FROM binary_annotations b"
                "   WHERE b.span_row = s.row AND b.key = ?))"
            )
            args = [end_ts, svc, annotation, annotation]
        q = (
            "SELECT s.trace_id, MAX(s.ts_last) AS mts" + base + match
            + " GROUP BY s.trace_id ORDER BY mts DESC LIMIT ?"
        )
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [IndexedTraceId(tid, ts) for tid, ts in rows]

    def get_traces_duration(self, trace_ids: Sequence[int]
                            ) -> List[TraceIdDuration]:
        out = []
        for tid in trace_ids:
            with self._lock:
                row = self._conn.execute(
                    "SELECT MIN(ts_first), MAX(ts_last) FROM spans"
                    " WHERE trace_id = ? AND ts_first IS NOT NULL",
                    (tid,),
                ).fetchone()
            if row and row[0] is not None:
                out.append(TraceIdDuration(tid, row[1] - row[0], row[0]))
        return out

    def get_all_service_names(self) -> Set[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT service_lc FROM annotations"
                " WHERE service_lc IS NOT NULL AND service_lc != ''"
            ).fetchall()
        return {r[0] for r in rows}

    def get_span_names(self, service: str) -> Set[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT s.name FROM spans s"
                " JOIN annotations a ON a.span_row = s.row"
                " WHERE s.indexable = 1 AND a.service_lc = ? AND s.name != ''",
                (service.lower(),),
            ).fetchall()
        return {r[0] for r in rows}

    # -- dependency aggregation (AnormAggregator role) -------------------

    def aggregate_dependencies(self) -> Dependencies:
        """SQL parent×child join + python Moments fold, persisted to the
        dependencies tables (AnormAggregator.scala:32-90 semantics,
        incremental: only spans newer than the last aggregated end_ts)."""
        with self._lock:
            last = self._conn.execute(
                "SELECT MAX(end_ts) FROM dependencies"
            ).fetchone()[0]
            q = (
                "SELECT p.row, c.row, c.duration, c.ts_first, c.ts_last"
                " FROM spans c JOIN spans p ON p.span_id = c.parent_id"
                "  AND p.trace_id = c.trace_id"
                " WHERE c.parent_id IS NOT NULL"
            )
            args: List = []
            if last is not None:
                q += " AND c.ts_last > ?"
                args.append(last)
            pairs = self._conn.execute(q, args).fetchall()
        if not pairs:
            return self.get_dependencies()
        # Owning service per span row (server-preferred) via span fetch.
        rows_needed = sorted({r for p in pairs for r in (p[0], p[1])})
        marks = ",".join("?" * len(rows_needed))
        with self._lock:
            raw = self._conn.execute(
                "SELECT row, trace_id, span_id, parent_id, name, debug"
                f" FROM spans WHERE row IN ({marks})", rows_needed,
            ).fetchall()
        spans = self._spans_for_rows(raw)
        svc_by_row = {r[0]: s.service_name for r, s in zip(raw, spans)}
        links: Dict[Tuple[str, str], Moments] = {}
        ts_min, ts_max = None, None
        for p_row, c_row, duration, ts_first, ts_last in pairs:
            parent, child = svc_by_row.get(p_row), svc_by_row.get(c_row)
            if parent is None or child is None:
                continue
            m = Moments.of(float(duration)) if duration is not None else Moments.zero()
            key = (parent, child)
            links[key] = links[key] + m if key in links else m
            if ts_first is not None:
                ts_min = ts_first if ts_min is None else min(ts_min, ts_first)
                ts_max = ts_last if ts_max is None else max(ts_max, ts_last)
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(
                "INSERT INTO dependencies (start_ts, end_ts) VALUES (?, ?)",
                (ts_min or 0, ts_max or 0),
            )
            dep_id = cur.lastrowid
            for (parent, child), m in links.items():
                cur.execute(
                    "INSERT INTO dependency_links (dep_id, parent, child,"
                    " m0, m1, m2, m3, m4) VALUES (?,?,?,?,?,?,?,?)",
                    (dep_id, parent, child, *m.to_central()),
                )
            self._conn.commit()
        return self.get_dependencies()

    def get_dependencies(self, start_ts=None, end_ts=None) -> Dependencies:
        """Aggregated links, optionally restricted to aggregation rows
        overlapping [start_ts, end_ts] — each `dependencies` row is one
        aggregation window, the zipkin_dependencies(start_ts, end_ts)
        rows of the anormdb schema (DB.scala:88-146)."""
        cond, args = [], []
        if end_ts is not None:
            cond.append("d.start_ts <= ?")
            args.append(end_ts)
        if start_ts is not None:
            cond.append("d.end_ts >= ?")
            args.append(start_ts)
        where = (" WHERE " + " AND ".join(cond)) if cond else ""
        with self._lock:
            deps = self._conn.execute(
                f"SELECT MIN(d.start_ts), MAX(d.end_ts)"
                f" FROM dependencies d{where}", args,
            ).fetchone()
            rows = self._conn.execute(
                f"SELECT l.parent, l.child, l.m0, l.m1, l.m2, l.m3, l.m4"
                f" FROM dependency_links l"
                f" JOIN dependencies d ON l.dep_id = d.id{where}", args,
            ).fetchall()
        if deps[0] is None:
            return Dependencies.zero()
        acc: Dict[Tuple[str, str], Moments] = {}
        for parent, child, m0, m1, m2, m3, m4 in rows:
            key = (parent, child)
            m = Moments.from_central(m0, m1, m2, m3, m4)
            acc[key] = acc[key] + m if key in acc else m
        return Dependencies(
            float(deps[0]), float(deps[1]),
            tuple(DependencyLink(p, c, m) for (p, c), m in acc.items()),
        )
