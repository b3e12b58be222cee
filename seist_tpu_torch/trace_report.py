"""Cross-process trace stitcher (counterpart of ``tools/trace_report.py``):
pull one request's span segments from every fleet endpoint's ``GET
/traces/<id>``, assemble the parent/child tree, and print where the
milliseconds went.

Each process on the request path (client -> router -> replica) keeps only
its own span segments (``obs/trace.py``); the trace id is the join key
and the ``traceparent`` parent span ids are the edges: the router's
per-attempt span id travels downstream in the header, so a replica's
``server:/predict`` root parents to the attempt that carried it.
Stitching is a pure merge, with no clock coordination beyond the hosts'
wall clocks (skew across hosts shows as child-outside-parent)::

    # the id comes from a response's `traceparent` header or GET /traces
    python -m seist_tpu_torch trace-report --trace <32-hex-id> \
        --endpoint http://127.0.0.1:8080 \
        --endpoint http://127.0.0.1:18100 --endpoint http://127.0.0.1:18101

    # discover the replica endpoints from the router; take the exemplars
    # of a benchmark's JSON (its `trace_exemplars`):
    python -m seist_tpu_torch trace-report --from-bench bench.json \
        --router http://127.0.0.1:8080

Exit codes: 0 stitched, 1 no segments found anywhere, 2 usage. It imports
neither torch nor numpy (safe in the front tier, beside the router).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from seist_tpu_torch.serve.router import _http_request


def fetch_trace(endpoint: str, trace_id: str,
                timeout_s: float = 5.0) -> Optional[Dict[str, Any]]:
    """GET <endpoint>/traces/<id>; None on 404/network failure (a
    process that sampled the trace out, restarted, or is gone — the
    stitch uses whatever segments survive)."""
    import http.client

    try:
        status, _, body = _http_request(
            endpoint, "GET", f"/traces/{trace_id}", timeout_s=timeout_s
        )
    except (OSError, http.client.HTTPException):
        return None
    if status != 200:
        return None
    try:
        payload = json.loads(body.decode())
    except ValueError:
        return None
    return payload if isinstance(payload, dict) else None


def replica_endpoints(router_url: str,
                      timeout_s: float = 5.0) -> List[str]:
    """The router's registry as scrape-able base URLs."""
    import http.client

    try:
        status, _, body = _http_request(
            router_url, "GET", "/router/replicas", timeout_s=timeout_s
        )
        if status != 200:
            return []
        payload = json.loads(body.decode())
        return [r["url"] for r in payload.get("replicas", [])]
    except (OSError, ValueError, KeyError, http.client.HTTPException):
        return []


# ------------------------------------------------------------- stitching
class StitchedTrace:
    """The merged cross-process view of one trace."""

    def __init__(self, trace_id: str, spans: List[Dict[str, Any]],
                 flags: Sequence[str]):
        self.trace_id = trace_id
        self.spans = spans
        self.flags = sorted(set(flags))
        by_id = {s["span_id"]: s for s in spans}
        self.roots: List[Dict[str, Any]] = []
        self.children: Dict[str, List[Dict[str, Any]]] = {}
        for s in spans:
            parent = s.get("parent_id")
            if parent and parent in by_id:
                self.children.setdefault(parent, []).append(s)
            else:
                # Orphans (parent process lost/sampled out) surface as
                # extra roots instead of disappearing.
                self.roots.append(s)
        for kids in self.children.values():
            kids.sort(key=lambda s: s.get("t0", 0.0))
        self.roots.sort(key=lambda s: s.get("t0", 0.0))

    @property
    def total_ms(self) -> float:
        """The stitched tree's total: the primary (earliest) root span's
        duration — the top of the request as the outermost process saw
        it. (Wall extent across all spans can exceed this only via
        cross-host clock skew; hedged attempts overlap INSIDE it.)"""
        return float(self.roots[0]["dur_ms"]) if self.roots else 0.0

    def span_sum_ms(self) -> float:
        """Sum of leaf-level exclusive durations is meaningless under
        hedging (parallel attempts); the acceptance metric is the root
        total vs the client-observed latency."""
        return self.total_ms

    def processes(self) -> List[str]:
        return sorted({s.get("process", "?") for s in self.spans})

    def find(self, name: str) -> List[Dict[str, Any]]:
        return [s for s in self.spans if s.get("name") == name]

    # ------------------------------------------------------------ rendering
    def format(self) -> str:
        lines = [
            f"trace {self.trace_id}  total {self.total_ms:.1f} ms  "
            f"processes={','.join(self.processes())}"
            + (f"  flags={','.join(self.flags)}" if self.flags else "")
        ]

        def walk(span: Dict[str, Any], depth: int, last: bool) -> None:
            pad = "   " * (depth - 1) + ("└─ " if last else "├─ ") \
                if depth else ""
            ann = span.get("annotations") or {}
            ann_str = " ".join(
                f"{k}={v}" for k, v in sorted(ann.items())
            )
            lines.append(
                f"{pad}{span.get('name', '?')}  "
                f"{span.get('dur_ms', 0.0):.1f} ms  "
                f"[{span.get('process', '?')}]"
                + (f"  {ann_str}" if ann_str else "")
            )
            kids = self.children.get(span["span_id"], [])
            for i, kid in enumerate(kids):
                walk(kid, depth + 1, i == len(kids) - 1)

        for i, root in enumerate(self.roots):
            walk(root, 0, i == len(self.roots) - 1)
        return "\n".join(lines)


def stitch(segments: Sequence[Optional[Dict[str, Any]]],
           trace_id: str = "") -> StitchedTrace:
    """Merge per-process ``/traces/<id>`` payloads (Nones skipped) into
    one tree; span ids dedup (the same endpoint fetched twice is
    harmless)."""
    seen: Dict[str, Dict[str, Any]] = {}
    flags: List[str] = []
    for seg in segments:
        if not seg:
            continue
        trace_id = trace_id or seg.get("trace_id", "")
        flags.extend(seg.get("flags", ()))
        for span in seg.get("spans", ()):
            sid = span.get("span_id")
            if sid and sid not in seen:
                s = dict(span)
                s.setdefault("process", seg.get("process", "?"))
                seen[sid] = s
    return StitchedTrace(trace_id, list(seen.values()), flags)


def stitch_from_endpoints(trace_id: str,
                          endpoints: Sequence[str]) -> StitchedTrace:
    return stitch(
        [fetch_trace(ep, trace_id) for ep in endpoints], trace_id
    )


# ------------------------------------------------------------------ CLI
def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m seist_tpu_torch trace-report",
        description="stitch one request's distributed trace across the "
        "fleet's /traces endpoints"
    )
    ap.add_argument("--trace", action="append", default=[],
                    metavar="TRACE_ID", help="trace id(s) to stitch")
    ap.add_argument("--from-bench", default="",
                    help="bench_serve --output JSON: stitch its "
                    "trace_exemplars (slowest + failed)")
    ap.add_argument("--endpoint", action="append", default=[],
                    metavar="URL", help="a /traces-serving endpoint "
                    "(router, replica, train worker), repeatable")
    ap.add_argument("--router", default="",
                    help="router URL: also auto-discovers the replica "
                    "endpoints from its registry")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of the tree")
    args = ap.parse_args(argv)

    trace_ids = list(args.trace)
    if args.from_bench:
        with open(args.from_bench) as f:
            bench = json.load(f)
        exemplars = bench.get("trace_exemplars", {})
        trace_ids.extend(
            e["trace_id"]
            for group in ("failed", "slowest")
            for e in exemplars.get(group, ())
            if e.get("trace_id")
        )
    endpoints = list(args.endpoint)
    if args.router:
        endpoints.append(args.router)
        endpoints.extend(replica_endpoints(args.router))
    if not trace_ids:
        ap.error("no trace ids (--trace or --from-bench)")
    if not endpoints:
        ap.error("no endpoints (--endpoint or --router)")

    found_any = False
    out_json: List[Dict[str, Any]] = []
    for tid in dict.fromkeys(trace_ids):  # dedup, keep order
        st = stitch_from_endpoints(tid, endpoints)
        if not st.spans:
            print(f"trace {tid}: no segments at any endpoint",
                  file=sys.stderr)
            continue
        found_any = True
        if args.json:
            out_json.append({
                "trace_id": tid,
                "total_ms": st.total_ms,
                "flags": st.flags,
                "processes": st.processes(),
                "spans": st.spans,
            })
        else:
            print(st.format())
            print()
    if args.json:
        print(json.dumps(out_json))
    return 0 if found_any else 1


if __name__ == "__main__":
    sys.exit(main())
