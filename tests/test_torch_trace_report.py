"""``python -m seist_tpu_torch trace-report`` (``seist_tpu_torch/trace_report.py``)
against the JAX package's stitcher (``tools/trace_report.py``), on the CPU.

* tests/test_trace.py's stitch cases (tree, total, flags, processes, the
  cross-process edge, orphans as roots, span ids deduplicated), and the
  JAX tool's stitch and text of the same segments equal the port's;
* the HTTP half against a stub fleet (a router's ``/router/replicas`` and
  three ``/traces/<id>`` endpoints, one of them gone): the endpoints found
  from the router, the stitch, ``--json`` and the exit codes (0 stitched,
  1 nothing found, 2 usage);
* the module imports neither torch nor numpy.

A real request through the router and two CPU replicas is stitched in
tests/test_torch_fleet_slice.py, on that file's fleet.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from seist_tpu_torch import trace_report as tr
from seist_tpu_torch.obs import trace as T


def _segments():
    tid = T._new_trace_id()
    router_root, attempt, server_root = (T._new_span_id() for _ in range(3))
    router_seg = {
        "trace_id": tid, "process": "router", "flags": ["retried"],
        "spans": [
            {"span_id": router_root, "parent_id": None, "name": "router:/predict",
             "t0": 100.0, "dur_ms": 50.0, "root": True, "process": "router"},
            {"span_id": attempt, "parent_id": router_root, "name": "attempt", "t0": 100.001,
             "dur_ms": 48.0, "annotations": {"replica": "r1", "class": "ok"},
             "process": "router"},
        ],
    }
    replica_seg = {
        "trace_id": tid, "process": "replica-1", "flags": [],
        "spans": [
            {"span_id": server_root, "parent_id": attempt, "name": "server:/predict",
             "t0": 100.002, "dur_ms": 46.0, "root": True, "process": "replica-1"},
            {"span_id": T._new_span_id(), "parent_id": server_root, "name": "queue_wait",
             "t0": 100.003, "dur_ms": 10.0, "process": "replica-1"},
            {"span_id": T._new_span_id(), "parent_id": server_root, "name": "forward",
             "t0": 100.013, "dur_ms": 30.0, "annotations": {"program": "m/full/b4/fp32"},
             "process": "replica-1"},
        ],
    }
    return tid, router_seg, replica_seg


def test_tree_assembly_total_and_format():
    tid, router_seg, replica_seg = _segments()
    st = tr.stitch([router_seg, None, replica_seg])
    assert st.trace_id == tid
    assert st.total_ms == 50.0
    assert st.flags == ["retried"]
    assert st.processes() == ["replica-1", "router"]
    assert len(st.roots) == 1
    text = st.format()
    assert "router:/predict" in text and "queue_wait" in text
    assert "program=m/full/b4/fp32" in text
    assert st.children[router_seg["spans"][1]["span_id"]][0]["name"] == "server:/predict"


def test_orphans_surface_as_roots():
    _, _, replica_seg = _segments()
    st = tr.stitch([replica_seg])
    assert len(st.roots) == 1
    assert st.roots[0]["name"] == "server:/predict"
    assert st.total_ms == 46.0


def test_duplicate_span_ids_dedup():
    _, router_seg, replica_seg = _segments()
    st = tr.stitch([router_seg, router_seg, replica_seg])
    assert len(st.spans) == 5


def test_stitch_and_text_equal_the_jax_tools():
    from tools import trace_report as jtr

    _, router_seg, replica_seg = _segments()
    segs = [router_seg, None, replica_seg]
    got, want = tr.stitch(segs), jtr.stitch(segs)
    assert got.format() == want.format()
    assert (got.spans, got.flags, got.total_ms) == (want.spans, want.flags, want.total_ms)


def _serve(pages):
    """An HTTP server answering GET with ``pages[path]`` as JSON, 404
    otherwise; returns (url, server)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = pages.get(self.path)
            data = json.dumps(body if body is not None else {"error": "unknown"}).encode()
            self.send_response(200 if body is not None else 404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}", server


@pytest.fixture()
def stub_fleet():
    """A router and two replicas answering ``/traces/<id>``: the second
    replica has lost the trace (404)."""
    tid, router_seg, replica_seg = _segments()
    r1, s1 = _serve({f"/traces/{tid}": replica_seg})
    r2, s2 = _serve({})
    router, s0 = _serve({f"/traces/{tid}": router_seg,
                         "/router/replicas": {"replicas": [{"url": r1}, {"url": r2}]}})
    yield tid, router, [r1, r2]
    for s in (s0, s1, s2):
        s.shutdown()
        s.server_close()


def test_stitch_from_the_fleets_endpoints(stub_fleet, capsys):
    tid, router, replicas = stub_fleet
    assert tr.replica_endpoints(router) == replicas
    assert tr.fetch_trace(replicas[1], tid) is None  # a process that lost it
    st = tr.stitch_from_endpoints(tid, [router] + replicas)
    assert len(st.roots) == 1 and st.processes() == ["replica-1", "router"]
    assert st.find("server:/predict")[0]["parent_id"] == st.find("attempt")[0]["span_id"]
    assert tr.main(["--trace", tid, "--router", router, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out[0]["trace_id"] == tid and out[0]["processes"] == ["replica-1", "router"]
    assert out[0]["flags"] == ["retried"] and out[0]["total_ms"] == 50.0
    assert tr.main(["--trace", tid, "--endpoint", router]) == 0
    assert capsys.readouterr().out.startswith(f"trace {tid}  total 50.0 ms")
    assert tr.main(["--trace", "f" * 32, "--endpoint", router]) == 1
    with pytest.raises(SystemExit) as usage:
        tr.main(["--endpoint", router])
    assert usage.value.code == 2


def test_trace_report_imports_neither_torch_nor_numpy():
    out = subprocess.run(
        [sys.executable, "-c", "import sys; import seist_tpu_torch.trace_report; "
         "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))"],
        capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
