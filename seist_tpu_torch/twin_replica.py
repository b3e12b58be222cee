"""One HTTP replica of the digital twin's deterministic picker (the port's
counterpart of ``tools/twin_replica.py``).

The stream chaos lane needs a real fleet (three processes behind the
router, one SIGKILLed in the middle of the mainshock), and its gates need
the twin's computable ground truth, which a trained model cannot give.
This is the ``twinpick`` service that ``twin.py`` drives in process, behind
the serving stack's HTTP front end, with the durability plane on: one
journal per station and the alert WAL under ``--journal-dir``, shared by
the fleet (the sharing is the failover channel).

``supervise-fleet`` launches it as it launches ``serve``::

    python -m seist_tpu_torch supervise-fleet --replicas 3 -- \\
        python -m seist_tpu_torch twin-replica --journal-dir /tmp/j

Signals follow ``serve``'s contract: SIGTERM is a managed preemption
(drain, flush the journals through ``shutdown(drain=True)``, exit
``PREEMPT_EXIT_CODE`` so the supervisor relaunches); SIGINT is an
operator's stop (exit 0). A SIGKILL runs nothing at all: recovery comes
from the journals the mux wrote before it.
"""

from __future__ import annotations

import argparse
import signal
import threading
from types import SimpleNamespace
from typing import List, Optional


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="twin picker HTTP replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--stations", type=int, default=200,
                    help="station capacity hint (mux max_stations)")
    ap.add_argument("--min-stations", type=int, default=4)
    ap.add_argument("--journal-dir", default=None,
                    help="shared fleet journal/WAL root (unset = none)")
    ap.add_argument("--journal-every-s", type=float, default=0.5,
                    help="per-station journal cadence; the chaos default "
                    "is tight so a SIGKILL loses sub-second state")
    ap.add_argument("--dedup-window-s", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="where twinpick runs: cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    from seist_tpu_torch import twin
    from seist_tpu_torch.serve.server import PREEMPT_EXIT_CODE, start_http_server
    from seist_tpu_torch.utils.logger import logger

    args = get_args(argv)
    service = twin._make_service(SimpleNamespace(
        window=args.window,
        stations=args.stations,
        min_stations=args.min_stations,
        journal_dir=args.journal_dir,
        journal_every_s=args.journal_every_s,
        assoc_dedup_window_s=args.dedup_window_s,
        device=args.device,
    ))
    server = start_http_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    logger.info(f"[twin-replica] listening on http://{host}:{port} "
                f"journal_dir={args.journal_dir or '-'} device={args.device}")

    stop = threading.Event()
    exit_code = {"rc": 0}

    def _term(signum, frame):
        if signum == signal.SIGTERM:
            exit_code["rc"] = PREEMPT_EXIT_CODE
        service.begin_drain()
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop.wait(1.0):  # timed: a lost set() cannot park it for ever
        pass
    rc = exit_code["rc"]
    logger.info("[twin-replica] draining...")
    # drain=True closes every stream mux: its sessions journal their final
    # state (the clean half of a failover; a SIGKILL skips it).
    service.shutdown(drain=True)
    server.shutdown()
    logger.info(f"[twin-replica] stopped (rc={rc})")
    return rc


if __name__ == "__main__":
    from seist_tpu_torch.serve.server import exit_process

    exit_process(main())
