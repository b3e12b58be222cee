"""``python -m seist_tpu_torch serve|train|pack|supervise|router|supervise-fleet ...``:
the port's command line. ``router`` and ``supervise-fleet`` are model-free
host processes: they take no device and import neither torch nor numpy."""

from __future__ import annotations

import sys

_USAGE = (
    "usage: python -m seist_tpu_torch serve --model NAME[=WEIGHTS] ...\n"
    "       python -m seist_tpu_torch train --model-name NAME --dataset-name synthetic|packed ...\n"
    "       python -m seist_tpu_torch pack --dataset NAME --out DIR ...\n"
    "       python -m seist_tpu_torch supervise [--retries N] [--backoff S] -- COMMAND ...\n"
    "       python -m seist_tpu_torch router --replica HOST:PORT [--replica ...] [--port P] ...\n"
    "       python -m seist_tpu_torch supervise-fleet [--replicas N] [--router-port P] "
    "[--rollout-file F] ... -- python -m seist_tpu_torch serve ..."
)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        from seist_tpu_torch.serve.server import main as serve_main

        serve_main(argv[1:])
    elif argv and argv[0] == "train":
        from seist_tpu_torch.cli import main as train_main

        train_main(argv[1:])
    elif argv and argv[0] == "pack":
        from seist_tpu_torch.pack import main as pack_main

        sys.exit(pack_main(argv[1:]))
    elif argv and argv[0] == "supervise":
        from seist_tpu_torch.supervise import main as supervise_main

        sys.exit(supervise_main(argv[1:]))
    elif argv and argv[0] == "router":
        from seist_tpu_torch.serve.router import main as router_main

        router_main(argv[1:])
    elif argv and argv[0] == "supervise-fleet":
        from seist_tpu_torch.supervise_fleet import main as fleet_main

        sys.exit(fleet_main(argv[1:]))
    else:
        raise SystemExit(_USAGE)


if __name__ == "__main__":
    main()
