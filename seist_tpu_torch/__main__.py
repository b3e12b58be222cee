"""``python -m seist_tpu_torch serve ...``: the port's command line."""

from __future__ import annotations

import sys


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "serve":
        raise SystemExit("usage: python -m seist_tpu_torch serve --model NAME[=WEIGHTS] ...")
    from seist_tpu_torch.serve.server import main as serve_main

    serve_main(argv[1:])


if __name__ == "__main__":
    main()
