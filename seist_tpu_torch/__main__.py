"""``python -m seist_tpu_torch serve|train|pack|supervise ...``: the port's
command line."""

from __future__ import annotations

import sys

_USAGE = (
    "usage: python -m seist_tpu_torch serve --model NAME[=WEIGHTS] ...\n"
    "       python -m seist_tpu_torch train --model-name NAME --dataset-name synthetic|packed ...\n"
    "       python -m seist_tpu_torch pack --dataset NAME --out DIR ...\n"
    "       python -m seist_tpu_torch supervise [--retries N] [--backoff S] -- COMMAND ..."
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
    else:
        raise SystemExit(_USAGE)


if __name__ == "__main__":
    main()
