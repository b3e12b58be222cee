"""``python -m seist_tpu_torch serve|train|pack|supervise|router|supervise-fleet|repick|
supervise-repick|import-pretrained|predict|demo|profile-step|trace-report|twin|
twin-replica ...``: the
port's command line. ``router``, ``supervise-fleet``, ``supervise-repick`` and
``trace-report`` are model-free host processes: they take no device and import
neither torch nor numpy. ``import-pretrained`` converts the reference's
published ``.pth`` weights into the port's weights file on the host;
``predict`` picks a continuous record into a CSV and ``demo`` plots one
trace; ``profile-step`` traces the captured train step; these three run on
the card unless ``--device cpu`` is passed. ``trace-report`` stitches one
request's spans from the fleet's ``/traces`` endpoints. ``twin`` drives the
streaming plane's digital twin in process and ``twin-replica`` serves its
picker over HTTP for a fleet (both on the card unless ``--device cpu``)."""

from __future__ import annotations

import sys

_USAGE = (
    "usage: python -m seist_tpu_torch serve --model NAME[=WEIGHTS] ...\n"
    "       python -m seist_tpu_torch train --model-name NAME --dataset-name synthetic|packed ...\n"
    "       python -m seist_tpu_torch pack --dataset NAME --out DIR ...\n"
    "       python -m seist_tpu_torch supervise [--retries N] [--backoff S] -- COMMAND ...\n"
    "       python -m seist_tpu_torch router --replica HOST:PORT [--replica ...] [--port P] ...\n"
    "       python -m seist_tpu_torch supervise-fleet [--replicas N] [--router-port P] "
    "[--rollout-file F] ... -- python -m seist_tpu_torch serve ...\n"
    "       python -m seist_tpu_torch repick --archive PACK --out DIR --model NAME[=WEIGHTS] "
    "[--workers N | --fleet --lease-dir D | --merge-only] ...\n"
    "       python -m seist_tpu_torch supervise-repick --archive PACK --out DIR --model NAME "
    "--workers N --lease-dir D ...\n"
    "       python -m seist_tpu_torch import-pretrained --pth W.pth --model-name NAME --out W.pt "
    "[--in-samples N] [--in-channels C]\n"
    "       python -m seist_tpu_torch predict --model-name NAME --checkpoint W.pt --input REC.npz "
    "[--output picks.csv] ...\n"
    "       python -m seist_tpu_torch demo --model-name NAME [--checkpoint W.pt] [--input T.npz] "
    "[--output-dir D] ...\n"
    "       python -m seist_tpu_torch profile-step [--model-name NAME] [--batch N] [--steps N] "
    "[--dtype fp32|bf16] [--out DIR] ...\n"
    "       python -m seist_tpu_torch trace-report --trace ID [--endpoint URL ...] [--router URL] "
    "[--from-bench F] [--json]\n"
    "       python -m seist_tpu_torch twin [--stations N] [--duration-s S] [--smoke] "
    "[--device cpu] [--output F] [--export-schedule F] ...\n"
    "       python -m seist_tpu_torch twin-replica [--journal-dir D] [--device cpu] ..."
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
    elif argv and argv[0] == "repick":
        from seist_tpu_torch.repick import main as repick_main

        sys.exit(repick_main(argv[1:]))
    elif argv and argv[0] == "supervise-repick":
        from seist_tpu_torch.supervise_repick import main as supervise_repick_main

        sys.exit(supervise_repick_main(argv[1:]))
    elif argv and argv[0] == "import-pretrained":
        from seist_tpu_torch.import_pretrained import main as import_main

        import_main(argv[1:])
    elif argv and argv[0] == "predict":
        from seist_tpu_torch.predict import main as predict_main

        predict_main(argv[1:])
    elif argv and argv[0] == "demo":
        from seist_tpu_torch.demo import main as demo_main

        demo_main(argv[1:])
    elif argv and argv[0] == "profile-step":
        from seist_tpu_torch.profile_step import main as profile_main

        profile_main(argv[1:])
    elif argv and argv[0] == "trace-report":
        from seist_tpu_torch.trace_report import main as report_main

        sys.exit(report_main(argv[1:]))
    elif argv and argv[0] == "twin":
        from seist_tpu_torch.twin import main as twin_main

        sys.exit(twin_main(argv[1:]))
    elif argv and argv[0] == "twin-replica":
        from seist_tpu_torch.serve.server import exit_process
        from seist_tpu_torch.twin_replica import main as replica_main

        exit_process(replica_main(argv[1:]))
    else:
        raise SystemExit(_USAGE)


if __name__ == "__main__":
    main()
