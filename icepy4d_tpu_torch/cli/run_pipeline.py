"""Run the full multi-epoch 4D pipeline from a YAML config on the card:

  python -m icepy4d_tpu_torch run_pipeline config.yaml
  python -m icepy4d_tpu_torch run_pipeline config.yaml --batched
  python -m icepy4d_tpu_torch run_pipeline config.yaml --watch \
      --poll-interval 60
  python -m icepy4d_tpu_torch run_pipeline config.yaml --distributed \
      --coordinator host:1234 --num-processes 4 --process-id 0

--batched matches the epochs in data-parallel groups (`run_batched`);
--distributed joins a `torch.distributed` group and runs this process's
share of the season (`run_distributed`). Without --coordinator,
--num-processes and --process-id it reads torchrun's MASTER_ADDR,
MASTER_PORT, WORLD_SIZE and RANK; with none of them it runs the season
in this one process.
"""

from __future__ import annotations

import argparse

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch run_pipeline")
    ap.add_argument("config")
    ap.add_argument("--batched", action="store_true",
                    help="mesh-batched epochs (data-parallel over cards)")
    ap.add_argument("--watch", action="store_true",
                    help="continuous monitoring: poll for new epochs")
    ap.add_argument("--poll-interval", type=float, default=60.0)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process epoch distribution "
                         "(torch.distributed; one process per card)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port "
                         "(or MASTER_ADDR:MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Run the season; returns the processed Epoches."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    from icepy4d_tpu_torch.pipeline import Pipeline
    from icepy4d_tpu_torch.utils import setup_logger

    setup_logger()
    if args.distributed:
        from icepy4d_tpu_torch.parallel.distributed import init_distributed

        init_distributed(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id, device=args.device)
        pipe = Pipeline(args.config, device=dev)
        epoches = pipe.run_distributed()
    elif args.watch:
        pipe = Pipeline(args.config, device=dev)
        epoches = pipe.watch(poll_interval=args.poll_interval)
    elif args.batched:
        pipe = Pipeline(args.config, device=dev)
        epoches = pipe.run_batched()
    else:
        pipe = Pipeline(args.config, device=dev)
        epoches = pipe.run()
    print(f"processed {len(epoches)} epochs")
    return epoches


if __name__ == "__main__":
    main()
