"""Registration training CLI on PyTorch/CUDA -- the twin of ``train.py`` for the
``mvp_benchmark_tpu_torch`` port, on the same ``cfgs/*.yaml``.

    python train_torch.py -c cfgs/dcp.yaml
    python train_torch.py -c cfgs/dcp_smoke.yaml --device cpu

IDAM's training is not ported yet: ``-c cfgs/idam.yaml`` raises
NotImplementedError before the first step (``engine.build_model``).

Writes ``train.log``, ``network.pkl`` every ``epoch_interval_to_save`` epochs
and ``best_<metric>_network.pkl`` (RotE, transE, MSE, RMSE, recall) after each
val pass into ``<work_dir>/<model>_<benchmark>_<flag>_torch_<time>/`` (or
beside ``load_model`` when resuming). The checkpoints hold the parameters and
running statistics in the JAX package's flax layout, so ``test.py``,
``test_torch.py`` and ``train.py`` all load them. ``--device`` defaults to
``cuda`` and raises when CUDA is absent; pass ``--device cpu`` to run the
plain versions of the kernels on the CPU.
"""

import argparse
import datetime
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mvp_benchmark_tpu_torch.train import engine  # noqa: E402
from mvp_benchmark_tpu_torch.train.config import load_config  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train config file")
    parser.add_argument("-c", "--config", help="path to config file",
                        required=True)
    parser.add_argument("--data-dir", default=None,
                        help="override dataset directory (default ./data)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; never falls back)")
    arg = parser.parse_args(argv)
    args = load_config(arg.config)
    device = engine.resolve_device(arg.device)

    if args.load_model:
        log_dir = os.path.dirname(args.load_model)
    else:
        time = datetime.datetime.now().isoformat()[:19]
        exp_name = f"{args.model_name}_{args.benchmark}_{args.flag}_torch_{time}"
        log_dir = os.path.join(args.work_dir, exp_name)
        os.makedirs(log_dir, exist_ok=True)

    logging.basicConfig(
        level=logging.INFO,
        handlers=[
            logging.FileHandler(os.path.join(log_dir, "train.log")),
            logging.StreamHandler(sys.stdout),
        ],
    )
    logging.info(str(args))
    logging.info("device: %s", device)
    data_dir = arg.data_dir or os.path.join(os.path.dirname(__file__), "data")
    engine.train_registration(args, log_dir, data_dir=data_dir, device=device)
    return log_dir


if __name__ == "__main__":
    main()
