"""Registration test CLI on PyTorch/CUDA -- the twin of ``test.py`` for the
``mvp_benchmark_tpu_torch`` port, on the same ``cfgs/*.yaml``.

    python test_torch.py -c cfgs/dcp.yaml          # results.h5 + submission.zip
    python test_torch.py -c cfgs/dcp.yaml --val    # val pass: RotE, transE, MSE, RMSE, recall
    python test_torch.py -c cfgs/idam.yaml --val   # IDAM (eval only so far)
    python test_torch.py -c cfgs/idam_smoke.yaml --val --device cpu

``--device`` defaults to ``cuda`` and raises when CUDA is absent; pass
``--device cpu`` to run the plain versions of the kernels on the CPU. Writing
results.h5 needs h5py; ``--val`` needs neither h5py nor PyYAML.
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mvp_benchmark_tpu_torch.train import engine  # noqa: E402
from mvp_benchmark_tpu_torch.train.config import load_config  # noqa: E402
from mvp_benchmark_tpu_torch.train.submission import run_registration_test  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description="Test config file")
    parser.add_argument("-c", "--config", help="path to config file",
                        required=True)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; never falls back)")
    parser.add_argument("--val", action="store_true",
                        help="run the val pass and log RotE/transE/MSE/RMSE/"
                             "recall instead of writing the test submission")
    arg = parser.parse_args(argv)
    args = load_config(arg.config)
    device = engine.resolve_device(arg.device)

    if args.load_model:
        log_dir = os.path.dirname(args.load_model)
    else:
        suffix = "val" if arg.val else "test"
        exp_name = f"{args.model_name}_{args.benchmark}_{args.flag}_torch_{suffix}"
        log_dir = os.path.join(args.work_dir, exp_name)
        os.makedirs(log_dir, exist_ok=True)

    logging.basicConfig(
        level=logging.INFO,
        handlers=[
            logging.FileHandler(os.path.join(log_dir, "test_torch.log")),
            logging.StreamHandler(sys.stdout),
        ],
    )
    logging.info(str(args))
    logging.info("device: %s", device)
    data_dir = arg.data_dir or os.path.join(os.path.dirname(__file__), "data")
    if arg.val:
        engine.run_registration_val(args, data_dir, device)
    else:
        zip_path, results = run_registration_test(args, log_dir, data_dir, device)
        logging.info("wrote %s (results %s)", zip_path, results.shape)


if __name__ == "__main__":
    main()
