"""The port stands without JAX: every slice module imports in a fresh
interpreter that holds no jax or flax. A subprocess, since the pytest
process has jax loaded (tests/conftest.py). The slices' runs without JAX are
in test_torch_import_completion.py and test_torch_import_registration.py,
one file a track, so that xdist spreads them."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "mvp_benchmark_tpu_torch",
    "mvp_benchmark_tpu_torch.ops",
    "mvp_benchmark_tpu_torch.ops.ref",
    "mvp_benchmark_tpu_torch.ops.kernels",
    "mvp_benchmark_tpu_torch.ops.dispatch",
    "mvp_benchmark_tpu_torch.metrics",
    "mvp_benchmark_tpu_torch.metrics.completion",
    "mvp_benchmark_tpu_torch.metrics.registration",
    "mvp_benchmark_tpu_torch.models",
    "mvp_benchmark_tpu_torch.models.layers",
    "mvp_benchmark_tpu_torch.models.pcn",
    "mvp_benchmark_tpu_torch.models.common",
    "mvp_benchmark_tpu_torch.models.ecg",
    "mvp_benchmark_tpu_torch.models.vrcnet",
    "mvp_benchmark_tpu_torch.models.dcp",
    "mvp_benchmark_tpu_torch.models.idam",
    "mvp_benchmark_tpu_torch.models.transplant",
    "mvp_benchmark_tpu_torch.data.augment",
    "mvp_benchmark_tpu_torch.data.mvp",
    "mvp_benchmark_tpu_torch.train.config",
    "mvp_benchmark_tpu_torch.train.checkpoint",
    "mvp_benchmark_tpu_torch.train.meters",
    "mvp_benchmark_tpu_torch.train.optim",
    "mvp_benchmark_tpu_torch.train.engine",
    "mvp_benchmark_tpu_torch.train.submission",
    "mvp_benchmark_tpu_torch.profile_eval",
    "mvp_benchmark_tpu_torch.probe_attention_backward",
    "mvp_benchmark_tpu_torch.probe_attention",
    "mvp_benchmark_tpu_torch.probe_train_backwards",
    "mvp_benchmark_tpu_torch.probe_knn_fps",
    "chip_smoke",
]


def _run(code: str) -> dict:
    """Run ``code`` in a fresh interpreter -> the JSON of its last line. Two
    torch threads: the test workers share the machine's cores, and a run
    whose threads outnumber them spins (the IDAM slice took 300 s instead
    of 7 under three workers)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_slice_modules_import_without_jax_or_flax():
    out = _run(
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        "if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))))\n")
    assert out == []
