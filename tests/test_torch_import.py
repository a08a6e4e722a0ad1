"""The port stands without JAX: every slice module imports, and the slice
runs, in a fresh interpreter that holds no jax or flax. A subprocess, since
the pytest process has jax loaded (tests/conftest.py)."""

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
    "mvp_benchmark_tpu_torch.models",
    "mvp_benchmark_tpu_torch.models.layers",
    "mvp_benchmark_tpu_torch.models.pcn",
    "mvp_benchmark_tpu_torch.models.common",
    "mvp_benchmark_tpu_torch.models.ecg",
    "mvp_benchmark_tpu_torch.models.vrcnet",
    "mvp_benchmark_tpu_torch.models.transplant",
    "mvp_benchmark_tpu_torch.data.mvp",
    "mvp_benchmark_tpu_torch.train.config",
    "mvp_benchmark_tpu_torch.train.checkpoint",
    "mvp_benchmark_tpu_torch.train.meters",
    "mvp_benchmark_tpu_torch.train.engine",
    "mvp_benchmark_tpu_torch.train.submission",
    "mvp_benchmark_tpu_torch.profile_eval",
    "chip_smoke",
]


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
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


def test_slice_runs_without_jax_flax_yaml_or_h5py(tmp_path):
    """Blocked imports raise ImportError, as on a machine without them: the
    config loads, the val pass and the test predictions run on the CPU."""
    out = _run(
        "import json, math, sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
        "import torch\n"
        "from mvp_benchmark_tpu_torch.train import config, engine, submission\n"
        "cfg = config.load_config('completion/cfgs/pcn_smoke.yaml')\n"
        "cpu = torch.device('cpu')\n"
        f"res = engine.run_completion_val(cfg, {str(tmp_path)!r}, cpu)\n"
        f"pred = submission.predict_completion_test(cfg, {str(tmp_path)!r}, cpu)\n"
        "print(json.dumps({'val': res, 'shape': list(pred.shape),\n"
        "  'finite': bool(torch.isfinite(torch.from_numpy(pred)).all())}))\n")
    assert sorted(out["val"]) == ["cd_p", "cd_t", "f1"]
    assert all(v == v and abs(v) != float("inf") for v in out["val"].values())
    assert out["shape"] == [52, 128, 3] and out["finite"]


def test_ecg_slice_runs_without_jax_flax_yaml_or_h5py(tmp_path):
    """The ECG slice the same way, through the CLI's functions: every kNN,
    FPS and gather op takes its plain version on the CPU."""
    out = _run(
        "import json, sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
        "import torch\n"
        "from mvp_benchmark_tpu_torch.train import config, engine, submission\n"
        "cfg = config.load_config('completion/cfgs/ecg_smoke.yaml')\n"
        "cpu = torch.device('cpu')\n"
        f"res = engine.run_completion_val(cfg, {str(tmp_path)!r}, cpu)\n"
        f"pred = submission.predict_completion_test(cfg, {str(tmp_path)!r}, cpu)\n"
        "print(json.dumps({'val': res, 'shape': list(pred.shape),\n"
        "  'finite': bool(torch.isfinite(torch.from_numpy(pred)).all())}))\n")
    assert sorted(out["val"]) == ["cd_p", "cd_t", "f1"]
    assert all(v == v and abs(v) != float("inf") for v in out["val"].values())
    assert out["shape"] == [52, 128, 3] and out["finite"]


def test_vrcnet_slice_runs_without_jax_flax_yaml_or_h5py(tmp_path):
    """The VRCNet slice through the CLI's functions, on the CPU: the SA block
    takes its plain version, and the eval step draws the latent noise."""
    out = _run(
        "import json, sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
        "import torch\n"
        "from mvp_benchmark_tpu_torch.train import config, engine, submission\n"
        "cfg = config.load_config('completion/cfgs/vrcnet_smoke.yaml')\n"
        "cpu = torch.device('cpu')\n"
        f"res = engine.run_completion_val(cfg, {str(tmp_path)!r}, cpu)\n"
        f"pred = submission.predict_completion_test(cfg, {str(tmp_path)!r}, cpu)\n"
        "print(json.dumps({'val': res, 'shape': list(pred.shape),\n"
        "  'finite': bool(torch.isfinite(torch.from_numpy(pred)).all())}))\n")
    assert sorted(out["val"]) == ["cd_p", "cd_t", "f1"]
    assert all(v == v and abs(v) != float("inf") for v in out["val"].values())
    assert out["shape"] == [52, 128, 3] and out["finite"]
