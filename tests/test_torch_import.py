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


def test_ecg_train_step_and_emd_run_without_jax_flax_yaml_or_h5py():
    """ECG's train step at 512 points (the uniform loss needs nsample >= 2)
    and calc_emd, on the CPU, with the ball query's and the auction's plain
    versions."""
    out = _run(
        "import json, sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
        "import torch\n"
        "from mvp_benchmark_tpu_torch.models import get_model\n"
        "from mvp_benchmark_tpu_torch.train.config import Config\n"
        "g = torch.Generator().manual_seed(0)\n"
        "ecg = get_model('ecg', Config(num_points=512, loss='cd', eval_emd=False),"
        " generator=g).train()\n"
        "x = torch.rand(2, 512, 3, generator=g)\n"
        "t = ecg.train_losses(x, torch.rand(2, 512, 3, generator=g), 0.5)\n"
        "t['total'].backward()\n"
        "from mvp_benchmark_tpu_torch.metrics import calc_emd\n"
        "emd = calc_emd(x[:, :256], torch.rand(2, 256, 3, generator=g), 0.004, 300)\n"
        "print(json.dumps({'u2': float(t['uniform2']), 'emd': emd.tolist(),\n"
        "  'grads': all(bool(torch.isfinite(p.grad).all()) for p in ecg.parameters()"
        " if p.grad is not None)}))\n")
    assert out["u2"] > 0 and out["grads"]
    assert len(out["emd"]) == 2 and all(0 < e < 2 for e in out["emd"])


def _registration_slice(cfg, tmp_path):
    """A registration slice through the CLI's functions on the CPU with jax,
    flax, optax, PyYAML and h5py blocked: the val metrics and the test poses
    come out finite, the poses rigid."""
    out = _run(
        "import json, sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
        "import torch\n"
        "from mvp_benchmark_tpu_torch.train import config, engine, submission\n"
        f"cfg = config.load_config({cfg!r})\n"
        "cpu = torch.device('cpu')\n"
        f"res = engine.run_registration_val(cfg, {str(tmp_path)!r}, cpu)\n"
        f"T = torch.from_numpy(submission.predict_registration_test(cfg, {str(tmp_path)!r}, cpu))\n"
        "R = T[:, :3, :3]\n"
        "print(json.dumps({'val': res, 'shape': list(T.shape),\n"
        "  'finite': bool(torch.isfinite(T).all()),\n"
        "  'rigid': float((R @ R.transpose(1, 2) - torch.eye(3)).abs().max()),\n"
        "  'det': float((torch.linalg.det(R) - 1).abs().max())}))\n")
    assert sorted(out["val"]) == sorted(["RotE", "transE", "MSE", "RMSE", "recall"])
    assert all(v == v and abs(v) != float("inf") for v in out["val"].values())
    assert out["shape"] == [32, 4, 4] and out["finite"]
    assert out["rigid"] < 1e-5 and out["det"] < 1e-5


def test_dcp_slice_runs_without_jax_flax_yaml_or_h5py(tmp_path):
    """The DCP slice: the kNN, the gather, the edge chain and both
    attentions take their plain versions."""
    _registration_slice("registration/cfgs/dcp_smoke.yaml", tmp_path)


def test_idam_slice_runs_without_jax_flax_yaml_or_h5py(tmp_path):
    """The IDAM slice (emb 32, 2 iterations): the kNN, the Propagate edge
    block and the similarity MLP take their plain versions."""
    _registration_slice("registration/cfgs/idam_smoke.yaml", tmp_path)


def test_dcp_train_path_runs_without_jax_flax_yaml_or_h5py(tmp_path):
    """DCP's train path through ``engine.train_registration`` on the CPU,
    one epoch of two steps at dcp_smoke.yaml's size: the edge chain's train
    mode, both attentions' gradients and BatchNorm's batch statistics take
    their plain versions; the losses and every gradient come out finite,
    the running statistics move, and the val pass writes its checkpoints."""
    out = _run(
        "import json, os, sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
        "import torch\n"
        "from mvp_benchmark_tpu_torch.train import config, engine\n"
        "cfg = config.load_config('registration/cfgs/dcp_smoke.yaml', nepoch=1)\n"
        f"res = engine.train_registration(cfg, {str(tmp_path)!r}, {str(tmp_path)!r},\n"
        "    max_steps_per_epoch=2, device=torch.device('cpu'))\n"
        "m = res['model']\n"
        "print(json.dumps({'losses': res['history']['step_losses'][0],\n"
        "  'grads': all(bool(torch.isfinite(p.grad).all()) for p in m.parameters()),\n"
        "  'moved': float(m.emb_nn.fused_var3.sub(1).abs().max()),\n"
        f"  'files': sorted(os.listdir({str(tmp_path)!r}))}}))\n")
    assert len(out["losses"]) == 2 and all(0 < x < 10 for x in out["losses"])
    assert out["grads"] and out["moved"] > 0
    assert "network.pkl" in out["files"] and "best_recall_network.pkl" in out["files"]
