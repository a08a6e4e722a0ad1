"""The completion track runs without JAX: PCN's, ECG's and VRCNet's slices
and ECG's train step, in a fresh interpreter with jax, flax, optax, PyYAML
and h5py blocked (``tests.test_torch_import._run``)."""

from tests.test_torch_import import _run


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
