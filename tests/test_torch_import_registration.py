"""The registration track runs without JAX: DCP's and IDAM's slices and
their train paths, in a fresh interpreter with jax, flax, optax, PyYAML and
h5py blocked (``tests.test_torch_import._run``)."""

from tests.test_torch_import import _run


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


def test_idam_train_path_runs_without_jax_flax_yaml_or_h5py(tmp_path):
    """IDAM's train path through ``engine.train_registration`` on the CPU,
    one epoch of two steps at idam_smoke.yaml's size (emb 32, 2 iterations,
    128 points, batch 4): the edge blocks' and similarity MLPs' train modes,
    the sampled kept points and the three losses take their plain versions;
    the losses and every gradient come out finite, the running statistics
    move, and the val pass writes its checkpoints."""
    out = _run(
        "import json, os, sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
        "import torch\n"
        "from mvp_benchmark_tpu_torch.train import config, engine\n"
        "cfg = config.load_config('registration/cfgs/idam_smoke.yaml', nepoch=1)\n"
        f"res = engine.train_registration(cfg, {str(tmp_path)!r}, {str(tmp_path)!r},\n"
        "    max_steps_per_epoch=2, device=torch.device('cpu'))\n"
        "m = res['model']\n"
        "print(json.dumps({'losses': res['history']['step_losses'][0],\n"
        "  'grads': all(bool(torch.isfinite(p.grad).all()) for p in m.parameters()),\n"
        "  'moved': float(m.gnn.props[0].edge_var.sub(1).abs().max()),\n"
        f"  'files': sorted(os.listdir({str(tmp_path)!r}))}}))\n")
    assert len(out["losses"]) == 2 and all(0 < x < 100 for x in out["losses"])
    assert out["grads"] and out["moved"] > 0
    assert "network.pkl" in out["files"] and "best_recall_network.pkl" in out["files"]
