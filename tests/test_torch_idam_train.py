"""IDAM's train branch in the torch port against the JAX package, on the CPU.

Sizes: the smoke config's emb 32 and 2 iterations on test_torch_idam.py's
two clouds of 192 grid points (M = 32 kept), the JAX model's parameters
transplanted, its BatchNorm scales and biases random. The kept source
points are handed to both packages (the port takes ``src_idx``; JAX's
``sample`` is replaced while its step runs, ``_jax_sampling``), drawn by
``idam.sample_src_idx`` from the ground-truth matches.

JAX runs op by op (``jax.disable_jit()``): jitted on XLA:CPU, its train
step's GNN leaves come out 5-6% from the op-by-op ones normwise (measured on
these inputs; the edge block's ``jnp.maximum(., 0)`` relu is the pattern
whose jitted cotangent XLA:CPU drops in DGCNN's edge chain, see
test_torch_dcp_train.py).
Every JAX call here has the same shapes, so XLA compiles each primitive
once for the file.

Rounding: ops/ref.py's rule, JAX's CPU autodiff's (the cotangents of bf16
product inputs and the product weights' gradients round to bf16). What is
held, each bar and its measured value in the test's docstring:

- the plain train versions against ``gnn_propagate_reference`` and
  ``sim_mlp_reference`` under ``jax.grad``;
- the unfused edge block's backward (``gnn_edge_train``, closed as covered
  by the fused one);
- each Propagate layer on JAX's own input, forward with batch statistics
  and backward from a seeded cotangent;
- the head (all after the GNN) on JAX's embeddings, a whole train step:
  the loss, every gradient leaf outside the GNN and the embeddings'
  cotangents, and the updated running statistics;
- a whole step with the port's own GNN (by direction: the gradient is a
  step function at the scale of the two GNNs' gap);
- ``engine.train_registration`` for two steps against JAX's train step on
  the same batches, kept points and correspondences, and the checkpoint it
  writes loaded by the JAX package;
- the launch counts of a train step, ``chip_smoke.IDAM_PER_STEP``.

Leaves whose gradient is zero in exact arithmetic (``idam.SHIFT_INVARIANT``)
are rounding noise in both packages; they are held to 1e-4 of the whole
gradient's norm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.models import idam as jidam
from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels as pk
from mvp_benchmark_tpu_torch.models import idam as tidam
from mvp_benchmark_tpu_torch.models.transplant import (load_flax_params, to_flax_grads,
                                                       to_flax_params)
from mvp_benchmark_tpu_torch.ops import ref
from tests.test_torch_idam import _inputs, _random_bn_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMB, ITERS = 32, 2
B, N = 2, 192
M = N // 6


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return np.linalg.norm(a - b) / den if den > 0 else float(np.linalg.norm(a - b) > 0)


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_sampling(monkeypatch, queue):
    """JAX's train branch keeps the source points popped from ``queue`` (one
    (B, M) array a forward): its ``jax.vmap(sample)`` is replaced."""
    real = jax.vmap

    def vmap(fn, *args, **kw):
        if getattr(fn, "__name__", "") == "sample":
            return lambda *a: jnp.asarray(queue.pop(0))
        return real(fn, *args, **kw)

    monkeypatch.setattr(jax, "vmap", vmap)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads for this file's many small CPU operations: the test
    workers share the machine's cores, and torch's default of one thread a
    core spins when they are oversubscribed (under six workers this file
    took 1014 s with it, ~100 s alone)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _port_model(v):
    return load_flax_params(tidam.Model(EMB, ITERS), v).train()


@pytest.fixture(scope="module")
def setup():
    src, tgt, T = _inputs()
    jm = jidam.Model(emb_dims=EMB, num_iters=ITERS)
    v = jax.tree.map(np.array, jax.jit(
        lambda k, s, g: jm.init(k, s, g, None, prefix="test"))(
            jax.random.PRNGKey(0), src, tgt))
    _random_bn_params(v["params"], np.random.default_rng(1))
    t = torch.from_numpy
    _, match = tidam._gt_matches(t(src), t(tgt), t(T))
    assert bool((match == 1).all())        # every grid point has its match
    src_idx = tidam.sample_src_idx(match, M, torch.Generator().manual_seed(0)).numpy()
    return jm, v, (src, tgt, T), src_idx


def _record(module, monkeypatch):
    seen = []
    take = module._batch_take

    def record(x, idx):
        seen.append(np.asarray(idx).astype(np.int64))
        return take(x, idx)

    monkeypatch.setattr(module, "_batch_take", record)
    return seen


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's train step, op by op: (loss, outputs, grads, new batch_stats,
    intermediates (the GNN's and each Propagate's outputs), the indices it
    took: src_idx twice, tgt_idx twice, each iteration's corr_idx)."""
    jm, v, (src, tgt, T), src_idx = setup
    mp = pytest.MonkeyPatch()
    try:
        _jax_sampling(mp, [src_idx, src_idx])

        def loss_fn(p):
            out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, src, tgt,
                                T, prefix="train", capture_intermediates=True,
                                mutable=["batch_stats", "intermediates"],
                                rngs={"sample": jax.random.PRNGKey(0)})
            return jnp.mean(out[0]), (out, new)

        with jax.disable_jit():
            (loss, (out, new)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                v["params"])
            seen = _record(jidam, mp)
            jm.apply(v, src, tgt, T, prefix="train", mutable=["batch_stats"],
                     rngs={"sample": jax.random.PRNGKey(0)})
    finally:
        mp.undo()
    return (float(loss), [np.asarray(o) for o in out], grads, new["batch_stats"],
            new["intermediates"], list(seen))


def _forced_argmax(monkeypatch, queue):
    """JAX's IDAM takes its correspondences popped from ``queue`` (one
    (B, M) array an iteration) in place of ``jnp.argmax`` of sim."""

    class Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def argmax(x, axis=None):
            return jnp.asarray(queue.pop(0))

    monkeypatch.setattr(jidam, "jnp", Jnp())


def _port_step(tm, batch, src_idx, monkeypatch, embeddings=None, corr=None):
    """The port's train forward and loss.mean() backward -> (loss, outputs,
    indices taken, the embeddings' leaves when ``embeddings`` (JAX's, tgt
    then src) stand in for the GNN's). ``corr``: each iteration's
    correspondences to take in place of the port's own."""
    src, tgt, T = (torch.from_numpy(x) for x in batch)
    leaves = None
    if corr is not None:
        queue = list(corr)
        monkeypatch.setattr(tidam, "_correspondences",
                            lambda sim: torch.from_numpy(queue.pop(0)))
    if embeddings is not None:
        leaves = [torch.from_numpy(np.array(e)).requires_grad_() for e in embeddings]
        calls = []

        def gnn(pts, train=False):
            calls.append(pts)
            return leaves[len(calls) - 1]

        monkeypatch.setattr(tm.gnn, "forward", gnn)
    seen = _record(tidam, monkeypatch)
    out = tm(src, tgt, T, prefix="train", src_idx=torch.from_numpy(src_idx))
    out[0].mean().backward()
    return float(out[0]), [o.detach().numpy() for o in out], list(seen), leaves


def _hold_leaves(tm, grads, v, names, cos_bar, norm_bar):
    """Every gradient leaf of ``names`` (torch names) against JAX's: cosine
    and normwise, the shift-invariant ones against the whole norm. Returns
    the worst (cosine, normwise, shift share)."""
    want = _jax_grads_by_name(grads, v)
    total = np.sqrt(sum(float(np.sum(w * w)) for w in want.values()))
    worst = [1.0, 0.0, 0.0]
    for name, p in tm.named_parameters():
        if name not in names:
            continue
        g, w = p.grad.double().numpy(), want[name]
        if name.endswith(tidam.SHIFT_INVARIANT):
            share = np.linalg.norm(g - w) / total
            assert share <= 1e-4, (name, share)
            worst[2] = max(worst[2], share)
            continue
        cos, gap = _cosine(g, w), _normwise(g, w)
        assert cos >= cos_bar and gap <= norm_bar, (name, cos, gap)
        worst[0], worst[1] = min(worst[0], cos), max(worst[1], gap)
    return worst


def _jax_grads_by_name(grads, v):
    """{torch name: array} of a flax gradient tree of IDAM, through the
    transplant."""
    m = load_flax_params(tidam.Model(EMB, ITERS), {"params": grads,
                                                   "batch_stats": v["batch_stats"]})
    return {n: p.detach().double().numpy() for n, p in m.named_parameters()}


def _hold_stats(tm, stats, scopes, atol):
    got = _leaves(to_flax_params(tm)["batch_stats"])
    worst = 0.0
    for name, w in _leaves(stats).items():
        if any(name.startswith(s) for s in scopes):
            worst = max(worst, float(np.abs(got[name] - w).max()))
    assert worst <= atol, worst
    return worst


# --- the model against JAX's ------------------------------------------------


def test_propagate_layers_match_jax_given_its_inputs(setup, jax_step):
    """Each Propagate layer of the GNN on tgt, in train mode, on JAX's input
    to it (the step's intermediates) and the kNN of the grid cloud (exact,
    so equal), JAX's Propagate alone under jax.vjp, op by op: the output
    normwise 1e-3 (1.0e-4 measured), the updated running statistics 1e-5
    (1.2e-7); from a seeded cotangent every parameter's gradient normwise
    2e-2 (1.2e-2; JAX's own bar for its kernel against its reference) but
    the two shift-invariant biases, held to 1e-4 of the layer's whole
    gradient, and the input's 5e-2 (1.2e-2: d_p = bf16(incoming) - outgoing
    of two nearly equal sums, so a bf16 rounding of the first on the other
    neighbour weighs much in the difference)."""
    jm, v, (src, tgt, T), _ = setup
    inter = jax_step[4]["GNN_0"]
    idx = jnp_ref.knn_indices(jnp.asarray(tgt), 12)
    tm = _port_model(v)
    x = tgt
    rng = np.random.default_rng(7)
    worst = {"x": 0.0, "stats": 0.0, "grad": 0.0, "dx": 0.0}
    for i, prop in enumerate(tm.gnn.props):
        jp = jidam.Propagate(EMB if i == 4 else 64)
        scope = f"Propagate_{i}"
        pv = {"params": v["params"]["GNN_0"][scope],
              "batch_stats": v["batch_stats"]["GNN_0"][scope]}
        r = rng.standard_normal((B, N, EMB if i == 4 else 64)).astype(np.float32)

        def f(p, xx):
            out, new = jp.apply({"params": p, "batch_stats": pv["batch_stats"]}, xx, idx,
                                True, mutable=["batch_stats"])
            return out, new["batch_stats"]

        with jax.disable_jit():
            jout, vjp, jstats = jax.vjp(f, pv["params"], jnp.asarray(x), has_aux=True)
            jgp, jgx = vjp(jnp.asarray(r))
        xt = torch.from_numpy(np.array(x)).requires_grad_()
        out = prop(xt, torch.from_numpy(np.asarray(idx)), train=True)
        params = dict(prop.named_parameters())
        grads = torch.autograd.grad(out, [xt, *params.values()], torch.from_numpy(r))
        worst["x"] = max(worst["x"], _normwise(out.detach(), jout))
        assert worst["x"] <= 1e-3, (i, worst)
        for name, w in (("edge_mean", jstats["edge_mean"]), ("edge_var", jstats["edge_var"])):
            worst["stats"] = max(worst["stats"],
                                 float(np.abs(getattr(prop, name).numpy() - w).max()))
        assert worst["stats"] <= 1e-5, (i, worst)
        want = {"fc.weight": np.asarray(jgp["TorchDense_0"]["kernel"]).T,
                "edge_W": jgp["edge_W"], "edge_b": jgp["edge_b"],
                "edge_scale": jgp["edge_scale"], "edge_bias": jgp["edge_bias"],
                "conv.denses.0.weight": np.asarray(
                    jgp["ConvBlock_0"]["TorchDense_0"]["kernel"]).T,
                "conv.denses.0.bias": jgp["ConvBlock_0"]["TorchDense_0"]["bias"]}
        total = np.sqrt(sum(float(np.sum(np.asarray(w, np.float64) ** 2))
                            for w in want.values()))
        worst["dx"] = max(worst["dx"], _normwise(grads[0], jgx))
        assert worst["dx"] <= 5e-2, (i, worst)
        for (name, _), g in zip(params.items(), grads[1:]):
            if name.endswith(tidam.SHIFT_INVARIANT):
                assert np.linalg.norm(g.numpy() - want[name]) <= 1e-4 * total, (i, name)
                continue
            gap = _normwise(g, want[name])
            worst["grad"] = max(worst["grad"], gap)
            assert gap <= 2e-2, (i, name, gap)
        x = np.asarray(inter[scope]["__call__"][0])
    print(f"Propagate layers against JAX on its inputs: {worst}")


def test_head_matches_jax_given_its_embeddings(setup, jax_step, monkeypatch):
    """Everything after the GNN, a whole train step, on JAX's embeddings
    (the port's GNN hands them back as leaves), the same kept points: the
    taken indices (src_idx, tgt_idx, each iteration's correspondences)
    equal; the loss and the four metrics within 1e-4 relative (the loss
    2.4e-7 measured); every gradient leaf outside the GNN by cosine 0.9999
    (0.99998) and normwise 2e-2 (6.9e-3, sim1_Wcat), the shift-invariant ones
    to 1e-4 of the whole norm (6.1e-7); the embeddings' cotangents by
    cosine 0.9999 and normwise 5e-3 (8.9e-4); the updated running
    statistics outside the GNN to 1e-5 (3.7e-6)."""
    jm, v, batch, src_idx = setup
    jloss, jout, grads, jstats, inter, jidx = jax_step
    tm = _port_model(v)
    embs = inter["GNN_0"]["__call__"]
    loss, out, idx, leaves = _port_step(tm, batch, src_idx, monkeypatch, embs)
    assert len(idx) == len(jidx) == 4 + ITERS
    for n, (g, w) in enumerate(zip(idx, jidx)):
        np.testing.assert_array_equal(g, w, err_msg=f"taken index {n}")
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    for g, w in zip(out[1:], jout[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    names = [n for n, _ in tm.named_parameters() if not n.startswith("gnn.")]
    worst = _hold_leaves(tm, grads, v, names, 0.9999, 2e-2)

    # JAX's cotangents of the embeddings: its loss as a function of them
    def head(e_t, e_s):
        queue = [e_t, e_s]
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(jidam.GNN, "__call__", lambda self, pts, train: queue.pop(0))
            _jax_sampling(mp, [src_idx])
            out, _ = jm.apply(v, *batch, prefix="train", mutable=["batch_stats"],
                              rngs={"sample": jax.random.PRNGKey(0)})
        finally:
            mp.undo()
        return jnp.mean(out[0])

    with jax.disable_jit():
        je = jax.grad(head, (0, 1))(*map(jnp.asarray, embs))
    emb_gaps = [(_cosine(l.grad, w), _normwise(l.grad, w)) for l, w in zip(leaves, je)]
    assert all(c >= 0.9999 and g <= 5e-3 for c, g in emb_gaps), emb_gaps
    stat = _hold_stats(tm, jstats, ("['ConvBlock", "['sim"), 1e-5)
    print(f"IDAM head on JAX's embeddings: loss {loss!r} / {jloss!r}; leaves outside "
          f"the GNN: worst cosine, normwise, shift share {worst}; embeddings' "
          f"cotangents {emb_gaps}; running statistics {stat!r}")


def test_train_step_matches_jax(setup, jax_step, monkeypatch):
    """A whole train step with the port's own GNN, the same parameters and
    kept points. The GNN's bf16 gather table turns one-ulp differences of
    the two frameworks' projections into 2^-8 of a table entry
    (test_torch_idam.py): the embeddings come out 6.4e-3 apart normwise, and
    a correspondence (an argmax of sim) flips where two similarities nearly
    tie (1 of 64 in the first iteration on these inputs), so JAX's
    correspondences are handed to the port. The gradient of a model whose
    activations round to bf16 is a step function at that scale: the port's
    own head gradient moves by 5-12% normwise when its embeddings move by
    1e-4 (printed by this test), so the leaves are held by direction, the
    tight checks being the staged ones above. Held: the gt matches equal
    (the expansion on both sides); the loss within 1e-3 relative (4.4e-4
    measured); every gradient leaf by cosine 0.85 (0.91 measured, the GNN's
    first projection), the shift-invariant ones to 1e-3 of the whole
    gradient's norm (4.6e-4); every updated running statistic to 1e-3
    (9.3e-5); the transplant's gradient tree has JAX's leaves
    (``to_flax_grads``)."""
    jm, v, batch, src_idx = setup
    jloss, jout, grads, jstats, inter, jidx = jax_step
    tm = _port_model(v)
    loss, out, idx, _ = _port_step(tm, batch, src_idx, monkeypatch, corr=jidx[4:])
    for n, (g, w) in enumerate(zip(idx[:4], jidx[:4])):
        np.testing.assert_array_equal(g, w, err_msg=f"taken index {n}")
    assert abs(loss - jloss) <= 1e-3 * abs(jloss)
    want = _jax_grads_by_name(grads, v)
    total = np.sqrt(sum(float(np.sum(w * w)) for w in want.values()))
    cos, shift = {}, {}
    for name, p in tm.named_parameters():
        g = p.grad.double().numpy()
        if name.endswith(tidam.SHIFT_INVARIANT):
            shift[name] = np.linalg.norm(g - want[name]) / total
        else:
            cos[name] = _cosine(g, want[name])
    worst = min(cos, key=cos.get)
    assert cos[worst] >= 0.85 and max(shift.values()) <= 1e-3, (worst, cos[worst], shift)
    stat = _hold_stats(tm, jstats, ("",), 1e-3)
    assert sorted(_leaves(to_flax_grads(tm)["params"])) == sorted(_leaves(grads))
    embs = inter["GNN_0"]["__call__"]
    moved = {}
    for eps in (0.0, 1e-4):
        head = _port_model(v)
        noise = np.random.default_rng(5)
        mp = pytest.MonkeyPatch()
        try:
            _port_step(head, batch, src_idx, mp, [np.asarray(e) * (1 + eps * noise.standard_normal(
                e.shape)).astype(np.float32) for e in embs], corr=jidx[4:])
        finally:
            mp.undo()
        moved[eps] = {n: p.grad.double().numpy() for n, p in head.named_parameters()
                      if p.grad is not None and not n.endswith(tidam.SHIFT_INVARIANT)}
    own = max(_normwise(moved[1e-4][n], moved[0.0][n]) for n in moved[0.0])
    print(f"IDAM train step against JAX: loss {loss!r} / {jloss!r}; worst cosine "
          f"{cos[worst]!r} ({worst}); shift-invariant shares <= {max(shift.values())!r}; "
          f"running statistics {stat!r}; the port's own head gradient moves by "
          f"{own!r} normwise under a 1e-4 move of its embeddings")


def test_train_registration_follows_jax_and_its_checkpoint_loads(tmp_path):
    """Two steps of ``engine.train_registration`` (idam_smoke.yaml at 192
    points, batch 2, Adam 1e-3) against the JAX package's train step, op by
    op, from the same initial parameters on the same batches, kept source
    points and correspondences (the port's, recorded and handed to JAX: a
    near-tied argmax flips between the two frameworks, see
    test_train_step_matches_jax): the first step's loss within rtol 1e-3
    (4.9e-4 measured), the second's 5e-2 (1.6e-2: Adam's first update is
    lr sign(g), and the gradient is a step function at the scale of the
    first step's gaps, see test_train_step_matches_jax). Then the
    checkpoint: ``network.pkl`` and the five ``best_*`` on disk;
    ``network.pkl`` loads in the JAX package (``checkpoint.load_model``,
    flax layout, ``params`` and ``batch_stats``), holds the port's
    parameters and running statistics bitwise (and loads back into the port
    bitwise), and the JAX model's test branch on it gives finite rigid
    poses. (Its poses are not held to the port's: with these random-weight
    significance scores the top-k kept points flip between the frameworks,
    see test_torch_idam.py.)"""
    from mvp_benchmark_tpu.train import checkpoint as jckpt
    from mvp_benchmark_tpu.train import engine as jengine
    from mvp_benchmark_tpu.train import optim as joptim
    from mvp_benchmark_tpu.train.config import load_config as jload
    from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPRegistrationDataset
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config

    cfg_path = os.path.join(ROOT, "registration", "cfgs", "idam_smoke.yaml")
    cfg = load_config(cfg_path, work_dir=str(tmp_path), nepoch=1, num_points=N,
                      batch_size=B)
    data = str(tmp_path / "nodata")
    cpu = torch.device("cpu")
    init = to_flax_params(engine.build_model(cfg, cpu, seed=1, for_training=True))
    drawn, corr = [], []
    sample, correspondences = tidam.sample_src_idx, tidam._correspondences
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tidam, "sample_src_idx",
                   lambda *a: (drawn.append(sample(*a).numpy()), torch.from_numpy(drawn[-1]))[1])
        mp.setattr(tidam, "_correspondences",
                   lambda sim: (corr.append(correspondences(sim).numpy()),
                                torch.from_numpy(corr[-1]))[1])
        res = engine.train_registration(cfg, str(tmp_path), data, max_steps_per_epoch=2,
                                        device=cpu)
    finally:
        mp.undo()
    got = res["history"]["step_losses"][0]
    assert len(drawn) == 2
    corr = corr[:2 * ITERS]            # the two steps' (the val pass's follow)

    jm = jidam.Model(emb_dims=EMB, num_iters=ITERS)
    tx = joptim.build_optimizer(jload(cfg_path))
    step = jengine.make_train_step(jm, tx, "registration")
    params, stats = init["params"], init["batch_stats"]
    opt_state = tx.init(params)
    ds = MVPRegistrationDataset("train", max_angle=45.0, max_trans=0.5, data_dir=data,
                                num_points=N, seed=1)
    want = []
    mp = pytest.MonkeyPatch()
    try:
        _jax_sampling(mp, list(drawn))
        _forced_argmax(mp, list(corr))
        for batch in list(ds.batches(BatchSpec(B, shuffle=True, seed=1), 0))[:2]:
            with jax.disable_jit():
                params, stats, opt_state, aux = step(
                    params, stats, opt_state,
                    {k: jnp.asarray(batch[k]) for k in ("src", "tgt", "transform")},
                    jnp.asarray(1.0), jax.random.PRNGKey(0))
            want.append(float(aux["total_loss"]))
    finally:
        mp.undo()
    print(f"train_registration step losses: port {got!r}, JAX {want!r}")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    np.testing.assert_allclose(got, want, rtol=5e-2)

    names = sorted(os.listdir(tmp_path))
    assert {"network.pkl", *(f"best_{m}_network.pkl" for m in
                             ("RotE", "transE", "MSE", "RMSE", "recall"))} <= set(names)
    tree = jckpt.load_model(str(tmp_path / "network.pkl"))["net_state_dict"]
    assert sorted(tree) == ["batch_stats", "params"]
    mine = to_flax_params(res["model"])
    for coll in ("params", "batch_stats"):
        a, b = _leaves(tree[coll]), _leaves(mine[coll])
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = load_flax_params(tidam.Model(EMB, ITERS), tree)
    for (n, p), (_, q) in zip(res["model"].state_dict().items(), back.state_dict().items()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    src, tgt, _ = _inputs()
    T12 = jax.jit(lambda t, s, g: jm.apply(t, s, g, None, prefix="test"))(tree, src, tgt)
    R = np.asarray(T12)[:, :3, :3].astype(np.float64)
    assert np.isfinite(np.asarray(T12)).all()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (B, 1, 1)),
                               atol=1e-5)


# --- the plain train versions against JAX's references ------------------------


@pytest.mark.parametrize("B_,N_,k,C", [(2, 48, 5, 16), (2, 64, 12, 64), (3, 40, 12, 32)])
def test_gnn_propagate_train_matches_jax_reference(B_, N_, k, C):
    """``ref.gnn_propagate_train`` against ``gnn_propagate_reference
    (train=True)`` under ``jax.grad``, jitted (its value and gradient are
    within 1.1e-7 of op by op here): x normwise 1e-3 (1.1e-4 measured at C
    32), the statistics 1e-5 (1.5e-6), the gradients of p, W, b, gamma and
    beta 5e-3 (1.0e-4)."""
    from tests.test_torch_gnn_propagate import _inputs as propagate_inputs

    p, idx, W, b, gamma, beta, _, _ = propagate_inputs(B_ * N_ + k, B_, N_, k, C)
    dx = np.random.default_rng(k).standard_normal(p.shape).astype(np.float32)

    def f(p, W, b, g, be):
        x, st = pk.gnn_propagate_reference(p, jnp.asarray(idx), W, b, g, be, train=True)
        return jnp.sum(x * dx), (x, st)

    (_, (jx, jst)), jg = jax.jit(jax.value_and_grad(f, (0, 1, 2, 3, 4), has_aux=True))(
        *map(jnp.asarray, (p, W, b, gamma, beta)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (p, W, b, gamma, beta)]
    x, st = ref.gnn_propagate_train(ts[0], torch.from_numpy(idx), *ts[1:])
    assert not st.requires_grad and st.shape == (2, C)
    grads = torch.autograd.grad(x, ts, torch.from_numpy(dx))
    gaps = {"x": _normwise(x.detach(), jx), "stats": _normwise(st, jst)}
    for name, g, w in zip(("p", "W", "b", "gamma", "beta"), grads, jg):
        gaps[name] = _normwise(g, w)
    print(f"gnn_propagate_train against JAX ({B_}, {N_}, k {k}, C {C}): {gaps}")
    assert gaps["x"] <= 1e-3 and gaps["stats"] <= 1e-5, gaps
    assert max(gaps[n] for n in ("p", "W", "b", "gamma", "beta")) <= 5e-3, gaps


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_sim_mlp_train_matches_jax_reference(ties):
    """``ref.sim_mlp_train`` against ``sim_mlp_reference(train=True)`` under
    ``jax.grad``, op by op, test_torch_sim_mlp.py's inputs at the model's
    size here (B 2, M 32, emb 32, C 32; the primitives the train step
    above compiled): sim and wmax normwise 1e-3 (3.0e-4 measured: a few
    activations on the other bf16 neighbour), the statistics 5e-5 (8.4e-6),
    the gradients of the embeddings and of every parameter 1e-2 (3.3e-3;
    JAX's own bar for its kernel against this reference is 1.5e-2,
    tests/test_pallas_kernels.py). With duplicate targets (``ties``) wmax ties over j: the port
    routes its cotangent to the first j, JAX's autodiff splits it evenly,
    so there temb's gradient is held summed over each pair of tied targets
    (the other leaves see the same values at tied pairs either way)."""
    from tests.test_torch_sim_mlp import _inputs as sim_inputs

    M_ = M
    (src, tgt, semb, temb, *params) = sim_inputs(M_ + ties, M=M_, emb=EMB, ties=ties)[:14]
    rng = np.random.default_rng(M_ + ties)
    dsim = rng.standard_normal((2, M_, M_)).astype(np.float32)
    dw = rng.standard_normal((2, M_, 32)).astype(np.float32)

    def f(semb, temb, *pp):
        s, w, st = pk.sim_mlp_reference(jnp.asarray(src), jnp.asarray(tgt), semb, temb,
                                        *pp, train=True)
        return jnp.sum(s * dsim) + jnp.sum(w * dw), (s, w, st)

    with jax.disable_jit():
        (_, (js, jw, jst)), jg = jax.value_and_grad(f, tuple(range(12)), has_aux=True)(
            *map(jnp.asarray, (semb, temb, *params)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (semb, temb, *params)]
    s, w, (st1, st2) = ref.sim_mlp_train(torch.from_numpy(src), torch.from_numpy(tgt), *ts)
    grads = torch.autograd.grad((s, w), ts, (torch.from_numpy(dsim), torch.from_numpy(dw)))
    assert float(s.detach().abs().max()) <= 20.0
    gaps = {"sim": _normwise(s.detach(), js), "wmax": _normwise(w.detach(), jw),
            "st1": _normwise(st1, jst[0]), "st2": _normwise(st2, jst[1])}
    names = ("semb", "temb", "Wcat", "W2", "b2", "W3", "W4", "b4", "g1", "be1", "g2",
             "be2")
    for name, g, wj in zip(names, grads, jg):
        g, wj = g.numpy(), np.asarray(wj)
        if ties and name == "temb":
            h = M_ // 2
            g, wj = g[:, :h] + g[:, h:2 * h], wj[:, :h] + wj[:, h:2 * h]
        gaps[name] = _normwise(g, wj)
    print(f"sim_mlp_train against JAX (ties {ties}): {gaps}")
    assert gaps["sim"] <= 1e-3 and gaps["wmax"] <= 1e-3, gaps
    assert gaps["st1"] <= 5e-5 and gaps["st2"] <= 5e-5, gaps
    assert max(gaps[n] for n in names) <= 1e-2, gaps


def test_gnn_edge_train_backward_is_covered_by_the_fused_one():
    """``_gnn_edge_train_bwd`` (``pallas_kernels.py:4201``, the unfused edge
    block's backward; ``ops.gnn_edge`` reaches it, no model does) computes
    the fused block's per-edge cotangent da1: held against the port's plain
    ``gnn_edge_backward`` on the Pallas kernels in interpret mode at a tiny
    size (B 1, k 3, N 16, C 8, distinct neighbours). The TPU kernel rounds
    dy_h to bf16 before its products (:4072-4080), the port rounds dx1 after
    (JAX's autodiff rule): normwise 2e-2 (measured: da1 4.3e-3, dW 2.2e-3,
    dgamma 1.7e-3, dbeta 1.4e-3, db 5.4e-8)."""
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    Bq, k, Nq, C = 1, 3, 16, 8
    a1 = jnp.asarray(f(Bq, k, Nq, C)).astype(jnp.bfloat16)
    W, b, gamma, beta, dx = f(C, C) * 0.3, f(C) * 0.1, 1 + f(C) * 0.1, f(C) * 0.1, f(Bq, Nq, C)

    def loss(a1, W, b, g, be):
        x, _ = pk.gnn_edge_train(a1, W, b, g, be)
        return jnp.sum(x * dx)

    jg = jax.grad(loss, (0, 1, 2, 3, 4))(a1, *map(jnp.asarray, (W, b, gamma, beta)))
    edge = torch.from_numpy(np.asarray(a1.astype(jnp.float32))).permute(0, 2, 1, 3)
    stats = ref._batch_stats(edge)
    t = torch.from_numpy
    _, slot = ref.gnn_edge_slots(edge, t(W), t(b), t(gamma), t(beta), stats[0], stats[1])
    got = ref.gnn_edge_backward(edge, t(W), t(gamma), t(beta), stats, slot, t(dx))
    want = [np.asarray(jg[0].astype(jnp.float32)).transpose(0, 2, 1, 3), *jg[1:]]
    gaps = [_normwise(g, w) for g, w in zip(got, want)]
    print("gnn_edge_train's gradients against the port's plain backward, normwise "
          f"(da1, dW, db, dgamma, dbeta): {gaps}")
    assert max(gaps) <= 2e-2, gaps


def test_train_step_launches_what_chip_smoke_derives(monkeypatch):
    """One train step of idam.yaml (3 iterations; the counts do not depend
    on N, so at 192 points and batch 2), every tensor routed as a CUDA tensor would be and each
    kernel wrapper replaced by a stand-in around its plain version that
    counts as the wrapper does: the launches equal
    ``chip_smoke.IDAM_PER_STEP``."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.ops import dispatch, kernels
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config
    from mvp_benchmark_tpu_torch.train.optim import build_optimizer

    counts = {}

    def count(**keys):
        for k, n in keys.items():
            counts[k] = counts.get(k, 0) + n

    def propagate_forward(p, idx, W, b, gamma, beta):
        count(gnn_propagate_stat=1, gnn_propagate=1)
        stats = ref.gnn_propagate_stats(p, idx)
        x, slot = ref.gnn_propagate_slots(p, idx, W, b, gamma, beta, stats[0], stats[1])
        return x, stats, slot

    def propagate_backward(p, idx, W, gamma, beta, stats, slot, dx, need_p=True):
        count(gnn_propagate_backward=3 if need_p else 1)
        d_p, *rest = ref.gnn_propagate_backward(p, idx, W, gamma, beta, stats, slot, dx)
        return (d_p if need_p else None, *rest)

    def sim_forward(*x):
        count(sim_mlp_stat=2, sim_mlp=1)
        st1, st2 = ref.sim_mlp_batch_stats(*x[:9], *x[10:12])
        simr, wmax, argj = ref.sim_mlp_slots(*x, st1, st2)
        return simr, wmax, st1, st2, argj

    def sim_backward(*x, need_inputs=True):
        count(sim_mlp_backward=3 if need_inputs else 2)
        grads = ref.sim_mlp_backward(*x)
        return grads if need_inputs else (None,) * 4 + grads[4:]

    def knn(*a):
        count(knn=1)
        return ref.knn(*a)

    for name, fn in (("knn", knn), ("gnn_propagate_train_forward", propagate_forward),
                     ("gnn_propagate_train_backward", propagate_backward),
                     ("sim_mlp_train_forward", sim_forward),
                     ("sim_mlp_train_backward", sim_backward)):
        monkeypatch.setattr(kernels, name, fn)
    monkeypatch.setattr(dispatch, "_route", lambda *xs: "cuda")
    cfg = load_config(chip_smoke.IDAM_CFG, batch_size=2, num_points=N)
    cpu = torch.device("cpu")
    batch = next(engine.registration_dataset(cfg, "train", os.path.join(ROOT, "nodata"))
                 .batches(engine.BatchSpec(2)))
    model = engine.build_model(cfg, cpu, seed=1, for_training=True).train()
    out = engine.make_registration_train_step(
        model, build_optimizer(cfg, model.parameters()), cpu)(batch)
    assert counts == chip_smoke.IDAM_PER_STEP
    assert all(bool(torch.isfinite(o)) for o in out.values())
