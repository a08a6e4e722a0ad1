"""IDAM's Propagate backward in the two stages of ``csrc/gnn_propagate.cu``,
on the CPU.

``ref.gnn_propagate_backward_dy`` (pass 1: dy, S, dW, db) then
``ref.gnn_propagate_gather`` (d_p from dy and S, with or without the reverse
list of the graph) against ``ref.gnn_propagate_backward``, whose parity
with JAX's autodiff is held in tests/test_torch_idam_train.py: bitwise, at
small shapes with distinct and with repeated neighbours. Then the GNN's
train step routed as on the card, its wrappers replaced by these stages
over the list the GNN builds once a graph, against the CPU path: the same
gradients bitwise, one list a graph and two backward launches a layer.
"""

import numpy as np
import pytest
import torch

from mvp_benchmark_tpu_torch.ops import ref


def _case(seed, B, N, k, C, dup):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    p = f(B, N, C)
    idx = torch.from_numpy(np.argsort(rng.random((B, N, N)), axis=-1)[:, :, :k]
                           .astype(np.int32))
    if dup:   # repeated neighbours: the max ties, and a point's list repeats an edge's row
        idx[:, :, k - k // 2:] = idx[:, :, :k // 2]
    W, b = f(C, C) * 0.3, f(C) * 0.1
    gamma, beta = 1 + f(C) * 0.05, f(C) * 0.05
    stats = ref.gnn_propagate_stats(p, idx)
    _, slot = ref.gnn_propagate_slots(p, idx, W, b, gamma, beta, stats[0], stats[1])
    return p, idx, W, gamma, beta, stats, slot, f(B, N, C)


CASES = [(2, 48, 5, 16, False), (2, 64, 12, 64, False), (3, 40, 12, 32, True),
         (1, 30, 7, 32, True)]


@pytest.mark.parametrize("B,N,k,C,dup", CASES)
@pytest.mark.parametrize("with_list", [False, True], ids=["scatter", "list"])
def test_two_stages_equal_the_plain_backward_bitwise(B, N, k, C, dup, with_list):
    p, idx, W, gamma, beta, stats, slot, dx = _case(B * N + k, B, N, k, C, dup)
    dy, S, dW, db = ref.gnn_propagate_backward_dy(p, idx, W, gamma, beta, stats, slot, dx)
    lst = ref.reverse_list(idx, N) if with_list else None
    d_p = ref.gnn_propagate_gather(p, idx, gamma, stats, dy, S, lst)
    want = ref.gnn_propagate_backward(p, idx, W, gamma, beta, stats, slot, dx)
    for name, got, w in zip(("d_p", "dW", "db", "dgamma", "dbeta"),
                            (d_p, dW, db, S[1], S[0]), want):
        assert got.shape == w.shape and got.dtype == torch.float32, name
        assert torch.equal(got, w), name
    # dy is bf16-valued (the kernel stores it as bf16 without loss) and zero
    # where BatchNorm's output is not positive
    assert dy.shape == (B, N, k, C)
    assert torch.equal(dy, dy.to(torch.bfloat16).to(torch.float32))
    assert bool((dy != 0).any())


def test_gnn_train_step_over_the_shared_list_gives_the_cpu_gradients(monkeypatch):
    """IDAM's GNN (emb 32, 3 clouds of 40 points) in train mode, forward and
    backward: once on the CPU path, once routed as on the card with each
    kernel wrapper replaced by a stand-in around its plain version (the
    backward the two stages, the gather over the list it is handed): every
    parameter's gradient, the input's and the output bitwise equal; the
    GNN builds one list a graph and hands it to all five layers."""
    from mvp_benchmark_tpu_torch.models import idam
    from mvp_benchmark_tpu_torch.ops import dispatch, kernels

    pts = torch.from_numpy(np.random.default_rng(5).random((3, 40, 3)).astype(np.float32))
    dout = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 40, 32))
                            .astype(np.float32))

    def run():
        gnn = idam.GNN(32, torch.Generator().manual_seed(3))
        x = pts.clone().requires_grad_()
        out = gnn(x, train=True)
        grads = torch.autograd.grad(out, [x, *gnn.parameters()], dout)
        return out.detach(), grads

    want_out, want = run()
    counts = {}
    handed = []

    def count(key, n=1):
        counts[key] = counts.get(key, 0) + n

    def propagate_forward(p, idx, W, b, gamma, beta):
        count("gnn_propagate_stat")
        count("gnn_propagate")
        stats = ref.gnn_propagate_stats(p, idx)
        x, slot = ref.gnn_propagate_slots(p, idx, W, b, gamma, beta, stats[0], stats[1])
        return x, stats, slot

    def propagate_backward(p, idx, W, gamma, beta, stats, slot, dx, need_p=True, lst=None):
        assert lst is not None
        handed.append(lst)
        count("gnn_propagate_backward", 2 if need_p else 1)
        dy, S, dW, db = ref.gnn_propagate_backward_dy(p, idx, W, gamma, beta, stats, slot, dx)
        d_p = ref.gnn_propagate_gather(p, idx, gamma, stats, dy, S, lst) if need_p else None
        return d_p, dW, db, S[1], S[0]

    def propagate_list(idx, n):
        count("gnn_propagate_list")
        return ref.reverse_list(idx, n)

    monkeypatch.setattr(kernels, "knn", lambda *a: ref.knn(*a))
    monkeypatch.setattr(kernels, "gnn_propagate_train_forward", propagate_forward)
    monkeypatch.setattr(kernels, "gnn_propagate_train_backward", propagate_backward)
    monkeypatch.setattr(kernels, "gnn_propagate_list", propagate_list)
    monkeypatch.setattr(dispatch, "_route", lambda *xs: "cuda")
    got_out, got = run()
    assert counts == {"gnn_propagate_list": 1, "gnn_propagate_stat": 5, "gnn_propagate": 5,
                      "gnn_propagate_backward": 10}
    assert len(handed) == 5 and all(h[i].data_ptr() == handed[0][i].data_ptr()
                                    for h in handed for i in (0, 1))
    assert torch.equal(got_out, want_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
