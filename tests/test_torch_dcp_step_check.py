"""The stages of ``chip_smoke.check_dcp_step_on_cpu``, the DCP train step
check of the card against the CPU, here with the CPU in the card's place, at
a small DCP size (``registration/cfgs/dcp_smoke.yaml`` at 512 points, two
pairs of the synthetic train split, the check's seed):

- the CPU step given its own statistics (``dcp_chain_given_stats``, the
  statistics substituted by value) is the free step bitwise: loss,
  gradients and running statistics;
- stage (a) passes the plain chain's fp32 statistics against the chain in
  fp64 (``chain_stat_gaps``), which differ in summation order only (2.4e-6
  at most measured here, bar ``EDGE_STAT_NORM`` 1e-5);
- a chain whose statistics carry a 3e-5 relative bias in one layer's mean
  fails stage (a), and the CPU step given those statistics (stage (b))
  reads another loss than the free step's; stage (b) itself, which hands
  the CPU the same statistics, passes.
"""

import contextlib
import os

import pytest
import torch

import chip_smoke
from mvp_benchmark_tpu_torch import ops
from mvp_benchmark_tpu_torch.ops import ref
from mvp_benchmark_tpu_torch.train.config import load_config

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def step():
    cfg = load_config(os.path.join(chip_smoke.ROOT, "registration", "cfgs", "dcp_smoke.yaml"),
                      num_points=512)
    batch = chip_smoke._dcp_train_batch(cfg, 2)
    calls = []
    with chip_smoke.record_dcp_chain(calls):
        free = chip_smoke._dcp_step_on(cfg, CPU, batch)
    return cfg, batch, free, calls


def test_given_its_own_statistics_the_step_is_the_free_step_bitwise(step):
    cfg, batch, (loss, grads, stats), calls = step
    assert len(calls) == 2                       # src and tgt
    with chip_smoke.dcp_chain_given_stats([c[4] for c in calls]):
        got_loss, got_grads, got_stats = chip_smoke._dcp_step_on(cfg, CPU, batch)
    assert got_loss == loss
    assert got_grads.keys() == grads.keys()
    assert all(torch.equal(got_grads[n], g) for n, g in grads.items())
    assert all(torch.equal(got_stats[n], s) for n, s in stats.items())


def test_stage_a_passes_statistics_in_another_summation_order(step):
    gaps = chip_smoke.chain_stat_gaps(step[3])
    assert [len(call) for call in gaps] == [4, 4]
    worst = max(g for call in gaps for layer in call for g in layer)
    assert 0 < worst <= chip_smoke.EDGE_STAT_NORM, gaps


@contextlib.contextmanager
def _biased_chain(layer, rel=3e-5):
    """The plain chain, its statistics (used and returned) with layer
    ``layer``'s mean times 1 + ``rel``."""
    saved = ops.edge_mlp_train

    def chain(a1, Ws, gammas, betas):
        _, stats = ref.edge_mlp_train(a1, Ws, gammas, betas)
        stats = [s.clone() for s in stats]
        stats[layer][0] *= 1 + rel
        return ref.edge_mlp_train(a1, Ws, gammas, betas, given=stats)

    ops.edge_mlp_train = chain
    try:
        yield
    finally:
        ops.edge_mlp_train = saved


@pytest.mark.parametrize("layer", [0, 3])
def test_a_biased_mean_fails_stage_a_and_moves_the_given_step(step, layer):
    cfg, batch, free, _ = step
    r = chip_smoke.dcp_step_stages(cfg, CPU, batch, free, lambda: _biased_chain(layer))
    assert min(call[layer][0] for call in r["stat_gaps"]) > chip_smoke.EDGE_STAT_NORM
    below = [g for call in r["stat_gaps"] for pair in call[:layer] for g in pair]
    assert all(g <= chip_smoke.EDGE_STAT_NORM for g in below), r["stat_gaps"]
    assert r["given"]["cpu_loss"] != free[0]
    # stage (b) runs the CPU on the biased statistics too, so only (a) sees them
    assert not chip_smoke.dcp_step_failures(r["given"])
