"""`repro_torch.train.evaluate` on eval batches of differing shapes: one
captured forward per (shape, dtype) of the batches, as the reference's
``jax.jit`` keeps one executable per shape.  On `cifar10_tnn_smoke`, seed 0,
a pipeline whose eval batches alternate 4 and 3 rows: ``n_examples`` and the
QAT and deployed hits equal the reference's `evaluate` and the port's plain
forwards exactly (tolerance 0: hit counts are integers)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api.program import CutieProgram as ProgramJ
from repro.api.registry import get_graph as get_graph_j
from repro.data.pipeline import pipeline_for_net as pipeline_j
from repro.train import evaluate as evaluate_j
from repro_torch import convert
from repro_torch.api.program import CutieProgram
from repro_torch.api.registry import get_graph
from repro_torch.data.pipeline import pipeline_for_net
from repro_torch.train import evaluate
from repro_torch.train.evaluate import eval_batches

NET = "cifar10_tnn_smoke"


class Alternating:
    """A pipeline whose batch at an odd step keeps its first 3 rows of 4."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.state = pipe.state

    def batch_at(self, step: int):
        x, y = self.pipe.batch_at(step)
        return (x[:3], y[:3]) if step % 2 else (x, y)


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def setup():
    gj = dataclasses.replace(get_graph_j(NET), qat_per_channel=True)
    gt = dataclasses.replace(get_graph(NET), qat_per_channel=True)
    pj, pt = ProgramJ(gj), CutieProgram(gt)
    params = pj.init(jax.random.PRNGKey(0))
    return pj, pt, params


def _plain_hits(pt, params, deployed, pipe, n):
    hq = hd = total = 0
    with torch.no_grad():
        for x, y in eval_batches(pipe, n):
            xt = torch.from_numpy(np.asarray(x))
            hq += int((pt.forward_qat(params, xt).argmax(-1).numpy() == y).sum())
            hd += int((deployed.forward(xt, backend="fused").argmax(-1).numpy() == y).sum())
            total += len(y)
    return hq, hd, total


@pytest.mark.parametrize("n_batches", [2, 4])
def test_alternating_batches_equal_the_reference_and_the_plain_forwards(setup, n_batches):
    pj, pt, params = setup
    pipe_j = Alternating(pipeline_j(pj.graph, 4, seed=0))
    dep_j = pj.quantize(params, calib=pipe_j.batch_at(0)[0])
    want = evaluate_j(pj, params, pipe_j, deployed=dep_j, n_batches=n_batches)

    pipe_t = Alternating(pipeline_for_net(pt.graph, 4, seed=0))
    dep_t = convert.deployed_from_reference_tables(pt.graph, _np_tree(dep_j.tables),
                                                   device="cpu")
    params_t = convert.params_from_reference(_np_tree(params), device="cpu")
    got = evaluate(pt, params_t, pipe_t, deployed=dep_t, n_batches=n_batches)

    n = 4 * ((n_batches + 1) // 2) + 3 * (n_batches // 2)
    assert got.n_examples == want.n_examples == n
    assert got.qat_accuracy == want.qat_accuracy
    assert got.deployed_accuracy == want.deployed_accuracy
    hq, hd, total = _plain_hits(pt, params_t, dep_t, pipe_t, n_batches)
    assert (got.qat_accuracy, got.deployed_accuracy, got.n_examples) == (
        hq / total, hd / total, total)
    # one build of each forward per batch shape: (4, ...) and (3, ...)
    assert got.step_builds == 2 * 2


def test_uniform_batches_build_each_forward_once(setup):
    _pj, pt, params = setup
    params_t = convert.params_from_reference(_np_tree(params), device="cpu")
    pipe = pipeline_for_net(pt.graph, 4, seed=0)
    got = evaluate(pt, params_t, pipe, n_batches=3)
    deployed = pt.quantize(params_t, calib=torch.from_numpy(eval_batches(pipe, 1)[0][0]))
    hq, hd, total = _plain_hits(pt, params_t, deployed, pipe, 3)
    assert (got.qat_accuracy, got.deployed_accuracy, got.n_examples) == (
        hq / total, hd / total, total)
    assert got.n_examples == 12 and got.step_builds == 2
