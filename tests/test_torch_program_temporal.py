"""Temporal registry nets of `repro_torch.api` held against `repro.api` on
the CPU: batch forward, frame-by-frame streaming and state export, on the
reference's own deploy tables carried across by `repro_torch.convert`.

All comparisons are **equality**: every inter-layer tensor of these nets is
ternary or dyadic, so the sums are exact in float32 under any order (see
tests/test_torch_program.py for the spatial nets and for `quantize`).  The
reference's ``ref`` backend is not re-run here: its own suite pins
fused == ref; the port's ``ref`` is held against the reference's ``fused``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import api as japi
from repro_torch import convert

TEMPORAL_NETS = ["dvs_cnn_tcn_smoke", "dvs_cnn_tcn_micro", "dvs_cnn_tcn_nano",
                 "kws_tcn_smoke"]


def _tree_np(x):
    """The reference's tables as numpy (arrays) and Python scalars."""
    if isinstance(x, dict):
        return {k: _tree_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree_np(v) for v in x]
    return np.array(x) if hasattr(x, "shape") else x


def _inputs(graph, seed, batch=2, frames=None):
    """Seeded numpy clips: 0/1 event frames (two polarity channels), trits
    for the single-channel spectrogram net."""
    rng = np.random.RandomState(seed)
    shape = (batch, frames, *graph.input_hw, graph.input_ch)
    if graph.input_ch == 2:
        return (rng.rand(*shape) < 0.05).astype(np.float32)
    return rng.randint(-1, 2, shape).astype(np.float32)


def _reference(name, calibrated, frames, seed=0):
    prog = japi.get_net(name)
    params = prog.init(jax.random.PRNGKey(seed))
    x = _inputs(prog.graph, seed + 1, frames=frames)
    dep = prog.quantize(params, calib=jnp.asarray(x) if calibrated else None)
    return prog, params, dep, x


def _port_of(name, dep):
    return convert.deployed_from_reference_tables(name, _tree_np(dep.tables), device="cpu")


def _exact(got, want):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want))


@pytest.mark.parametrize("calibrated", [True, False], ids=["calib", "fan_in"])
@pytest.mark.parametrize("name", TEMPORAL_NETS)
def test_temporal_nets_batch_and_stream_equal_reference(name, calibrated):
    """Clips two frames longer than the ring: batch forward == reference,
    port fused == port ref, and streaming == batch at every backend."""
    steps = japi.get_graph(name).tcn_steps
    _, _, dep, x = _reference(name, calibrated, frames=steps + 2)
    port = _port_of(name, dep)
    xt = torch.from_numpy(x)
    want = np.asarray(dep.forward(jnp.asarray(x), backend="fused"))
    for backend in ("fused", "ref"):
        _exact(port.forward(xt, backend=backend), want)
        session = port.stream(batch=2, backend=backend)
        for t in range(x.shape[1]):
            logits = session.step(xt[:, t])
        _exact(logits, want)
        assert session.steps_seen == steps + 2 and session.window_warm


def test_stream_logits_equal_reference_session_every_frame():
    """Frame by frame, not only at the end: the port's lone session tracks
    the reference's through warm-up and across the ring's wrap."""
    name = "dvs_cnn_tcn_smoke"
    _, _, dep, x = _reference(name, True, frames=11)
    port = _port_of(name, dep)
    s_ref = dep.stream(batch=1, backend="fused")
    s_port = port.stream(batch=1, backend="fused")
    for t in range(x.shape[1]):
        want = s_ref.step(jnp.asarray(x[:1, t]))
        got = s_port.step(torch.from_numpy(x[:1, t]))
        _exact(got, want)
    _exact(s_port.state.ring.buf, s_ref.state.ring.buf)
    assert int(s_port.state.ring.cursor) == int(s_ref.state.ring.cursor)
    state = s_port.export_state()
    other = port.stream(batch=1, backend="ref")
    other.load_state(state)
    assert other.steps_seen == 11
    with pytest.raises(ValueError, match="ring shape"):
        port.stream(batch=3).load_state(state)
