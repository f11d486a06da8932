"""`BatchClassifier` — a spatial net served as a fixed-batch image
classifier (`DeployedProgram.classify`, ``launch/serve.py --classify``) —
held on the CPU against the deploy forward and the benchmark's plain
reference (``cellbench/reference/cutie.py``) at ``cifar10_tnn_smoke``, with
weights drawn from a seed; every comparison is equality.  The captured
step runs only on a card: the ``gpu``-marked test at the end (and
``chip_smoke.py``) holds it at full width there.
"""
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api.program import CutieProgram
from repro_torch.api.registry import get_graph
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import Tracer
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving import BatchClassifier, SessionPool

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cellbench import bench  # noqa: E402
from cellbench.reference import cutie  # noqa: E402

SMOKE_CFG = json.loads((ROOT / "cellbench/tests/data/cifar10_tnn_smoke.json").read_text())
SIZES = [3, 6, 1, 2, 5, 4]  # 21 images at batch 4: requests straddle batches, the last is short
BATCH = 4
STEPS = ("classify.assemble", "classify.upload", "classify.replay", "classify.flush")


def images8(n, shape, seed):
    """Seeded 8-bit pixels ``(k - 128) / 128``: dyadic, so sums are exact."""
    k = np.random.default_rng(seed).integers(0, 256, (n, *shape))
    return ((k - 128) / 128).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    """The smoke net quantized from seeded weights, the reference's tables
    derived from the same weights and calibration, and the images."""
    cfg = SMOKE_CFG
    params = bench.make_params(cfg, 7, torch.device("cpu"))
    images = images8(sum(SIZES), (*cfg["input_hw"], cfg["input_ch"]), 7)
    calib = torch.from_numpy(images[:16])
    deployed = CutieProgram(get_graph(cfg["registry"])).quantize(params, calib=calib)
    return deployed, cutie.derive(cfg, params, calib), images


def submit_all(clf, images, sizes=SIZES):
    ends = np.cumsum(sizes)
    for i, (lo, hi) in enumerate(zip(ends - sizes, ends)):
        clf.submit(f"r{i}", images[lo:hi])


def test_every_answered_image_equals_the_ref_forward_and_the_plain_reference(smoke):
    deployed, tables, images = smoke
    clf = deployed.classify(BATCH)
    assert isinstance(clf, BatchClassifier) and clf.tracer is NULL_TRACER
    submit_all(clf, images)
    answers = clf.run()
    assert [rid for rid, _ in answers] == [f"r{i}" for i in range(len(SIZES))]
    assert [len(logits) for _, logits in answers] == SIZES
    got = np.concatenate([logits for _, logits in answers])
    x = torch.from_numpy(images)
    want = deployed.forward(x, backend="ref").numpy()
    assert np.abs(want).max() > 0  # live activations: the comparison is not of zeros
    assert np.array_equal(got, want)
    assert np.array_equal(got, cutie.spatial(SMOKE_CFG, tables, x).numpy())
    assert clf.trace_count == 1 and not clf.captured  # eager on the CPU


def test_requests_straddle_batches_and_padding_is_never_answered_or_counted(smoke):
    deployed, _, images = smoke
    clf = deployed.classify(BATCH)
    submit_all(clf, images)
    assert clf.queue_depth == sum(SIZES) and clf.pending
    ticks = []
    while clf.pending:
        n, departed = clf.tick()
        ticks.append((n, [rid for rid, _ in departed]))
    # each batch's logits reach the host one tick after its step, while
    # untaken images remain; r1's 6 images span batches 0-2; the last tick
    # takes the last image (and 3 zero rows) and flushes batches 4 and 5
    assert ticks == [(0, []), (4, ["r0"]), (4, []), (4, ["r1", "r2", "r3"]), (4, []),
                     (5, ["r4", "r5"])]
    assert clf.images_stepped == sum(SIZES) and clf.queue_depth == 0 and not clf.inflight
    assert not clf.x[1:].any()  # the short batch's padding rows are zero images
    assert clf.tick() == (0, []) and clf.tick_index == len(ticks) + 1
    assert clf.images_stepped == sum(SIZES)


def test_a_traced_run_spans_every_stepping_tick_once(smoke):
    deployed, _, images = smoke
    tracer = Tracer(capacity=4096)
    clf = deployed.classify(BATCH, tracer=tracer)
    submit_all(clf, images)
    clf.run()
    clf.tick()  # nothing queued: a tick span of 0 images, nothing under it
    events = tracer.events()
    names = Counter(e.name for e in events if e.phase == "X")
    # six stepping ticks; every one but the first flushes, once
    assert {name: names[name] for name in STEPS} == {**{name: 6 for name in STEPS[:3]},
                                                    "classify.flush": 5}
    assert names["classify.tick"] == 7
    ticks = [e.args for e in events if e.name == "classify.tick"]
    assert [a["images"] for a in ticks] == [4] * 5 + [1, 0]
    assert [a["inflight"] for a in ticks] == [1] * 5 + [0, 0]
    flushes = [e.args for e in events if e.name == "classify.flush"]
    assert [a["rows"] for a in flushes] == [4, 4, 4, 4, 5]
    assert all(a["waited_us"] == 0.0 for a in flushes)  # no events to wait on, on the CPU
    assert [e.args["classify.queue_depth"] for e in events
            if e.name == "classify.queue_depth"] == [21, 17, 13, 9, 5, 1, 0]
    assert sum(e.name == "classify.build" for e in events) == 1
    assert all(e.track == "cifar10_tnn_smoke" for e in events)
    assert not any(e.name.startswith("dev.") for e in events)  # no device spans on the CPU
    # untraced, the same answers
    again = deployed.classify(BATCH)
    submit_all(again, images)
    assert again.tracer is NULL_TRACER
    traced = deployed.classify(BATCH, tracer=Tracer())
    submit_all(traced, images)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(again.run(), traced.run()))


def test_submits_between_ticks_keep_answers_exact_and_in_order(smoke):
    """A closed loop: each departed request is replaced by the next one,
    submitted between ticks while a batch is on the card."""
    deployed, _, images = smoke
    sizes = [3, 5, 2, 7, 1, 4, 6, 2, 3, 1, 5, 2]
    ends = np.cumsum(sizes)
    pool = np.concatenate([images, images])[:ends[-1]]
    clf = deployed.classify(BATCH)
    nxt, answers, ticks, deferred = 0, [], 0, 0

    def submit_next():
        nonlocal nxt
        clf.submit(f"q{nxt}", pool[ends[nxt] - sizes[nxt]:ends[nxt]])
        nxt += 1

    for _ in range(4):
        submit_next()
    while clf.pending:
        _, departed = clf.tick()
        ticks += 1
        deferred += clf.inflight
        answers.extend(departed)
        for _ in departed:
            if nxt < len(sizes):
                submit_next()
    assert [rid for rid, _ in answers] == [f"q{i}" for i in range(len(sizes))]
    assert [len(a) for _, a in answers] == sizes
    got = np.concatenate([a for _, a in answers])
    assert np.array_equal(got, deployed.forward(torch.from_numpy(pool), backend="ref").numpy())
    assert clf.images_stepped == ends[-1] and ticks == clf.tick_index
    assert 0 < deferred < ticks  # the pipeline engaged, and the drain flushed in its tick
    # a lone short request is answered in the tick that steps it
    tracer = Tracer(capacity=64)
    lone = deployed.classify(BATCH, tracer=tracer)
    lone.submit("one", images[:2])
    n, departed = lone.tick()
    assert n == 2 and [rid for rid, _ in departed] == ["one"] and not lone.inflight
    assert np.array_equal(departed[0][1],
                          deployed.forward(torch.from_numpy(images[:2]), backend="ref").numpy())
    tick = next(e for e in tracer.events() if e.name == "classify.tick")
    assert tick.args == {"images": 2, "inflight": 0}


def test_consecutive_batches_use_the_two_host_batches_in_turn(smoke, monkeypatch):
    """Batch k goes into host batch k % 2, and the host batch of the batch
    on the card is not written until that batch is flushed."""
    deployed, _, images = smoke
    clf = deployed.classify(BATCH)
    submit_all(clf, images)
    assemble = BatchClassifier._assemble
    written = []

    def spy(self, slot):
        if self._inflight is not None:
            assert slot != self._inflight.slot  # the batch on the card keeps its host batch
        written.append(slot)
        return assemble(self, slot)

    monkeypatch.setattr(BatchClassifier, "_assemble", spy)
    while clf.pending:
        held = clf._inflight
        kept = None if held is None else clf._images_np[held.slot].copy()
        clf.tick()
        if held is not None:  # flushed this tick, and not rewritten in it
            assert np.array_equal(clf._images_np[held.slot], kept)
    assert written == [0, 1, 0, 1, 0, 1]
    assert clf._images_np[0] is not clf._images_np[1]


def test_the_pool_refuses_a_spatial_net_and_the_classifier_a_temporal_one(smoke):
    deployed, _, images = smoke
    with pytest.raises(ValueError, match=r"no TCN memory to pool.*classify\(\)"):
        SessionPool(deployed, 2)
    with pytest.raises(ValueError, match=r"no TCN memory to pool.*classify\(\)"):
        deployed.serve(2)
    nano = CutieProgram(get_graph("dvs_cnn_tcn_nano"))
    temporal = nano.quantize(nano.init(torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError, match=r"TCN memory.*serve\(\)"):
        temporal.classify(4)
    clf = deployed.classify(BATCH)
    with pytest.raises(ValueError, match="are not"):
        clf.submit("bad", images[0])  # one image without its batch axis
    with pytest.raises(ValueError, match="are not"):
        clf.submit("empty", images[:0])
    clf.submit("a", images[:2])
    with pytest.raises(ValueError, match="already queued"):
        clf.submit("a", images[2:4])
    with pytest.raises(ValueError, match="batch must be"):
        deployed.classify(0)


def test_the_launcher_serves_the_classify_scenario(capsys):
    assert launch_serve.main(["--classify", "--net", "cifar10_tnn_smoke", "--device", "cpu",
                              "--batch", "4", "--requests", "6"]) == 0
    out = capsys.readouterr().out
    assert "served == eager forward on every answered image: True" in out
    assert launch_serve.main(["--classify", "--net", "dvs_cnn_tcn_nano",
                              "--device", "cpu"]) == 2


@pytest.mark.gpu
def test_the_captured_classifier_at_full_width_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step is captured as a CUDA graph there")
    from repro_torch.kernels.ternary_conv2d import ternary_conv2d_cuda
    from repro_torch.obs.device import resolve_pending

    graph = get_graph("cifar10_tnn")
    prog = CutieProgram(graph)
    sizes = [100, 300, 7, 200, 250]  # 857 images: 3 full batches of 256 and a short one
    images = images8(sum(sizes), (*graph.input_hw, graph.input_ch), 11)
    deployed = prog.quantize(prog.init(torch.Generator().manual_seed(11), device="cuda"),
                             calib=torch.from_numpy(images[:16]).cuda())
    tracer = Tracer(capacity=1 << 14)
    clf = deployed.classify(256, tracer=tracer)
    clf._device_spans.min_gap_ns = 0  # time every step
    submit_all(clf, images, sizes)
    ternary_conv2d_cuda.launches = 0
    answers = clf.run()
    resolve_pending(tracer)
    assert clf.captured and clf.trace_count == 1 and clf.step.k1_per_replay == 8
    assert ternary_conv2d_cuda.launches == 8 * 4  # the eager build tick, then 3 replays
    got = np.concatenate([logits for _, logits in answers])
    # the eager fused forward launches the same K1 as the replays; "ref" is
    # the plain float32 path, which holds K1 itself at this batch and input
    for backend in ("fused", "ref"):
        want = torch.cat([deployed.forward(torch.from_numpy(images[i:i + 256]).cuda(),
                                           backend=backend)
                          for i in range(0, len(images), 256)]).cpu().numpy()
        assert np.array_equal(got, want) and np.abs(want).max() > 0, backend
    ev = tracer.events()
    assert all(e.args["pinned"] for e in ev if e.name == "classify.upload")
    # three full batches leave the queue untaken images; the short one drains it
    assert [e.args["inflight"] for e in ev if e.name == "classify.tick"] == [1, 1, 1, 0]
    assert [e.args["rows"] for e in ev if e.name == "classify.flush"] == [256, 256, 345]
    replays = [e for e in ev if e.name == "dev.replay"]
    assert len(replays) == 4 and [e.args["k1"] for e in replays] == [8, 8, 8, 8]
    assert {e.track for e in replays} == {"cifar10_tnn.device"}
