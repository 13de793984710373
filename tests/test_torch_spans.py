"""The port's spans (``raytracercore_tpu_torch/core/spans.py``) and the
benchmark's reading of them (``rtbench/spantrace.py``), on the CPU: the
off path keeps nothing; the recorder's nesting, ``parent`` and ``top`` on
an eager frame and an eager train step; ``graph.feed`` and
``graph.replay`` in :class:`graphs.Captured`; the spans a profiler's
stretch keeps; the anchors' map onto a CPU ``torch.profiler`` run; the
idle split and ``idle_under`` on synthetic intervals; and the benchmark's
own idle filing (``rtbench/devtrace.py``), which the split leaves as it
is; ``Renderer.profile`` writes the mapped spans into its trace, eager
here and graphed on the card."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from raytracercore_tpu_torch.core import graphs, spans
from raytracercore_tpu_torch.diff import get_material_params
from raytracercore_tpu_torch.parallel import make_train_step
from raytracercore_tpu_torch.render.renderer import Renderer
from rtbench import devtrace, spantrace
from rtbench.spans import Spans
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_graphs import _FakeGraph
from test_torch_renderer import _small
from test_torch_train import _scenes, _target

PHASES = {"camera_rays", "trace_fused", "closest_hit", "film_accum"}


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts past any profiled stretch (a span outside a
    profiler ends one) and leaves the recorder off."""
    with spans.span("settle"):
        pass
    yield
    try:
        spans.stop()
    except RuntimeError:
        pass


def _renderer():
    _, thost = _small("cornell", 8, 3)
    return Renderer(thost, device="cpu", seed=4)


def _children(records, i):
    return [r[0] for r in records if r[3] == i]


def test_off_path_records_nothing():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("render.step") is spans.span("graph.replay")
    before = spans.profiled()
    r = _renderer()
    r.step(2)
    r.image()
    assert spans.profiled() == before
    spans.start()
    assert spans.stop() == []
    with pytest.raises(RuntimeError, match="not on"):
        spans.stop()


def test_eager_frame_nests_under_step_and_image():
    r = _renderer()
    spans.start()
    r.step(2)
    r.image()
    records = spans.stop()
    tops = [i for i, rec in enumerate(records) if rec[3] is None]
    assert [records[i][0] for i in tops] == ["render.step", "render.image"]
    step, image = tops
    kids = _children(records, step)
    assert set(kids) <= PHASES
    assert kids.count("camera_rays") == kids.count("film_accum") == 2
    assert _children(records, image) == ["film.tonemap", "film.to_host"]
    for i, (name, t0, t1, parent, top) in enumerate(records):
        assert t0 <= t1
        assert top == (step if i < image else image)
        if parent is not None:
            assert records[parent][1] <= t0 and t1 <= records[parent][2]


def test_eager_train_step_nests_the_optimizer():
    _, _, ta, tc = _scenes("rough", 8, 3)
    params = get_material_params(ta)
    step = make_train_step(None, torch.optim.Adam(params.values(), lr=1e-2))
    target = torch.tensor(_target(8))
    spans.start()
    step(params, ta, tc, target, 3)
    step(params, ta, tc, target, 4)
    records = spans.stop()
    tops = [i for i, rec in enumerate(records) if rec[3] is None]
    assert [records[i][0] for i in tops] == ["train.step"] * 2
    for i in tops:
        assert _children(records, i)[-1:] == ["train.optimizer"]
        assert _children(records, i).count("train.optimizer") == 1
    assert all(rec[4] in tops and rec[4] <= i
               for i, rec in enumerate(records))


def test_captured_feed_and_replay_are_spans():
    a, b = torch.zeros(4), torch.zeros(2, 3)
    cap = graphs.Captured(graph=_FakeGraph(), inputs=(a, b), outputs=None,
                          launches={}, capture_ms=0.0, pool_bytes=0,
                          label="fake")
    spans.start()
    with spans.span("train.step"):
        cap.feed(torch.ones(4), b)
        cap.replay()
        cap.replay()
    records = spans.stop()
    assert [r[0] for r in records] == ["train.step", "graph.feed",
                                       "graph.replay", "graph.replay"]
    assert all(r[3] == 0 and r[4] == 0 for r in records[1:])
    assert cap.replays == cap.graph.replays == 2
    assert torch.equal(a, torch.ones(4))


def test_profiled_stretch_keeps_spans_and_opens_no_ranges():
    r = _renderer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.step(1)
    r.image()  # the first span after the profiler stopped ends the stretch
    records = spans.profiled()
    assert records[0][0] == "render.step"
    assert {rec[0] for rec in records[1:]} <= PHASES
    assert all(rec[4] == 0 for rec in records)
    ranges = {e.name for e in prof.events()}
    assert not ({"render.step"} | PHASES) & ranges
    assert spantrace.median_us(records, "camera_rays", "render.step") > 0
    assert spantrace.median_us(records, "camera_rays", "train.step") is None
    assert spantrace.median_us([], "camera_rays", "render.step") is None


def test_eager_profile_writes_the_mapped_spans(tmp_path):
    r = _renderer()
    with open(r.profile(str(tmp_path), n=2)) as f:
        trace = json.load(f)
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "rtc.span"]
    assert [e["name"] for e in ours if e["args"]["parent"] is None] == [
        "render.step"]
    step = ours[0]
    for e in ours[1:]:
        assert e["name"] in PHASES and e["args"] == {"parent": 0, "top": 0}
        assert step["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= step["ts"] + step["dur"]
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    width = trace["rtcSpanClock"]["width_us"]
    assert ops and all(step["ts"] - width <= e["ts"] and e["ts"] + e["dur"]
                       <= step["ts"] + step["dur"] + width for e in ops)


def test_anchor_maps_a_span_over_its_op():
    x = torch.randn(400, 400)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.anchor()  # the profiler's first range costs more
        spans.start()
        anchors = [spans.anchor()]
        with spans.span("matmul"):
            torch.mm(x, x)
        anchors.append(spans.anchor())
        records = spans.stop()
    events = prof.events()
    marks = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == spans.ANCHOR)[1:]
    offset, width, drift = spans.clock_offset(anchors, marks)
    (name, s0, s1, parent, top), = spans.on_profiler_clock(records, offset)
    assert (name, parent, top) == ("matmul", None, 0)
    mm = next(e for e in events if e.name == "aten::mm")
    tol = width + abs(drift)
    assert s0 - tol <= mm.time_range.start
    assert mm.time_range.end <= s1 + tol
    assert width < s1 - s0


def test_span_profile_maps_spans_inside_the_benchmark_ranges():
    r = _renderer()
    bench = Spans()
    p = spantrace.SpanProfile()
    p.start(bench)
    with bench("step"):
        r.step(1)
    with bench("image"):
        r.image()
    p.stop()
    assert not bench.annotate
    assert [s[0] for s in p.spans if s[3] is None] == ["render.step",
                                                       "render.image"]
    ranges = {name: (r0, r1) for r0, r1, name in p.ranges}
    tol = p.anchor_width_us + abs(p.drift_us)
    for name, s0, s1, parent, _ in p.spans:
        if parent is None:
            r0, r1 = ranges[name.split(".")[1]]
            assert r0 - tol <= s0 and s1 <= r1 + tol
    assert p.launches_inside is None and p.gap_intervals == []
    assert p.idle_split() == {} and p.idle_under("render.step") == 0.0


def test_idle_split_cuts_a_gap_across_spans():
    gaps = [(10.0, 20.0), (40.0, 44.0), (60.0, 70.0)]
    program = [("a", 0.0, 15.0, None, 0), ("b", 15.0, 50.0, None, 1),
               ("c", 41.0, 43.0, 1, 1)]
    ranges = [(0.0, 55.0, "step"), (58.0, 65.0, "image")]
    split = spantrace.idle_split(gaps, program, ranges)
    assert split == pytest.approx({"a": 5e-6, "b": 7e-6, "c": 2e-6,
                                   "image": 5e-6,
                                   spantrace.OUTSIDE: 5e-6})
    assert sum(split.values()) == pytest.approx(2.4e-5)
    assert spantrace.idle_under(gaps, program, "a") == pytest.approx(5e-6)
    assert spantrace.idle_under(gaps, program, "b") == pytest.approx(9e-6)
    assert spantrace.idle_under(gaps, program, "c") == pytest.approx(2e-6)
    assert spantrace.idle_under(gaps, program, "d") == 0.0
    assert spantrace.idle_gaps([(0, 10), (5, 12), (20, 30), (29, 31)]) == [
        (12, 20)]


def _event(name, t0, t1, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=t0, end=t1,
                                   elapsed_us=lambda: t1 - t0))


def _synthetic_events():
    cuda = DeviceType.CUDA
    return [
        _event("rtbench.step", 0.0, 25.0, annotation=True),
        _event("rtbench.image", 25.0, 55.0, annotation=True),
        _event("rtbench.step", 0.0, 25.0, cuda, annotation=True),
        _event("k1", 0.0, 10.0, cuda),
        _event("k2", 20.0, 30.0, cuda),
        _event("k1", 50.0, 60.0, cuda),
        _event(spans.ANCHOR, 0.0, 2.0, annotation=True),
        _event(spans.ANCHOR, 100.0, 102.0, annotation=True),
        _event("cudaGraphLaunch", 7.0, 8.0),
        _event("cudaGraphLaunch", 15.0, 16.0),
    ]


def _same_breakdown(got, want):
    assert set(got) == set(want)
    for key, rows in want.items():
        assert [name for name, _ in got[key]] == [name for name, _ in rows]
        assert [v for _, v in got[key]] == pytest.approx(
            [v for _, v in rows])


def test_breakdown_files_gaps_by_their_start():
    """The benchmark's filing (PR 19's rule, unchanged): a gap goes to the
    span it starts in; :class:`SpanProfile` gives the same breakdown and
    splits the same gaps between the program's spans."""
    want = {"device_ops": [["k1", 2e-5], ["k2", 1e-5]],
            "idle_gaps": [["image", 2e-5], ["step", 1e-5]]}
    p = devtrace.Profile()
    p._reduce(_synthetic_events())
    _same_breakdown(p.breakdown(), want)
    assert p.busy_s == pytest.approx(3e-5)

    sp = spantrace.SpanProfile()
    sp._recorder = spans
    sp.anchors = [(1_000_000, 1_002_000), (1_100_000, 1_102_000)]
    sp._records = [("render.step", 1_005_000, 1_028_000, None, 0),
                   ("graph.replay", 1_006_000, 1_012_000, 0, 0),
                   ("render.image", 1_029_000, 1_056_000, None, 2),
                   ("film.to_host", 1_040_000, 1_055_000, 2, 2)]
    sp._reduce(_synthetic_events())
    _same_breakdown(sp.breakdown(), want)
    assert (sp.anchor_width_us, sp.drift_us) == (2.0, 0.0)
    assert sp.gap_intervals == [(10.0, 20.0), (30.0, 50.0)]
    assert sp.launches_inside == 0.5
    split = sp.idle_split()
    assert split == pytest.approx({"graph.replay": 2e-6,
                                   "render.step": 8e-6,
                                   "render.image": 1e-5,
                                   "film.to_host": 1e-5})
    assert sum(split.values()) == pytest.approx(3e-5)
    assert sp.idle_under("render.step") == pytest.approx(1e-5)
    assert sp.idle_under("render.image") == pytest.approx(2e-5)


@pytest.mark.cuda
def test_graphed_profile_writes_the_spans_on_card(cuda_device, tmp_path):
    _, thost = _small("cornell", 64, 4)
    r = Renderer(thost, device=cuda_device, seed=3)
    path = r.profile(str(tmp_path), n=3)
    assert r.pass_index == 3 and r.pass_graphs.captures == 1
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ours = [e for e in events if e.get("cat") == "rtc.span"]
    names = [e["name"] for e in ours]
    assert names.count("render.step") == 1 and names.count("graph.feed") == 1
    assert names.count("graph.replay") == 3 and "render.sync" in names
    replays = [(e["ts"], e["ts"] + e["dur"]) for e in ours
               if e["name"] == "graph.replay"]
    launches = [e["ts"] for e in events
                if e["name"].startswith("cudaGraphLaunch")]
    assert launches and all(any(a <= t <= b for a, b in replays)
                            for t in launches)
    assert trace["rtcSpanClock"]["width_us"] > 0
