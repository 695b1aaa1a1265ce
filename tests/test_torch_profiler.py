"""``paddle_tpu_torch.profiler`` held against ``paddle_tpu.profiler`` on
the same inputs (schedulers, summaries, the throughput monitor, the
recorder, exported traces), on the CPU; the device trace needs the card
and a GPU target without one raises."""

import pickle

import numpy as np
import pytest
import torch

import paddle_tpu.profiler as ref
import paddle_tpu_torch.profiler as port
from paddle_tpu_torch import incubate, jit, optimizer
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.profiler import profiler as port_profiler
from paddle_tpu_torch.profiler import utils as port_utils

CPU = [port.ProfilerTarget.CPU]
STEPS = 24


def _states(fn, n=STEPS):
    return [fn(i).name for i in range(n)]


@pytest.mark.parametrize("closed,ready,record", [
    (c, r, k) for c in (0, 1, 2) for r in (0, 1) for k in (1, 2, 3)])
def test_make_scheduler_matches_the_reference(closed, ready, record):
    for repeat in (0, 1, 2):
        for skip_first in (0, 1, 3):
            kw = dict(closed=closed, ready=ready, record=record,
                      repeat=repeat, skip_first=skip_first)
            assert _states(port.make_scheduler(**kw)) == _states(
                ref.make_scheduler(**kw)), kw


@pytest.mark.parametrize("window", [(0, 1), (1, 2), (0, 3), (2, 5)])
def test_tuple_scheduler_matches_the_reference(window):
    got = port.Profiler(targets=CPU, scheduler=window)._scheduler
    want = ref.Profiler(targets=[ref.ProfilerTarget.CPU],
                        scheduler=window)._scheduler
    assert _states(got) == _states(want)


@pytest.mark.parametrize("kw", [dict(closed=0, ready=0, record=0),
                                dict(closed=-1, ready=0, record=1),
                                dict(closed=0, ready=-1, record=1)])
def test_make_scheduler_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        ref.make_scheduler(**kw)
    with pytest.raises(ValueError):
        port.make_scheduler(**kw)


def _events():
    rng = np.random.RandomState(0)
    names = ["fwd", "bwd", "optimizer.step", "data_loading", "fwd"]
    out, t = [], 10_000
    for i in range(40):
        dur = int(rng.randint(1_000, 3_000_000))
        out.append((names[i % len(names)], t, t + dur, 1 + i % 3))
        t += dur + int(rng.randint(0, 5000))
    return out


@pytest.mark.parametrize("key", ["total", "avg", "max", "min", "calls"])
@pytest.mark.parametrize("unit", ["ms", "us"])
def test_build_summary_is_the_references(key, unit):
    from paddle_tpu.profiler.profiler_statistic import build_summary as rb
    from paddle_tpu_torch.profiler.profiler_statistic import build_summary

    events = _events()
    assert build_summary(events, time_unit=unit, sorted_by=key) == rb(
        events, time_unit=unit, sorted_by=key)


def test_benchmark_ips_matches_the_reference(monkeypatch):
    """The same clock readings give the same ips and step_info."""
    import paddle_tpu.profiler.timer as rt
    import paddle_tpu_torch.profiler.timer as pt

    def run(mod):
        clock = iter([0.0, 0.5, 0.75, 1.25, 1.5, 2.5, 2.625])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        bm = mod.Benchmark()
        bm.begin()
        for n in (32, 64, 64, 16, 8, 128):
            bm.step(n)
        bm.end()
        return bm.ips, bm.step_info("tokens/s")

    got, want = run(pt), run(rt)
    assert got == want
    # the first step is warm-up: (64 + 64 + 16 + 8 + 128) items in 2.125 s
    assert got[0] == pytest.approx(280 / 2.125)


def test_record_event_records_only_while_enabled():
    rec = port_utils.RECORDER
    rec.clear()
    with port.RecordEvent("outside"):
        pass
    assert rec.events == [] and not port.in_profiler_mode()
    p = port.Profiler(targets=CPU)
    with p:
        assert port.in_profiler_mode()
        with port.RecordEvent("inside"):
            pass
        ev = port.RecordEvent("begin_end").begin()
        ev.end()
    assert not port.in_profiler_mode()
    assert [e[0] for e in p._events_snapshot] == ["inside", "begin_end"]
    assert "inside" in p.summary()


def test_record_event_is_a_torch_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with port.RecordEvent("port_span"):
            torch.ones(4).sum()
    assert "port_span" in {e.key for e in prof.key_averages()}


def _llama_step():
    torch.manual_seed(0)
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    return incubate.fused_train_step(
        model, optimizer.AdamW(learning_rate=1e-3,
                               parameters=model.parameters()))


def test_cpu_profile_of_a_training_step_holds_the_window_spans(tmp_path):
    """A CPU-target profile around ``drive`` exports the window's
    observability spans beside the RecordEvent spans, disarms the
    tracer it armed, and names no device trace."""
    step = _llama_step()
    rng = np.random.RandomState(0)
    batches = [tuple(torch.from_numpy(rng.randint(0, 512, (2, 16)))
                     for _ in range(2)) for _ in range(4)]
    trace.clear()
    p = port.Profiler(targets=CPU)
    with p:
        with trace.span("obs_span_in_window", cat="test"):
            pass
        with port.RecordEvent("train_loop"):
            step.drive(iter(batches), steps=4, log_every=2)
    assert not trace.enabled()
    out = p.export(str(tmp_path / "t.json"))
    doc = port.load_profiler_result(out)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"obs_span_in_window", "train_loop", "train.window",
            "train.dispatch"} <= names
    assert doc["metadata"]["device_trace_dir"] is None


def test_scheduled_window_and_step_info(tmp_path):
    step = _llama_step()
    rng = np.random.RandomState(1)
    seen = []
    p = port.Profiler(targets=CPU, scheduler=(1, 3),
                      on_trace_ready=port.export_chrome_tracing(
                          str(tmp_path), "w0"))
    with p:
        for i in range(5):
            with port.RecordEvent(f"step{i}"):
                step(*(torch.from_numpy(rng.randint(0, 512, (2, 16)))
                       for _ in range(2)))
            seen.append(p.current_state.name)
            p.step(num_samples=32)
    assert seen == ["READY", "RECORD", "RECORD_AND_RETURN", "CLOSED",
                    "CLOSED"]
    assert [e[0] for e in p._events_snapshot] == ["step1", "step2"]
    files = list(tmp_path.glob("w0_time_*.paddle_trace.json"))
    assert len(files) == 1
    info = p.step_info("tokens/s")
    assert info.startswith("avg_samples_per_sec: ") and "tokens/s" in info


def test_load_profiler_result_reads_both_packages_files(tmp_path):
    from paddle_tpu.observability import trace as ref_trace

    rp = ref.Profiler(targets=[ref.ProfilerTarget.CPU])
    with rp:
        with ref.RecordEvent("ref_span"):
            pass
    pp = port.Profiler(targets=CPU)
    with pp:
        with port.RecordEvent("port_span"):
            pass
    ref_file = rp.export(str(tmp_path / "ref.json"))
    port_file = pp.export(str(tmp_path / "port.json"))
    ref_trace.clear()
    for load in (ref.load_profiler_result, port.load_profiler_result):
        assert {e["name"] for e in load(ref_file)["traceEvents"]} == {
            "ref_span"}
        assert {e["name"] for e in load(port_file)["traceEvents"]} == {
            "port_span"}
        assert set(load(ref_file)) == set(load(port_file))


def test_export_protobuf_pickles_the_window(tmp_path):
    p = port.Profiler(targets=CPU,
                      on_trace_ready=port.export_protobuf(str(tmp_path),
                                                          "w"))
    with p:
        with port.RecordEvent("pb_span"):
            pass
    (path,) = tmp_path.glob("w_*.pb")
    with open(path, "rb") as f:
        assert [e[0] for e in pickle.load(f)] == ["pb_span"]


def test_wrap_optimizers_records_eager_steps():
    port_utils.wrap_optimizers()
    port_utils.wrap_optimizers()  # idempotent
    w = torch.nn.Parameter(torch.ones(3))
    opt = optimizer.SGD(learning_rate=0.1, parameters=[w])
    (w * w).sum().backward()
    opt.step()  # outside a window: no span, the update applied
    p = port.Profiler(targets=CPU)
    with p:
        (w * w).sum().backward()
        opt.step()
    assert [e[0] for e in p._events_snapshot] == ["Optimization Step"]


def test_compile_span_lands_in_a_cpu_profile(monkeypatch):
    monkeypatch.setattr(jit, "_BACKEND", "eager")

    def scaled(x):
        return x * 2 + 1

    fn = jit.to_static(scaled)
    p = port.Profiler(targets=CPU)
    with p:
        fn(torch.ones(4))
        fn(torch.ones(4))  # a hit: no second compile span
    names = [e[0] for e in p._events_snapshot]
    assert names == ["jit::compile::scaled"]


@pytest.mark.parametrize("targets", [None, [port.ProfilerTarget.GPU],
                                     [port.ProfilerTarget.CPU,
                                      port.ProfilerTarget.GPU]])
def test_gpu_target_without_a_card_raises(targets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port.Profiler(targets=targets)
    # timing only: no device trace asked for
    port.Profiler(targets=targets, timer_only=True)


@pytest.mark.parametrize("target", ["XPU", "CUSTOM_DEVICE", "TPU"])
def test_targets_the_port_has_no_device_for_raise(target):
    with pytest.raises(ValueError, match="targets"):
        port.Profiler(targets=[getattr(port.ProfilerTarget, target)])


def test_enums_keep_the_references_names():
    for enum_name in ("ProfilerState", "ProfilerTarget"):
        got = [m.name for m in getattr(port_profiler, enum_name)]
        want = [m.name for m in getattr(ref.profiler, enum_name)]
        assert got == want
    assert vars(port.SortedKeys).keys() >= {"CPUTotal", "Calls"}
    assert port.SummaryView.KernelView == ref.SummaryView.KernelView
