"""Program spans (``utils/profiling.span``, ``take_spans``) on the CPU.

A span records only while a ``torch.profiler`` session runs, on the
profiler's clock, nested per thread.  ``serve`` records each request's
read, prep (its PCA, spectra, pad and upload), map and write; the
trainers record each call, its pool gather and one step a step with the
step's phases.  Recording changes no number of a run."""

import io
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cmlpl_tpu_torch.cli import serve
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.registry import get_dataset
from cmlpl_tpu_torch.train import CMLPLTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.train.supervised import SupervisedTrainer
from cmlpl_tpu_torch.utils import profiling
from cmlpl_tpu_torch.utils.profiling import span, take_spans
from cmlpl_tpu_torch.weights import init_basenet2_params, save_params_npz
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W = 8, 8
TINY = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=8, num_unlabel=32,
            num_epochs=1, noise=0.5, dropout=0.5, thr=0.13, queue_batch=1)
STEP_PARTS = ["train.gather", "train.draws", "train.forward",
              "train.backward", "train.adam", "train.write"]


@pytest.fixture(autouse=True)
def no_spans_left():
    take_spans()
    yield
    take_spans()


@pytest.fixture(scope="module")
def scene():
    cube, gt = synthetic_scene(0)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu")
    return scene, generate_splits(scene.labels, num_label=5)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def _names(spans):
    return [s.name for s in spans]


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    assert span("a") is span("b", id=1)

    def no_clock():
        raise AssertionError("a span read the clock")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    with span("a", id=1):
        with span("b"):
            pass
    monkeypatch.undo()
    assert take_spans() == []


def test_spans_nest_per_thread_with_their_roots():
    go, done = threading.Event(), threading.Event()

    def worker():
        # started before the session: the gate is the process's, not the
        # thread's
        go.wait()
        with span("w.outer", who="worker"):
            with span("w.inner"):
                pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with _profiled():
        with span("m.outer", who="main"):
            go.set()
            with span("m.mid"):
                with span("m.inner"):
                    pass
            done.wait()
        t.join()
    with span("after"):
        pass
    got = {s.name: s for s in take_spans()}
    assert set(got) == {"w.outer", "w.inner", "m.outer", "m.mid", "m.inner"}
    mo, mm, mi = got["m.outer"], got["m.mid"], got["m.inner"]
    wo, wi = got["w.outer"], got["w.inner"]
    assert (mo.parent, mo.root) == (None, mo.index)
    assert (mm.parent, mm.root) == (mo.index, mo.index)
    assert (mi.parent, mi.root) == (mm.index, mo.index)
    assert (wo.parent, wo.root) == (None, wo.index)
    assert (wi.parent, wi.root) == (wo.index, wo.index)
    assert wo.thread != mo.thread and wi.thread == wo.thread
    assert mo.attrs == {"who": "main"} and wo.attrs == {"who": "worker"}
    assert _inside(mm, mo) and _inside(mi, mm) and _inside(wi, wo)


def test_span_bounds_lie_on_the_profilers_clock():
    a = torch.randn(128, 128)
    with _profiled() as prof:
        a.sum()
        with span("product"):
            a @ a
        a.sum()
    (s,) = take_spans()
    events = prof.profiler.kineto_results.events()
    starts = [e.start_ns() for e in events]
    ends = [e.start_ns() + e.duration_ns() for e in events]
    assert min(starts) <= s.start_ns < s.end_ns <= max(ends)
    mm = next(e for e in events if e.name() == "aten::mm")
    assert s.start_ns <= mm.start_ns()
    assert mm.start_ns() + mm.duration_ns() <= s.end_ns


def test_take_spans_hands_over_the_window_and_forgets_every_span():
    with _profiled():
        with span("before"):
            pass
        t0 = time.time_ns()
        with span("inside"):
            pass
        t1 = time.time_ns()
        with span("after"):
            time.sleep(0.001)
    assert _names(take_spans(t0, t1)) == ["inside"]
    assert take_spans() == []


def _weights(tmp_path):
    wpath = str(tmp_path / "w.npz")
    save_params_npz(wpath, init_basenet2_params(
        0, n_pc=N_PC, num_features=103, num_classes=9, patch_size=W))
    return wpath


def _serve(wpath, text, *flags):
    out = io.StringIO()
    with _profiled():
        serve.main(["--dataID", "0", "--n_PC", str(N_PC), "--w", str(W),
                    "--val_batch_size", "1024", "--weights", wpath,
                    "--device", "cpu", *flags], stdin=io.StringIO(text),
                   stdout=out)
    return [json.loads(r) for r in out.getvalue().splitlines()]


def test_serve_request_records_its_parts(tmp_path):
    wpath = _weights(tmp_path)
    cube, _ = synthetic_scene(0)
    np.save(tmp_path / "cube.npy", cube)
    line = json.dumps({"id": "r1", "cube": str(tmp_path / "cube.npy"),
                       "out": str(tmp_path / "map.npy")})
    assert _serve(wpath, line + "\n")[-1]["id"] == "r1"
    spans = take_spans()
    roots = [s for s in spans if s.parent is None]
    # the warm-up's preps (an f32 and an f64 cube) and map, then the request
    assert _names(roots) == ["serve.prep", "serve.prep", "serve.map",
                             "serve.request"]
    req = roots[-1]
    parts = _children(spans, req)
    assert _names(parts) == ["serve.read", "serve.prep", "serve.map",
                             "serve.write"]
    prep = parts[1]
    assert _names(_children(spans, prep)) == [
        "prep.pca", "prep.spectra", "prep.pad", "prep.upload"]
    assert all(s.root == req.index for s in spans
               if s.start_ns >= req.start_ns)
    assert all(_inside(s, req) for s in parts)
    assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("text, parts", [
    ("{not json\n", []),
    (json.dumps({"id": "m", "cube": "missing.npy"}) + "\n", ["serve.read"]),
    ("\n  \n", None),
], ids=["bad_json", "missing_cube", "blank_lines"])
def test_serve_request_span_of_an_answered_error(tmp_path, text, parts):
    responses = _serve(_weights(tmp_path), text, "--no_warmup")
    assert responses[0] == {"ready": True, "dataset": "Synthetic"}
    spans = take_spans()
    if parts is None:  # no request: the end of stdin records nothing
        assert len(responses) == 1 and spans == []
        return
    assert len(responses) == 2 and "error" in responses[1]
    (req,) = [s for s in spans if s.parent is None]
    assert req.name == "serve.request"
    assert _names(_children(spans, req)) == parts


def _cmlpl(scene, seed=0):
    scene, splits = scene
    trainer = CMLPLTrainer(CMLPLConfig(**TINY), device="cpu")
    sampler = SemiSupervisedSampler(splits, scene.labels, 8, 8, 32, seed=7)
    li, ly, ui = (np.stack(a) for a in zip(*sampler.epoch()))
    return trainer, trainer.init_state(seed), (li[:2], ly[:2], ui[:2])


def _serial(scene):
    trainer, state, (li, ly, ui) = _cmlpl(scene)
    trainer.train_epoch(state, scene[0], li, ly, ui)
    return len(li), STEP_PARTS


def _fused(scene):
    trainer, _, (li, ly, ui) = _cmlpl(scene)
    ms = trainer.stack_states([trainer.init_state(i) for i in range(2)])
    trainer._run(ms, scene[0], np.stack([li] * 2)[:, None],
                 np.stack([ly] * 2)[:, None], np.stack([ui] * 2)[:, None],
                 [0])
    return len(li), STEP_PARTS


def _supervised(scene):
    scene, splits = scene
    trainer = SupervisedTrainer("basenet1", get_dataset(0), patch_size=W,
                                n_pc=N_PC, device="cpu")
    state = trainer.init_state(0)
    ids = np.asarray(splits.train)[:12].reshape(2, 6)
    trainer.train_run(state, scene, ids, scene.labels[ids] - 1)
    return 2, ["train.gather", "train.forward", "train.backward",
               "train.adam"]


@pytest.mark.parametrize("run", [_serial, _fused, _supervised])
def test_training_call_records_one_step_a_step(scene, run):
    with _profiled():
        steps, parts = run(scene)
    spans = take_spans()
    calls = [s for s in spans if s.name == "train.call"]
    assert len(calls) == 1 and calls[0].parent is None
    call = calls[0]
    outer = _names(_children(spans, call))
    pool = ["train.pool_gather"] if run is not _supervised else []
    assert outer == pool + ["train.step"] * steps + ["train.metrics"]
    for i, step in enumerate(s for s in _children(spans, call)
                             if s.name == "train.step"):
        assert step.attrs == ({} if run is _supervised
                              else {"epoch": 0, "batch": i})
        assert step.root == call.index
        inner = _children(spans, step)
        assert _names(inner) == parts
        assert all(_inside(s, step) for s in inner)


def test_profiler_changes_no_number(scene):
    def one_call():
        trainer, state, (li, ly, ui) = _cmlpl(scene, seed=3)
        _, m = trainer.train_epoch(state, scene[0], li, ly, ui)
        return m, trainer.named_params(state)

    m0, p0 = one_call()
    with _profiled():
        m1, p1 = one_call()
    assert take_spans()
    assert m0.keys() == m1.keys() and p0.keys() == p1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
