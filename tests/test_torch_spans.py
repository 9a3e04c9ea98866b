"""The port's layer spans (``mvae_torch.utils.profiling``: ``span``,
``mark``, ``host_sync``) and the graphs that carry them
(``train.graphs.Graphed``).

On the CPU:

* while a ``torch.profiler`` records, the eager training step, the ELBO
  batch and the IWAE batch mark their layers in the program's order (an
  instant host span a marker; the conv nets' four layers beside the MLP's,
  which keep theirs), and the epoch's and the pass's host spans
  nest as the code nests them; with no profiler nothing is recorded and
  ``span`` hands back the shared no-op;
* ``host_syncs`` counts one device-to-host read an epoch and one a pass;
* ``csrc/spans.cu``, compiled for the host by ``g++`` with the build's own
  flag, defines exactly one marker kernel a name of ``LAYERS``, and its
  launcher launches each;
* ``Graphed`` replays its marked graph while the profiler records and its
  plain one otherwise, with the calls' host spans only then, and its two
  captures leave the kernel wrappers' launch counts as one capture does.

On a card (``cuda`` marker; skipped here): the marked and the plain graph
give bit-equal parameters, Adam state, statistics and IWAE estimates; each
traced replay shows its markers in order (9 a step, 11 an IWAE-500 batch;
13 a conv step) and the plain graph none; every Adam launch
(``csrc/adam.cu``) lies in its step's optimizer layer; every
``cudaGraphLaunch`` of a traced window lies inside a ``graph.replay`` span,
so the host spans share the profiler's clock.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvae_torch.components import parse_components
from mvae_torch.data import ArrayDataset
from mvae_torch.kernels import _build, tail_kernels
from mvae_torch.models import vae as tvae
from mvae_torch.train import TrainConfig, Trainer, graphs
from mvae_torch.train.trainer import _leaves
from mvae_torch.utils import profiling

D = 24
STEP = ["encode", "tail", "decode", "loss", "bwd_decode", "bwd_tail",
        "bwd_encode", "optimizer", "end"]
ELBO = ["encode", "tail", "decode", "loss", "end"]
# the conv nets add a boundary inside the encoder and the decoder, forward
# and backward
CONV_STEP = ["encode", "encode_fc", "tail", "decode", "decode_conv", "loss",
             "bwd_decode", "bwd_decode_fc", "bwd_tail", "bwd_encode",
             "bwd_encode_conv", "optimizer", "end"]
IMAGE = (8, 8, 3)


def iwae(chunks):
    return ["encode"] + ["reparam", "decode"] * chunks + ["logsumexp", "end"]


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.clear_host_spans()
    yield
    profiling.clear_host_spans()


def _trainer(tmp_path, spec="h2,s2,e2", **tc):
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(32, D)) > 0.5).astype(np.float32) * 0.8
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False), (D,),
                         h_dim=16)
    tc = {"batch_size": 16, "eval_batch_size": 16, "likelihood_n": 500,
          "burnin_epochs": 0, "seed": 1, "epochs": 1, **tc}
    return Trainer(cfg, ArrayDataset("toy", x, x[:16].copy(), (D,), True),
                   TrainConfig(**tc), run_dir=str(tmp_path), device="cpu")


def _conv_trainer(tmp_path, spec="u2", device="cpu", **tc):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(32,) + IMAGE).astype(np.float32)
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False),
                         IMAGE, "conv", h_dim=16)
    tc = {"batch_size": 8, "eval_batch_size": 16, "likelihood_n": 20,
          "burnin_epochs": 0, "seed": 1, "epochs": 1, **tc}
    return Trainer(cfg, ArrayDataset("toy", x, x[:16].copy(), IMAGE, False),
                   TrainConfig(**tc), run_dir=str(tmp_path), device=device)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _markers(spans):
    return [n[len("mvae_span_"):] for n, *_ in sorted(spans,
                                                       key=lambda s: s[1])
            if n.startswith("mvae_span_")]


def test_span_is_the_shared_noop_without_a_profiler(tmp_path):
    assert not profiling.recording()
    assert profiling.span("graph.replay") is profiling._NOOP
    tr = _trainer(tmp_path)
    tr.train_one_epoch(0)
    tr.evaluate_log_likelihood()
    assert profiling.host_spans() == []


def test_span_records_name_clock_and_parent():
    with _cpu_profile() as prof:
        with profiling.span("outer") as outer:
            with profiling.span("inner"):
                pass
    assert outer is not profiling._NOOP
    (inner, i0, i1, ip), (name, o0, o1, op) = profiling.host_spans()
    assert (inner, ip, name, op) == ("inner", "outer", "outer", None)
    assert o0 <= i0 <= i1 <= o1
    # the profiler recorded CPU activity: each span is a range of its trace
    names = {e.name for e in prof.events()}
    assert {"outer", "inner"} <= names


@pytest.mark.parametrize("spec", ["h2,s2,e2", "d2,p2,e2"])
def test_eager_step_marks_its_layers_in_order(tmp_path, spec):
    tr = _trainer(tmp_path, spec)
    with _cpu_profile():
        tr.train_one_epoch(0)
    assert _markers(profiling.host_spans()) == STEP * tr.steps_per_epoch


def test_step_body_of_the_graph_marks_its_layers_in_order(tmp_path):
    tr = _trainer(tmp_path)
    epoch = graphs.TrainEpoch(tr)
    with _cpu_profile():
        epoch.run(tr._epoch_perm(), graph=False)
        tr._epoch_means(epoch.stats)
    spans = profiling.host_spans()
    assert _markers(spans) == STEP * tr.steps_per_epoch
    host = [(n, p) for n, _, _, p in sorted(spans, key=lambda s: s[1])
            if not n.startswith("mvae_span_")]
    assert host == [("epoch.copy_in", None), ("epoch.replays", None),
                    ("epoch.stats_read", None)]
    inside = {p for n, _, _, p in spans if n.startswith("mvae_span_")}
    assert inside == {"epoch.replays"}


@pytest.mark.parametrize("spec", ["u2", "h2,s2,e2"])
def test_conv_eager_step_marks_its_conv_layers_in_order(tmp_path, spec):
    tr = _conv_trainer(tmp_path, spec)
    with _cpu_profile():
        tr.train_one_epoch(0)
    assert _markers(profiling.host_spans()) == CONV_STEP * tr.steps_per_epoch


def test_conv_step_body_of_the_graph_marks_its_conv_layers(tmp_path):
    tr = _conv_trainer(tmp_path)
    epoch = graphs.TrainEpoch(tr)
    with _cpu_profile():
        epoch.run(tr._epoch_perm(), graph=False)
        tr._epoch_means(epoch.stats)
    assert _markers(profiling.host_spans()) == CONV_STEP * tr.steps_per_epoch


def test_conv_iwae_and_elbo_batches_mark_the_conv_layers(tmp_path):
    tr = _conv_trainer(tmp_path)
    with _cpu_profile():
        tr.evaluate_log_likelihood()
        tr.evaluate_elbo()
    assert _markers(profiling.host_spans()) == [
        "encode", "encode_fc", "reparam", "decode", "decode_conv",
        "logsumexp", "end", "encode", "encode_fc", "tail", "decode",
        "decode_conv", "loss", "end"]


@pytest.mark.parametrize("n,chunks", [(500, 4), (256, 2), (10, 1)])
def test_iwae_batch_marks_a_reparam_and_decode_a_chunk(tmp_path, n, chunks):
    tr = _trainer(tmp_path, likelihood_n=n)
    with _cpu_profile():
        tr.evaluate_log_likelihood()
    spans = profiling.host_spans()
    assert _markers(spans) == iwae(chunks)
    assert [s[0] for s in spans if not s[0].startswith("mvae_span_")] == [
        "iwae.read"]


def test_elbo_batch_marks_the_forward_layers(tmp_path):
    tr = _trainer(tmp_path)
    with _cpu_profile():
        tr.evaluate_elbo()
    assert _markers(profiling.host_spans()) == ELBO


def test_host_syncs_one_an_epoch_and_one_a_pass(tmp_path):
    tr = _trainer(tmp_path)
    before = profiling.counters["host_syncs"]
    tr.train_one_epoch(0)
    assert profiling.counters["host_syncs"] == before + 1
    tr.train_one_epoch(1)
    assert profiling.counters["host_syncs"] == before + 2
    tr.evaluate_log_likelihood()
    assert profiling.counters["host_syncs"] == before + 3
    tr.evaluate_elbo()
    assert profiling.counters["host_syncs"] == before + 4


def test_marking_overrides_the_profiler():
    like = torch.zeros(1)
    with profiling.marking(True):
        assert profiling.markers_on()
        profiling.mark("loss", like)
    with _cpu_profile(), profiling.marking(False):
        assert not profiling.markers_on()
        profiling.mark("tail", like)
    profiling.mark("decode", like)
    assert _markers(profiling.host_spans()) == ["loss"]
    with pytest.raises(KeyError):
        with profiling.marking(True):
            profiling.mark("no_such_layer", like)


def test_gradient_markers_only_while_on():
    x = torch.ones(3, requires_grad=True)
    y = x * 2.0
    profiling.mark_grad(y, "bwd_tail")            # off: no hook
    assert y._backward_hooks is None or not y._backward_hooks
    with _cpu_profile():
        z = x * 3.0
        profiling.mark_grad(z, "bwd_tail")
        profiling.mark_grad(torch.ones(2), "bwd_tail")  # needs no gradient
        z.sum().backward()
    assert _markers(profiling.host_spans()) == ["bwd_tail"]


_SPANS_STUB = r"""
#pragma once
#define __global__
typedef void* cudaStream_t;
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1,
                                      unsigned c = 1) : x(a), y(b), z(c) {} };
enum { cudaErrorInvalidValue = 1 };
extern "C" const void* last_kernel;
extern "C" void* last_stream;
static inline int cudaLaunchKernel(const void* f, dim3 g, dim3 b, void**,
                                   unsigned long, cudaStream_t s) {
  if (g.x * g.y * g.z != 1 || b.x * b.y * b.z != 1) return 2;
  last_kernel = f;
  last_stream = s;
  return 0;
}
"""

_SPANS_HARNESS = r"""
extern "C" const void* last_kernel = nullptr;
extern "C" void* last_stream = nullptr;
"""


@pytest.fixture(scope="module")
def spans_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the host")
    work = tmp_path_factory.mktemp("spans_host")
    (work / "cuda_runtime.h").write_text(_SPANS_STUB)
    src = work / "spans.cpp"
    src.write_text(_SPANS_HARNESS + (_build.CSRC / "spans.cu").read_text())
    lib = work / "spans.so"
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-I", str(work),
                    _build.span_layers_flag(), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    symbols = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                             capture_output=True, text=True).stdout
    return ctypes.CDLL(str(lib)), symbols


def test_spans_cu_names_exactly_the_layer_list(spans_host):
    lib, symbols = spans_host
    names = sorted(set(re.findall(r"\bmvae_span_(\w+)", symbols))
                   - {"count", "launch"})
    assert names == sorted(profiling.LAYERS)
    assert lib.mvae_span_count() == len(profiling.LAYERS)
    assert "spans" in _build.EXTRA_FLAGS
    assert _build.span_layers_flag() in _build._flags("spans")
    # no layer name is written in the source: the build passes the list
    text = (_build.CSRC / "spans.cu").read_text()
    assert not any(f"MVAE_SPAN({layer})" in text
                   for layer in profiling.LAYERS)


def test_spans_launcher_launches_each_marker(spans_host):
    lib, _ = spans_host
    lib.mvae_span_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    last = ctypes.c_void_p.in_dll(lib, "last_kernel")
    stream = ctypes.c_void_p.in_dll(lib, "last_stream")
    for i, layer in enumerate(profiling.LAYERS):
        assert lib.mvae_span_launch(i, 0x1234 + i) == 0
        kernel = ctypes.cast(getattr(lib, f"mvae_span_{layer}"),
                             ctypes.c_void_p).value
        assert last.value == kernel and stream.value == 0x1234 + i
    assert lib.mvae_span_launch(len(profiling.LAYERS), None) == 1
    assert lib.mvae_span_launch(-1, None) == 1


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _captured(statics=(), copy_out=False):
    g = graphs.Graphed(lambda *a: None, statics, None, 0, copy_out)
    g.graph, g.marked = _Graph(), _Graph()
    g.out, g.marked_out = torch.zeros(2), torch.ones(2)
    g.per_replay = {tail_kernels.tail_forward: 1}
    return g


@pytest.mark.parametrize("copy_out", [False, True])
def test_replay_takes_the_marked_graph_while_the_profiler_records(copy_out):
    g = _captured((torch.zeros(2),), copy_out)
    launches = tail_kernels.tail_forward.launches
    out = g(torch.full((2,), 3.0))
    assert (g.graph.replays, g.marked.replays) == (1, 0)
    assert torch.equal(out, g.out) and (out is g.out) != copy_out
    assert profiling.host_spans() == []
    with _cpu_profile():
        out = g(torch.full((2,), 4.0))
    assert (g.graph.replays, g.marked.replays) == (1, 1)
    assert torch.equal(out, g.marked_out)
    assert torch.equal(g.statics[0], torch.full((2,), 4.0))
    names = [s[0] for s in profiling.host_spans()]
    assert names == ["graph.copy_in", "graph.replay"] + (
        ["graph.copy_out"] if copy_out else [])
    assert g.replays == 2
    assert tail_kernels.tail_forward.launches == launches + 2
    with _cpu_profile(), profiling.marking(False):
        g(torch.zeros(2))
    assert (g.graph.replays, g.marked.replays) == (2, 1)


def test_two_captures_count_the_launches_of_one(monkeypatch):
    seen = []

    def record(self, marks):
        seen.append(marks)
        tail_kernels.tail_forward.launches += 2   # the body's wrapper calls
        out = torch.full((1,), float(marks))
        if marks:
            self.marked, self.marked_out = _Graph(), out
        else:
            self.graph, self.out = _Graph(), out

    monkeypatch.setattr(graphs.Graphed, "_record", record)
    g = graphs.Graphed(lambda: None, (), None, 0)
    launches = tail_kernels.tail_forward.launches
    with _cpu_profile():
        g()
    assert seen == [False, True]
    assert g.captures == 1 and g.per_replay == {tail_kernels.tail_forward: 2}
    assert g.marked.replays == 1 and g.graph.replays == 0
    assert float(g.marked_out) == 1.0 and float(g.out) == 0.0
    # the capture's calls come off the counts; the one replay adds its own
    assert tail_kernels.tail_forward.launches == launches + 2
    assert [s[0] for s in profiling.host_spans()] == [
        "graph.copy_in", "graph.capture", "graph.replay"]


# --- on a card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the marker kernels "
                    "exist only there")
    return torch.device("cuda", 0)


def _card_trainer(tmp_path, name, steps=3):
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(64 * steps, 784)).astype(np.float32)
    cfg = tvae.VAEConfig(parse_components("h2,s2,e2", fixed_curvature=False),
                         (784,), h_dim=400)
    ds = ArrayDataset("tiny", x, x[:128].copy(), (784,), True)
    tc = TrainConfig(epochs=1, batch_size=64, burnin_epochs=1, seed=3,
                     eval_batch_size=64, likelihood_n=500)
    return Trainer(cfg, ds, tc, str(tmp_path / name))


def _cuda_profile():
    return profile(activities=[ProfilerActivity.CUDA])


def _device_markers(prof):
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and e.name().startswith("mvae_span_")]
    return [e.name()[len("mvae_span_"):]
            for e in sorted(evs, key=lambda e: e.start_ns())]


@torch.no_grad()
def _ll_pass(tr):
    bs = tr.tc.eval_batch_size
    batches, _, n = tr._split_batches(tr._test_data, bs)
    run = tr._eval_program("eval_ll", tr._ll_batch, batches[0], None, None,
                           True)
    return torch.cat([run(batches[i], None, None)
                      for i in range(batches.shape[0])])[:n]


@pytest.mark.cuda
def test_marked_and_plain_graphs_agree_bit_for_bit_on_card(tmp_path):
    _card()
    plain, marked = (_card_trainer(tmp_path, n) for n in ("p", "m"))
    for tr in (plain, marked):
        tr.train_one_epoch(0)        # three eager steps
        tr.train_one_epoch(1)        # the capture, three plain replays
        _ll_pass(tr)                 # a warm batch, the capture, a replay
    want = plain.train_one_epoch(2)
    want_ll = _ll_pass(plain)
    with _cuda_profile() as prof:
        got = marked.train_one_epoch(2)
        got_ll = _ll_pass(marked)
    torch.cuda.synchronize()
    assert got == want
    assert torch.equal(got_ll, want_ll)
    for a, b in zip(_leaves(plain.params), _leaves(marked.params)):
        assert torch.equal(a, b)
    for pa, pb in zip(_leaves(plain.params), _leaves(marked.params)):
        sa, sb = plain.opt.state[pa], marked.opt.state[pb]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # each replay shows its markers in order: 3 steps, then 2 IWAE batches
    assert _device_markers(prof) == STEP * 3 + iwae(4) * 2
    assert [k[0] for k in marked._programs] == ["train_step", "eval_ll"]
    assert all(p.captures == 1 for p in marked._programs.values())


@pytest.mark.cuda
def test_plain_graph_launches_no_marker_on_card(tmp_path):
    _card()
    tr = _card_trainer(tmp_path, "t")
    tr.train_one_epoch(0)
    tr.train_one_epoch(1)
    launches = tail_kernels.tail_forward.launches
    with _cuda_profile() as prof, profiling.marking(False):
        tr.train_one_epoch(2)
    torch.cuda.synchronize()
    assert _device_markers(prof) == []
    assert tail_kernels.tail_forward.launches == launches + 3
    with _cuda_profile() as prof:
        tr.train_one_epoch(3)
    torch.cuda.synchronize()
    assert _device_markers(prof) == STEP * 3
    assert tail_kernels.tail_forward.launches == launches + 6
    # every Adam launch lies in its step's optimizer layer, one a step
    layer, adam = None, 0
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.start_ns())
    for e in evs:
        if e.name().startswith("mvae_span_"):
            layer = e.name()[len("mvae_span_"):]
        elif "adam_kernel" in e.name():
            assert layer == "optimizer", e.name()
            adam += 1
    assert adam == 3


@pytest.mark.cuda
def test_conv_step_marks_its_conv_layers_on_card(tmp_path):
    """The conv VAE's traced replays show the conv layers' markers in order,
    the backward's two from their gradient hooks inside the graph."""
    _card()
    tr = _conv_trainer(tmp_path, device="cuda")
    assert tr.graph_path["path"] == "graph"
    tr.train_one_epoch(0)
    tr.train_one_epoch(1)
    with _cuda_profile() as prof:
        tr.train_one_epoch(2)
    torch.cuda.synchronize()
    assert _device_markers(prof) == CONV_STEP * tr.steps_per_epoch


@pytest.mark.cuda
def test_graph_launches_lie_inside_replay_spans_on_card(tmp_path):
    _card()
    tr = _card_trainer(tmp_path, "t")
    tr.train_one_epoch(0)
    tr.train_one_epoch(1)
    profiling.clear_host_spans()
    with _cuda_profile() as prof:
        tr.train_one_epoch(2)
        torch.cuda.synchronize()
    replays = sorted((s, e) for n, s, e, _ in profiling.host_spans()
                     if n == "graph.replay")
    launches = [e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.name() == "cudaGraphLaunch"]
    assert len(replays) == 3 and len(launches) == 3
    for t in launches:
        assert any(s <= t <= e for s, e in replays), (t, replays)
    names = [n for n, *_ in sorted(profiling.host_spans(),
                                   key=lambda s: s[1])]
    assert names[:2] == ["epoch.copy_in", "epoch.replays"]
    assert names[-1] == "epoch.stats_read"
