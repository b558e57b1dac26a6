"""The training loop's phase spans (``pde_inverse_torch/tracing.py``) and
``backend.profile_dir``, on the CPU at small sizes: each step holds its
sample, loss-and-gradient and optimizer spans, each chunk its sync and
writer, the tests fire at their cadence; with no profiler a span records
nothing; the profiled chunk's trace holds the spans and the run's losses
are those of the same run without it."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pde_inverse_torch import config as config_lib
from pde_inverse_torch import main as tmain
from pde_inverse_torch import tracing
from pde_inverse_torch.registry import check_supported

torch.set_num_threads(1)

KMV = ("KMV-nonparametric-fourier", [
    "neural_network.model=mlp", "neural_network.fourier_features=0",
    "neural_network.fourier_trainable=False", "solver.train.kmv_field_reg=0.0",
    "train.optimizer.weight_decay=1e-1", "solver.train.n_time_stamps=3",
    "solver.train.sample_per_time=13", "neural_network.hidden_dim=8", "neural_network.layers=2",
    "neural_network.feature_dim=8"])
KGMM_NP = ("KGMM-nonparametric-online", [
    "solver.train.batch_size_0T=16", "pde_instance.n_steps=10", "neural_network.hidden_dim=16",
    "neural_network.feature_dim=8", "neural_network.fourier_features=4",
    "train.optimizer.ema_switch_step=2"])
STREAMED = ("KGMM-nonparametric-offline-XL", [
    "pde_instance.sample_initial_size=240", "pde_instance.sample_terminal_size=120",
    "pde_instance.sample_0T_size=30", "pde_instance.n_steps_0T=20",
    "pde_instance.n_steps_terminal=20", "pde_instance.n_steps=10", "neural_network.hidden_dim=16",
    "neural_network.feature_dim=8", "neural_network.fourier_features=4",
    "solver.train.offline_traj_batch=8", "train.optimizer.ema_switch_step=2",
    "pde_instance.dataset_path={tmp}/store"])
STEP_PHASES = ["pde.sample", "pde.loss_grad", "pde.optimizer"]
KFP_LOSS = ["pde.kfp_path", "pde.kfp_boundary"]


def _cfg(job, tmp_path, iterations, chunk, frequency, *extra):
    preset, overrides = job
    return config_lib.preset(preset, [
        *(o.format(tmp=tmp_path) for o in overrides), f"train.number_of_iterations={iterations}",
        f"train.steps_per_chunk={chunk}", f"test.frequency={frequency}", "logging.writer=none",
        *extra])


def _spans(events):
    """The pde.* spans as (name, start, end) in time order, all on one thread."""
    found = [e for e in events if e.name.startswith("pde.")]
    assert len({e.thread for e in found}) == 1
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in found),
                  key=lambda s: (s[1], -s[2]))


def _children(spans, parent):
    """The names of the spans directly inside `parent` (name, start, end),
    in time order."""
    _, start, end = parent
    inside = [s for s in spans if start <= s[1] and s[2] <= end and s != parent]
    return [s[0] for s in inside
            if not any(o is not s and o[1] <= s[1] and s[2] <= o[2] for o in inside)]


def _profiled_run(job, tmp_path, n, k, freq):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        tmain.run(_cfg(job, tmp_path, n, k, freq), "cpu")
    return prof


# (job, iterations, chunk, test frequency, tests that fire, streamed,
#  pde.langevin spans outside the steps and tests: the end-of-run test of
#  main.run simulates two batches, the offline store its terminal and its
#  trajectory shard)
CADENCES = {
    "kmv_test_every_chunk": (KMV, 6, 3, 3, 2, False, 0),
    "kmv_final_test_only": (KMV, 6, 3, 0, 1, False, 0),
    "kgmm_np_online": (KGMM_NP, 4, 2, 4, 1, False, 2),
    "kgmm_np_streamed": (STREAMED, 4, 2, 2, 2, True, 4),
}


@pytest.mark.parametrize("case", sorted(CADENCES))
def test_fit_marks_every_phase_under_a_profiler(case, tmp_path):
    job, n, k, freq, n_tests, streamed, elsewhere = CADENCES[case]
    prof = _profiled_run(job, tmp_path, n, k, freq)
    spans = _spans(prof.events())
    counts = {name: sum(s[0] == name for s in spans) for name in {s[0] for s in spans}}
    chunks = -(-n // k)
    kfp = job is not KMV
    # an SDE problem simulates the path and the terminal particles in each
    # step's sample and in each test's probe
    langevin = 2 * ((0 if streamed else n) + n_tests) + elsewhere if kfp else 0
    assert counts == {"pde.step": n, **{p: n for p in STEP_PHASES}, "pde.sync": chunks,
                      "pde.writer": chunks, "pde.test": n_tests,
                      **({"pde.gather": chunks, "pde.upload": chunks, "pde.store": 1} if streamed else {}),
                      **({p: n for p in KFP_LOSS} if kfp else {}),
                      **({"pde.langevin": langevin} if langevin else {})}
    steps = [s for s in spans if s[0] == "pde.step"]
    for step in steps:
        assert _children(spans, step) == STEP_PHASES
    args = [e.kwinputs.get("step") for e in prof.events() if e.name == "pde.step"]
    assert sorted(args) == list(range(n))
    if streamed:
        # the gather is the host's alone; the copy to the device is the upload's
        ops = [(e.name, e.time_range.start) for e in prof.events() if not e.name.startswith("pde.")]
        held = lambda span: [o for o, t in ops if span[1] <= t <= span[2]]
        for span in spans:
            if span[0] == "pde.gather":
                assert "aten::to" not in held(span)
            if span[0] == "pde.upload":  # the trajectories and their stamps
                assert held(span).count("aten::to") == 2


# what each step phase holds, by job: the online sampler's two simulated
# batches (the path, then the terminal particles) and the KFP loss's path
# and boundary terms
NESTED = {
    "kmv_test_every_chunk": {},
    "kgmm_np_online": {"pde.sample": ["pde.langevin", "pde.langevin"], "pde.loss_grad": KFP_LOSS},
    "kgmm_np_streamed": {"pde.loss_grad": KFP_LOSS},
}
# the simulated batches outside the steps and tests that a span other than
# pde.sample, pde.loss_grad and pde.test holds: the store's terminal set and
# its trajectory shard, in pde.store
SET_UP = {"kgmm_np_streamed": {"pde.store": ["pde.langevin", "pde.langevin"]}}


@pytest.mark.parametrize("case", sorted(NESTED))
def test_kgmm_spans_nest_under_sample_and_loss_grad(case, tmp_path):
    job, n, k, freq, *_ = CADENCES[case]
    spans = _spans(_profiled_run(job, tmp_path, n, k, freq).events())
    for phase in STEP_PHASES:
        for span in (s for s in spans if s[0] == phase):
            assert _children(spans, span) == NESTED[case].get(phase, [])
    for test in (s for s in spans if s[0] == "pde.test"):
        assert _children(spans, test) == (["pde.langevin"] * 2 if job is not KMV else [])
    outside = [s[0] for s in spans if s[0] in ("pde.langevin", *KFP_LOSS)
               and not any(o[0] in ("pde.sample", "pde.loss_grad", "pde.test")
                           and o[1] <= s[1] and s[2] <= o[2] for o in spans)]
    assert outside == ["pde.langevin"] * CADENCES[case][6]
    for phase, held in SET_UP.get(case, {}).items():
        (span,) = [s for s in spans if s[0] == phase]
        assert _children(spans, span) == held


def test_span_records_nothing_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler active")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    for args in [("step", 3), ("step", 0), ("sync",), ("langevin",), ("kfp_path",),
                 ("kfp_boundary",)]:
        context = tracing.span(*args)
        assert context is tracing._NULL
        with context:
            pass


def test_kgmm_step_records_no_span_without_a_profiler(monkeypatch, tmp_path):
    """The online KGMM job's sampler and loss take the shared null context
    at every span when nothing profiles them, and train as before."""
    opened = []
    null_enter = type(tracing._NULL).__enter__

    def counted(self):
        if self is tracing._NULL:
            opened.append(self)
        return null_enter(self)

    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler active")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(type(tracing._NULL), "__enter__", counted)
    n, k, freq = CADENCES["kgmm_np_online"][1:4]
    out = tmain.run(_cfg(KGMM_NP, tmp_path, n, k, freq), "cpu")
    assert np.all(np.isfinite(out.losses))
    # per step: step, sample, 2 langevin, loss_grad, kfp_path, kfp_boundary,
    # optimizer; per chunk: sync, writer; the test: test, 2 langevin; the
    # end-of-run test: 2 langevin
    assert len(opened) == 8 * n + 2 * (-(-n // k)) + 3 + 2


def test_span_is_a_host_op_and_no_user_annotation():
    """A user annotation would be copied onto the device's timeline, where
    readers of device operations would count it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("step", 5):
            torch.ones(3).sum()
    (event,) = [e for e in prof.events() if e.name == "pde.step"]
    assert not event.is_user_annotation
    assert any(e.name == "aten::sum" for e in prof.events())


# (iterations, chunk, steps in the profiled chunk): the second chunk, or the
# only one
PROFILED = {"second_of_two_chunks": (3, 2, 1), "only_chunk": (2, 2, 2)}


@pytest.mark.parametrize("case", sorted(PROFILED))
def test_profile_dir_traces_one_chunk_and_changes_no_loss(case, tmp_path, capsys):
    n, k, traced = PROFILED[case]
    plain = tmain.run(_cfg(KMV, tmp_path, n, k, k), "cpu")
    out = tmp_path / "profile"
    profiled = tmain.run(_cfg(KMV, tmp_path, n, k, k, f"backend.profile_dir={out}"), "cpu")
    assert f"[trainer] profile trace -> {out}" in capsys.readouterr().out
    assert plain.losses.dtype == profiled.losses.dtype and np.array_equal(plain.losses, profiled.losses)
    assert all(torch.equal(plain.params[name], v) for name, v in profiled.params.items())
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X" and e["name"].startswith("pde.")]
    assert names.count("pde.step") == traced and names.count("pde.sync") == 1
    assert {*STEP_PHASES, "pde.writer", "pde.test"} <= set(names)


@pytest.mark.parametrize("preset", ["KGMM", "KMV", "KGMM-nonparametric-online"])
def test_check_supported_accepts_profile_dir(preset):
    check_supported(config_lib.preset(preset, ["backend.profile_dir=trace_out"]))
