"""Named spans at the training loop's phase boundaries, and the backend's
profile of one chunk.

``span(name)`` marks a phase as ``pde.<name>`` in a ``torch.profiler``
trace, on the profiler's clock, where the device's kernels and copies are
too.  With no profiler active it is one flag check and returns a shared
null context, so the spans cost nothing in an unprofiled run; an operator
turns them on by profiling (``backend.profile_dir``, or any
``torch.profiler.profile`` around ``Trainer.fit``).

The spans, from the entry point down (each wraps what it names, and no
span is put inside a provider: their kernels name them on the device):

* ``pde.step`` (keyword ``step``, the step index): one training step;
* ``pde.sample``: the step's data (``ConsistencyBased.sample_data``);
* ``pde.langevin``, inside ``pde.sample`` (and ``pde.test``) of an SDE
  problem: the simulator's seed draw and its kernel launches
  (``ops/simulate.py``), one span a simulated batch;
* ``pde.loss_grad``: the loss and its gradient, forward and backward;
* ``pde.kfp_path`` and ``pde.kfp_boundary``, inside ``pde.loss_grad`` of
  the kinetic Fokker-Planck loss: the path term's gradient and Hessian
  form (the fused provider's call) and the boundary terms' gradients
  through the network; their backward is autograd's, under
  ``pde.loss_grad``;
* ``pde.optimizer``: the optimizer's update, EMA and the parameter norm;
* ``pde.gather``: a streaming chunk's host gather from the store's
  memmaps (``gather_stream_chunk``), and then ``pde.upload``: its copy to
  the device;
* ``pde.store``, in set-up: an offline array store's generation on the
  device, its copy to the host and its memmap writes
  (``problems/kfp_gmm.py``);
* ``pde.sync``: the chunk's one copy of its metrics to the host;
* ``pde.writer``: the NaN guard and the writer's chunk log;
* ``pde.test``: a test and its log.

A span is a host operation of the profiler's FUNCTION scope
(``_RecordFunctionFast``), not a user annotation: ``record_function``'s
user scope also puts a copy of each span on the device's timeline
(``gpu_user_annotation``), which a reader of device operations would count
as one.  The step index is recorded as the keyword ``step`` where the
profiler records inputs (``record_shapes=True``).
"""

from __future__ import annotations

import contextlib
import os

import torch

_NULL = contextlib.nullcontext()
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def span(name: str, step=None):
    """A context that marks ``pde.<name>`` in an active profiler's trace;
    the shared null context when none is active."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    if step is None:
        return _RecordFunctionFast(f"pde.{name}")
    return _RecordFunctionFast(f"pde.{name}", (), {"step": int(step)})


@contextlib.contextmanager
def profile_to(profile_dir: str):
    """Runs the block under ``torch.profiler`` (CPU activity, and CUDA's
    where there is a card) and writes its chrome trace to
    ``<profile_dir>/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    print(f"[trainer] profile trace -> {profile_dir}")
