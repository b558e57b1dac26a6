"""Kinetic Fokker-Planck inverse problem with a Gaussian-mixture potential
(counterpart of pde_inverse_tpu/problems/kfp_gmm.py): online SDE sampling
and the offline dataset.

Ground truth: underdamped Langevin dynamics in U(x) = -logsumexp_k(
-||x - mu_k||^2 / 2) with friction gamma = 0.5; the initial law is
N(0, diag(4 I, 0.1 I)) and path data comes from the simulator (K1, or K2
with ``pde_instance.langevin_pack`` > 1, on CUDA).

Offline (``pde_instance.sample_mode=offline``) the instance holds one
dataset {initial, terminal, 0T, tau_0T} for the whole run: generated in
memory, or persisted to ``pde_instance.dataset_path`` (an ``.npz`` file, or
a directory in the raw array-store format of ``utils/data.py``, generated
shard by shard).  With ``pde_instance.offline_streaming`` the trajectory
arrays stay host memmaps (``dataset_stream``) and only initial/terminal go
to the device; with no ``dataset_path`` the store is the run's own: made
in a fresh directory under ``tempfile.gettempdir()`` (``TMPDIR``) and
removed when the instance is collected, when the process exits, or when
its set-up raises.

The means mu_k are drawn from the port's own generator, so the same
``seed`` gives a different ground truth than the JAX package.  To run both
on one ground truth, pass ``configuration={"mus": <numpy [k, d]>}``, and
``"dataset": {name: numpy array}`` to train on a dataset made elsewhere.
A persisted dataset records what it was generated with: the means, the
``pde_instance`` fields of RECORD_FIELDS and its key.  Loading one recorded
for anything else, or with no record (a store of the JAX package, or of an
older port), raises.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import tempfile
import time
import weakref
from typing import Optional

import numpy as np
import torch

from pde_inverse_torch import rng
from pde_inverse_torch.config import Config
from pde_inverse_torch.distributions import Gaussian
from pde_inverse_torch.models.parametric import GMMMeansModel
from pde_inverse_torch.ops.simulate import simulate
from pde_inverse_torch.potentials import GMMPotential
from pde_inverse_torch.problems.base import ProblemInstance
from pde_inverse_torch.tracing import span
from pde_inverse_torch.utils.data import ArrayStoreWriter, load_array_store, store_bytes

GROUND_TRUTH_FILE = "ground_truth.json"  # beside a store's manifest: what it was generated with
# the pde_instance fields that decide an offline dataset, recorded beside it
RECORD_FIELDS = ("integrator", "total_evolving_time", "n_steps_terminal", "n_steps_0T",
                 "sample_initial_size", "sample_terminal_size", "sample_0T_size")


def make_configuration(
    dim: int, device: torch.device, key: Optional[int] = None, mus=None
) -> dict:
    """The instance's constants; mus is drawn U[-4, 4]^{3 x d} from key
    unless given (numpy or tensor [k, d])."""
    if mus is None:
        mus = torch.rand((3, dim), generator=rng.generator(key)) * 8.0 - 4.0
    mus = torch.from_numpy(np.array(mus, np.float32)).to(device)
    eye = torch.eye(dim, device=device)
    zeros = torch.zeros((dim, dim), device=device)
    P_0 = torch.cat(
        [torch.cat([4.0 * eye, zeros], 1), torch.cat([zeros, 0.1 * eye], 1)], 0
    )
    return {
        "n_Gaussian": mus.shape[0],
        "gamma_friction": 0.5,
        "m_0": torch.zeros(2 * dim, device=device),
        "P_0": P_0,
        "mus": mus,
    }


class KineticFokkerPlanckGMM(ProblemInstance):
    sample_scheme = "SDE"

    # oversampling multiples of the online initial / terminal batches
    multiple_init = 30
    multiple_terminal = 30

    def __init__(
        self,
        cfg: Config,
        key: int,
        device: torch.device,
        configuration: Optional[dict] = None,
    ):
        super().__init__(cfg, device)
        p = cfg.pde_instance
        if self.sample_mode not in ("online", "offline"):
            raise ValueError(f"unknown pde_instance.sample_mode {self.sample_mode!r}")
        if p.init_broaden < 1.0:
            raise ValueError("pde_instance.init_broaden must be >= 1.0")
        if p.init_broaden > 1.0 and p.antithetic:
            raise ValueError("pde_instance.init_broaden and pde_instance.antithetic are "
                             "mutually exclusive")
        if p.init_broaden > 1.0 and self.sample_mode != "online":
            raise ValueError("pde_instance.init_broaden reweights ONLINE SDE sampling; "
                             "offline datasets are drawn from the true initial law")
        if p.init_broaden > 1.0:
            raise NotImplementedError("pde_instance.init_broaden>1 (tail-boost weights) is not "
                                      "ported yet: ROADMAP queue 1, item 14")
        configuration = configuration or {}
        if "dataset" in configuration and "mus" not in configuration:
            raise ValueError("a given dataset needs the means it was generated with "
                             "(configuration['mus'])")
        key_config, key_dataset = rng.split(key, 2)
        c = make_configuration(self.dim, self.device, key=key_config, mus=configuration.get("mus"))
        self.configuration = c
        self.gamma_friction = c["gamma_friction"]
        self.potential = GMMPotential.create(c["mus"], 1.0)
        self.distribution_initial = Gaussian.create(c["m_0"], c["P_0"])
        self.distribution_terminal = None  # reachable only by simulation
        self.dataset = None
        self.dataset_stream = None
        self.store_cleanup = None  # removes the run's own store (_private_store)
        if self.sample_mode == "offline":
            if "dataset" in configuration:
                self.dataset = self._to_device(configuration["dataset"])
            else:
                self.dataset = self._load_or_generate_dataset(key_dataset)

    def V_true_fn(self, x: torch.Tensor) -> torch.Tensor:
        return self.potential.value(x)

    # -- online SDE sampling ---------------------------------------------------

    def sample_ground_truth(self, key: int, batch_size: int):
        """(initial, terminal, path) for one step: multiple_init x batch_size
        exact initial draws, multiple_terminal x batch_size particles
        simulated to T, and batch_size trajectories flattened over their
        n_steps states.  Same 5-way key layout as the split entry points."""
        k_traj, k_term, k_i0, k_i1, k_i2 = rng.split(key, 5)
        path = self._sample_path(k_traj, k_i0, batch_size)
        initial, terminal = self._sample_boundary(k_term, k_i1, k_i2, batch_size)
        return initial, terminal, path

    def sample_path_only(self, key: int, batch_size: int) -> torch.Tensor:
        k_traj, _, k_i0, _, _ = rng.split(key, 5)
        return self._sample_path(k_traj, k_i0, batch_size)

    def sample_boundary_only(self, key: int, batch_size: int):
        _, k_term, _, k_i1, k_i2 = rng.split(key, 5)
        return self._sample_boundary(k_term, k_i1, k_i2, batch_size)

    def _sim_kwargs(self):
        p = self.cfg.pde_instance
        return dict(
            n_steps=p.n_steps,
            dt=p.total_evolving_time / p.n_steps,
            potential=self.potential,
            gamma=self.gamma_friction,
            integrator=p.integrator,
            pack=p.langevin_pack or None,
            antithetic=p.antithetic,
        )

    def _n_draw(self, batch_size: int) -> int:
        if self.cfg.pde_instance.antithetic:
            if batch_size % 2:
                raise ValueError("pde_instance.antithetic needs an even batch size")
            return batch_size // 2
        return batch_size

    def _sample_path(self, key_traj: int, key_i0: int, batch_size: int) -> torch.Tensor:
        antithetic = self.cfg.pde_instance.antithetic
        m0 = self.distribution_initial.mean
        z0 = self.distribution_initial.sample(
            self._n_draw(batch_size), rng.generator(key_i0, self.device)
        )
        _, traj, _ = simulate(
            key_traj, z0, z0_mirror=(2.0 * m0 - z0) if antithetic else None,
            **self._sim_kwargs(),
        )
        stride = self.cfg.solver.train.path_stride
        if stride > 1:
            # every trajectory carries its own random phase, so strided
            # states still cover (0, T]
            traj = traj[:, ::stride]
        return traj.reshape(-1, 2 * self.dim)

    def _sample_boundary(self, key_term: int, key_i1: int, key_i2: int, batch_size: int):
        antithetic = self.cfg.pde_instance.antithetic
        n_draw = self._n_draw(batch_size)
        m0 = self.distribution_initial.mean
        if antithetic:
            half = self.distribution_initial.sample(
                n_draw * self.multiple_init, rng.generator(key_i1, self.device)
            )
            initial = torch.cat([half, 2.0 * m0 - half])
        else:
            initial = self.distribution_initial.sample(
                batch_size * self.multiple_init, rng.generator(key_i1, self.device)
            )
        z0_term = self.distribution_initial.sample(
            n_draw * self.multiple_terminal, rng.generator(key_i2, self.device)
        )
        terminal, _, _ = simulate(
            key_term, z0_term, return_trajectory=False,
            z0_mirror=(2.0 * m0 - z0_term) if antithetic else None,
            **self._sim_kwargs(),
        )
        return initial, terminal

    # -- offline dataset ---------------------------------------------------------

    def _sim(self, key: int, z0: torch.Tensor, n_steps: int, return_trajectory: bool):
        p = self.cfg.pde_instance
        return simulate(
            key, z0, n_steps, p.total_evolving_time / n_steps, self.potential,
            self.gamma_friction, return_trajectory=return_trajectory,
            integrator=p.integrator, pack=p.langevin_pack or None,
        )

    def _initial(self, key: int, n: int) -> torch.Tensor:
        return self.distribution_initial.sample(n, rng.generator(key, self.device))

    def generate_ground_truth_dataset(self, key: int) -> dict:
        """{initial [Ni, 2d], terminal [Nt, 2d] at T after n_steps_terminal
        steps, 0T [n_traj, n_steps_0T, 2d] and its stamps tau_0T [n_traj,
        n_steps_0T]}, in memory, with the JAX package's 5-way key layout."""
        p = self.cfg.pde_instance
        k_init, k_term0, k_term1, k_0T0, k_0T1 = rng.split(key, 5)
        t0 = self._clock()
        initial = self._initial(k_init, p.sample_initial_size)
        t1 = self._clock()
        terminal, _, _ = self._sim(
            k_term1, self._initial(k_term0, p.sample_terminal_size), p.n_steps_terminal, False)
        t2 = self._clock()
        _, traj, taus = self._sim(k_0T1, self._initial(k_0T0, p.sample_0T_size), p.n_steps_0T, True)
        t3 = self._clock()
        dataset = {"initial": initial, "terminal": terminal, "0T": traj, "tau_0T": taus}
        self.data_timing = {"initial_s": t1 - t0, "terminal_s": t2 - t1, "0T_s": t3 - t2,
                            "bytes": sum(v.numel() * v.element_size() for v in dataset.values())}
        return dataset

    def _clock(self) -> float:
        """Host seconds after the device's queued work has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _to_device(self, arrays: dict) -> dict:
        return {k: torch.from_numpy(np.array(v, np.float32)).to(self.device) for k, v in arrays.items()}

    def _mus_numpy(self) -> np.ndarray:
        return self.configuration["mus"].cpu().numpy()

    def _record(self, key: int) -> dict:
        """What a persisted dataset generated here with `key` records."""
        p = self.cfg.pde_instance
        return {"mus": self._mus_numpy().tolist(), **{f: getattr(p, f) for f in RECORD_FIELDS},
                "key": int(key)}

    def _check_record(self, path: str, record: Optional[dict], key: int) -> None:
        """Raise unless `record` (what a persisted dataset was generated with)
        is what this instance would generate with `key`: the port never
        trains silently on another ground truth or another simulation, such
        as a store the JAX package generated at the same path, or one made
        with another integrator."""
        elsewhere = "Remove it or set pde_instance.dataset_path elsewhere"
        if record is None or "mus" not in record:
            raise ValueError(
                f"the offline dataset at {path!r} holds no record of the GMM means it was "
                "generated with (a store of the JAX package, or of an older port?): it may "
                f"hold another ground truth. {elsewhere}"
            )
        mus = np.asarray(record["mus"], np.float32)
        if mus.shape != self._mus_numpy().shape or not np.array_equal(mus, self._mus_numpy()):
            raise ValueError(
                f"the offline dataset at {path!r} was generated for other GMM means "
                f"({mus.tolist()}) than this instance's ({self._mus_numpy().tolist()}). {elsewhere}"
            )
        want = self._record(key)
        missing = [f for f in want if f not in record]
        if missing:
            raise ValueError(f"the offline dataset at {path!r} does not record {missing} (a store of "
                             f"an older port?): it may hold another simulation. {elsewhere}")
        other = [f"{f}={record[f]!r} (this run: {want[f]!r})" for f in want
                 if f != "mus" and record[f] != want[f]]
        if other:
            raise ValueError(f"the offline dataset at {path!r} was generated with other settings: "
                             f"{', '.join(other)}. {elsewhere}")

    def _load_or_generate_dataset(self, key: int) -> dict:
        """The offline dataset: generated in memory without a dataset_path;
        with an ``.npz`` path, loaded from it or generated and saved there;
        with a directory path, loaded from the array store there or
        generated into it shard by shard.  Offline streaming keeps 0T and
        tau_0T as host memmaps in ``self.dataset_stream``; without a
        dataset_path it generates a store of its own (``_private_store``)."""
        p = self.cfg.pde_instance
        path = p.dataset_path
        if p.offline_streaming and path.endswith(".npz"):
            raise ValueError(
                "pde_instance.offline_streaming needs a raw array-store dataset_path "
                "(directory, not .npz): streaming gathers host-side from the memmap"
            )
        if p.offline_streaming and not path:
            return self._private_store(key)
        if not path:
            return self.generate_ground_truth_dataset(key)
        if path.endswith(".npz"):
            if os.path.exists(path):
                with np.load(path) as z:
                    arrays = {k: z[k] for k in z.files}
                mus, settings = arrays.pop("mus", None), arrays.pop("generated_with", None)
                record = None if mus is None else {
                    "mus": mus, **({} if settings is None else json.loads(str(settings)))}
                self._check_record(path, record, key)
                return self._to_device(arrays)
            dataset = self.generate_ground_truth_dataset(key)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            settings = {k: v for k, v in self._record(key).items() if k != "mus"}
            np.savez(path, mus=self._mus_numpy(), generated_with=np.array(json.dumps(settings)),
                     **{k: v.cpu().numpy() for k, v in dataset.items()})
            return dataset
        return self._open_store(path, key)

    def _private_store(self, key: int) -> dict:
        """The streamed dataset from a store of this instance's own: generated
        into a fresh directory under ``tempfile.gettempdir()``, so that no
        other run (another seed, or the same one at once) shares or reuses
        it, and removed when the instance is collected or the process exits
        (``self.store_cleanup``, a ``weakref.finalize``), or at once if
        set-up raises.  The memmaps stay readable until they are closed.  A
        process killed past its exit handlers (SIGKILL) leaves its
        directory behind, which no later run reuses."""
        path = tempfile.mkdtemp(prefix="kgmm_store_")
        self.store_cleanup = weakref.finalize(self, shutil.rmtree, path, ignore_errors=True)
        try:
            return self._open_store(path, key)
        except BaseException:
            self.store_cleanup()
            raise

    def _open_store(self, path: str, key: int) -> dict:
        """The dataset of the array store at `path`, generated there first
        if it holds none, its record checked."""
        p = self.cfg.pde_instance
        if not os.path.exists(os.path.join(path, "manifest.json")):
            with span("store"):
                self._generate_dataset_to_store(path, key)
        record = None
        if os.path.exists(os.path.join(path, GROUND_TRUTH_FILE)):
            with open(os.path.join(path, GROUND_TRUTH_FILE)) as f:
                record = json.load(f)
        self._check_record(path, record, key)
        store = load_array_store(path)
        if p.offline_streaming:
            self.dataset_stream = {k: store[k] for k in ("0T", "tau_0T") if k in store}
            return self._to_device({k: v for k, v in store.items() if k not in self.dataset_stream})
        return self._to_device(store)

    # largest shard generated on the device at once when writing a store:
    # 64M float32 (256 MB), so peak device memory is one shard
    _STORE_SHARD_ELEMENTS = 64_000_000

    def _generate_dataset_to_store(self, path: str, key: int) -> str:
        """Generate the offline dataset into a raw array store in shards of
        at most _STORE_SHARD_ELEMENTS floats: exact initial draws, simulated
        terminal particles and simulated 0T trajectories with their stamps.
        Each shard goes device -> pinned host buffer -> memmap once, as it
        lands.  The record (means, settings, key) goes beside the manifest
        (GROUND_TRUTH_FILE), and the manifest last.  Seconds per part and bytes are in data_timing."""
        p = self.cfg.pde_instance
        d2 = 2 * self.dim
        writer = ArrayStoreWriter(path)
        k_init, k_term, k_0T = rng.split(key, 3)
        timing = {"generate_s": 0.0, "to_host_s": 0.0, "write_s": 0.0}
        cuda = self.device.type == "cuda"
        clock = self._clock

        def shard_loop(total, per_item, gen_fn, outs, key):
            """gen_fn(key, n) -> tensors [n, ...], one per memmap in outs."""
            shard = max(1, min(total, self._STORE_SHARD_ELEMENTS // per_item))
            for start in range(0, total, shard):
                n = min(shard, total - start)
                t0 = clock()
                parts = gen_fn(rng.fold_in(key, start), n)
                t1 = clock()
                hosts = []
                for part in parts:
                    host = torch.empty(part.shape, dtype=part.dtype, pin_memory=cuda)
                    host.copy_(part)
                    hosts.append(host)
                t2 = clock()
                for out, host in zip(outs, hosts):
                    out[start:start + n] = host.numpy()
                t3 = clock()
                timing["generate_s"] += t1 - t0
                timing["to_host_s"] += t2 - t1
                timing["write_s"] += t3 - t2
            t0 = clock()
            for out in outs:
                out.flush()
            timing["write_s"] += clock() - t0

        def gen_initial(k, n):
            return (self._initial(k, n),)

        def gen_terminal(k, n):
            k0, k1 = rng.split(k, 2)
            return (self._sim(k1, self._initial(k0, n), p.n_steps_terminal, False)[0],)

        def gen_0T(k, n):
            k0, k1 = rng.split(k, 2)
            _, traj, taus = self._sim(k1, self._initial(k0, n), p.n_steps_0T, True)
            return traj, taus

        shard_loop(p.sample_initial_size, d2, gen_initial,
                   [writer.create("initial", (p.sample_initial_size, d2), np.float32)], k_init)
        shard_loop(p.sample_terminal_size, d2, gen_terminal,
                   [writer.create("terminal", (p.sample_terminal_size, d2), np.float32)], k_term)
        shard_loop(p.sample_0T_size, p.n_steps_0T * d2, gen_0T,
                   [writer.create("0T", (p.sample_0T_size, p.n_steps_0T, d2), np.float32),
                    writer.create("tau_0T", (p.sample_0T_size, p.n_steps_0T), np.float32)], k_0T)
        with open(os.path.join(path, GROUND_TRUTH_FILE), "w") as f:
            json.dump(self._record(key), f)
        writer.finalize()
        timing["bytes"] = store_bytes(path)
        self.data_timing = timing
        return path

    # -- models ------------------------------------------------------------------

    def create_parametric_model(self, generator: torch.Generator) -> GMMMeansModel:
        return GMMMeansModel(
            self.dim, self.configuration["n_Gaussian"], generator=generator
        ).to(self.device)

    def recovered_parameter_rel_l2(self, params) -> Optional[float]:
        """Rel-L2 of the recovered means under the best permutation match
        (component labels are exchangeable)."""
        if "mus" not in params:
            return None
        est = params["mus"].detach().to(self.device)
        true = self.configuration["mus"]
        k = true.shape[0]
        errs = [
            torch.linalg.norm(est[list(perm)] - true)
            for perm in itertools.permutations(range(k))
        ]
        return float(torch.min(torch.stack(errs)) / torch.linalg.norm(true))
