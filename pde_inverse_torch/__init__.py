"""pde_inverse_torch — the PyTorch/CUDA port of ``pde_inverse_tpu``.

Same problems, losses, hypotheses and trainer semantics as the JAX package,
which stays beside it as the reference.  The configuration system is shared:
``pde_inverse_tpu.config`` is pure Python (no JAX import), so the port reads
the same ``Config`` dataclasses and ``PRESETS``.

The port grows slice by slice (ROADMAP.md).  Slice 1 is online kinetic
Fokker-Planck with a GMM potential and parametric means recovery
(``preset=KGMM``); its Langevin simulator is a hand-written CUDA kernel
(``csrc/langevin.cu``).  Slice 2 is the same problem with a non-parametric
PotentialMLP (``preset=KGMM-nonparametric-online``); its fused pointwise
pass and that pass's gradient are hand-written CUDA kernels
(``csrc/pointwise.cu``).  Slice 3 is online kinetic McKean-Vlasov with
exact-law batches (``preset=KMV`` and the non-parametric PotentialMLP
interaction kernel); its pairwise mean-field sums and their gradient are
hand-written CUDA kernels (``csrc/pairwise.cu``).  Every configuration
outside the slices raises
``NotImplementedError`` naming the ROADMAP item that will port it.

Importing any module of this package initialises neither CUDA nor JAX.
"""

__version__ = "0.1.0"
