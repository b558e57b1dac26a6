"""The port's diagnostic scripts (counterparts of the JAX package's
``scripts/diag_packed_onchip.py``, ``scripts/microtest_sublane_reduce.py``
and ``scripts/microtest_blkdiag_dot.py``), each run as

    python -m pde_inverse_torch.scripts.<name> [--device cpu]

on the card by default, and three measurement scripts of the card's time:
``time_langevin`` (K1/K2 at the KGMM paths' shapes), ``time_pairwise``
(K7/K8 at the KMV MLP shape) and ``profile_step`` (where a training step's
time goes, under ``torch.profiler``).  Importing one initialises nothing.
"""
