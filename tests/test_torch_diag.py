"""S1-S3, the port's diagnostic checks, on the CPU: their plain versions
against numpy float64 (the kernels themselves run on the card,
tests/test_torch_diag_cuda.py)."""

import numpy as np
import pytest
import torch

from pde_inverse_torch.ops.cuda import mma_tf32
from pde_inverse_torch.ops.cuda import pairwise as pw
from pde_inverse_torch.scripts import diag_packed_onchip as s1
from pde_inverse_torch.scripts import microtest_blkdiag_dot as s3
from pde_inverse_torch.scripts import microtest_sublane_reduce as s2
from pde_inverse_torch.scripts import ablate_s3, profile_step, time_langevin

torch.set_num_threads(1)


def test_s1_plain_versions_pass_every_check(capsys):
    out = s1.run("cpu")
    printed = capsys.readouterr().out
    assert out["ok"] and out["checks"] == 22 and out["max_abs_err"] == 0.0
    assert printed.count("[OK ]") == 22 and printed.strip().endswith("DIAG OK")
    assert s1.main(["--device", "cpu"]) == 0


def test_s1_pair_rows_and_m_layer_plain_against_float64():
    """Tolerance: one f32 rounding of each difference (pair rows, exact up to
    it) and of a 20-term f32 dot (the M layer), 1e-6 relative."""
    rs = np.random.default_rng(3)
    ax, av = rs.normal(size=(2, 16, 20))
    ar = rs.normal(size=(48, 20))
    z, dz = pw.s1_pair_rows_plain(*(torch.from_numpy(a.astype(np.float32)) for a in (ax, av, ar)))
    np.testing.assert_allclose(z.numpy(), ax[None] - ar[:, None], rtol=1e-6, atol=1e-6)
    assert dz.shape == (48, 16, 20) and np.array_equal(dz.numpy()[7], av.astype(np.float32))
    g3, M = rs.normal(size=(3, 16, 20)), rs.normal(size=(20, 20))
    got = pw.s1_m_layer_plain(torch.from_numpy(g3.astype(np.float32)), torch.from_numpy(M.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), g3 @ M, rtol=1e-5, atol=1e-5)


def test_sum_rows_plain_adds_in_row_order():
    part = torch.tensor([[1.0, 1e8], [1e-8, -1e8], [2.0, 1.0]])
    assert pw.sum_rows_plain(part).tolist() == [3.0, 1.0]  # (1 + 1e-8) rounds to 1 first
    x = np.random.default_rng(4).normal(size=(300, 7)).astype(np.float32)
    np.testing.assert_allclose(pw.sum_rows_plain(torch.from_numpy(x)).numpy(), x.astype(np.float64).sum(0),
                               rtol=0, atol=299 * 2.0**-24 * np.abs(x).sum(0).max())


def test_round_tf32_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one, one + ulp / 2, one + ulp / 4, -(one + ulp / 2), one + 3 * ulp / 4, 3.0e-3],
                     dtype=torch.float32)
    got = mma_tf32.round_tf32(x).tolist()
    assert got[:5] == [one, one + ulp, one, -(one + ulp), one + ulp]
    bits = mma_tf32.round_tf32(torch.randn(1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    y = torch.randn(1000)
    assert float(((mma_tf32.round_tf32(y) - y).abs() / y.abs()).max()) <= 2.0**-11


@pytest.mark.parametrize("precision,tol", [("tf32", 2.0**-10 + 8 * 2.0**-24),
                                            ("3xtf32", 2.0**-20 + 24 * 2.0**-24)])
@pytest.mark.parametrize("transpose_b", [False, True])
def test_tf32_plain_one_tile_against_float64(precision, tol, transpose_b):
    """The (16, 8, 8) tile the kernel is first held at: every entry within
    its rounding bound over sum_k |a_ik| |b_kj|."""
    rs = np.random.default_rng(5)
    a, b = rs.normal(size=(16, 8)), rs.normal(size=(8, 8))
    got = mma_tf32.tf32_matmul(torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32)),
                               precision, transpose_b=transpose_b).double().numpy()
    a32, b32 = a.astype(np.float32).astype(np.float64), b.astype(np.float32).astype(np.float64)
    bb = b32.T if transpose_b else b32
    err = np.abs(got - a32 @ bb)
    assert (err <= tol * (np.abs(a32) @ np.abs(bb))).all()
    if precision == "tf32":
        assert err.max() > 1e-5  # TF32 is visibly coarser than float32


def test_s2_plain_versions_within_their_rounding_bounds(capsys):
    out = s2.run("cpu")
    assert out["ok"] and len(out["rows"]) == 9 and out["max_abs_err"] == 0.0
    rel = {(R, w, mode): r for R, w, mode, _, _, r in out["rows"]}
    # 3xTF32 is f32-accurate, TF32 is not (the envelope the JAX script measured)
    assert rel[(2048, 120, "dot_hi")] < 1e-6 < rel[(2048, 120, "dot")]
    assert "rel(cancel-scale)=" in capsys.readouterr().out


@pytest.mark.parametrize("mode", s2.MODES)
@pytest.mark.parametrize("fault", ["zeros", "last k-step dropped", "one row twice"])
def test_s2_fails_a_wrong_sum(monkeypatch, mode, fault):
    """S2 holds each mode against its plain version and, on columns whose
    sums do not cancel, against float64: a kernel that returned zeros, left
    out a k-step of 8 rows or added a row twice would fail the run."""
    right = s2.reduce

    def wrong(m, x):
        if m != mode:
            return right(m, x)
        if fault == "zeros":
            return torch.zeros(x.shape[1])
        if fault == "last k-step dropped":
            return right(m, x[:-8])
        return right(m, x) + x[0]

    monkeypatch.setattr(s2, "reduce", wrong)
    assert not s2.run("cpu")["ok"]


def test_s3_plain_versions_within_their_rounding_bounds(capsys):
    out = s3.run("cpu")
    assert out["ok"] and len(out["rows"]) == 12 and out["max_abs_err"] == 0.0
    for R, pw_, mode, tag, rel in out["rows"]:
        assert rel < (1e-3 if tag == "def" else 1e-6), (R, pw_, mode, tag, rel)
    assert s3.main(["--device", "cpu"]) == 0 and s2.main(["--device", "cpu"]) == 0
    assert "[2048x120 bwd] hi  rel=" in capsys.readouterr().out


def test_scripts_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script in (s1, s2, s3):
        with pytest.raises(RuntimeError, match="cuda"):
            script.main([])


def test_time_langevin_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        time_langevin.main(["--pack", "1", "2"])
    with pytest.raises(SystemExit, match="CUDA"):
        ablate_s3.main([])


def test_profile_step_runs_offline_steps_on_the_cpu(capsys):
    """The profiling script drives whole training steps (here of a small
    offline KGMM run); on the CPU it records no device time."""
    import json

    assert profile_step.main([
        "preset=KGMM-offline", "device=cpu", "pde_instance.sample_initial_size=300",
        "pde_instance.sample_terminal_size=150", "pde_instance.sample_0T_size=40",
        "pde_instance.n_steps_0T=20", "pde_instance.n_steps_terminal=20", "--steps", "2",
        "--warmup", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 2 and line["device"] == "cpu" and line["device_ms_per_step"] == 0.0
    assert line["wall_ms_per_step"] > 0 and line["uninstrumented_ms_per_step"] > 0
