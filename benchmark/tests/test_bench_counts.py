"""The frozen work counts (``benchmark/roofline``) equal the port's own
arithmetic for table_lack as the benchmark was defined: the cursor's and
Sawyer's ``fp32_ops_per_env`` and the lane solver's counts."""

import pytest

import furniture_tpu_torch as ft
from furniture_tpu_torch.config import EnvConfig as PortEnvConfig, SimConfig
from furniture_tpu_torch.physics import lane_solver

import benchmark.reference as R
from benchmark.reference.config import EnvConfig
from benchmark.roofline import kernel1, kernel2, kernel3


@pytest.mark.parametrize("n", [1, 5, 50])
def test_kernel1_count_equals_megaphysics(n):
    ref = R.make("IKEACursor-v0", EnvConfig(), "cpu")
    for iters in (8, 12):
        port = ft.CursorEnv(PortEnvConfig(sim=SimConfig(solver_iters=iters)), device="cpu")
        assert kernel1.ops_per_env(ref.tables, iters, n) == port.physics.fp32_ops_per_env(n)
    ops, nbytes = kernel1.work(ref.tables, 12, 4096, n)
    assert ops == 4096 * kernel1.ops_per_env(ref.tables, 12, n)
    assert nbytes > 0


@pytest.mark.parametrize("n", [1, 50])
def test_kernel2_count_equals_armmegaphysics(n):
    port = ft.make_vec_env("IKEASawyer-v0", 1, device="cpu", control_type="impedance").env
    ref = R.make("IKEASawyer-v0", EnvConfig(control_type="impedance"), "cpu")
    assert kernel2.ops_per_env(ref.tables, ref.robot, 12, n) == port.physics.fp32_ops_per_env(n)
    assert kernel2.ops_per_env(ref.tables, ref.robot, 12, 50) == 96_051_000


def test_kernel3_counts_equal_the_lane_solver():
    for args in [(210, 170, 5, 12), (210, 170, 5, 12, 20, 10), (4153, 4000, 8, 12, 13, 9)]:
        assert kernel3.ops_per_env(*args) == lane_solver.fp32_ops_per_env(*args)
        assert kernel3.ops_per_env(*args, vel_b=True) == lane_solver.fp32_ops_per_env(*args, vel_b=True)
    for args in [(210, 5), (210, 5, 40, 20), (4153, 8, 30, 13)]:
        assert kernel3.bytes_per_env(*args) == lane_solver.bytes_per_env(*args)
