"""The reference (``benchmark/reference``) against the port's plain path on
the CPU at a small size: the same draws and inputs give the same reset, the
same cursor step, Sawyer impedance step and MPPI plan, to the bit."""

import torch

import furniture_tpu_torch as ft
from furniture_tpu_torch.config import SimConfig
from furniture_tpu_torch.planning import MPPIConfig, make_mppi

import benchmark.reference as R
from benchmark import checks
from benchmark.reference.config import EnvConfig as RefEnvConfig, SimConfig as RefSimConfig
from benchmark.reference.planning.mppi import MPPIConfig as RefMPPIConfig
from benchmark.reference.planning.mppi import make_mppi as ref_make_mppi


def _widest(a, b, B):
    return float(checks.row_gaps(a, b, B).max())


def _pair(env_id, B, seed, **kw):
    vec = ft.make_vec_env(env_id, B, seed=seed, device="cpu", sim=SimConfig(control_freq=100), **kw)
    vec.reset()
    ref = R.make(env_id, RefEnvConfig(sim=RefSimConfig(control_freq=100), **kw), "cpu")
    g = torch.Generator().manual_seed(seed)
    return vec, ref, ref.reset_batch(B, g)


def _steps(env_id, **kw):
    B = 3
    vec, ref, rs = _pair(env_id, B, 11, **kw)
    assert _widest(vec.state, rs, B) == 0.0
    g = torch.Generator().manual_seed(12)
    for _ in range(2):
        a = torch.rand((B, vec.env.dof), generator=g) * 2 - 1
        pre = vec.state
        got = vec.env.step_batch(pre, a)
        want = ref.step_batch(checks.rebuild(pre, rs), a)
        assert float(checks.step_rows(got, want).max()) == 0.0
        vec.step(a)


def test_cursor_step_agrees_with_the_port():
    _steps("IKEACursor-v0")


def test_sawyer_impedance_step_agrees_with_the_port():
    _steps("IKEASawyer-v0", control_type="impedance")


def test_mppi_plan_agrees_with_the_port():
    vec, ref, rs = _pair("IKEACursor-v0", 1, 21)
    cfg = dict(horizon=3, n_samples=4, sigma=0.3, temperature=1.0, gamma=1.0)
    g = torch.Generator().manual_seed(22)
    noise = torch.randn((4, 3, 15), generator=g) * 0.3
    mean = torch.zeros((3, 15))
    got_mean, got = make_mppi(vec.env, MPPIConfig(**cfg))(vec.state, mean, None, noise=noise)
    want_mean, want = ref_make_mppi(ref, RefMPPIConfig(**cfg))(rs, mean, None, noise=noise)
    assert torch.equal(got_mean, want_mean)
    assert torch.equal(got["costs"], want["costs"])


def test_control_rounds_the_state():
    vec, ref, rs = _pair("IKEACursor-v0", 2, 31)
    low = R.make("IKEACursor-v0", RefEnvConfig(sim=RefSimConfig(control_freq=100)), "cpu",
                 state_dtype=torch.bfloat16)
    a = torch.zeros((2, 15))
    want = ref.step_batch(rs, a)
    got = low.step_batch(rs, a)
    assert float(checks.step_rows(got, want).max()) > 1e-4
