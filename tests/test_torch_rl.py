"""PyTorch port: the RL/IL stack against the JAX package.

* every network function against ``furniture_tpu.rl.networks`` with the
  JAX parameters carried across (``convert.rl_params_to_state_dict``);
  where JAX draws noise, the test draws it with JAX and hands it to the
  port: within 1e-5;
* the port's clip + Adam step against ``optax.chain(clip_by_global_norm,
  adam)`` on the same parameters and gradients, below and above the clip
  norm: within 1e-6 relative;
* BC against JAX ``make_bc`` with ``batch_size = n`` (the permutation only
  reorders one full batch): each epoch's loss within 1e-4 relative over 3
  epochs;
* GAE against a numpy transcription of the reference's scan;
* port-only mirrors of ``tests/test_rl.py`` (PPO, SAC, BC, the demo
  dataset, GAIL's discriminator, the checkpoint round trip, bit-exact with
  the generator state and ``keep=1`` pruning, the evaluation) and of
  ``tests/test_generated_demos.py``'s BC on the committed demos;
* ``train_rl --algo ppo`` for one iteration writes ``metrics.jsonl`` and
  ``result.json``.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from furniture_tpu.rl import bc as jbc
from furniture_tpu.rl import networks as JN
from furniture_tpu_torch import rl
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import rl_params_to_state_dict, state_dict_to_rl_params
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.rl import networks as N
from furniture_tpu_torch.rl.ppo import Transition, gae

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
OBS_D, ACT_D, BATCH, HIDDEN = 11, 4, 7, (32, 16)


def _obs(seed=0, n=BATCH, d=OBS_D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _module(cls, jparams, *args):
    m = cls(*args)
    m.load_state_dict(rl_params_to_state_dict(_np(jparams)))
    return m


# -- networks ------------------------------------------------------------------------


def test_flatten_obs_matches_jax():
    rng = np.random.default_rng(0)
    obs = {"robot_ob": rng.standard_normal((3, 8)), "object_ob": rng.standard_normal((3, 5, 7)),
           "subtask_ob": rng.integers(0, 4, (3, 2)).astype(np.int32)}
    want = np.asarray(JN.flatten_obs({k: jnp.asarray(v) for k, v in obs.items()}))
    got = N.flatten_obs({k: torch.from_numpy(v) for k, v in obs.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    assert N.obs_dim({k: torch.from_numpy(v) for k, v in obs.items()}) == JN.obs_dim(obs) == 45


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_mlp_matches_jax(activation):
    jp = JN.init_mlp(jax.random.PRNGKey(0), (OBS_D, *HIDDEN, 3), final_scale=0.5)
    act = {"tanh": jax.nn.tanh, "relu": jax.nn.relu}[activation]
    want = np.asarray(JN.mlp_apply(jp, jnp.asarray(_obs()), activation=act))
    m = _module(N.MLP, jp, (OBS_D, *HIDDEN, 3), activation)
    np.testing.assert_allclose(m(torch.from_numpy(_obs())).detach().numpy(), want, atol=1e-5)
    # the carried parameters come back unchanged
    back = state_dict_to_rl_params(m.state_dict())
    for a, b in zip(jax.tree.leaves(_np(jp)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_mlp_init_is_orthogonal():
    """Orthogonal rows/columns at gain √2 (hidden) and final_scale (last),
    zero biases, the same weights for the same seed."""
    m = N.MLP((OBS_D, 32, 5), "tanh", 0.01, torch.Generator().manual_seed(0))
    w0 = m.layers[0].weight.detach()                       # [32, 11]
    torch.testing.assert_close(w0.T @ w0, 2.0 * torch.eye(OBS_D), atol=1e-5, rtol=0)
    w1 = m.layers[1].weight.detach()                       # [5, 32]
    torch.testing.assert_close(w1 @ w1.T, 1e-4 * torch.eye(5), atol=1e-8, rtol=0)
    assert all(float(l.bias.detach().abs().max()) == 0.0 for l in m.layers)
    m2 = N.MLP((OBS_D, 32, 5), "tanh", 0.01, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))


def test_gaussian_policy_matches_jax():
    jp = JN.init_policy(jax.random.PRNGKey(1), OBS_D, ACT_D, HIDDEN)
    jp["log_std"] = jnp.linspace(-1.0, 0.5, ACT_D)
    pi = _module(N.GaussianPolicy, jp, OBS_D, ACT_D, HIDDEN)
    x = _obs(1)
    jmean, jlog_std = JN.policy_dist(jp, jnp.asarray(x))
    mean, log_std = pi.dist(torch.from_numpy(x))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean), atol=1e-5)
    np.testing.assert_allclose(log_std.detach().numpy(), np.asarray(jlog_std), atol=1e-5)
    key = jax.random.PRNGKey(2)
    ja, jl = JN.policy_sample(jp, jnp.asarray(x), key)
    eps = np.array(jax.random.normal(key, (BATCH, ACT_D)))
    a, lp = pi.sample(torch.from_numpy(x), noise=torch.from_numpy(eps))
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(
        N.gaussian_logp(torch.from_numpy(eps), mean, log_std).detach().numpy(),
        np.asarray(JN.gaussian_logp(jnp.asarray(eps), jmean, jlog_std)), atol=1e-5)
    np.testing.assert_allclose(N.gaussian_entropy(log_std).item(),
                               float(JN.gaussian_entropy(jlog_std)), atol=1e-5)
    # without noise the draw comes from the generator: same seed, same draw
    g = lambda: torch.Generator().manual_seed(3)
    assert torch.equal(pi.sample(torch.from_numpy(x), g())[0], pi.sample(torch.from_numpy(x), g())[0])


def test_tanh_policy_and_heads_match_jax():
    ks = jax.random.split(jax.random.PRNGKey(4), 4)
    jpi = JN.init_tanh_policy(ks[0], OBS_D, ACT_D, HIDDEN)
    jv = JN.init_value(ks[1], OBS_D, HIDDEN)
    jq = JN.init_q(ks[2], OBS_D, ACT_D, HIDDEN)
    x = _obs(5)
    eps = np.array(jax.random.normal(ks[3], (BATCH, ACT_D)))
    ja, jl, jdet = JN.tanh_policy_sample(jpi, jnp.asarray(x), ks[3])
    pi = _module(N.TanhGaussianPolicy, jpi, OBS_D, ACT_D, HIDDEN)
    a, lp, det = pi.sample(torch.from_numpy(x), noise=torch.from_numpy(eps))
    for got, want in ((a, ja), (lp, jl), (det, jdet), (pi.mode(torch.from_numpy(x)), jdet)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    v = _module(N.ValueHead, jv, OBS_D, HIDDEN)
    np.testing.assert_allclose(v(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(JN.value_apply(jv, jnp.asarray(x))), atol=1e-5)
    q = _module(N.QHead, jq, OBS_D, ACT_D, HIDDEN)
    act = np.asarray(ja)
    np.testing.assert_allclose(q(torch.from_numpy(x), torch.from_numpy(act)).detach().numpy(),
                               np.asarray(JN.q_apply(jq, jnp.asarray(x), jnp.asarray(act))),
                               atol=1e-5)


@pytest.mark.parametrize("max_norm", [1e3, 0.05], ids=["below_clip", "above_clip"])
def test_clipped_adam_matches_optax(max_norm):
    """Three updates with different gradients (so the bias correction and
    the moments are exercised), within 1e-6 relative."""
    jp = JN.init_policy(jax.random.PRNGKey(6), OBS_D, ACT_D, HIDDEN)
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(3e-3))
    pi = _module(N.GaussianPolicy, jp, OBS_D, ACT_D, HIDDEN)
    opt = N.ClippedAdam(pi.parameters(), 3e-3, max_norm)
    opt_state = tx.init(jp)
    rng = np.random.default_rng(7)
    norms = []
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), jp)
        norms.append(float(optax.global_norm(grads)))
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        sd = rl_params_to_state_dict(_np(grads))
        for name, p in pi.named_parameters():
            p.grad = sd[name].clone()
        opt.step()
    assert all(n > max_norm for n in norms) == (max_norm < 1.0)
    want = rl_params_to_state_dict(_np(jp))
    for name, p in pi.named_parameters():
        w = want[name].numpy().astype(np.float64)
        err = np.abs(p.detach().numpy() - w).max() / np.abs(w).max()
        assert err < 1e-6, (name, err)


# -- BC, GAE ----------------------------------------------------------------------------


def test_bc_matches_jax_full_batch():
    """BC with batch_size = n from the JAX-initialised policy: each of three
    epochs' loss and mse within 1e-4 relative of JAX's."""
    rng = np.random.default_rng(8)
    X = rng.standard_normal((64, 6)).astype(np.float32)
    Y = (X @ (0.3 * rng.standard_normal((6, 3)))).astype(np.float32)
    cfg = dict(lr=1e-3, batch_size=64, hidden=(32, 32))
    jinit, jfit, _ = jbc.make_bc(6, 3, jbc.BCConfig(**cfg))
    jst = jinit(jax.random.PRNGKey(0))
    init, fit, predict = rl.make_bc(6, 3, rl.BCConfig(**cfg), device="cpu")
    st = init(0)
    st.params.load_state_dict(rl_params_to_state_dict(_np(jst.params)))
    for _ in range(3):
        jst, jm = jfit(jst, X, Y)
        st, m = fit(st, X, Y)
        for k in ("loss", "mse"):
            assert abs(m[k].item() - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    assert predict(st.params, X[:4]).shape == (4, 3)


def test_gae_matches_numpy():
    rng = np.random.default_rng(9)
    T, B, gamma, lam = 6, 3, 0.99, 0.95
    rew = rng.standard_normal((T, B)).astype(np.float32)
    val = rng.standard_normal((T, B)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.3
    last = rng.standard_normal(B).astype(np.float32)
    # the reference's reverse scan (furniture_tpu/rl/ppo.py), in numpy
    adv = np.zeros((T, B), np.float64)
    g, nv = np.zeros(B), last.astype(np.float64)
    for t in reversed(range(T)):
        nonterm = 1.0 - done[t]
        delta = rew[t] + gamma * nv * nonterm - val[t]
        g = delta + gamma * lam * nonterm * g
        adv[t], nv = g, val[t]
    z = torch.zeros(T, B)
    traj = Transition(z, z, z, torch.from_numpy(val), torch.from_numpy(rew), torch.from_numpy(done))
    a, r = gae(traj, torch.from_numpy(last), gamma, lam)
    np.testing.assert_allclose(a.numpy(), adv, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), adv + val, atol=1e-5)


# -- the losses and their gradients against JAX -------------------------------------------


class _DimsEnv:
    """Just enough of an env for the JAX and the port's ``make_*`` to build:
    the observation and action widths."""
    device = torch.device("cpu")
    dof = ACT_D

    def reset(self, key):
        return None

    def reset_batch(self, n, generator):
        return None

    def observe(self, state):
        return {"x": torch.zeros((1, OBS_D))}


def _jax_inner(fn, *names):
    """The JAX package's nested function reached from ``fn`` through the
    closures named in ``names`` (a jit or partial is looked through)."""
    for name in names:
        fn = getattr(fn, "__wrapped__", fn)
        fn = getattr(fn, "func", fn)
        cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
        fn = cells[name].cell_contents
    return fn


def _hold_grads(module, jgrads, prefix=""):
    """Each parameter's gradient within 1e-5 of the leaf's max |grad| (JAX)."""
    want = rl_params_to_state_dict(_np(jgrads))
    got = {prefix + k: p.grad for k, p in module.named_parameters() if (prefix + k) in want}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        assert got[k] is not None, k
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[k] - w).abs().max())
        assert err <= 1e-5 * scale, (k, err, scale)


def _close(got, want, rel=1e-5):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    assert abs(float(got) - float(want)) <= rel * abs(float(want)), (float(got), float(want))


def test_ppo_loss_and_grads_match_jax():
    from furniture_tpu.rl import ppo as jppo

    cfg = rl.PPOConfig()
    jloss = _jax_inner(jppo.make_ppo(_DimsEnv(), jppo.PPOConfig())[1], "_update", "_loss")
    ks = jax.random.split(jax.random.PRNGKey(11), 2)
    jp = {"pi": JN.init_policy(ks[0], OBS_D, ACT_D, HIDDEN), "vf": JN.init_value(ks[1], OBS_D, HIDDEN)}
    jp["pi"]["log_std"] = jnp.linspace(-0.7, 0.3, ACT_D)
    rng = np.random.default_rng(12)
    n = 32
    obs = _obs(13, n)
    action = rng.standard_normal((n, ACT_D)).astype(np.float32)
    mean, log_std = JN.policy_dist(jp["pi"], jnp.asarray(obs))
    # old log-probabilities and values off the current ones, so that both
    # clips bind on some rows and not on others
    logp = np.asarray(JN.gaussian_logp(jnp.asarray(action), mean, log_std)) + rng.uniform(-0.5, 0.5, n)
    value = rng.standard_normal(n).astype(np.float32)
    adv = rng.standard_normal(n).astype(np.float32)
    ret = (value + 0.6 * rng.standard_normal(n)).astype(np.float32)
    logp = logp.astype(np.float32)
    done = np.zeros(n, np.float32)
    jbatch = jppo.Transition(*map(jnp.asarray, (obs, action, logp, value, adv, done)))
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jp, jbatch, jnp.asarray(adv), jnp.asarray(ret))
    ratio = np.exp(np.asarray(JN.gaussian_logp(jnp.asarray(action), mean, log_std)) - logp)
    assert ((ratio < 1 - cfg.clip_eps) | (ratio > 1 + cfg.clip_eps)).any() and \
        ((ratio > 1 - cfg.clip_eps) & (ratio < 1 + cfg.clip_eps)).any()

    params = torch.nn.ModuleDict({"pi": N.GaussianPolicy(OBS_D, ACT_D, HIDDEN),
                                  "vf": N.ValueHead(OBS_D, HIDDEN)})
    params.load_state_dict(rl_params_to_state_dict(_np(jp)))
    loss_fn = rl.make_ppo(_DimsEnv(), cfg)[1].loss
    batch = Transition(*(torch.from_numpy(np.asarray(x)) for x in (obs, action, logp, value, adv, done)))
    loss, aux = loss_fn(params, batch, torch.from_numpy(adv), torch.from_numpy(ret))
    loss.backward()
    _close(loss, jl)
    for k in ("pg_loss", "vf_loss", "entropy", "approx_kl"):
        _close(aux[k], jaux[k])
    _hold_grads(params, jg)


def test_sac_losses_and_grads_match_jax():
    from furniture_tpu.rl import sac as jsac

    jlosses = _jax_inner(jsac.make_sac(_DimsEnv(), jsac.SACConfig())[1], "_update", "_losses")
    ks = jax.random.split(jax.random.PRNGKey(21), 6)
    jp = {"pi": JN.init_tanh_policy(ks[0], OBS_D, ACT_D, HIDDEN),
          "q1": JN.init_q(ks[1], OBS_D, ACT_D, HIDDEN), "q2": JN.init_q(ks[2], OBS_D, ACT_D, HIDDEN),
          "log_alpha": jnp.asarray(0.3)}
    # targets apart from the critics, so that a mix-up shows
    jp["q1_t"] = jax.tree.map(lambda a: a * 1.1 + 0.01, jp["q1"])
    jp["q2_t"] = JN.init_q(ks[3], OBS_D, ACT_D, HIDDEN)
    rng = np.random.default_rng(22)
    n = 16
    batch = (_obs(23, n), rng.uniform(-0.9, 0.9, (n, ACT_D)).astype(np.float32),
             rng.standard_normal(n).astype(np.float32), _obs(24, n),
             (rng.uniform(size=n) < 0.3).astype(np.float32))
    key = ks[4]

    def total(trainable):
        pi, q1, q2, log_alpha = trainable
        return jlosses({**jp, "pi": pi, "q1": q1, "q2": q2, "log_alpha": log_alpha},
                       tuple(map(jnp.asarray, batch)), key)

    (jl, jaux), jg = jax.value_and_grad(total, has_aux=True)(
        (jp["pi"], jp["q1"], jp["q2"], jp["log_alpha"]))
    # the one draw both policy samples take from the key
    eps = np.array(jax.random.normal(key, (n, ACT_D)))

    nets = rl.sac.SACNets(OBS_D, ACT_D, HIDDEN, torch.Generator().manual_seed(0), "cpu")
    nets.load_state_dict(rl_params_to_state_dict(_np(jp)))
    losses = rl.make_sac(_DimsEnv(), rl.SACConfig())[1].losses
    loss, aux = losses(nets, tuple(map(torch.from_numpy, batch)), torch.from_numpy(eps))
    loss.backward()
    _close(loss, jl)
    for k in ("q_loss", "pi_loss", "alpha", "entropy"):
        _close(aux[k], jaux[k])
    for i, name in enumerate(("pi", "q1", "q2")):
        _hold_grads(nets[name], jg[i])
    _close(nets.log_alpha.grad, jg[3])
    assert all(p.grad is None for p in [*nets.q1_t.parameters(), *nets.q2_t.parameters()])


def test_gail_disc_loss_and_grads_match_jax():
    from furniture_tpu.rl import gail as jgail

    rng = np.random.default_rng(31)
    n, in_d = 24, OBS_D + ACT_D
    e_obs, e_act = _obs(32, 64), rng.uniform(-1, 1, (64, ACT_D)).astype(np.float32)
    gcfg = jgail.GAILConfig(hidden=HIDDEN)
    jloss = _jax_inner(jgail.make_gail(_DimsEnv(), None, gcfg, e_obs, e_act)[2], "disc_loss")
    jp = JN.init_mlp(jax.random.PRNGKey(33), (in_d, *HIDDEN, 1))
    ex, px = rng.standard_normal((n, in_d)).astype(np.float32), rng.standard_normal((n, in_d)).astype(np.float32)
    key = jax.random.PRNGKey(34)
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jp, jnp.asarray(ex), jnp.asarray(px), key)
    eps = np.array(jax.random.uniform(key, (n, 1)))

    made = rl.make_gail(_DimsEnv(), rl.PPOConfig(), rl.GAILConfig(hidden=HIDDEN), e_obs, e_act)
    disc = N.MLP((in_d, *HIDDEN, 1), "relu")
    disc.load_state_dict(rl_params_to_state_dict(_np(jp)))
    loss, aux = made[2].loss(disc, torch.from_numpy(ex), torch.from_numpy(px), torch.from_numpy(eps))
    loss.backward()
    _close(loss, jl)
    _close(aux["disc_bce"], jaux["disc_bce"])
    assert float(loss.detach()) - float(aux["disc_bce"]) > 1e-3   # the penalty is in the loss
    _hold_grads(disc, jg)


# -- port-only mirrors of tests/test_rl.py ------------------------------------------------


@pytest.fixture(scope="module")
def tiny_env():
    return CursorEnv(EnvConfig(sim=SimConfig(control_freq=100, solver_iters=2)), device="cpu")


def _params_delta(a, b):
    return sum(float((x - y).abs().sum()) for x, y in zip(a, b))


def _snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def test_ppo_iteration_updates_params(tiny_env):
    init, train = rl.make_ppo(
        tiny_env, rl.PPOConfig(num_envs=4, rollout_len=4, epochs=2, num_minibatches=2,
                               hidden=(32, 32)))
    st = init(0)
    p0 = _snapshot(st.params)
    st2, m = train(st)
    assert _params_delta(p0, st2.params.parameters()) > 0.0
    for k, v in m.items():
        assert np.isfinite(float(v)), k
    assert st2.step == 1
    assert st2.env_states.t.shape == (4,) and int(st2.env_states.t.max()) == 4


def test_sac_fills_buffer_and_updates(tiny_env):
    init, train = rl.make_sac(
        tiny_env, rl.SACConfig(num_envs=2, buffer_size=64, batch_size=8, hidden=(16, 16),
                               warmup=2, updates_per_step=1))
    st = init(2)
    p0 = _snapshot(st.params.pi)
    q1t0 = _snapshot(st.params.q1_t)
    for _ in range(4):
        st, m = train(st)
    assert st.buffer.size == 8 and st.buffer.ptr == 8
    assert _params_delta(p0, st.params.pi.parameters()) > 0.0
    assert _params_delta(q1t0, st.params.q1_t.parameters()) > 0.0      # Polyak
    assert np.isfinite(float(m["q_loss"]))
    assert float(st.buffer.obs[8:].abs().max()) == 0.0


def test_bc_fits_linear_expert():
    rng = np.random.RandomState(0)
    X = rng.randn(512, 6).astype(np.float32)
    W = 0.3 * rng.randn(6, 3).astype(np.float32)
    Y = X @ W
    init, fit, predict = rl.make_bc(6, 3, rl.BCConfig(batch_size=64, hidden=(64, 64)), device="cpu")
    st = init(3)
    for _ in range(150):
        st, m = fit(st, X, Y)
    assert float(m["mse"]) < 0.02
    pred = predict(st.params, X[:4])
    assert np.allclose(pred.numpy(), Y[:4], atol=0.5)


def test_bc_demo_dataset_roundtrip():
    demos = [{"obs": [{"a": np.ones(3), "b": np.zeros(2)}] * 4,
              "actions": [np.arange(5, dtype=np.float32)] * 3}]
    X, Y = rl.demos_to_dataset(demos)
    assert X.shape == (3, 5) and Y.shape == (3, 5)
    assert np.allclose(X[0], [1, 1, 1, 0, 0])       # sorted-key flattening


def test_gail_discriminator_separates(tiny_env):
    """Expert at +1, policy at -1 in a 4-dim (obs+act) space."""
    expert = np.ones((256, 2), np.float32)
    g_init, disc_reward, disc_update, _ = rl.make_gail(
        tiny_env, rl.PPOConfig(), rl.GAILConfig(hidden=(32, 32), disc_updates=20), expert, expert)
    st, policy_seed = g_init(4)
    assert isinstance(policy_seed, int)
    pol = -torch.ones((256, 2))
    for _ in range(5):
        st, m = disc_update(st, pol, pol)
    assert float(m["disc_acc"]) > 0.9
    rfn = disc_reward(st.params)
    r_exp = rfn(torch.ones(8, 2), torch.ones(8, 2), 0.0)
    r_pol = rfn(-torch.ones(8, 2), -torch.ones(8, 2), 0.0)
    assert float(r_exp.mean()) > float(r_pol.mean())


def test_checkpoint_roundtrip(tiny_env, tmp_path):
    """save/load restore the whole PPO state bit for bit (modules, the
    optimizer's moments and counts, the generator state, the env states,
    the step); keep=1 prunes to the newest."""
    from furniture_tpu_torch.utils.checkpoint import (
        checkpoint_step,
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )

    init, train = rl.make_ppo(
        tiny_env, rl.PPOConfig(num_envs=4, rollout_len=4, epochs=1, num_minibatches=2,
                               hidden=(16, 16)))
    st, _ = train(init(0))
    save_checkpoint(str(tmp_path), st, 0)
    st, _ = train(st)
    path1 = save_checkpoint(str(tmp_path), st, 1)
    assert path1.endswith("ckpt_1.pt")

    path = latest_checkpoint(str(tmp_path))
    assert path is not None and checkpoint_step(path) == 1
    restored = load_checkpoint(path, init(7))
    assert restored.step == st.step == 2
    for a, b in zip(st.params.state_dict().values(), restored.params.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = st.opt_state.state_dict(), restored.opt_state.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k in sa["state"]:
        assert sa["state"][k]["count"] == sb["state"][k]["count"] == 4   # 2 iterations x 2 minibatches
        for name in ("mu", "nu"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
    assert torch.equal(st.generator.get_state(), restored.generator.get_state())
    leaves = lambda t: [y for x in t for y in (leaves(x) if isinstance(x, tuple) else [x])]
    for a, b in zip(leaves(st.env_states), leaves(restored.env_states), strict=True):
        assert torch.equal(a, b)
    # the restored state trains on exactly as the original does
    _, m_a = train(st)
    _, m_b = train(restored)
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a)

    save_checkpoint(str(tmp_path), st, 2, keep=1)
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 2
    assert len([n for n in os.listdir(tmp_path) if n.startswith("ckpt_")]) == 1


def test_evaluate_success_rate(tiny_env):
    init, _ = rl.make_ppo(tiny_env, rl.PPOConfig(num_envs=2, rollout_len=2, hidden=(16, 16)))
    st = init(0)
    evaluate = rl.make_evaluate(tiny_env, rl.ppo_act, n_episodes=4, max_steps=3)
    m = evaluate(st.params, torch.Generator().manual_seed(1))
    assert 0.0 <= float(m["success_rate"]) <= 1.0
    assert np.isfinite(float(m["mean_reward"]))
    assert 0.0 <= float(m["mean_episode_len"]) <= 3.0


# -- the committed demos, and the entry point ----------------------------------------------


def test_bc_trains_on_generated_demos():
    """A mirror of tests/test_generated_demos.py: BC on the committed
    scripted demos loses loss over 5 epochs."""
    from furniture_tpu_torch.utils.demo import load_demo

    files = sorted(glob.glob(os.path.join(HERE, "..", "demos", "generated", "*.pkl")))
    assert files, "the committed demos are missing"
    X, Y = rl.demos_to_dataset([load_demo(f) for f in files])
    init, fit, predict = rl.make_bc(X.shape[-1], Y.shape[-1], rl.BCConfig(lr=3e-4), device="cpu")
    st = init(0)
    st, m0 = fit(st, X, Y)
    for _ in range(4):
        st, m = fit(st, X, Y)
    assert np.isfinite(float(m["mse"]))
    assert float(m["mse"]) < float(m0["mse"]), "BC loss did not decrease"
    assert predict(st.params, X[:64]).shape == (64, Y.shape[-1])


def test_train_rl_ppo_writes_metrics_and_result(tmp_path):
    from furniture_tpu_torch.tools.train_rl import main

    run_dir = str(tmp_path / "run")
    result = main(["--algo", "ppo", "--num_envs", "4", "--rollout_len", "4", "--iters", "1",
                   "--platform", "cpu", "--run_dir", run_dir, "--eval_episodes", "2",
                   "--eval_max_steps", "2"])
    lines = [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [l["iter"] for l in lines] == [0, "eval"]
    assert np.isfinite(lines[0]["loss"]) and "success_rate" in lines[1]
    on_disk = json.load(open(os.path.join(run_dir, "result.json")))
    assert on_disk["algo"] == "ppo" and on_disk["device"] == "cpu"
    assert on_disk == json.loads(json.dumps(result))
    assert os.path.exists(os.path.join(run_dir, "ckpt_0.pt"))
    with pytest.raises(RuntimeError, match="process group"):   # no group: never alone
        main(["--algo", "ppo", "--mesh", "2", "--platform", "cpu", "--run_dir", run_dir])
