"""The port's RL stack (ray_tpu_torch.rl) side by side with the JAX
package's ray_tpu.rl.

Numerics: the JAX function and its port take the same numpy inputs, the
port's weights coming from the JAX package's init through
models/convert.py `rl_params_from_numpy`:
  - module forwards, `logp_entropy`, the Gaussian and the squashed-Gaussian
    logp (the noise passed in): 1e-5;
  - `compute_gae`, replay sampling, connectors and `rollouts_to_dataset` /
    `rollouts_to_transitions`: exact;
  - `vtrace`: 1e-5;
  - the PPO, IMPALA, APPO, DQN, BC and MARWIL losses and each gradient
    leaf: 1e-5 of the leaf's norm;
  - one SAC update and one CQL update (the JAX update's key split into the
    same draws): every param, target and Adam moment within 1e-5 of its
    norm, every metric 1e-5;
  - a 3-step learner trajectory against optax's chain of
    clip_by_global_norm and adam, clipping and not: 1e-5;
  - a learner checkpoint's params crossed both ways bit for bit, and Adam's
    state crossed through the converter bit for bit.
The learners and SAC/CQL/DQN updates run on CUDA unless given
device="cpu", and raise without a card; env runners run on the CPU.

tests/test_torch_rl_algos.py runs tests/test_rl.py's behaviour cases on
both packages.
"""

import copy
import functools
import importlib
import types

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.models import convert
from torch_waits import bounded

TOL = 1e-5
CASE_S = 120
PACKAGES = ("jax", "torch")


def _ns(name):
    pkg = {"jax": ray_tpu, "torch": ray_tpu_torch}[name]
    mods = {m: importlib.import_module(f"{pkg.__name__}.rl.{m}") for m in (
        "module", "learner", "env_runner", "connectors", "ppo", "impala", "appo", "dqn", "sac",
        "cql", "offline", "multi_agent", "replay")}
    return types.SimpleNamespace(name=name, rt=pkg, rl=importlib.import_module(f"{pkg.__name__}.rl"),
                                 kw={"device": "cpu"} if name == "torch" else {}, **mods)


def _jax_params(module, seed=0):
    import jax

    return jax.device_get(module.init_params(jax.random.PRNGKey(seed)))


def _weights(ns, module, seed=0):
    """Initial weights for a group's sync_weights, in the package's form."""
    if ns.name == "jax":
        return _jax_params(module, seed)
    return convert.rl_params_to_numpy(module.init_params(torch.Generator().manual_seed(seed),
                                                         device="cpu"))


def _t(x):
    return torch.as_tensor(np.array(x))  # a writable copy (JAX's host arrays are read-only)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.linalg.norm(want)), 1.0) if want.ndim else max(abs(float(want)), 1.0)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _close_trees(got, want, tol=TOL):
    gp, gl = convert.flatten(got)
    wp, wl = convert.flatten(want)
    assert gp == wp, (gp, wp)
    for path, g, w in zip(gp, gl, wl):
        _close(g, w, tol, "/".join(map(str, path)))


def _modules(name, kind):
    """(JAX module, port module) of one kind, at a small width."""
    out = []
    for ns in (_ns("jax"), _ns(name)):
        m = ns.module
        if kind == "discrete":
            out.append(m.DiscretePolicyModule(m.DiscretePolicyConfig(obs_dim=4, n_actions=3,
                                                                      hidden=(16, 16))))
        elif kind == "gaussian":
            out.append(m.GaussianPolicyModule(m.GaussianPolicyConfig(
                obs_dim=3, act_dim=2, hidden=(16,), low=(-2.0, -1.0), high=(2.0, 1.0),
                init_log_std=-0.3)))
        elif kind == "q":
            out.append(ns.dqn.QModule(m.DiscretePolicyConfig(obs_dim=4, n_actions=3,
                                                             hidden=(16, 16))))
        else:
            out.append(ns.sac.SquashedGaussianModule(3, 2, hidden=(16, 16), low=-2.0, high=2.0))
    return out


# ------------------------------------------------------------- modules


@pytest.mark.parametrize("kind", ["discrete", "gaussian", "q", "squashed"])
def test_module_forward_matches_jax(kind):
    jm, tm = _modules("torch", kind)
    tree = _jax_params(jm)
    params = convert.rl_params_from_numpy(tree, device="cpu")
    back = convert.rl_params_to_numpy(params)
    bp, bl = convert.flatten(back)
    tp, tl = convert.flatten(tree)
    assert bp == tp and all(np.array_equal(b, np.asarray(t)) and b.dtype == np.asarray(t).dtype
                            for b, t in zip(bl, tl))
    obs_dim = 4 if kind in ("discrete", "q") else 3
    obs = np.random.default_rng(0).normal(size=(32, obs_dim)).astype(np.float32)
    want = jm.forward_inference(tree, obs)
    got = tm.forward_inference(params, _t(obs))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], what=k)


def test_discrete_logp_entropy_matches_jax():
    from ray_tpu.rl import module as jmod
    from ray_tpu_torch.rl import module as tmod

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(64, 5)).astype(np.float32) * 3
    actions = rng.integers(0, 5, size=64)
    want = jmod.logp_entropy(logits, actions)
    got = tmod.logp_entropy(_t(logits), _t(actions))
    for g, w in zip(got, want):
        _close(g, w)
    mask = (rng.random(64) > 0.3).astype(np.float32)
    _close(tmod.masked_mean(_t(logits[:, 0]), _t(mask)), jmod.masked_mean(logits[:, 0], mask))


def test_gaussian_sample_logp_entropy_matches_jax():
    import jax

    jm, tm = _modules("torch", "gaussian")
    tree = _jax_params(jm)
    params = convert.rl_params_from_numpy(tree, device="cpu")
    obs = np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32)
    jout = jm.forward_inference(tree, obs)
    tout = tm.forward_inference(params, _t(obs))
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, jout["mean"].shape, jout["mean"].dtype))
    ja, jl = jm.sample(key, jout)
    ta, tl = tm.sample(None, tout, noise=_t(noise))
    _close(ta, ja, what="action")
    _close(tl, jl, what="logp")
    for g, w in zip(tm.logp_entropy(tout, ta), jm.logp_entropy(jout, ja)):
        _close(g, w)
    _close(tm.clip_action(_np(ta)), jm.clip_action(ja), what="clip")


def test_squashed_gaussian_logp_matches_jax():
    import jax

    jm, tm = _modules("torch", "squashed")
    tree = _jax_params(jm)
    params = convert.rl_params_from_numpy(tree, device="cpu")
    obs = np.random.default_rng(4).normal(size=(16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (16, 2), np.float32))
    ja, jl = jm.pi_sample(tree, key, obs)
    ta, tl = tm.pi_sample(params, None, _t(obs), noise=_t(noise))
    _close(ta, ja, what="action")
    _close(tl, jl, what="logp")
    assert float(np.max(np.abs(_np(ta)))) <= 2.0 + 1e-5
    q_in = np.random.default_rng(6).uniform(-2, 2, size=(16, 2)).astype(np.float32)
    _close(tm.q_value(params.q1, _t(obs), _t(q_in)), jm.q_value(tree["q1"], obs, q_in))


# ------------------------------------------------- numpy parts: exact


def _rollout(rng, T=16, N=4, obs_dim=4, continuous=False):
    dones = (rng.random((T, N)) < 0.15).astype(np.float32)
    terms = dones * (rng.random((T, N)) < 0.6)
    mask = np.ones((T, N), np.float32)
    mask[1:][dones[:-1] > 0] = 0.0
    acts = (rng.normal(size=(T, N, 2)).astype(np.float32) if continuous
            else rng.integers(0, 2, size=(T, N)))
    return {
        "obs": rng.normal(size=(T, N, obs_dim)).astype(np.float32),
        "actions": acts,
        "logp": rng.normal(size=(T, N)).astype(np.float32) * 0.1 - 0.7,
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": dones, "terminateds": terms.astype(np.float32), "mask": mask,
        "last_obs": rng.normal(size=(N, obs_dim)).astype(np.float32),
        "last_values": rng.normal(size=(N,)).astype(np.float32),
    }


def test_compute_gae_is_exact():
    from ray_tpu.rl.ppo import compute_gae as jgae
    from ray_tpu_torch.rl.ppo import compute_gae as tgae

    ro = _rollout(np.random.default_rng(7))
    args = (ro["rewards"], ro["values"], ro["dones"], ro["last_values"], 0.99, 0.95)
    for kw in ({}, {"terminateds": ro["terminateds"]}):
        for g, w in zip(tgae(*args, **kw), jgae(*args, **kw)):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_replay_sampling_is_exact():
    rng = np.random.default_rng(8)
    ros = [_rollout(rng) for _ in range(5)]
    out = {}
    for name in PACKAGES:
        buf = _ns(name).replay.TransitionReplayBuffer(capacity=50, seed=3)
        added = [buf.add_rollout(ro) for ro in ros]
        out[name] = (added, len(buf), [buf.sample(17) for _ in range(4)])
    assert out["torch"][:2] == out["jax"][:2]
    for g, w in zip(out["torch"][2], out["jax"][2]):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def _connector_run(c, dones_seq):
    rng = np.random.default_rng(9)
    outs = []
    for dones in dones_seq:
        obs = (rng.normal(size=(4, 2, 3)) * 3 + 1).astype(np.float32)
        outs.append(c(obs, dones=dones) if dones is not None else c(obs))
    return outs


def test_connectors_are_exact():
    dones_seq = [None, np.array([False, True, False, False]), np.array([True, False, False, True]),
                 np.zeros(4, bool), np.array([False, False, True, False])]
    outs, states = {}, {}
    for name in PACKAGES:
        c = _ns(name).connectors
        pipe = c.ConnectorPipeline([c.FlattenObs(), c.ClipObs(-5, 5), c.NormalizeObs(),
                                    c.FrameStack(k=3)])
        outs[name] = _connector_run(pipe, dones_seq)
        states[name] = pipe.get_state()
        act = c.ActionPipeline([c.UnsquashAction(low=[0.0, -2.0], high=[10.0, 2.0]),
                                c.ClipAction(low=1.0, high=9.0)])
        outs[name].append(act(np.array([[1.0, 0.0], [-3.0, 0.5]], np.float32)))
        norm = c.NormalizeObs()
        norm.set_state(copy.deepcopy(states[name][2]))
        norm.freeze()
        outs[name].append(norm(np.ones((2, 6), np.float32)))
    for g, w in zip(outs["torch"], outs["jax"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for i in states["jax"]:
        for k, w in states["jax"][i].items():
            g = states["torch"][i][k]
            assert np.array_equal(np.asarray(g), np.asarray(w)), (i, k)


def _dataset_rows(name, fn):
    ns = _ns(name)
    ns.rt.shutdown()
    ns.rt.init(local_mode=True, num_cpus=2)
    try:
        return bounded(lambda: fn(ns).take_all(), CASE_S)
    finally:
        ns.rt.shutdown()


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def test_rollouts_to_dataset_and_transitions_are_exact():
    rng = np.random.default_rng(10)
    ros = [_rollout(rng, T=12, N=3), _rollout(rng, T=9, N=3, continuous=True),
           _rollout(rng, T=7, N=3, continuous=True)]
    for fn in (lambda ns: ns.offline.rollouts_to_dataset(ros[:1], gamma=0.9),
               lambda ns: ns.offline.rollouts_to_dataset(ros[1:], gamma=0.5),
               lambda ns: ns.offline.rollouts_to_transitions(ros[1:])):
        _same_rows(_dataset_rows("torch", fn), _dataset_rows("jax", fn))


# ----------------------------------------------------------- vtrace, losses


def test_vtrace_matches_jax():
    from ray_tpu.rl.impala import vtrace as jv
    from ray_tpu_torch.rl.impala import vtrace as tv

    rng = np.random.default_rng(11)
    ro = _rollout(rng, T=20, N=5)
    target = ro["logp"] + rng.normal(size=ro["logp"].shape).astype(np.float32) * 0.5
    for kw in ({}, {"terminateds": ro["terminateds"], "mask": ro["mask"]}):
        want = jv(ro["logp"], target, ro["rewards"], ro["values"], ro["dones"],
                  ro["last_values"], gamma=0.97, **kw)
        got = tv(_t(ro["logp"]), _t(target), _t(ro["rewards"]), _t(ro["values"]),
                 _t(ro["dones"]), _t(ro["last_values"]), gamma=0.97,
                 **{k: _t(v) for k, v in kw.items()})
        for g, w in zip(got, want):
            _close(g, w)


def _batch(kind, rng):
    """A loss's batch for the JAX function and the port, as numpy."""
    B = 48
    if kind in ("impala", "appo"):
        ro = _rollout(rng, T=8, N=6, obs_dim=4)
        ro["actions"] = rng.integers(0, 3, size=(8, 6))
        return {k: ro[k] for k in ("obs", "actions", "logp", "rewards", "dones", "terminateds",
                                   "mask", "last_obs")}
    obs_dim = 3 if kind == "ppo_gaussian" else 4
    b = {"obs": rng.normal(size=(B, obs_dim)).astype(np.float32)}
    if kind == "ppo_gaussian":
        b["actions"] = rng.normal(size=(B, 2)).astype(np.float32)
    else:
        b["actions"] = rng.integers(0, 3, size=B)
    if kind.startswith("ppo"):
        b.update(logp=(rng.normal(size=B) * 0.2 - 1.0).astype(np.float32),
                 advantages=rng.normal(size=B).astype(np.float32),
                 returns=rng.normal(size=B).astype(np.float32),
                 mask=(rng.random(B) > 0.2).astype(np.float32))
    elif kind == "dqn":
        b["targets"] = rng.normal(size=B).astype(np.float32) * 2
    elif kind == "marwil":
        b["returns"] = rng.normal(size=B).astype(np.float32)
    return b


def _losses(name, kind):
    ns = _ns(name)
    if kind.startswith("ppo"):
        return functools.partial(ns.ppo.ppo_loss, clip=0.2, vf_coeff=0.5, ent_coeff=0.01)
    if kind == "impala":
        return functools.partial(ns.impala.impala_loss, gamma=0.99, vf_coeff=0.5, ent_coeff=0.01)
    if kind == "appo":
        return functools.partial(ns.appo.appo_loss, gamma=0.99, vf_coeff=0.5, ent_coeff=0.01,
                                 clip_param=0.3)
    if kind == "dqn":
        return ns.dqn.dqn_loss
    if kind == "bc":
        return ns.offline.bc_loss
    return functools.partial(ns.offline.marwil_loss, beta=1.5, vf_coeff=0.7)


def _grad_tree(params, grads):
    """The gradients in the JAX tree's layout."""
    holder = copy.deepcopy(params)
    for p, g in zip(holder.parameters(), grads):
        p.data = torch.zeros_like(p) if g is None else g.detach()
    for b in holder.buffers():  # a leaf no loss reaches: JAX's gradient is 0
        b.zero_()
    return convert.rl_params_to_numpy(holder)


@pytest.mark.parametrize("kind", ["ppo", "ppo_gaussian", "impala", "appo", "dqn", "bc",
                                  "marwil"])
def test_loss_and_gradients_match_jax(kind):
    import jax

    mk = {"ppo_gaussian": "gaussian", "dqn": "q"}.get(kind, "discrete")
    jm, tm = _modules("torch", mk)
    tree = _jax_params(jm, seed=1)
    batch = _batch(kind, np.random.default_rng(12))
    jloss = _losses("jax", kind)
    (want, wmet), wgrad = jax.value_and_grad(lambda p: jloss(jm, p, batch), has_aux=True)(tree)
    params = convert.rl_params_from_numpy(tree, device="cpu")
    got, gmet = _losses("torch", kind)(tm, params, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(got, list(params.parameters()), allow_unused=True)
    _close(got, want, what="loss")
    assert sorted(gmet) == sorted(wmet)
    for k in wmet:
        _close(gmet[k], wmet[k], what=k)
    _close_trees(_grad_tree(params, grads), jax.device_get(wgrad))


def _sac_batch(rng, B=32):
    return {"obs": rng.normal(size=(B, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, size=(B, 2)).astype(np.float32),
            "rewards": rng.normal(size=B).astype(np.float32),
            "next_obs": rng.normal(size=(B, 3)).astype(np.float32),
            "terminateds": (rng.random(B) < 0.2).astype(np.float32)}


def _jax_adam_trees(opt):
    """{name: ScaleByAdamState} of SAC's three optax adams as numpy dicts."""
    import jax

    return {k: {"count": np.asarray(s[0].count), "mu": jax.device_get(s[0].mu),
                "nu": jax.device_get(s[0].nu)} for k, s in opt.items()}


@pytest.mark.parametrize("algo", ["sac", "cql"])
def test_one_sac_and_cql_update_match_jax(algo):
    import jax
    import optax

    from ray_tpu.rl import cql as jcql
    from ray_tpu.rl import sac as jsac
    from ray_tpu_torch.rl import cql as tcql
    from ray_tpu_torch.rl import sac as tsac

    N = 4
    jm = jsac.SquashedGaussianModule(3, 2, hidden=(16, 16), low=-2.0, high=2.0)
    if algo == "sac":
        j = jsac.SAC.__new__(jsac.SAC)
        j.config = jsac.SACConfig(gamma=0.97, tau=0.05, actor_lr=1e-3, critic_lr=2e-3,
                                  alpha_lr=3e-3)
    else:
        j = jcql.CQL(jcql.CQLConfig(obs_dim=3, act_dim=2, action_low=-2.0, action_high=2.0,
                                    cql_alpha=2.0, n_action_samples=N, gamma=0.97, tau=0.05,
                                    actor_lr=1e-3, critic_lr=2e-3, alpha_lr=3e-3,
                                    hidden=(16, 16)))
    j.module, j.target_entropy = jm, -2.0
    j._tx = {"pi": optax.adam(1e-3), "q": optax.adam(2e-3), "alpha": optax.adam(3e-3)}
    params = _jax_params(jm, seed=2)
    params["log_alpha"] = np.asarray(-0.4, np.float32)
    target = {"q1": copy.deepcopy(params["q1"]), "q2": copy.deepcopy(params["q2"])}
    opt = {"pi": j._tx["pi"].init(params["pi"]),
           "q": j._tx["q"].init({"q1": params["q1"], "q2": params["q2"]}),
           "alpha": j._tx["alpha"].init(params["log_alpha"])}
    batch = _sac_batch(np.random.default_rng(13))
    B = len(batch["obs"])
    key = jax.random.PRNGKey(21)
    new_p, new_t, new_opt, metrics = j._update_impl(params, target, opt, key, batch)

    # The JAX update's draws, from its own key split.
    if algo == "sac":
        k1, k2 = jax.random.split(key)
        noise = {"next": jax.random.normal(k1, (B, 2)), "pi": jax.random.normal(k2, (B, 2))}
        learner = tsac.SACLearner(
            tsac.SquashedGaussianModule(3, 2, hidden=(16, 16), low=-2.0, high=2.0),
            gamma=0.97, tau=0.05, actor_lr=1e-3, critic_lr=2e-3, alpha_lr=3e-3,
            target_entropy=-2.0, seed=0, device="cpu")
    else:
        k_next, k_pi, k_unif, k_cur = jax.random.split(key, 4)
        lo, hi = jm.center - jm.scale, jm.center + jm.scale
        noise = {"next": jax.random.normal(k_next, (B, 2)), "pi": jax.random.normal(k_pi, (B, 2)),
                 "unif": jax.random.uniform(k_unif, (N, B, 2), minval=lo, maxval=hi),
                 "cur": jax.numpy.stack([jax.random.normal(kk, (B, 2))
                                         for kk in jax.random.split(k_cur, N)])}
        learner = tcql.CQLLearner(
            tsac.SquashedGaussianModule(3, 2, hidden=(16, 16), low=-2.0, high=2.0),
            cql_alpha=2.0, n_action_samples=N, gamma=0.97, tau=0.05, actor_lr=1e-3,
            critic_lr=2e-3, alpha_lr=3e-3, target_entropy=-2.0, seed=0, device="cpu")
    learner.load(params, target)
    got = learner.update(batch, noise={k: np.array(v) for k, v in noise.items()})
    for k, v in metrics.items():
        _close(got[k], v, what=k)
    state = learner.state()
    _close_trees(state["params"], jax.device_get(new_p))
    _close_trees(state["target_q"], jax.device_get(new_t))
    want_opt = _jax_adam_trees(new_opt)
    for k in ("pi", "q", "alpha"):
        assert int(state["opt"][k]["count"]) == int(want_opt[k]["count"]) == 1
        _close_trees(state["opt"][k]["mu"], want_opt[k]["mu"])
        _close_trees(state["opt"][k]["nu"], want_opt[k]["nu"])


# ---------------------------------------------------------------- learner


@pytest.mark.parametrize("grad_clip", [0.05, 100.0], ids=["clipped", "unclipped"])
def test_learner_trajectory_matches_optax(grad_clip):
    import jax

    from ray_tpu.rl.learner import JaxLearner
    from ray_tpu_torch.rl.learner import TorchLearner

    jm, tm = _modules("torch", "discrete")
    loss_j, loss_t = _losses("jax", "ppo"), _losses("torch", "ppo")
    jl = JaxLearner(jm, loss_j, lr=1e-2, grad_clip=grad_clip, seed=0)
    tl = TorchLearner(tm, loss_t, lr=1e-2, grad_clip=grad_clip, seed=5, device="cpu")
    tl.set_weights(jax.device_get(jl.params))
    rng = np.random.default_rng(14)
    for step in range(3):
        batch = _batch("ppo", rng)
        want, got = jl.update(batch), tl.update(batch)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], what=f"step {step} {k}")
        if grad_clip < 1:
            assert want["grad_norm"] > grad_clip  # the clip acted
        _close_trees(tl.get_weights(), jax.device_get(jl.params))
    adam = convert._find_adam_state(jl.opt_state)
    state = convert.rl_opt_state_to_numpy(tl.opt, tl.params)
    assert int(state["count"]) == int(adam.count) == 3
    _close_trees(state["mu"], jax.device_get(adam.mu))
    _close_trees(state["nu"], jax.device_get(adam.nu))


def _same_bits(got, want):
    gp, gl = convert.flatten(got)
    wp, wl = convert.flatten(want)
    assert gp == wp
    for p, g, w in zip(gp, gl, wl):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), p


@pytest.mark.parametrize("kind", ["ppo", "dqn"])  # dqn: a tree with a buffer leaf (epsilon)
def test_checkpoint_params_and_adam_state_cross_bit_for_bit(tmp_path, kind):
    import jax

    from ray_tpu.rl.learner import JaxLearner
    from ray_tpu.train.checkpoint import load_pytree as jax_load
    from ray_tpu_torch.rl.learner import TorchLearner

    jm, tm = _modules("torch", "q" if kind == "dqn" else "discrete")
    jl = JaxLearner(jm, _losses("jax", kind), lr=3e-3, seed=0)
    rng = np.random.default_rng(15)
    for _ in range(2):
        jl.update(_batch(kind, rng))
    jl.save_state(str(tmp_path / "jax"))
    jtree = jax_load(str(tmp_path / "jax"))["params"]
    # JAX -> port: params through the JAX file, Adam's state through the converter.
    tl = TorchLearner(tm, _losses("torch", kind), lr=3e-3, seed=1, device="cpu")
    tl.set_weights(jtree)
    convert.rl_opt_state_from_numpy(jl.opt_state, tl.opt, tl.params)
    tl.save_state(str(tmp_path / "torch"))
    fresh = TorchLearner(tm, _losses("torch", kind), lr=3e-3, seed=2, device="cpu")
    fresh.load_state(str(tmp_path / "torch"))
    _same_bits(fresh.get_weights(), jax.device_get(jl.params))
    adam = convert._find_adam_state(jl.opt_state)
    state = convert.rl_opt_state_to_numpy(fresh.opt, fresh.params)
    _same_bits({"count": state["count"], "mu": state["mu"], "nu": state["nu"]},
               {"count": np.asarray(adam.count), "mu": jax.device_get(adam.mu),
                "nu": jax.device_get(adam.nu)})
    # Both continue from the same state alike.
    batch = _batch(kind, rng)
    jl.update(batch)
    fresh.update(batch)
    _close_trees(fresh.get_weights(), jax.device_get(jl.params))
    # port -> JAX: the port's params into a JAX learner, saved and restored.
    tree = fresh.get_weights()
    jl2 = JaxLearner(jm, _losses("jax", kind), lr=3e-3, seed=9)
    jl2.set_weights(tree)
    jl2.save_state(str(tmp_path / "jax2"))
    jl2.load_state(str(tmp_path / "jax2"))
    _same_bits(jax.device_get(jl2.params), tree)


def test_learners_run_on_cuda_unless_asked_for_the_cpu():
    from ray_tpu_torch.rl import CQL, CQLConfig, DQNConfig, TorchLearner
    from ray_tpu_torch.rl.env_runner import SingleAgentEnvRunner
    from ray_tpu_torch.rl.sac import SACLearner, SquashedGaussianModule

    jm, tm = _modules("torch", "discrete")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchLearner(tm, _losses("torch", "ppo"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SACLearner(SquashedGaussianModule(3, 1), gamma=0.99, tau=0.005, actor_lr=1e-3,
                       critic_lr=1e-3, alpha_lr=1e-3, target_entropy=-1.0, seed=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CQL(CQLConfig(obs_dim=3, act_dim=1))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DQNConfig().build()  # the learner comes before any env runner
    tl = TorchLearner(tm, _losses("torch", "ppo"), device="cpu")
    assert {p.device.type for p in tl.params.parameters()} == {"cpu"}
    runner = SingleAgentEnvRunner("CartPole-v1", tm, num_envs=2)
    assert runner.device == torch.device("cpu")


def _algo_state(algo):
    """Everything a restore must bring back, in the JAX layout."""
    if hasattr(algo, "learner"):  # SAC
        state = algo.learner.state()
        return {"params": state["params"], "target": state["target_q"], "opt": state["opt"],
                "counters": [algo.num_env_steps, algo.num_updates, algo.iteration]}
    out = {"params": algo.learner_group.get_weights()}
    if hasattr(algo, "target_params"):  # DQN
        out["target"] = convert.rl_params_to_numpy(algo.target_params)
        out["counters"] = [algo.num_env_steps, algo.num_updates, algo.iteration]
    return out


@pytest.mark.parametrize("kind", ["ppo", "dqn", "sac"])
def test_port_algorithms_restore_their_checkpoints_bit_for_bit(tmp_path, kind):
    """save() after two iterations, restore() into a fresh algorithm: the
    params, the target networks, SAC's three Adam states and the counters
    come back bit for bit (the JAX package's save/restore keep the same)."""
    from ray_tpu_torch.rl import DQNConfig, PPOConfig
    from ray_tpu_torch.rl.sac import SACConfig

    def build():
        if kind == "ppo":
            return PPOConfig().env_runners(1, num_envs_per_runner=2).training(
                rollout_length=16, num_epochs=1, minibatch_size=16, hidden=(16,),
                device="cpu").build()
        if kind == "dqn":
            return DQNConfig().training(learning_starts=16, rollout_length=4,
                                        updates_per_iteration=2, hidden=(16,),
                                        device="cpu").build()
        return SACConfig().training(learning_starts=16, rollout_length=4, train_batch_size=8,
                                    updates_per_iteration=2, hidden=(16,),
                                    device="cpu").build()

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        algo = build()
        for _ in range(2):
            bounded(algo.train, CASE_S)
        algo.save(str(tmp_path))
        want = _algo_state(algo)
        fresh = build()
        fresh.restore(str(tmp_path))
        got = _algo_state(fresh)
        if kind == "dqn":  # restore re-syncs epsilon from the restored step count
            assert got["params"].pop("epsilon") == want["params"].pop("epsilon")
        _same_bits(got, want)
        bounded(fresh.train, CASE_S)  # and trains on
    finally:
        ray_tpu_torch.shutdown()
