"""tests/test_rl.py's behaviour cases (those not marked slow) on both
packages, the JAX package's ray_tpu.rl and the port's ray_tpu_torch.rl,
with the same configs and assertions (the port's learners on
device="cpu"): the env runner and connector state surviving a replacement
on `init(local_mode=True)` and on a cluster of worker processes
(tests/torch_modes.py), a runner with connector pipelines, IMPALA and APPO
improving, the DQN and SAC smokes, continuous PPO, multi-agent PPO, BC and
MARWIL, CQL's conservatism, and a 2-learner LearnerGroup against one
learner on the cluster runtime.

IMPALA and APPO get 150 iterations to show the learning signal (mean
return 60): the async pipeline makes the crossing iteration vary, 6-75
iterations over seeds 0-4 for APPO in both packages, past tests/test_rl.py's
60-iteration APPO cap in some (tests/test_rl.py's IMPALA case gives 150 for
the same reason). Every case runs under its own `case_time_limit`; each
package boots one cluster for the file.
"""

import sys

import numpy as np
import pytest

import cloudpickle

import torch_modes
from ray_tpu_torch.core import serialization
from ray_tpu_torch.models import convert
from test_torch_rl import (CASE_S, PACKAGES, _close, _close_trees, _losses, _ns, _same_bits,
                           _t, _weights)
from torch_waits import bounded

serialization.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(sys.modules[__name__])

CLUSTER_CASE_S = 150


# ------------------------------------------------------------- behaviour


@pytest.fixture(scope="module")
def clusters():
    booted = torch_modes.Clusters(num_cpus=8)
    try:
        yield booted
    finally:
        booted.shutdown()


@pytest.fixture(params=torch_modes.PARAMS, ids=torch_modes.IDS)
def pkg(request):
    """The package's namespace on local mode or its cluster; cluster cases
    run under their own time limit."""
    name, mode = request.param
    clusters = request.getfixturevalue("clusters") if mode == "cluster" else None
    limit = CLUSTER_CASE_S if mode == "cluster" else CASE_S
    with torch_modes.case_time_limit(request, limit):
        with torch_modes.runtime_for(clusters, name, mode, num_cpus=8):
            ns = _ns(name)
            ns.mode = mode
            yield ns


@pytest.fixture(params=PACKAGES)
def local(request):
    """The package's namespace on `init(local_mode=True)`."""
    with torch_modes.case_time_limit(request, CASE_S):
        with torch_modes.runtime_for(None, request.param, "local", num_cpus=8):
            yield _ns(request.param)


def _discrete(ns, obs_dim=4, hidden=(64, 64)):
    return ns.module.DiscretePolicyModule(ns.module.DiscretePolicyConfig(
        obs_dim=obs_dim, n_actions=2, hidden=hidden))


def test_module_and_learner_step(local):
    rng = np.random.default_rng(0)
    batch = {"obs": rng.normal(size=(32, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 32),
             "logp": np.full(32, -0.69, np.float32),
             "advantages": rng.normal(size=32).astype(np.float32),
             "returns": rng.normal(size=32).astype(np.float32)}
    cls = getattr(local.learner, "JaxLearner" if local.name == "jax" else "TorchLearner")
    learner = cls(_discrete(local), _losses(local.name, "ppo"), lr=1e-3, **local.kw)
    m1, m2 = learner.update(batch), learner.update(batch)
    assert np.isfinite(m1["total_loss"]) and np.isfinite(m2["total_loss"])
    assert m1["grad_norm"] > 0


def test_env_runner_sampling(pkg):
    module = _discrete(pkg)
    group = pkg.env_runner.EnvRunnerGroup("CartPole-v1", module, num_runners=2,
                                          num_envs_per_runner=2)
    group.sync_weights(_weights(pkg, module))
    rollouts = bounded(lambda: group.sample(8), CASE_S)
    assert len(rollouts) == 2
    ro = rollouts[0]
    assert ro["obs"].shape == (8, 2, 4) and ro["actions"].shape == (8, 2)
    assert set(np.unique(ro["actions"])).issubset({0, 1})
    assert ro["mask"][0].tolist() == [1.0, 1.0]
    assert np.isfinite(ro["last_values"]).all() and ro["last_obs"].shape == (2, 4)


def test_env_runner_with_connector_pipelines(local):
    """FrameStack env->module pipeline through a real EnvRunner sample."""
    c = local.connectors
    k = 2
    module = _discrete(local, obs_dim=4 * k, hidden=(16,))
    pipe = c.ConnectorPipeline([c.NormalizeObs(), c.FrameStack(k=k)])
    if local.name == "jax":
        runner = local.env_runner.SingleAgentEnvRunner(
            "CartPole-v1", cloudpickle.dumps(module), num_envs=2,
            connector_blob=cloudpickle.dumps(pipe))
    else:
        runner = local.env_runner.SingleAgentEnvRunner("CartPole-v1", module, num_envs=2,
                                                       connector=pipe)
    runner.set_weights(_weights(local, module))
    batch = runner.sample(8)
    assert batch["obs"].shape == (8, 2, 4 * k)
    assert np.isfinite(batch["obs"]).all()


def test_connector_state_survives_runner_replacement(pkg):
    c = pkg.connectors
    module = _discrete(pkg)
    group = pkg.env_runner.EnvRunnerGroup(
        "CartPole-v1", module, num_runners=1, num_envs_per_runner=2,
        connector=c.ConnectorPipeline([c.FlattenObs(), c.NormalizeObs()]))
    group.sync_weights(_weights(pkg, module))
    for _ in range(3):
        bounded(lambda: group.sample(8), CASE_S)
    state = group.connector_state()
    assert state is not None and state[1]["count"] > 0
    replacement = group._make_runner(0)
    inherited = pkg.rt.get(replacement.get_connector_state.remote())
    assert inherited[1]["count"] == state[1]["count"]


def _improves(algo, target, iters):
    best = -np.inf
    for _ in range(iters):
        r = algo.train().get("episode_return_mean")
        if r is not None and np.isfinite(r):
            best = max(best, r)
        if best >= target:
            break
    return best


def test_impala_cartpole_runs_and_improves(local):
    algo = local.impala.IMPALAConfig(num_env_runners=2, num_envs_per_runner=4,
                                     rollout_length=32, seed=3, **local.kw).build()
    best = bounded(lambda: _improves(algo, 60, 150), CASE_S)
    assert best >= 60, f"IMPALA showed no learning signal: best={best}"


def test_appo_cartpole_runs_and_improves(local):
    algo = local.appo.APPOConfig(env="CartPole-v1", num_env_runners=2, num_envs_per_runner=4,
                                 **local.kw).build()
    best = bounded(lambda: _improves(algo, 60, 150), CASE_S)
    assert best >= 60, f"APPO showed no learning signal: best={best}"


def test_dqn_smoke(local):
    algo = (local.dqn.DQNConfig().environment("CartPole-v1")
            .training(learning_starts=64, rollout_length=8, updates_per_iteration=4, seed=2,
                      **local.kw).build())
    for _ in range(4):
        result = algo.train()
    assert result["buffer_size"] > 0 and result["num_updates"] > 0
    assert np.isfinite(result.get("td_error_mean", np.nan))
    assert result["epsilon"] < 1.0


def test_sac_smoke(local):
    algo = (local.sac.SACConfig().environment("Pendulum-v1")
            .training(learning_starts=128, rollout_length=8, updates_per_iteration=4, seed=3,
                      **local.kw).build())
    for _ in range(4):
        result = algo.train()
    assert result["buffer_size"] > 0 and result["num_updates"] > 0
    assert np.isfinite(result["q_loss"]) and np.isfinite(result["pi_loss"])
    assert result["alpha"] > 0


def test_ppo_pendulum_continuous_runs(local):
    algo = (local.ppo.PPOConfig().environment("Pendulum-v1")
            .env_runners(num_env_runners=1, num_envs_per_runner=4)
            .training(rollout_length=32, num_epochs=2, minibatch_size=64, seed=5, **local.kw)
            .build())
    for _ in range(3):
        result = algo.train()
    assert result["num_env_steps_sampled"] > 0
    assert np.isfinite(result["policy_loss"]) and np.isfinite(result["entropy"])
    assert abs(result["kl_approx"]) < 0.5, result["kl_approx"]


class _TwoBanditEnv:
    """Two agents, constant obs; agent_i is rewarded for playing action i."""

    possible_agents = ["a0", "a1"]

    def __init__(self):
        self._t = 0

    def reset(self, *, seed=None):
        self._t = 0
        return {a: np.ones(2, np.float32) for a in self.possible_agents}, {}

    def step(self, actions):
        self._t += 1
        rewards = {"a0": 1.0 if int(actions["a0"]) == 0 else 0.0,
                   "a1": 1.0 if int(actions["a1"]) == 1 else 0.0}
        obs = {a: np.ones(2, np.float32) for a in self.possible_agents}
        return obs, rewards, {"__all__": self._t >= 8}, {"__all__": False}, {}


def test_multi_agent_ppo_learns_per_policy(local):
    ma = local.multi_agent
    algo = ma.MultiAgentPPOConfig(
        env_ctor=_TwoBanditEnv,
        policies={"p0": _discrete(local, obs_dim=2, hidden=(16,)),
                  "p1": _discrete(local, obs_dim=2, hidden=(16,))},
        policy_mapping_fn=lambda agent_id: "p0" if agent_id == "a0" else "p1",
        rollout_length=64, lr=0.02, entropy_coeff=0.0, seed=0, **local.kw).build()
    try:
        best = -np.inf
        for _ in range(20):
            r = algo.train()["episode_return_mean"]
            if np.isfinite(r):
                best = max(best, r)
            if best >= 14:  # 8 steps x 2 agents, near-optimal = 16
                break
        assert best >= 14, f"multi-agent PPO failed to learn: best={best}"
    finally:
        algo.shutdown()


def test_multi_agent_shared_policy(local):
    ma = local.multi_agent
    algo = ma.MultiAgentPPOConfig(
        env_ctor=_TwoBanditEnv, policies={"shared": _discrete(local, obs_dim=2, hidden=(8,))},
        policy_mapping_fn=lambda agent_id: "shared", rollout_length=32, seed=1,
        **local.kw).build()
    try:
        result = algo.train()
        assert result["num_env_steps_sampled"] == 64  # both agents' steps
        assert np.isfinite(result["module_metrics"]["shared"]["total_loss"])
    finally:
        algo.shutdown()


def _expert_rollout(mixed: bool):
    rng = np.random.RandomState(0)
    T, N = 64, 4
    obs = rng.randn(T, N, 4).astype(np.float32)
    good = (obs[..., 0] > 0).astype(np.int64)
    if not mixed:
        return obs, good, {"obs": obs, "actions": good, "rewards": np.ones((T, N), np.float32),
                           "dones": np.zeros((T, N), np.float32),
                           "mask": np.ones((T, N), np.float32)}
    actions = np.where(np.arange(N) % 2 == 0, good, 1 - good)
    rewards = np.broadcast_to(np.where(np.arange(N) % 2 == 0, 1.0, 0.0).astype(np.float32),
                              (T, N)).copy()
    return obs, good, {"obs": obs, "actions": actions, "rewards": rewards,
                       "dones": np.ones((T, N), np.float32), "mask": np.ones((T, N), np.float32)}


def _greedy(ns, algo, obs):
    params = algo.get_weights()
    if ns.name == "jax":
        out = algo.config.module.forward_inference(params, obs)
        return np.asarray(out["logits"]).argmax(-1)
    p = convert.rl_params_from_numpy(params, device="cpu")
    return algo.config.module.forward_inference(p, _t(obs))["logits"].argmax(-1).numpy()


def test_behavior_cloning_from_offline_dataset(local):
    off = local.offline
    _, _, rollout = _expert_rollout(mixed=False)
    dataset = off.rollouts_to_dataset([rollout])
    assert dataset.count() == 64 * 4
    bc = off.BCConfig(module=_discrete(local, hidden=(32,)), lr=5e-3, **local.kw).build()
    for _ in range(8):
        metrics = bc.train_on_dataset(dataset)
    assert np.isfinite(metrics["bc_nll"])
    acc = bc.action_accuracy(dataset)
    assert acc > 0.9, f"BC failed to clone the expert: accuracy={acc}"


def test_marwil_upweights_high_return_actions(local):
    off = local.offline
    obs, good, rollout = _expert_rollout(mixed=True)
    dataset = off.rollouts_to_dataset([rollout])
    assert "return" in dataset.take(3)[0]
    marwil = off.MARWILConfig(module=_discrete(local, hidden=(32,)), beta=3.0, lr=5e-3,
                              **local.kw).build()
    for _ in range(10):
        metrics = marwil.train_on_dataset(dataset)
    assert np.isfinite(metrics["marwil_policy_loss"])
    flat_obs = obs.reshape(-1, 4)
    marwil_acc = (_greedy(local, marwil, flat_obs) == good.reshape(-1)).mean()
    assert marwil_acc > 0.75, f"MARWIL did not follow the high-return policy: {marwil_acc}"
    bc = off.BCConfig(module=_discrete(local, hidden=(32,)), lr=5e-3, **local.kw).build()
    for _ in range(10):
        bc.train_on_dataset(dataset)
    bc_acc = (_greedy(local, bc, flat_obs) == good.reshape(-1)).mean()
    assert bc_acc < marwil_acc, (bc_acc, marwil_acc)


def test_cql_is_conservative_on_ood_actions(local):
    rng = np.random.RandomState(0)
    T, N, obs_dim, act_dim = 40, 8, 3, 1
    obs = rng.randn(T, N, obs_dim).astype(np.float32)
    actions = (0.5 + 0.05 * rng.randn(T, N, act_dim)).astype(np.float32).clip(-1, 1)
    rewards = (1.0 - np.abs(actions[..., 0] - 0.5)).astype(np.float32)
    rollout = {"obs": obs, "actions": actions, "rewards": rewards,
               "dones": np.zeros((T, N), np.float32)}
    dataset = local.offline.rollouts_to_transitions([rollout])
    assert dataset.count() == (T - 1) * N
    algo = local.cql.CQLConfig(obs_dim=obs_dim, act_dim=act_dim, cql_alpha=5.0,
                               n_action_samples=4, batch_size=64, seed=0, **local.kw).build()
    for _ in range(6):
        metrics = algo.train_on_dataset(dataset)
    assert np.isfinite(metrics["q_loss"]) and "cql_conservative" in metrics
    eval_obs = obs[:-1].reshape(-1, obs_dim)[:128]
    data_act = actions[:-1].reshape(-1, act_dim)[:128]
    ood_act = rng.uniform(-1.0, -0.6, size=data_act.shape).astype(np.float32)
    q_data = algo.q_values(eval_obs, data_act).mean()
    q_ood = algo.q_values(eval_obs, ood_act).mean()
    assert q_ood < q_data, f"CQL not conservative: ood {q_ood} >= data {q_data}"
    acts = algo.compute_actions(eval_obs[:4])
    assert acts.shape == (4, act_dim) and np.all(np.abs(acts) <= 1.0)


@pytest.mark.parametrize("name", PACKAGES)
def test_two_learner_group_matches_one_learner(request, clusters, name):
    """LearnerGroup(num_learners=2): two learner processes, each on half of
    every batch, averaging gradients, end where one learner on the whole
    batch ends (within 1e-5), and stay identical to each other."""
    import jax

    with torch_modes.case_time_limit(request, CLUSTER_CASE_S):
        with torch_modes.runtime_for(clusters, name, "cluster", num_cpus=8):
            ns = _ns(name)
            module = _discrete(ns, hidden=(8,))

            def loss_fn(mod, params, batch):
                out = mod.forward_train(params, batch["obs"])
                loss = ((out["vf"] - batch["target"]) ** 2).mean()
                return loss, {"vf_loss": loss}

            kw = {"devices_per_learner": 1} if name == "jax" else {"device": "cpu"}
            group = ns.learner.LearnerGroup(module, loss_fn, num_learners=2, lr=1e-2, seed=4,
                                            **kw)
            single = ns.learner.LearnerGroup(module, loss_fn, num_learners=1, lr=1e-2, seed=4,
                                             **({} if name == "jax" else {"device": "cpu"}))
            try:
                rng = np.random.RandomState(0)
                losses = []
                for _ in range(3):
                    batch = {"obs": rng.randn(17, 4).astype(np.float32),  # a ragged row
                             "target": rng.randn(17).astype(np.float32)}
                    m = bounded(lambda: group.update(batch), CASE_S)
                    even = {k: v[:16] for k, v in batch.items()}
                    s = single.update(even)
                    _close(m["vf_loss"], s["vf_loss"], what="loss")
                    losses.append(m["vf_loss"])
                assert losses[-1] < losses[0]
                got = bounded(group.get_weights, CASE_S)
                other = ns.rt.get(group._actors[1].get_weights.remote())
                _same_bits(jax.device_get(other), jax.device_get(got))
                _close_trees(jax.device_get(got), jax.device_get(single.get_weights()))
            finally:
                group.shutdown()
