"""ray_tpu_torch.rl: the RL stack (the counterpart of ray_tpu.rl, a
re-design of the reference's RLlib new API stack): RLModule (torch MLPs),
EnvRunner (over the port's own CartPole and Pendulum, rl/envs.py),
TorchLearner (Adam with optax's global-norm clip, on the card unless
device="cpu"; several learners average gradients over torch.distributed),
PPO, IMPALA, APPO, DQN, SAC, CQL, BC, MARWIL and multi-agent PPO."""

from .appo import APPO, APPOConfig, appo_loss
from .dqn import DQN, DQNConfig, QModule, dqn_loss
from .env_runner import EnvRunnerGroup, SingleAgentEnvRunner
from .impala import IMPALA, IMPALAConfig, impala_loss, vtrace
from .learner import LearnerGroup, TorchLearner
from .module import (
    DiscretePolicyConfig,
    DiscretePolicyModule,
    GaussianPolicyConfig,
    GaussianPolicyModule,
    RLModule,
    build_module_for_env,
    logp_entropy,
    sample_actions,
)
from .connectors import (
    ClipObs,
    Connector,
    ConnectorPipeline,
    FlattenObs,
    NormalizeObs,
)
from .offline import (
    BC,
    MARWIL,
    BCConfig,
    MARWILConfig,
    bc_loss,
    marwil_loss,
    rollouts_to_dataset,
)
from .multi_agent import (
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from .ppo import PPO, PPOConfig, compute_gae, ppo_loss
from .replay import TransitionReplayBuffer
from .cql import CQL, CQLConfig
from .offline import rollouts_to_transitions
from .sac import SAC, SACConfig, SquashedGaussianModule

__all__ = [
    "APPO", "APPOConfig", "appo_loss",
    "EnvRunnerGroup", "SingleAgentEnvRunner", "IMPALA", "IMPALAConfig",
    "impala_loss", "vtrace", "TorchLearner", "LearnerGroup",
    "DiscretePolicyConfig", "DiscretePolicyModule", "RLModule",
    "GaussianPolicyConfig", "GaussianPolicyModule", "build_module_for_env",
    "logp_entropy", "sample_actions", "PPO", "PPOConfig", "compute_gae",
    "ppo_loss", "DQN", "DQNConfig", "QModule", "dqn_loss",
    "TransitionReplayBuffer", "MultiAgentEnv", "MultiAgentEnvRunner",
    "MultiAgentPPO", "MultiAgentPPOConfig", "BC", "BCConfig", "bc_loss",
    "MARWIL", "MARWILConfig", "marwil_loss",
    "rollouts_to_dataset", "Connector", "ConnectorPipeline", "FlattenObs",
    "ClipObs", "NormalizeObs", "SAC", "SACConfig", "SquashedGaussianModule",
    "CQL", "CQLConfig", "rollouts_to_transitions",
]
