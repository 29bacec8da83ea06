"""The system under test, built from a configuration file: the port's
config objects and models, with the weights the benchmark made. This is
the only file, beside the drivers, that imports the port."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": True, "float32": False}


def dqn_agent_config(cfg, traffic):
    from tpu2048_torch.agents import dqn as dqnlib

    return dqnlib.DQNConfig(
        gamma=cfg["gamma"], epsilon=cfg["epsilon"],
        epsilon_min=cfg["epsilon_min"], epsilon_decay=cfg["epsilon_decay"],
        batch_size=traffic.get("train_batch", 64),
        memory_size=cfg["memory_size"], learning_rate=cfg["learning_rate"],
        features=cfg["features"], hidden=cfg["hidden"],
        dropout=cfg["dropout"], num_blocks=cfg["num_blocks"],
        bf16=DTYPES[cfg["compute_dtype"]])


@torch.no_grad()
def load_weights(module: torch.nn.Module, weights) -> torch.nn.Module:
    """Copy the benchmark's weights into a module of the port, by name."""
    module.load_state_dict(weights, strict=True)
    return module


def dqn_model(cfg, weights, device):
    """The port's Q-network at the configuration's sizes, in eval mode,
    with ``weights``."""
    from tpu2048_torch.models import dqn as dqn_model

    model = dqn_model.create_model(dqn_agent_config(cfg, {}), device)
    return load_weights(model, weights).eval()


def tabular_config(cfg, traffic):
    from tpu2048_torch.agents import tabular as tab
    from tpu2048_torch.env.env import SHAPED, EnvConfig
    from tpu2048_torch.training import tabular as ttrain

    agent = tab.TabularConfig(
        learning_rate=cfg["learning_rate"], discount=cfg["discount"],
        exploration_rate=cfg["exploration_rate"],
        exploration_min=cfg["exploration_min"],
        total_epochs=cfg["total_epochs"],
        capacity_log2=cfg["capacity_log2"])
    env = EnvConfig(reward=SHAPED,
                    max_consecutive_actions=traffic["max_consecutive_actions"],
                    stall_force_done=traffic["stall_force_done"])
    return ttrain.TabularTrainConfig(
        agent=agent, env=env, batch_size=traffic["lanes"],
        steps_per_chunk=traffic["steps_per_chunk"], engine="fast",
        table_backend="auto")
