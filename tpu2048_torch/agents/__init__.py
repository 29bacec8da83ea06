"""Agents: the DQN actor-learner and the tabular Q-learner."""
