"""Agents: DQN configuration and the tabular Q-learner."""
