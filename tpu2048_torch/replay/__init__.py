"""Replay memory of the DQN learner."""
