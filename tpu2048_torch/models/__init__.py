"""The DQN Q-network."""
