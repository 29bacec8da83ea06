"""The fast batched environment on the env-step kernel."""
