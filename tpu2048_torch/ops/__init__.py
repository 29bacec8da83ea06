"""Board operations and the env-step kernel."""
