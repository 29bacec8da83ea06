"""Training metrics: JSONL rows."""
