"""Training metrics: JSONL rows and CSV traces, plots, run analysis and
profiling helpers."""
