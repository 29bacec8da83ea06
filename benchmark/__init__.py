"""The benchmark of ``tpu2048_torch`` on one NVIDIA H100: a harness driven
by data (``BENCHMARK.json`` and the files under this folder), its plain
reference and its yardstick. See ``README.md``."""
