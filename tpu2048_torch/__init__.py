"""tpu2048_torch — the PyTorch/CUDA port of :mod:`tpu2048` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. Each module
names the ``tpu2048`` function it ports; the tests run both packages on the
same inputs. Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
