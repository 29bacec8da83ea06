"""``python -m tpu2048_torch`` — CLI entry point."""

import sys

from tpu2048_torch.cli.main import main

sys.exit(main())
