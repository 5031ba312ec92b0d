"""``python -m raytracing_tpu_torch``: the batch-render CLI."""

import sys

from .cli import main

sys.exit(main())
