"""``python -m fanlin_tpu_torch`` — same as ``python -m fanlin_tpu_torch.cli``."""

import sys

from .cli import main

sys.exit(main())
