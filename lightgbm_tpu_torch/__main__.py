"""``python -m lightgbm_tpu_torch config=train.conf``: the reference's
``lightgbm`` CLI binary (src/main.cpp) on the card."""

import sys

from .cli import main

sys.exit(main())
