"""`python -m aniso_torch run data.cfg`: module entry to the CLI."""

import sys

from .cli import main

sys.exit(main())
