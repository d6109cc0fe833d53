"""`python -m repro_torch.analysis` — see repro_torch.analysis.cli."""
import sys

from .cli import main

sys.exit(main())
