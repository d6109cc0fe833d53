"""Rule implementations.  Importing this package populates the registry
(base._REGISTRY) — all_rules()/get_rule() trigger the import lazily."""
from . import clock          # noqa: F401
from . import host_sync      # noqa: F401
from . import ir_rules       # noqa: F401
from . import jit_hygiene    # noqa: F401
from . import policy_conformance  # noqa: F401
from . import pytree         # noqa: F401
from . import rng            # noqa: F401
