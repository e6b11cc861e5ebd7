"""Built-in rules: importing this package registers the six invariant
families in declaration order (= run/report order)."""
from repro_torch.analysis.rules import purity  # noqa: F401
from repro_torch.analysis.rules import parity  # noqa: F401
from repro_torch.analysis.rules import registries  # noqa: F401
from repro_torch.analysis.rules import units  # noqa: F401
from repro_torch.analysis.rules import dtypes  # noqa: F401
from repro_torch.analysis.rules import wallclock  # noqa: F401
