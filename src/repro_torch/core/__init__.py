# The loader-aware evaluation protocol's statistics and decision tiers,
# and the raw-result schema they read: what the service's router needs.
# ``paper_data``, ``protocols`` and ``report`` come with the bench surface.
from repro_torch.core import decision, schema, stats  # noqa: F401
