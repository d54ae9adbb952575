"""Launch surfaces in torch (``train``, ``cli``, ``mesh``, ``ranks``,
``serve``, ``quickstart``, ``decentralized_head`` and the ``profile_*``
scripts).  Counterpart of ``repro.launch``; the sharding and dry-run
surfaces wait for later slices of the port (ROADMAP Queue 1 items 13.5
and 15)."""
