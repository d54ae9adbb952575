"""Launch surfaces in torch (``mesh``, ``ranks``, ``serve``, ``quickstart``,
``decentralized_head`` and the ``profile_*`` scripts).  Counterpart of
``repro.launch``; the sharding, training and dry-run surfaces wait for
later slices of the port (ROADMAP Queue 1 items 13 and 15)."""
