"""Launch surfaces in torch (``serve``, ``quickstart`` and the
``profile_*`` scripts).  Counterpart of ``repro.launch``;
the mesh, sharding, training and dry-run surfaces wait for later slices
of the port (ROADMAP Queue 1 items 12, 13 and 15)."""
