"""Launch surfaces in torch (``train``, ``cli``, ``mesh``, ``sharding``,
``ranks``, ``serve``, ``quickstart``, ``decentralized_head`` and the
``profile_*`` scripts).  Counterpart of ``repro.launch``: the LM meshes,
the placement rules and the sharded train step are here (ROADMAP Queue 1
item 13.5, sub-steps 1, 2 and 4); the sharded serve step and the dry-run
surfaces wait for later slices of the port (item 13.5, sub-step 3, and
item 15)."""
