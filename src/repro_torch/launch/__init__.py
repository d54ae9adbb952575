"""Launch surfaces in torch (``train``, ``cli``, ``mesh``, ``sharding``,
``ranks``, ``serve``, ``quickstart``, ``decentralized_head`` and the
``profile_*`` scripts).  Counterpart of ``repro.launch``: the LM meshes,
the placement rules, the sharded train step and the sharded serve step
(tensor-parallel decode over "model", ``serve.make_jitted_serve_step``)
are here (ROADMAP Queue 1 item 13.5); the dry-run surfaces wait for a
later slice of the port (item 15)."""
