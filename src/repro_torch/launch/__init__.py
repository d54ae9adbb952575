"""Launch surfaces in torch (``train``, ``cli``, ``mesh``, ``sharding``,
``ranks``, ``serve``, ``dryrun``, ``dryrun_decsvm``, ``quickstart``,
``decentralized_head`` and the ``profile_*`` scripts).  Counterpart of
``repro.launch``: the LM meshes, the placement rules, the sharded train
step, the sharded serve step (tensor-parallel decode over "model",
``serve.make_jitted_serve_step``) and the dry runs (one rank's step on
meta tensors against JAX's production meshes, with H100 rooflines) are
here."""
