"""Distribution layer on `torch.distributed`: sharding rules, wire
compression, pipeline parallelism.

  * sharding    -- logical-axis -> mesh placement rules (DTensor
    placements on an `launch.mesh.SNNMesh`): the SNN mesh path's lanes and
    row tiles, and LM sharding's `param_specs`, `batch_specs`,
    `cache_specs` (a serving step's cache: `serve_cache_specs`),
    `logits_spec`, `place_tree`/`gather_tree`, and the
    `activation_rules` context with `constrain`, which model code calls
    freely (the identity unless rules are active).
  * compress    -- `compressed_psum_mean`, the int8-wire gradient mean with
    error feedback, and the single-device `fake_compress`.
  * pipeline    -- `make_pipeline_fn`, GPipe over one mesh axis.
  * collectives -- the functional collectives through blocking calls,
    which DTensor needs on a gloo group with CUDA tensors.
"""
