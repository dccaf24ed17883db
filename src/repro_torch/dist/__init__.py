"""Distributed execution. `sharding` places the SNN mesh path's tensors on
an `launch.mesh.SNNMesh` (the SNN rows of the JAX package's sharding
rules: `ShardingError`, `_fit`, `logical_spec`, `snn_state_specs`);
`compress.fake_compress` is the single-device numerics of the int8
gradient wire. The LM rules (`param_specs`, `batch_specs`, `cache_specs`,
`activation_rules`, `constrain`), `dist/pipeline.py` and the int8-wire
reduction come with LM sharding."""
