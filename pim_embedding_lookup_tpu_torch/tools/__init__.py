"""The port's measurement entry points, one module each, the counterparts of
the JAX package's ``tools/`` scripts with their flags, defaults and JSON
keys, plus ``--device``:

    python -m pim_embedding_lookup_tpu_torch.tools.train_bench     # sparse train steps
    python -m pim_embedding_lookup_tpu_torch.tools.serving_bench   # latency under load
    python -m pim_embedding_lookup_tpu_torch.tools.phase_bench     # feed/dispatch/compute/fetch
    python -m pim_embedding_lookup_tpu_torch.tools.capacity_bench  # int8 at f32-impossible sizes
    python -m pim_embedding_lookup_tpu_torch.tools.trace_capture   # Chrome trace + Gantt
    python -m pim_embedding_lookup_tpu_torch.tools.kernel_lab      # kernel and scatter probes
    python -m pim_embedding_lookup_tpu_torch.tools.scaling_bench   # lookups/s at 1..N shards
    python -m pim_embedding_lookup_tpu_torch.tools.routed_gather_audit  # rows gathered a shard

Each runs on CUDA unless ``--device`` names another device, and fails where
there is no card and the CPU was not asked for.  One more, with no JAX
counterpart, needs ``nvcc`` and no card:

    python -m pim_embedding_lookup_tpu_torch.tools.build_times     # nvcc seconds a source

Importing a module runs nothing.
"""
