"""Domain decomposition: meshes of shards, halo exchange and the sharded
steps (counterpart of ``gcm_tpu/parallel``)."""
