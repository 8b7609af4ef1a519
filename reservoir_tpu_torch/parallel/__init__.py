"""Stream-axis parallelism: one logical stream sampled by several shards,
whose reservoirs merge into one exact sample (:mod:`.merge`)."""
