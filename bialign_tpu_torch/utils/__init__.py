"""Host utilities: run statistics and traces (:mod:`.profiling`) and kernel
warmup (:mod:`.warmup`)."""
