"""Host utilities: spans and run statistics (:mod:`.profiling`) and kernel
warmup (:mod:`.warmup`)."""
